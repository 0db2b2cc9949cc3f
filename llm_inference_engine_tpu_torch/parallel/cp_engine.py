"""Engine wiring for context parallelism (the ``seq`` mesh axis).

Port of ``llm_inference_engine_tpu/parallel/cp_engine.py``.
:func:`make_cp_forward` builds the counterpart of
``models.llama.forward_hidden`` over a (data, seq, model) mesh and a
:class:`~llm_inference_engine_tpu_torch.parallel.cp_cache.CPCache`. The
JAX package runs it inside one ``shard_map``; here one controller drives
every rank's layer body (``parallel/sharding.lockstep``):

- prefill: the token chunk is sequence-sharded: rank s embeds and
  projects only its [s*T/n, (s+1)*T/n) sub-chunk, appends the resulting
  k/v to its LOCAL log, and attention runs as ring attention over the seq
  ranks (``parallel/context_parallel.py``);
- decode: activations are replicated over seq (every seq rank runs the
  token's layer body), the least-full rank appends the token, and
  attention runs as split-KV: each rank attends its local log and the
  partials are combined over the seq ranks;
- tensor and data parallelism compose unchanged: the wo / w_down sums
  run over the model ranks of each (data, seq) group, the vocab-sharded
  logits are concatenated over the model ranks, then the data ranks.

Before the layers every rank appends its new rows' absolute positions to
its kv_pos; after them ``llen`` advances (the layers write at the old log
tails). The last valid token's hidden state comes from the seq rank that
owns it, and the lm_head runs once per (data, model) rank, on seq rank
0's device. Seq ranks that share a device share their weight tensors
(``sharding.shard_params``).

Rows that attention reads: a forward with ``kv_hi`` reads the first
``kv_hi`` rows of every local log (the engine's prefill passes its host
mirror of max(llen) rounded up to ``context_parallel.BLOCK_KV``); without
it, the whole local log: a captured decode graph replays one row count
(what it costs a step is in PERF.md).
"""

from __future__ import annotations

import torch

from llm_inference_engine_tpu_torch.models import llama as llama_model
from llm_inference_engine_tpu_torch.parallel.cp_cache import (
    CPCache, CPSpec, append_kv_pos, cp_llen_after, cp_write_plan)
from llm_inference_engine_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, local_config, validate_mesh)
from llm_inference_engine_tpu_torch.parallel.sharding import (
    ShardedParams, _on, lockstep, mesh_logits)

__all__ = ["cp_cache_pspecs", "make_cp_forward"]


def cp_cache_pspecs(cache: CPCache | None = None) -> dict:
    """How each field of a :class:`CPCache` splits over the mesh, the JAX
    package's partition specs by axis name per dimension (None: whole):
    the rows over seq, the batch over data, the kv heads over model (an
    int8 log's scale planes with their rows); ``llen`` and ``lengths``
    live whole on the home device, which one controller updates
    (the JAX package replicates ``llen`` over seq and model instead)."""
    rows = (None, DATA_AXIS, SEQ_AXIS, MODEL_AXIS, None)
    quant = cache is not None and cache.quantized
    return {"k": rows, "v": rows, "kv_pos": (DATA_AXIS, SEQ_AXIS),
            "llen": (None, None), "lengths": (None,),
            "k_scale": rows[:4] if quant else None,
            "v_scale": rows[:4] if quant else None}


def make_cp_forward(config, engine_config, mesh: Mesh):
    """``forward_hidden`` over a (data, seq, model) mesh: a function of
    (sharded params, a :class:`CPCache`, token_ids [B, T], q_start [B],
    kv_len [B], all on the home device, and ``kv_hi``, the local rows to
    read, None for all) returning (logits [B, V] f32 on the home device,
    the cache), the logs, kv_pos, llen and lengths updated in place. A
    prefill chunk's T must divide over the seq ranks; T == 1 is decode."""
    validate_mesh(config, engine_config, mesh)
    cfg_local = local_config(config, mesh)
    dp, n, tp = mesh.dp, mesh.cp, mesh.tp

    def fwd(params: ShardedParams, cache: CPCache, token_ids, q_start,
            kv_len, kv_hi=None):
        B, T = token_ids.shape
        if T > 1 and (T % n or T < 2 * n):
            raise ValueError(f"a prefill chunk of T {T} gives cp {n} ranks "
                             "unequal or single-row parts")
        t_local = T // n if T > 1 else 1
        s_local = cache.local_len
        rows = s_local if kv_hi is None else max(1, min(s_local, kv_hi))
        gens, lasts = [], []
        for d in range(dp):
            rs = cache.rows(d)
            ids, qs, kl, llen = (token_ids[rs], q_start[rs], kv_len[rs],
                                 cache.llen[rs])
            for s in range(n):
                start, count, pos0 = cp_write_plan(llen, qs, kl, s, n,
                                                   t_local)
                ids_s = ids[:, s * t_local:(s + 1) * t_local] if T > 1 else ids
                for r in range(tp):
                    dev = mesh.device(d, s, r)
                    with _on(dev):
                        st, ct, p0 = start.to(dev), count.to(dev), pos0.to(dev)
                        kv_pos = cache.kv_pos[d][s][r]
                        append_kv_pos(kv_pos, st, ct, p0, t_local)
                        offs = torch.arange(max(t_local, rows),
                                            dtype=torch.int32, device=dev)
                        q_pos = (p0[:, None] + offs[None, :t_local]
                                 if T > 1 else p0[:, None])
                        spec = CPSpec(n, s, st, ct, q_pos, kv_pos[:, :rows],
                                      offs[None, :rows] < (st + ct)[:, None])
                        gens.append(llama_model.decoder(
                            cfg_local, engine_config, params.shard(d, s, r),
                            ids_s.to(dev), cache.shards[d][s][r], qs.to(dev),
                            kl.to(dev), tapped=False, cp=spec))
            # before the forward: it overwrites the lengths, which q_start
            # may be
            new = kl - qs
            last = torch.clamp(new - 1, min=0).long()
            lasts.append((new > 0, last // t_local, last % t_local))
        hidden = lockstep(gens, mesh)
        cache.llen.copy_(cp_llen_after(cache.llen, q_start, kv_len, n,
                                       t_local))
        # each (data, model) rank's last valid hidden states, from the seq
        # rank that owns each row's last token, on seq rank 0's device
        h_last = []
        for d in range(dp):
            real, owner, local_idx = lasts[d]
            for r in range(tp):
                dev = mesh.device(d, 0, r)
                hs = [hidden[(d * n + s) * tp + r] for s in range(n)]
                if T == 1:
                    h_last.append(hs[0][:, 0])  # the same on every rank
                    continue
                b = torch.arange(hs[0].shape[0], device=dev)
                cands = torch.stack([h.to(dev)[b, local_idx.to(dev)]
                                     for h in hs])
                h_last.append(torch.where(real.to(dev)[:, None],
                                          cands[owner.to(dev), b],
                                          torch.zeros_like(cands[0])))
        cache.lengths.copy_(kv_len)
        return mesh_logits(cfg_local, engine_config, mesh, params,
                           h_last), cache

    return fwd

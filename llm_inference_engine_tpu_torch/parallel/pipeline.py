"""Pipeline parallelism: layer stages over a ``pipe`` mesh axis.

Port of ``llm_inference_engine_tpu/parallel/pipeline.py``: a (pipe, data,
model) mesh where every stacked per-layer tensor, the weights and the KV
cache, is split along its layer axis over ``pipe`` (stage s holds layers
[s*L/pp, (s+1)*L/pp), with their tensor-parallel shards), and the
embedding, final norm and lm_head are whole on every stage, as in the JAX
package.

The JAX package runs every stage on every tick under SPMD, gating the
cache writes of the ticks that carry no real activations (``write_gate``)
and moving activations with ``ppermute``. One controller runs only the
real ticks: each stage runs ``models.llama.decoder`` on its layers over
its (data, model) ranks in ``make_sharded_forward``'s lockstep
(``parallel/sharding.mesh_decoder``; stage 0 embeds), and hands its
output to the next stage's devices. Under the port's norm folding a
layer's output is the pair (down, residual), whose sum the next norm
adds (``models/llama.py``): the pair crosses the stage boundary as it
is, so the next stage's first norm is the same fused add + rmsnorm a
one-rank forward runs, and the logits and every cache row equal the
one-rank forward's bit for bit. The last stage's final norm and lm_head
give the logits, gathered over the model ranks, then the data ranks
(``sharding.mesh_logits``), on stage 0's home device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from llm_inference_engine_tpu_torch.ops.kv_cache import KVCache
from llm_inference_engine_tpu_torch.ops.quant import add_decode_layouts
from llm_inference_engine_tpu_torch.parallel import sharding as S
from llm_inference_engine_tpu_torch.parallel.mesh import (
    Mesh, local_config, make_mesh, validate_mesh)

__all__ = ["PIPE_AXIS", "PPMesh", "make_pp_mesh", "pp_param_pspecs",
           "pp_cache_pspecs", "shard_params_pp", "shard_cache_pp",
           "make_pp_forward"]

PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True, eq=False)
class PPMesh:
    """stages[s]: pipeline stage s's (data, model) :class:`Mesh`."""
    stages: tuple

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them."""
        m = self.stages[0]
        return {PIPE_AXIS: self.pp, "data": m.dp, "model": m.tp}

    @property
    def pp(self) -> int:
        return len(self.stages)

    @property
    def home(self) -> torch.device:
        return self.stages[0].home


def make_pp_mesh(pp: int = 1, dp: int = 1, tp: int = 1,
                 devices: Optional[Sequence[torch.device]] = None) -> PPMesh:
    """A (pipe=pp, data=dp, model=tp) mesh: stage s takes devices
    [s*dp*tp, (s+1)*dp*tp). ``devices`` defaults to ``cuda:0 ...
    cuda:n-1``; ``[torch.device("cuda", 0)] * n`` puts every rank on one
    card, ``[torch.device("cpu")] * n`` on the CPU."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n, per = pp * dp * tp, dp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices for pp={pp} dp={dp} tp={tp}, "
                         f"have {len(devices)}")
    return PPMesh(tuple(make_mesh(dp, tp, devices=devices[s * per:
                                                          (s + 1) * per])
                        for s in range(pp)))


def _stage_layers(num_layers: int, pp: int, s: int) -> slice:
    if num_layers % pp:
        raise ValueError(f"num_layers {num_layers} % pp {pp}")
    per = num_layers // pp
    return slice(s * per, (s + 1) * per)


def pp_param_pspecs(params: dict) -> dict:
    """The tensor-parallel split of every leaf (``sharding.param_pspecs``),
    each per-layer leaf's layer axis also split over ``pipe``:
    ``("pipe", split)`` for the layers, the split alone for the rest."""
    base = S.param_pspecs(params)
    return {**base, "layers": {k: (PIPE_AXIS, v)
                               for k, v in base["layers"].items()}}


def pp_cache_pspecs(quantized: bool = False) -> dict:
    """The slot cache's split: k/v [L, B, S, K, D] (and an int8 cache's
    scale planes [L, B, S, K]) over pipe on L, data on B, model on K; the
    lengths over data."""
    spec = (PIPE_AXIS, "data", None, "model")
    return {"k": spec, "v": spec,
            "k_scale": spec if quantized else None,
            "v_scale": spec if quantized else None,
            "lengths": ("data",)}


def shard_params_pp(params: dict, mesh: PPMesh) -> list:
    """Stage s's params (its layers' views of the stacked leaves, the
    embedding, final norm and lm_head whole), sharded over the stage's
    (data, model) mesh: a list of ``sharding.ShardedParams``. On the card
    each INT4 shard gets its fragment-order copy, which kernel E reads at
    m <= 16 (``quant.add_decode_layouts``, at the model's dtype)."""
    L = next(iter(params["layers"].values())).shape[0]
    out = []
    for s, stage in enumerate(mesh.stages):
        part = _stage_layers(L, mesh.pp, s)
        out.append(S.shard_params(
            {**params, "layers": {k: w[part]
                                  for k, w in params["layers"].items()}},
            stage))
        add_decode_layouts(out[-1].grid, params["embed"].dtype)
    return out


def shard_cache_pp(cache: KVCache, mesh: PPMesh) -> list:
    """Stage s's layers of a one-device slot cache, sharded over the
    stage's (data, model) mesh (``sharding.shard_cache``): a list of
    ``sharding.MeshCache``."""
    L = cache.num_layers
    out = []
    for s, stage in enumerate(mesh.stages):
        part = _stage_layers(L, mesh.pp, s)

        def layers(t):
            return None if t is None else t[part]
        out.append(S.shard_cache(KVCache(
            layers(cache.k), layers(cache.v), cache.lengths,
            layers(cache.k_scale), layers(cache.v_scale),
            snapped=cache.snapped), stage))
    return out


def make_pp_forward(config, engine_config, mesh: PPMesh):
    """``forward_hidden`` over a (pipe, data, model) mesh: a function of
    (the stages' params from :func:`shard_params_pp`, the stages' caches
    from :func:`shard_cache_pp`, token_ids [B, T], q_start [B], kv_len
    [B], all on the home device) returning (logits [B, V] f32 on the home
    device, the caches), every stage's K/V and lengths written in place."""
    for stage in mesh.stages:
        validate_mesh(config, engine_config, stage)
    _stage_layers(config.num_layers, mesh.pp, 0)
    cfg = local_config(config, mesh.stages[0])
    eng = engine_config

    def fwd(params: list, caches: list, token_ids, q_start, kv_len):
        T = token_ids.shape[1]
        # before the forward: it overwrites the lengths, which q_start may
        # be
        last = torch.clamp(kv_len - q_start - 1, 0, T - 1).long()
        out = None
        for s, stage in enumerate(mesh.stages):
            out = S.mesh_decoder(cfg, eng, stage, params[s], caches[s],
                                 token_ids, q_start, kv_len, carry=out,
                                 final=s == mesh.pp - 1)
        for cache in caches:
            cache.lengths.copy_(kv_len)
        logits = S.mesh_logits(cfg, eng, mesh.stages[-1], params[-1], out,
                               last)
        return logits.to(mesh.home), caches

    return fwd

"""Sharded weights and caches, and the forward over a mesh (TP and DP).

Port of ``llm_inference_engine_tpu/parallel/sharding.py``: Megatron-style
tensor parallelism with whole KV groups on every model rank, and data
parallelism over batch slots. The JAX package runs the layer body on local
shards inside ``shard_map``; here one controller drives every rank
(``parallel/mesh.py``). Each (data, model) rank holds its shard tensors
on its device, and :func:`make_sharded_forward` runs every rank's layer
body (``models.llama.decoder``, a generator) on its local shapes with the
same kernels as a one-rank engine, in lockstep: after the row-sharded
``wo`` and after ``w_down`` each rank yields its partial product,
:func:`rank_sum` sums a data group's partials in rank order on model rank
0's device and copies the sum to each rank's device (the JAX ``psum``),
and the ranks go on. The vocab-sharded logits are concatenated over the
model ranks (the JAX ``all_gather``), then the data ranks' rows over
data. The ranks are never folded into one launch: each launches its own
kernels on its own shard.

Sharding map (weights [in, out]):
- wqkv  [L, H, K*(G+2)*D] -> columns; the layout is group-major, so model
  rank r takes whole KV groups [r*K/tp, (r+1)*K/tp) (bqkv likewise)
- wo    [L, H*D_q, H]     -> rows, summed after
- w_gate_up [L, H, 2, I]  -> the last axis (quantized: [L, 2, H, I])
- w_down    [L, I, H]     -> rows, summed after
- lm_head   [H, V]        -> columns (the vocab), gathered after
- embed, norms            -> whole on every rank
- quantized leaves: column shards slice q and scale alike; on row shards
  INT4's byte rows split at K/(2*tp) and its scales follow the
  contraction groups, INT8's per-channel scale stays whole
  (``QuantizedTensor.rows``/``columns``)
- slot cache k/v [L, B, S, K, D]: rows [d*B/dp, (d+1)*B/dp) of data rank
  d, heads [r*K/tp, (r+1)*K/tp) of model rank r; an int8 cache's scale
  planes [L, B, S, K] go with their heads, its numerics picked on the
  local head count, as the JAX package does per shard group
- paged pool [L, P, page, K, D]: heads over model, every data group a
  full pool replica; block-table rows and lengths over data. Each data
  group writes only the pages its own slots hold (the host allocator gives
  disjoint pages to disjoint slots), so the replicas differ only in pages
  no slot of the group references. The int8 pool is refused under a mesh
  as in the JAX package, whose scale rows ride the kv-head axis; the
  port's scale planes could shard (ROADMAP.md, queue 2 item 7).

What every rank shares (the batch's token ids, q_start, kv_len, the
global lengths and block table) lives on the mesh's home device
(``Mesh.home``); each rank reads its rows from there. The shards'
own ``lengths`` are written by each forward; the engine reads the global
ones.

What prefix snapshots, speculation and beam search need of a mesh: a
slot's rows lie in one data group, each model rank holding its heads
(:meth:`MeshCache.slot_shards`: a snapshot is one copy a rank, a restore
copies each rank's part onto the ranks of the slot's data group, across
cards where the mesh spans them); the verify of a speculative round takes
the lm_head at every position (:func:`make_sharded_forward` with
``all_logits``); a beam search runs one sequence on data group 0's model
ranks (:meth:`ShardedParams.data_group`) over a :class:`MeshCache` of its
own.

A mesh with a ``seq`` axis (context parallelism) runs
``parallel/cp_engine.py``'s forward: :func:`lockstep` then also answers
a third kind of yield, a seq-axis request (the ring's chunks, the
split-KV combine), over each (data, model) rank's seq ranks; the sums
run over the model ranks of each (data, seq) group. Its ranks share
weights where their model index and device agree
(:func:`shard_params`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from llm_inference_engine_tpu_torch.models import llama as llama_model
from llm_inference_engine_tpu_torch.ops.kv_cache import KVCache
from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
from llm_inference_engine_tpu_torch.parallel.mesh import (
    Mesh, local_config, validate_mesh)

__all__ = ["MeshCache", "ShardedParams", "param_pspecs", "shard_params",
           "shard_cache", "sharded_cache", "make_sharded_forward",
           "mesh_decoder", "mesh_logits", "rank_sum", "lockstep",
           "INT8_POOL_REFUSAL"]

COLUMNS, ROWS = "columns", "rows"
# how each layer leaf splits over the model axis (None: whole)
_LAYER_SPLIT = {"wqkv": COLUMNS, "bqkv": COLUMNS, "w_gate_up": COLUMNS,
                "wo": ROWS, "w_down": ROWS, "attn_norm": None,
                "ffn_norm": None}
INT8_POOL_REFUSAL = (
    "paged + mesh excludes the int8 (embedded-scale) pool: scale rows ride "
    "the kv-head axis and cannot shard (parallel/sharding.paged_cache_pspecs)")


def param_pspecs(params: dict) -> dict:
    """How each leaf splits over the model axis: a tree of the params'
    structure holding ``"columns"`` (the last axis), ``"rows"`` (the
    contraction axis, summed after) or None (whole on every rank)."""
    return {"embed": None,
            "layers": {name: _LAYER_SPLIT[name] for name in params["layers"]},
            "final_norm": None,
            "lm_head": COLUMNS}


def _split(w, how: Optional[str], r: int, tp: int):
    """Model rank r's part of leaf ``w`` (contiguous), or ``w`` whole."""
    if how is None or tp == 1:
        return w
    n = w.shape[-1] if how == COLUMNS else w.shape[-2]
    a, b = r * n // tp, (r + 1) * n // tp
    if isinstance(w, QuantizedTensor):
        return w.columns(a, b) if how == COLUMNS else w.rows(a, b)
    axis = w.dim() - (1 if how == COLUMNS else 2)
    return w.narrow(axis, a, b - a).contiguous()


@dataclasses.dataclass(eq=False)
class ShardedParams:
    """grid[d][s][r]: data rank d's, seq rank s's, model rank r's params,
    a dict of the one-device params' structure on that rank's device.
    Ranks with the same model index on the same device share one dict (no
    copy: seq ranks on one device share every weight tensor)."""
    mesh: Mesh
    grid: list

    @property
    def shards(self) -> list:
        """shards[d][r]: seq rank 0's params of (d, r)."""
        return [[row[0][r] for r in range(self.mesh.tp)] for row in self.grid]

    def shard(self, d: int, s: int, r: int) -> dict:
        return self.grid[d][s][r]

    def data_group(self) -> "ShardedParams":
        """Data rank 0's model ranks of seq rank 0 as params over a mesh of
        their own (dp = cp = 1), sharing this one's tensors: what one
        sequence runs on (a beam search), since every data rank holds the
        same weights."""
        grid = np.empty((1, 1, self.mesh.tp), dtype=object)
        grid[0, 0, :] = self.mesh.grid[0, 0, :]
        return ShardedParams(Mesh(grid), [[self.grid[0][0]]])


def shard_params(params: dict, mesh: Mesh) -> ShardedParams:
    """Each rank's shard of ``params`` (one device's params, dense or
    quantized) on its device, by :func:`param_pspecs`. INT4 row shards
    must hold whole scale groups (``QuantizedTensor.rows`` raises
    ValueError otherwise)."""
    tp = mesh.tp
    specs = param_pspecs(params)
    made: dict = {}
    grid = []
    for d in range(mesh.dp):
        seq = []
        for s in range(mesh.cp):
            row = []
            for r in range(tp):
                dev = mesh.device(d, s, r)
                key = (r, dev)
                if key not in made:
                    made[key] = {
                        "embed": params["embed"].to(dev),
                        "layers": {n: _split(w, specs["layers"][n], r,
                                             tp).to(dev)
                                   for n, w in params["layers"].items()},
                        "final_norm": params["final_norm"].to(dev),
                        "lm_head": _split(params["lm_head"], COLUMNS, r,
                                          tp).to(dev)}
                row.append(made[key])
            seq.append(row)
        grid.append(seq)
    return ShardedParams(mesh, grid)


@dataclasses.dataclass(eq=False)
class MeshCache:
    """A KV cache or page pool over a mesh: shards[d][r] is data rank d's,
    model rank r's ``KVCache`` or ``PagedKVCache`` on its device, holding
    the rows of d's slots and the heads of r's groups. ``lengths`` [B]
    (and a pool's ``block_table`` [B, max_pages]) are the global ones, on
    the mesh's home device: the engine reads and writes those, and
    :meth:`upload_table` copies the table's rows to every data group."""

    mesh: Mesh
    shards: list
    lengths: torch.Tensor
    block_table: Optional[torch.Tensor] = None

    def rows(self, d: int) -> slice:
        """The global batch rows of data rank d."""
        b = self.lengths.shape[0] // self.mesh.dp
        return slice(d * b, (d + 1) * b)

    def slot_shards(self, slot: int) -> tuple[int, list]:
        """Global row ``slot``'s local row, and the shards that hold it:
        data rank ``slot // (B / dp)``'s, one a model rank (its heads, and
        an int8 cache's scale planes of those heads)."""
        b = self.lengths.shape[0] // self.mesh.dp
        return slot % b, self.shards[slot // b]

    def upload_table(self) -> None:
        """Copy the global block table's rows into every shard's table, in
        place (a captured decode program reads the shards' tables)."""
        for d, row in enumerate(self.shards):
            for shard in row:
                shard.block_table.copy_(self.block_table[self.rows(d)],
                                        non_blocking=True)


def sharded_cache(mesh: Mesh, new_shard: Callable, batch_size: int,
                  num_kv_heads: int, max_pages: Optional[int] = None
                  ) -> MeshCache:
    """A zero-filled :class:`MeshCache`: ``new_shard(batch, kv_heads,
    device)`` makes each rank's cache at its local batch and head count;
    ``max_pages`` (a pool) adds the global block table."""
    home = mesh.home
    shards = [[new_shard(batch_size // mesh.dp, num_kv_heads // mesh.tp,
                         mesh.devices[d, r]) for r in range(mesh.tp)]
              for d in range(mesh.dp)]
    lengths = torch.zeros((batch_size,), dtype=torch.int32, device=home)
    table = (torch.zeros((batch_size, max_pages), dtype=torch.int32,
                         device=home) if max_pages is not None else None)
    return MeshCache(mesh, shards, lengths, table)


def shard_cache(cache: KVCache, mesh: Mesh) -> MeshCache:
    """Slice a one-device slot cache into its shards (rows over data,
    heads over model), each a copy on its rank's device. The engine
    builds its caches and pools with :func:`sharded_cache`."""
    B, K = cache.lengths.shape[0], cache.k.shape[3]
    kb, hb = B // mesh.dp, K // mesh.tp

    def part(t, d, r):
        if t is None:
            return None
        return t.narrow(1, d * kb, kb).narrow(3, r * hb, hb).contiguous().to(
            mesh.devices[d, r])

    shards = [[KVCache(part(cache.k, d, r), part(cache.v, d, r),
                       cache.lengths[d * kb:(d + 1) * kb].clone().to(
                           mesh.devices[d, r]),
                       part(cache.k_scale, d, r), part(cache.v_scale, d, r),
                       snapped=cache.snapped)
               for r in range(mesh.tp)] for d in range(mesh.dp)]
    return MeshCache(mesh, shards, cache.lengths.clone().to(mesh.home))


def rank_sum(parts: list, devices) -> list:
    """The JAX ``psum`` over one data group's model ranks: the partial
    products summed in rank order, in their dtype, on model rank 0's
    device, and the sum on each rank's device (the same tensor where the
    devices are the same; no op writes into it)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total.to(dev) for dev in devices]


def _on(device: torch.device):
    """The rank's device made current while its ops launch: the kernels
    launch on the current device, with its stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def lockstep(gens: list, mesh: Mesh) -> list:
    """Drive one layer generator per rank (rank-major: data, seq, model)
    to its end, each with its device current. Each time every rank has
    yielded, answer: a partial product (a tensor) with the sum over its
    model ranks (:func:`rank_sum`); a seq-axis request
    (``context_parallel.RingPass`` / ``SeqStats``) with the exchange over
    its seq ranks (``context_parallel.seq_exchange``). Returns the ranks'
    values."""
    tp, cp = mesh.tp, mesh.cp
    devices = list(mesh.grid.flat)
    sent = [None] * len(gens)
    while True:
        parts, outs = [], []
        for g, v, dev in zip(gens, sent, devices):
            try:
                with _on(dev):
                    parts.append(g.send(v))
            except StopIteration as stop:
                outs.append(stop.value)
        if outs:
            if len(outs) != len(gens):
                raise RuntimeError("mesh ranks left the layer loop apart")
            return outs
        if isinstance(parts[0], torch.Tensor):
            sent = []
            for g in range(len(gens) // tp):
                sent += rank_sum(parts[g * tp:(g + 1) * tp],
                                 devices[g * tp:(g + 1) * tp])
            continue
        from llm_inference_engine_tpu_torch.parallel.context_parallel import (
            seq_exchange)
        for d in range(mesh.dp):
            for r in range(tp):
                group = [(d * cp + s) * tp + r for s in range(cp)]
                replies = seq_exchange([parts[i] for i in group],
                                       [devices[i] for i in group])
                for i, reply in zip(group, replies):
                    sent[i] = reply


def mesh_decoder(cfg, eng, mesh: Mesh, params: ShardedParams,
                 cache: MeshCache, token_ids, q_start, kv_len, carry=None,
                 final: bool = True) -> list:
    """Every (data, model) rank's ``models.llama.decoder`` over its data
    rank's rows (token_ids, q_start, kv_len: the global ones, on the home
    device), driven in :func:`lockstep`; the ranks' values, rank-major.
    ``carry`` and ``final``: a pipeline stage's, as ``decoder`` takes
    them, with ``carry`` the stage before's values."""
    gens = []
    for d in range(mesh.dp):
        rows = cache.rows(d)
        for r in range(mesh.tp):
            dev = mesh.devices[d, r]
            pair = (None if carry is None else
                    tuple(t.to(dev) for t in carry[d * mesh.tp + r]))
            gens.append(llama_model.decoder(
                cfg, eng, params.shards[d][r], token_ids[rows].to(dev),
                cache.shards[d][r], q_start[rows].to(dev),
                kv_len[rows].to(dev), tapped=False, carry=pair, final=final))
    return lockstep(gens, mesh)


def mesh_logits(cfg, eng, mesh: Mesh, params: ShardedParams, hidden: list,
                last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The lm_head on each (data, model) rank's last valid hidden states:
    ``hidden`` rank-major on the ranks' devices, each [b, T, H] with
    ``last`` [B] the index of every row's last valid token, or each
    [b, H] already taken, or each [b, T, H] with ``last`` None for every
    position. Logits [B, V] (or [B, T, V]) f32 on the home device, the
    vocab shards concatenated over the model ranks, then the data
    ranks."""
    logits = []
    for d in range(mesh.dp):
        group = []
        for r in range(mesh.tp):
            h = hidden[d * mesh.tp + r]
            with _on(h.device):
                if last is not None:
                    b = h.shape[0]
                    h = h[torch.arange(b, device=h.device),
                          last[d * b:(d + 1) * b].to(h.device)]
                group.append(llama_model.lm_head_logits(
                    cfg, eng, params.shard(d, 0, r), h).to(mesh.home))
        logits.append(torch.cat(group, dim=-1) if mesh.tp > 1 else group[0])
    return torch.cat(logits, dim=0) if mesh.dp > 1 else logits[0]


def make_sharded_forward(config, engine_config, mesh: Mesh,
                         all_logits: bool = False):
    """``forward_hidden`` over the mesh: a function of (sharded params, a
    :class:`MeshCache`, token_ids [B, T], q_start [B], kv_len [B], all on
    the home device) returning (logits [B, V] f32 on the home device, the
    cache), with the shards' K/V and the global lengths updated in place.
    The shards carry their own layout (slot or paged, bf16 or int8).
    ``all_logits``: ``forward_all_logits`` over the mesh instead, logits
    [B, T, V] at every position (the verify of speculative decoding). The
    cache need not be an engine's: a beam search passes its own."""
    validate_mesh(config, engine_config, mesh)
    if mesh.cp > 1:
        raise ValueError("a mesh with a seq axis runs "
                         "parallel.cp_engine.make_cp_forward")
    cfg_local = local_config(config, mesh)

    def fwd(params: ShardedParams, cache: MeshCache, token_ids, q_start,
            kv_len):
        T = token_ids.shape[1]
        # before the forward: it overwrites the lengths, which q_start may
        # be
        last = (None if all_logits else
                torch.clamp(kv_len - q_start - 1, 0, T - 1).long())
        hidden = mesh_decoder(cfg_local, engine_config, mesh, params, cache,
                              token_ids, q_start, kv_len)
        cache.lengths.copy_(kv_len)
        return mesh_logits(cfg_local, engine_config, mesh, params, hidden,
                           last), cache

    return fwd

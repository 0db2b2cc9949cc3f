"""Context-parallel KV cache: per-rank append logs with explicit positions.

Port of ``llm_inference_engine_tpu/parallel/cp_cache.py``. Under context
parallelism (mesh axis ``seq``, size n) the KV cache's token capacity is
split over the seq ranks, and every write is rank-LOCAL by construction:

- each rank's local cache rows form an **append log**: a rank writes the
  k/v it computed at its own next free row, whatever the token's absolute
  position (kernel C, or kernel I for an int8 log, at the log's tail);
- the absolute position of every row is carried in ``kv_pos`` (-1 =
  empty), and attention masks come from those absolute positions
  (``parallel/context_parallel.py``), so row ORDER never matters;
- ``llen`` [B, n] tracks each rank's local row count. It lives once, on
  the mesh's home device, and one controller updates it.

Placement rules (as in the JAX package):
- prefill chunk of T tokens: rank i computes and appends the contiguous
  sub-chunk [i*T/n, (i+1)*T/n);
- decode token: every rank computes the same k/v (decode activations are
  replicated over ``seq``); the rank with the SMALLEST local log appends
  it (argmin over ``llen``, ties to the lowest rank).

Ragged prefill chunks skew ``llen`` toward low ranks; the engine mirrors
``llen`` on the host and raises before a local log can overflow
(``runtime/engine.py``). Every function here runs on the device with no
host read: a captured decode step runs them.

The int8 log is a ``KVCache`` with the port's f32 scale planes and the
numerics the slot cache picks (``ops/kv_cache.py``: snapped on a CUDA
device where ``embedded_supported`` holds for the local head count,
absmax elsewhere); the JAX package's embedded scale rows are a TPU DMA
layout, not ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.parallel.mesh import Mesh

__all__ = ["CPCache", "CPSpec", "new_cp_cache", "cp_write_plan",
           "cp_llen_after", "append_kv_pos", "reset_cp_cache"]


class CPSpec(NamedTuple):
    """One seq rank's view of a forward, handed to its layer body
    (``models/llama.py``): the rank ``me`` of ``n``; its write plan
    ``start``/``count`` [b] int32 (:func:`cp_write_plan`); ``q_pos``
    [b, t_local] the absolute positions of its query rows; ``kv_pos``
    [b, rows] and ``kv_valid`` [b, rows] of the first ``rows`` rows of its
    log, which attention reads (the rows valid after this forward's
    writes)."""
    n: int
    me: int
    start: torch.Tensor
    count: torch.Tensor
    q_pos: torch.Tensor
    kv_pos: torch.Tensor
    kv_valid: torch.Tensor


@dataclasses.dataclass(eq=False)
class CPCache:
    """shards[d][s][r]: rank (d, s, r)'s local log, a ``KVCache`` of
    [L, B/dp, S/cp, K/tp, D] on its device (its ``lengths``: the log's row
    count per slot); kv_pos[d][s][r]: [B/dp, S/cp] int32 absolute position
    of each row (-1 = empty), the same on every model rank of (d, s);
    llen [B, cp] int32 each rank's row count and lengths [B] int32 the
    global valid tokens, both on the mesh's home device."""

    mesh: Mesh
    shards: list
    kv_pos: list
    llen: torch.Tensor
    lengths: torch.Tensor

    def rows(self, d: int) -> slice:
        """The global batch rows of data rank d."""
        b = self.lengths.shape[0] // self.mesh.dp
        return slice(d * b, (d + 1) * b)

    def ranks(self):
        """(d, s, r, local log, its kv_pos) of every rank, rank-major."""
        for d, seq in enumerate(self.shards):
            for s, row in enumerate(seq):
                for r, shard in enumerate(row):
                    yield d, s, r, shard, self.kv_pos[d][s][r]

    @property
    def local_len(self) -> int:
        """S / cp: the rows of one rank's log."""
        return self.shards[0][0][0].k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.shards[0][0][0].quantized


def new_cp_cache(num_layers: int, batch_size: int, num_kv_heads: int,
                 max_seq_len: int, head_dim: int, mesh: Mesh,
                 dtype: torch.dtype = torch.bfloat16,
                 quantized: bool = False) -> CPCache:
    """Zero-filled append logs over ``mesh`` (every ``kv_pos`` -1);
    ``quantized`` gives int8 logs with scale planes, their numerics picked
    per rank as ``ops.kv_cache.new_kv_cache`` picks them."""
    cp = mesh.cp
    if max_seq_len % cp:
        raise ValueError(f"max_seq_len {max_seq_len} % cp {cp}")
    if num_kv_heads % mesh.tp:
        raise ValueError(f"num_kv_heads {num_kv_heads} % tp {mesh.tp}")
    b, k = batch_size // mesh.dp, num_kv_heads // mesh.tp
    sl = max_seq_len // cp
    shards, kv_pos = [], []
    for d in range(mesh.dp):
        shards.append([[kvc.new_kv_cache(num_layers, b, k, sl, head_dim,
                                         dtype=dtype,
                                         device=mesh.device(d, s, r),
                                         quantized=quantized)
                        for r in range(mesh.tp)] for s in range(cp)])
        kv_pos.append([[torch.full((b, sl), -1, dtype=torch.int32,
                                   device=mesh.device(d, s, r))
                        for r in range(mesh.tp)] for s in range(cp)])
    home = mesh.home
    return CPCache(mesh, shards, kv_pos,
                   torch.zeros((batch_size, cp), dtype=torch.int32,
                               device=home),
                   torch.zeros((batch_size,), dtype=torch.int32, device=home))


def _owner(llen: torch.Tensor) -> torch.Tensor:
    """The decode token's rank per slot: argmin over ``llen`` [B, n], ties
    to the lowest rank."""
    return torch.argmin(llen, dim=1)


def cp_write_plan(llen, q_start, kv_len, me: int, n: int, t_local: int):
    """Rank ``me``'s append window for the current forward.

    llen [B, n]; q_start/kv_len [B]; t_local: the per-rank query length
    (1: decode). Returns int32 (start [B], count [B], pos0 [B]): start,
    the local row to write at (this rank's log tail); count, how many of
    the t_local new rows are real for each slot; pos0, the absolute
    position of this rank's first new token. Decode: the least-full rank
    takes the token. Prefill: rank i takes the chunk's contiguous
    [i*Tl, (i+1)*Tl) span."""
    new = kv_len - q_start
    start = llen[:, me].contiguous()
    if t_local == 1:
        count = ((_owner(llen) == me) & (new > 0)).to(torch.int32)
        pos0 = q_start
    else:
        count = torch.clamp(new - me * t_local, 0, t_local).to(torch.int32)
        pos0 = q_start + me * t_local
    return start, count, pos0.to(torch.int32)


def cp_llen_after(llen, q_start, kv_len, n: int, t_local: int):
    """``llen`` after the forward whose plan :func:`cp_write_plan` gives."""
    new = kv_len - q_start
    ranks = torch.arange(n, dtype=torch.int32, device=llen.device)[None, :]
    if t_local == 1:
        add = (ranks == _owner(llen)[:, None]) & (new > 0)[:, None]
    else:
        add = torch.clamp(new[:, None] - ranks * t_local, 0, t_local)
    return llen + add.to(torch.int32)


def append_kv_pos(kv_pos_local, start, count, pos0, t_local: int) -> None:
    """Append this rank's new rows' absolute positions into its local
    kv_pos [B, S_local], in place: prefill rows get pos0 + 0..count-1,
    a decode row gets pos0 itself. Rows past S_local are dropped."""
    offs = torch.arange(t_local, dtype=torch.int32,
                        device=kv_pos_local.device)
    vals = pos0[:, None] + (offs[None, :] if t_local > 1 else 0)
    # the slot cache's plain row write, on a one-layer view
    kvc._write_rows_torch(kv_pos_local[None], vals.expand(-1, t_local), 0,
                          start, count)


def reset_cp_cache(cache: CPCache,
                   slots: Optional[Sequence[int]] = None) -> CPCache:
    """Clear the append logs of all slots or of ``slots``, in place:
    kv_pos -1, llen and the lengths 0."""
    B = cache.lengths.shape[0]
    rows = list(range(B)) if slots is None else list(slots)
    b = B // cache.mesh.dp
    for d, _, _, shard, kv_pos in cache.ranks():
        local = [i - d * b for i in rows if d * b <= i < (d + 1) * b]
        kv_pos[local] = -1
        shard.lengths[local] = 0
    cache.llen[rows] = 0
    cache.lengths[rows] = 0
    return cache

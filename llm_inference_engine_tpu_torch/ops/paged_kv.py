"""Paged KV cache: block-table indirection over a shared page pool.

Port of ``llm_inference_engine_tpu/ops/paged_kv.py``, bf16 (or f32) and
int8 pools. The pool is ``[L, P, page, K, D]``, token-major within a page;
a page is the unit of allocation across layers (physical page p is
``pool[:, p]`` on every layer), so the block table ``[B, max_pages]``
int32 is per sequence: key row j of sequence b lives at page
``table[b, j // page]``, row ``j % page``. Page 0 is reserved as the
scratch page every unused table entry points at; it never holds live
data. The allocator is host-side bookkeeping; the device only sees the
table. The pool is updated IN PLACE.

Kernel H (CUDA, the paged instance of kernel C in ``csrc/kv_write.cu``;
its launch is ``kv_cache.write_plan``) replaces the TPU kernel
``_paged_write_kernel``. One launch serves chunk rows (``new_len > 1``,
starting page-aligned in the engine) and decode rows (``new_len == 1``,
at any in-page offset); rows with ``new_len == 0`` write nothing. Every
token row is translated through the table on its own, so correctness does
not rest on the page-alignment invariant. H writes only real rows
(``t < new_len[b]``), as kernel C does; the TPU kernel DMAs the whole
padded T-window inside the page. The two differ only in rows at or past
``kv_len``, which attention never reads and a later write overwrites
before they become valid. The engine's pure-decode steps over a bf16,
float16 or float32 pool launch no H: kernel D's fused paged decode (Df
for a float pool) writes the token through the table with H's rules and
attends (``attention.attention_decode_paged_fused``).

The int8 pool (``quantized=True``) holds int8 values [L, P, page, K, D]
and f32 scale planes [L, P, page, K], indexed by page as the values are,
so a page shared through the table shares its scales. The JAX package
embeds log2-snapped scale codes in 8 pad rows per token of its int8 pool
(a TPU DMA workaround); the port keeps those snapped numerics
(``kv_cache.quantize_kv_snapped``) in the plane layout. Kernel H's int8
mode (``paged_kv_write_quant``, the paged instance of kernel I in
``csrc/kv_write_quant.cu``) quantizes the bf16 rows and writes values and
scales through the table in one launch; float16 and float32 rows take
its float instance If (:func:`paged_kv_write_quant_float`). The engine's
pure-decode steps over an int8 pool launch neither: kernel D's fused
paged decode (Df for float rows) quantizes the token's row, writes it
through the table with H's rules and attends.

Under tensor parallelism each model rank holds the pool's K/tp heads of
every page, and each data group a whole pool, with its own rows of the
block table and lengths (``parallel/sharding.py``). The int8 pool is
refused under a mesh, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from llm_inference_engine_tpu_torch.ops._native import (
    FLOAT_HEAD_DIMS, HEAD_DIMS)
from llm_inference_engine_tpu_torch.ops.kv_cache import (
    FLOAT_ROW_DTYPES, launch_write_quant, quantize_kv_snapped)
from llm_inference_engine_tpu_torch.utils import use_kernel
from llm_inference_engine_tpu_torch.utils.checks import kernel_output

__all__ = ["PagedKVCache", "PageAllocator", "new_paged_kv_cache",
           "paged_update_at_layer", "paged_update_at_layer_torch",
           "paged_kv_write_quant", "paged_kv_write_quant_float",
           "gather_pages", "gather_layer_pages"]


@dataclasses.dataclass
class PagedKVCache:
    """k/v: [L, P, page, K, D] page pool; block_table: [B, max_pages]
    int32 physical page per (slot, logical block); lengths: [B] int32
    valid tokens per slot. The int8 pool adds f32 scale planes
    k_scale/v_scale [L, P, page, K]. All on the pool's device."""

    k: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def snapped(self) -> bool:
        """The int8 pool always quantizes with snapped scales, as the JAX
        package's embedded-scale pool does."""
        return self.quantized

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def batch_size(self) -> int:
        return self.block_table.shape[0]

    @property
    def max_pages_per_seq(self) -> int:
        return self.block_table.shape[1]

    @property
    def max_seq_len(self) -> int:
        return self.max_pages_per_seq * self.page_size

    @property
    def num_kv_heads(self) -> int:
        return self.k.shape[3]


def new_paged_kv_cache(num_layers: int, batch_size: int, num_kv_heads: int,
                       num_pages: int, page_size: int, head_dim: int,
                       max_pages_per_seq: int,
                       dtype: torch.dtype = torch.bfloat16,
                       device: Optional[torch.device] = None,
                       quantized: bool = False) -> PagedKVCache:
    """Zero-filled pool and an all-scratch table on ``device``;
    ``quantized`` gives int8 values and scale planes of ones (``dtype`` is
    then unused)."""
    shape = (num_layers, num_pages, page_size, num_kv_heads, head_dim)
    vdt = torch.int8 if quantized else dtype
    planes = [torch.ones(shape[:-1], dtype=torch.float32, device=device)
              for _ in range(2)] if quantized else [None, None]
    return PagedKVCache(
        torch.zeros(shape, dtype=vdt, device=device),
        torch.zeros(shape, dtype=vdt, device=device),
        torch.zeros((batch_size, max_pages_per_seq), dtype=torch.int32,
                    device=device),
        torch.zeros((batch_size,), dtype=torch.int32, device=device),
        *planes)


class PageAllocator:
    """Host-side free list over the pool's physical pages, with reference
    counting so pages can be SHARED read-only across slots (zero-copy
    prefix caching: one prefix's pages appear in many block tables).
    Page 0 is RESERVED as the scratch target every unused table entry
    points at; it never holds live data."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))   # stack, 0 reserved
        self._rc: dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"paged KV pool exhausted: want {n} pages, "
                              f"{len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add a reference to already-allocated pages (a slot adopting a
        shared prefix's pages)."""
        for p in pages:
            if p not in self._rc:
                raise ValueError(f"page {p} is not allocated")
            self._rc[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page returns to the pool when
        its last reference goes."""
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"bad page id {p}")
            rc = self._rc.get(p, 0)
            if rc <= 0:
                raise ValueError(f"double free of page {p}")
            if rc == 1:
                del self._rc[p]
                self._free.append(p)
            else:
                self._rc[p] = rc - 1


# ---------------------------------------------------------------------------
# Writes
# ---------------------------------------------------------------------------

def _write_rows_torch(pool: torch.Tensor, new: torch.Tensor, layer: int,
                      starts: torch.Tensor, new_len: torch.Tensor,
                      table: torch.Tensor) -> None:
    """pool[layer, table[b, p // page], p % page] = new[b, t] for
    p = starts[b] + t, t < new_len[b] and p inside the table (in place;
    a scale plane [L, P, page, K] takes rows [B, T, K]). Reads nothing on
    the host (a captured decode step runs it with kernels="torch"): every
    (b, t) is stored, an entry past the real rows where its row stores
    t = 0, with that value, or, in a row that stores nothing, onto row 0
    of the reserved page 0 with the value there (a real row never lands
    there: its page is allocated before the write)."""
    page = pool.shape[2]
    B, T = new.shape[:2]
    t = torch.arange(T, device=new.device)
    pos = starts.long()[:, None] + t[None, :]                      # [B, T]
    valid = ((t[None, :] < new_len.long()[:, None]) & (pos >= 0)
             & (pos < table.shape[1] * page))
    blk = torch.where(valid, pos // page, 0)
    rows = torch.gather(table.long(), 1, blk) * page + pos % page
    stores = valid[:, :1]                  # the row stores t = 0 (or none)
    dest = torch.where(valid, rows, torch.where(stores, rows[:, :1], 0))
    flat = pool[layer].view(-1, *pool.shape[3:])
    lead = (B, T) + (1,) * (new.dim() - 2)
    new = new.to(pool.dtype)
    flat[dest] = torch.where(
        valid.view(lead), new,
        torch.where(stores.view(B, 1, *lead[2:]), new[:, :1], flat[dest]))


def paged_update_at_layer_torch(cache: PagedKVCache, layer: int,
                                new_k: torch.Tensor, new_v: torch.Tensor,
                                starts: torch.Tensor,
                                new_len: Optional[torch.Tensor] = None
                                ) -> PagedKVCache:
    """Plain version of kernel H: a per-row scatter through the table (the
    JAX package's ``_paged_write_xla`` on real rows); an int8 pool gets the
    rows quantized with snapped scales, values and scales."""
    if new_len is None:
        new_len = torch.full_like(starts, new_k.shape[1])
    if cache.quantized:
        for new, vals, scales in ((new_k, cache.k, cache.k_scale),
                                  (new_v, cache.v, cache.v_scale)):
            q, sc = quantize_kv_snapped(new)
            _write_rows_torch(vals, q, layer, starts, new_len,
                              cache.block_table)
            _write_rows_torch(scales, sc, layer, starts, new_len,
                              cache.block_table)
        return cache
    _write_rows_torch(cache.k, new_k, layer, starts, new_len,
                      cache.block_table)
    _write_rows_torch(cache.v, new_v, layer, starts, new_len,
                      cache.block_table)
    return cache


def _check_write(cache, layer, new_k, new_v, starts, new_len,
                 name="paged_kv_write"):
    L, P, page, K, D = cache.k.shape
    B = cache.block_table.shape[0]
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside [0, {L})")
    if new_k.dim() != 4 or new_k.shape[0] != B or new_k.shape[2:] != (K, D):
        raise ValueError(f"{name}: new rows {tuple(new_k.shape)} do "
                         f"not fit pool {tuple(cache.k.shape)} with {B} "
                         "table rows")
    # an int8 pool takes bf16 rows (kernel H's int8 mode quantizes them)
    # or float16 / float32 rows (kernel If)
    new_dtype = cache.k.dtype
    if cache.quantized:
        new_dtype = (new_k.dtype if new_k.dtype in FLOAT_ROW_DTYPES
                     else torch.bfloat16)
    for t, want in ((new_k, new_dtype), (new_v, new_dtype),
                    (cache.k, cache.k.dtype), (cache.v, cache.k.dtype)):
        if t.dtype != want or t.device != cache.k.device:
            raise TypeError(f"{name}: new rows must be {new_dtype}, on the "
                            "pool's device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if cache.quantized:
        for t in (cache.k_scale, cache.v_scale):
            if (t.dtype != torch.float32 or t.shape != (L, P, page, K)
                    or t.device != cache.k.device or not t.is_contiguous()):
                raise ValueError(f"{name}: scale planes must be contiguous "
                                 f"float32 [{L}, {P}, {page}, {K}]")
        dims = (FLOAT_HEAD_DIMS if new_dtype in FLOAT_ROW_DTYPES
                else HEAD_DIMS)
        if D not in dims:
            raise NotImplementedError(f"{name}: head_dim {D} (built for "
                                      f"{dims})")
    if new_v.shape != new_k.shape or cache.v.shape != cache.k.shape:
        raise ValueError(f"{name}: k and v shapes differ")
    for t in (starts, new_len, cache.block_table):
        if (t.dtype != torch.int32 or t.device != cache.k.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: starts/new_len/table must be "
                             "contiguous int32 on the pool's device")
    if starts.shape != (B,) or new_len.shape != (B,):
        raise ValueError(f"{name}: starts/new_len must be [{B}]")
    row_bytes = K * D * cache.k.element_size()
    if row_bytes % 16:
        raise ValueError(f"{name}: a token row of {row_bytes} bytes "
                         "is not a multiple of the kernel's 16-byte copies")
    return row_bytes


def paged_update_at_layer(cache: PagedKVCache, layer: int,
                          new_k: torch.Tensor, new_v: torch.Tensor,
                          starts: torch.Tensor,
                          new_len: Optional[torch.Tensor] = None,
                          kernels: str = "auto") -> PagedKVCache:
    """Write new tokens for one layer into the page pool, in place.

    new_k/new_v: [B, T, K, D]; starts: [B] int32 absolute token offsets;
    new_len: [B] int32 real tokens (0 skips the row; 1 = a decode write at
    any offset; > 1 = a chunk, page-aligned in the engine; defaults to T).
    Rows whose position falls past the table's reach are never written.
    """
    if new_len is None:
        new_len = torch.full_like(starts, new_k.shape[1])
    if cache.quantized:
        return paged_kv_write_quant(cache, layer, new_k, new_v, starts,
                                    new_len, kernels=kernels)
    if not use_kernel(kernels, new_k):
        return paged_update_at_layer_torch(cache, layer, new_k, new_v,
                                           starts, new_len)
    from llm_inference_engine_tpu_torch.ops import _native
    row_bytes = _check_write(cache, layer, new_k, new_v, starts, new_len)
    L, P, page, K, D = cache.k.shape
    B, max_pages = cache.block_table.shape
    status = _native.library().paged_kv_write(
        new_k.data_ptr(), new_v.data_ptr(), cache.k.data_ptr(),
        cache.v.data_ptr(), starts.data_ptr(), new_len.data_ptr(),
        cache.block_table.data_ptr(), int(layer), B, new_k.shape[1], P,
        page, max_pages, row_bytes, _native.stream_of(new_k))
    _native.check(status, "paged_kv_write")
    paged_update_at_layer.launches += 1
    kernel_output("paged_kv_write", cache.k, cache.v, layer=layer)
    return cache


paged_update_at_layer.launches = 0


def paged_kv_write_quant(cache: PagedKVCache, layer: int,
                         new_k: torch.Tensor, new_v: torch.Tensor,
                         starts: torch.Tensor, new_len: torch.Tensor,
                         kernels: str = "auto") -> PagedKVCache:
    """Kernel H's int8 mode: quantize bf16 rows [B, T, K, D] with snapped
    scales and write values and scales through the table (the rules of
    :func:`paged_update_at_layer`), in place. Float16 or float32 rows take
    :func:`paged_kv_write_quant_float`."""
    if not use_kernel(kernels, new_k):
        return paged_update_at_layer_torch(cache, layer, new_k, new_v,
                                           starts, new_len)
    if new_k.dtype in FLOAT_ROW_DTYPES:
        return paged_kv_write_quant_float(cache, layer, new_k, new_v,
                                          starts, new_len)
    _check_write(cache, layer, new_k, new_v, starts, new_len,
                 "paged_kv_write_quant")
    launch_write_quant("paged_kv_write_int8", cache, layer, new_k, new_v,
                       starts, new_len, cache.block_table)
    paged_kv_write_quant.launches += 1
    return cache


paged_kv_write_quant.launches = 0


def paged_kv_write_quant_float(cache: PagedKVCache, layer: int,
                               new_k: torch.Tensor, new_v: torch.Tensor,
                               starts: torch.Tensor, new_len: torch.Tensor
                               ) -> PagedKVCache:
    """Kernel If through the block table (kernel I's paged instance over
    float16 or float32 rows): what :func:`paged_kv_write_quant` runs for
    such rows on the card (snapped scales)."""
    if new_k.dtype not in FLOAT_ROW_DTYPES:
        raise TypeError(f"paged_kv_write_quant_float: kernel If takes "
                        f"float16 or float32 rows, got {new_k.dtype}")
    _check_write(cache, layer, new_k, new_v, starts, new_len,
                 "paged_kv_write_quant_float")
    launch_write_quant("paged_kv_write_quant_float", cache, layer, new_k,
                       new_v, starts, new_len, cache.block_table)
    paged_kv_write_quant_float.launches += 1
    return cache


paged_kv_write_quant_float.launches = 0


def gather_pages(pool: torch.Tensor, layer: int, table: torch.Tensor):
    """Dense [B, max_pages * page, ...] copy of one layer of a pool or a
    scale plane (the plain path: gathers the whole table; rows past a
    sequence's length hold whatever their page holds and must be masked by
    kv_len)."""
    B, MP = table.shape
    page = pool.shape[2]
    idx = table.reshape(-1).long()
    return pool[layer][idx].reshape(B, MP * page, *pool.shape[3:])


def gather_layer_pages(cache: PagedKVCache, layer: int):
    """Dense [B, max_pages * page, K, D] copies of one layer of the pool's
    values (see :func:`gather_pages`)."""
    return (gather_pages(cache.k, layer, cache.block_table),
            gather_pages(cache.v, layer, cache.block_table))

"""KV cache: preallocated token-major [L, B, S, K, D] tensors, updated in place.

Port of the bf16 slot variant of ``llm_inference_engine_tpu/ops/kv_cache.py``.
The token-major layout is kept: one sequence's [T, K, D] span is
contiguous, and the attention kernel reads the stacked cache at a layer
index without slicing it. JAX's cache is an immutable pytree donated to
each step; here the tensors are mutated IN PLACE by
:func:`update_cache_at_layer` and by the fused decode attention, and the
functions return the same :class:`KVCache` object.

Kernel C (CUDA, ``csrc/kv_write.cu``) replaces the TPU kernel
``_write_kernel``. It writes only each sequence's real rows
(``t < new_len[b]``); the JAX kernel DMAs the whole padded T-window, which
differs only in rows >= kv_len that attention never reads.

Not ported yet: the int8 cache variants (ROADMAP.md, queue 1, "INT8 KV
cache") and head-group sharding (with "Parallelism"). The TPU tile
padding of K and D is dropped: it was a DMA-layout workaround.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from llm_inference_engine_tpu_torch.utils import use_kernel

__all__ = ["KVCache", "new_kv_cache", "update_cache_at_layer",
           "update_cache_at_layer_torch"]


@dataclasses.dataclass
class KVCache:
    """k/v: [L, B, S, K, D] token-major; lengths: [B] int32 valid tokens
    per slot (on the cache's device)."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]


def new_kv_cache(num_layers: int, batch_size: int, num_kv_heads: int,
                 max_seq_len: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None) -> KVCache:
    """Zero-filled cache on ``device``."""
    shape = (num_layers, batch_size, max_seq_len, num_kv_heads, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch_size,), dtype=torch.int32,
                               device=device))


def _write_rows_torch(cache_t, new, layer: int, starts, new_len):
    """cache_t[layer, b, starts[b] + t] = new[b, t] for t < new_len[b] and
    starts[b] + t < S (in place)."""
    B, T = new.shape[:2]
    S = cache_t.shape[2]
    t = torch.arange(T, device=new.device)
    pos = starts.long()[:, None] + t[None, :]                     # [B, T]
    valid = (t[None, :] < new_len.long()[:, None]) & (pos < S)
    rows = torch.arange(B, device=new.device)[:, None].expand(B, T)
    cache_t[layer][rows[valid], pos[valid]] = new[valid].to(cache_t.dtype)


def update_cache_at_layer_torch(cache: KVCache, layer: int,
                                new_k: torch.Tensor, new_v: torch.Tensor,
                                starts: torch.Tensor,
                                new_len: Optional[torch.Tensor] = None
                                ) -> KVCache:
    """Plain version of kernel C (the semantics of the JAX package's
    ``_update_one_at_layer`` on real rows): rows with ``new_len == 0``
    are left untouched."""
    if new_len is None:
        new_len = torch.full_like(starts, new_k.shape[1])
    _write_rows_torch(cache.k, new_k, layer, starts, new_len)
    _write_rows_torch(cache.v, new_v, layer, starts, new_len)
    return cache


def _check_write(cache, layer, new_k, new_v, starts, new_len):
    L, B, S, K, D = cache.k.shape
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside [0, {L})")
    if new_k.dim() != 4 or new_k.shape[0] != B or new_k.shape[2:] != (K, D):
        raise ValueError(f"kv_write: new rows {tuple(new_k.shape)} do not "
                         f"fit cache {tuple(cache.k.shape)}")
    for t in (new_k, new_v, cache.k, cache.v):
        if t.dtype != cache.k.dtype or t.device != cache.k.device:
            raise TypeError("kv_write: new rows and caches must share dtype "
                            "and device")
        if not t.is_contiguous():
            raise ValueError("kv_write: tensors must be contiguous")
    if new_v.shape != new_k.shape or cache.v.shape != cache.k.shape:
        raise ValueError("kv_write: k and v shapes differ")
    for t in (starts, new_len):
        if (t.dtype != torch.int32 or t.shape != (B,)
                or t.device != cache.k.device or not t.is_contiguous()):
            raise ValueError("kv_write: starts/new_len must be contiguous "
                             f"int32 [{B}] on the cache's device")
    row_bytes = K * D * cache.k.element_size()
    if row_bytes % 16:
        raise ValueError(f"kv_write: a token row of {row_bytes} bytes is not "
                         "a multiple of the kernel's 16-byte copies")
    return row_bytes


def update_cache_at_layer(cache: KVCache, layer: int, new_k: torch.Tensor,
                          new_v: torch.Tensor, starts: torch.Tensor,
                          new_len: Optional[torch.Tensor] = None,
                          kernels: str = "auto") -> KVCache:
    """Write new tokens for one layer straight into the stacked cache, in
    place.

    cache.k/v: [L, B, S, K, D]; new_k/new_v: [B, T, K, D]; layer: int;
    starts: [B] int32 per-sequence write offsets; new_len: [B] int32 real
    new tokens per sequence (rows with 0 are untouched; defaults to T).
    Rows that would land at or past S are never written: the engine
    refuses such prefill chunks on the host before calling this.
    """
    if new_len is None:
        new_len = torch.full_like(starts, new_k.shape[1])
    if not use_kernel(kernels, new_k):
        return update_cache_at_layer_torch(cache, layer, new_k, new_v,
                                           starts, new_len)
    from llm_inference_engine_tpu_torch.ops import _native
    row_bytes = _check_write(cache, layer, new_k, new_v, starts, new_len)
    L, B, S, K, D = cache.k.shape
    lib = _native.library()
    status = lib.kv_write(
        new_k.data_ptr(), new_v.data_ptr(), cache.k.data_ptr(),
        cache.v.data_ptr(), starts.data_ptr(), new_len.data_ptr(),
        int(layer), B, new_k.shape[1], S, row_bytes,
        _native.stream_of(new_k))
    _native.check(status, "kv_write")
    update_cache_at_layer.launches += 1
    return cache


update_cache_at_layer.launches = 0

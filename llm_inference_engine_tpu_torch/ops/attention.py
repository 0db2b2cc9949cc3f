"""Causal attention over the stacked token-major KV cache, GQA-native.

Port of ``llm_inference_engine_tpu/ops/attention.py`` over the slot cache
[L, B, S, K, D] and the paged pool [L, P, page, K, D] with its block table
(``ops/paged_kv.py``), bf16 or int8 with f32 scale planes [.., K]
(``k_scale``/``v_scale``; ``ops/kv_cache.py``):

- :func:`attention_torch` is the plain version, a port of
  ``attention_xla`` (dense mask, f32 math, int8 values times their
  scales); over a pool, :func:`attention_paged_torch` gathers the table
  (values and planes) into a dense view first, as the JAX package's golden
  does;
- :func:`attention` (prefill, chunked prefill, mixed steps) runs kernel
  D2 (``csrc/attention_prefill.cu``, a flash-attention kernel on the
  tensor cores) in place of the TPU kernel ``_attn_kernel``:
  ``attention_prefill`` on the slot cache, ``attention_prefill_paged``
  (through :func:`attention_prefill_paged`) with ``table=`` given, and
  their int8 modes (:func:`attention_int8`,
  :func:`attention_prefill_paged_int8`) when scale planes are given;
- :func:`attention_decode_fused` (one new token per sequence, slot cache)
  runs kernel D (``csrc/attention_decode.cu``, split-KV over a thread-block
  cluster) in its fused mode (``attention_decode``, int8:
  :func:`attention_decode_fused_int8`) in place of the TPU kernel
  ``_decode_fused_mxu_kernel`` (the JAX package's
  ``attention_decode_fused_mxu``): it writes the new K/V row into the
  cache IN PLACE (an int8 cache: quantized in the cache's numerics, with
  its scale) and attends history plus the new token;
- :func:`attention_decode` (one token per sequence, paged pool, written
  by kernel H first) runs kernel D's attend-only mode
  (``attention_decode_paged``, int8: :func:`attention_decode_int8`) in
  place of the TPU kernel ``_decode_mxu_kernel`` (``_attention_decode_mxu``
  with a table). Its split plan and summation order are the fused mode's
  (:func:`decode_plan`), so a paged engine reproduces a slot engine bit
  for bit.

Every kernel is built for the head dims ``_native.HEAD_DIMS`` (64, 80,
96, 128, 256); another head_dim raises ``NotImplementedError`` on a CUDA
tensor.

Each int8 mode is a wrapper of its own with its own launch counter.

Row semantics (all versions): query row (t, h) at position
p = q_start[b] + t attends key j iff j < kv_len[b], j <= p and, with a
sliding window W, j > p - W, using kv head h // G. A row with no visible
key gives 0, not NaN. The decode kernel reads ``kv_len`` per sequence, so
the JAX package's static ``kv_hi`` watermark has no counterpart.

Not ported yet: the attend-only decode over a slot cache (the engine
always fuses the slot decode) and tensor-parallel decode (ROADMAP.md,
queue 1, "Parallelism").
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from llm_inference_engine_tpu_torch.ops import _native
from llm_inference_engine_tpu_torch.ops.kv_cache import (
    _write_rows_torch, quantize_rows)
from llm_inference_engine_tpu_torch.ops.paged_kv import (
    PagedKVCache, gather_pages)
from llm_inference_engine_tpu_torch.utils import use_kernel
from llm_inference_engine_tpu_torch.utils.checks import kernel_output

__all__ = ["attention", "attention_torch", "attention_paged_torch",
           "attention_int8", "attention_prefill_paged",
           "attention_prefill_paged_int8", "attention_decode",
           "attention_decode_int8", "attention_decode_fused",
           "attention_decode_fused_int8", "attention_decode_fused_torch",
           "can_fuse_decode", "decode_plan", "prefill_plan"]


def attention_torch(q, k_cache, v_cache, q_start, kv_len, *,
                    sm_scale: Optional[float] = None,
                    layer: Optional[int] = None,
                    window: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense-masked causal attention (plain reference; O(Sq*Skv) memory).

    q:       [B, Sq, H, D]
    k_cache: [B, Skv, K, D], v_cache: same; with ``layer`` given, a
             stacked [L, B, Skv, K, D] cache read at that layer
    k_scale/v_scale: an int8 cache's scales [(L,) B, Skv, K]
    q_start: [B] int absolute position of q[:, 0]
    kv_len:  [B] int valid kv length (history + new tokens)
    returns  [B, Sq, H, D] in q's dtype
    """
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    B, Sq, H, D = q.shape
    Skv, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)

    qf = q.float().reshape(B, Sq, K, G, D)
    kf = k_cache.float()
    vf = v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    s = torch.einsum("bikgd,btkd->bkgit", qf, kf) * scale     # [B,K,G,Sq,Skv]
    q_pos = q_start.long()[:, None] + torch.arange(Sq, device=q.device)[None]
    j = torch.arange(Skv, device=q.device)[None, None, :]
    valid = (j < kv_len.long()[:, None, None]) & (j <= q_pos[:, :, None])
    if window is not None:
        valid = valid & (j > q_pos[:, :, None] - window)
    valid = valid[:, None, None]                               # [B,1,1,Sq,Skv]
    s = torch.where(valid, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    out = torch.einsum("bkgit,btkd->bikgd", p, vf)             # [B,Sq,K,G,D]
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention_paged_torch(q, k_pool, v_pool, q_start, kv_len, layer: int,
                          table, *, sm_scale: Optional[float] = None,
                          window: Optional[int] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version over the paged pool [L, P, page, K, D] (and an int8
    pool's scale planes [L, P, page, K]): gather the table into a dense
    [B, max_pages * page, ...] view, then :func:`attention_torch` (prefill
    and decode alike)."""
    dense = [None if t is None else gather_pages(t, layer, table)
             for t in (k_pool, v_pool, k_scale, v_scale)]
    return attention_torch(q, dense[0], dense[1], q_start, kv_len,
                           sm_scale=sm_scale, window=window,
                           k_scale=dense[2], v_scale=dense[3])


def _check(q, k_cache, v_cache, q_start, kv_len, layer, table=None,
           k_scale=None, v_scale=None):
    if q.dim() != 4 or k_cache.dim() != 5:
        raise ValueError(f"attention kernel: need q [B,T,H,D] and a stacked "
                         f"cache [L,B,S,K,D] or pool [L,P,page,K,D], got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, T, H, D = q.shape
    L, Bc, S, K, Dc = k_cache.shape
    if table is not None:
        if (table.dtype != torch.int32 or table.dim() != 2
                or table.shape[0] != B or table.device != q.device
                or not table.is_contiguous()):
            raise ValueError(f"attention kernel: the block table must be "
                             f"contiguous int32 [{B}, max_pages] on "
                             f"{q.device}")
        Bc = B                        # pool pages are not sequences
    if Bc != B or Dc != D or H % K:
        raise ValueError(f"attention kernel: q {tuple(q.shape)} does not fit "
                         f"cache {tuple(k_cache.shape)}")
    if D not in _native.HEAD_DIMS:
        raise NotImplementedError(f"attention kernel: head_dim {D} (built "
                                  f"for {_native.HEAD_DIMS})")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside [0, {L})")
    int8 = k_scale is not None
    kv_dtype = torch.int8 if int8 else torch.bfloat16
    for t, want in ((q, torch.bfloat16), (k_cache, kv_dtype),
                    (v_cache, kv_dtype)):
        if t.dtype != want:
            raise TypeError(f"attention kernel: need bf16 q and a "
                            f"{kv_dtype} cache, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention kernel: tensors must be contiguous "
                             "and 16-byte aligned")
        if t.device != q.device:
            raise ValueError("attention kernel: tensors on different devices")
    if v_cache.shape != k_cache.shape:
        raise ValueError("attention kernel: k and v caches differ in shape")
    if int8:
        for t in (k_scale, v_scale):
            if (t is None or t.dtype != torch.float32
                    or t.shape != k_cache.shape[:-1] or t.device != q.device
                    or not t.is_contiguous()):
                raise ValueError(f"attention kernel: the int8 cache's scale "
                                 f"planes must be contiguous float32 "
                                 f"{tuple(k_cache.shape[:-1])} on {q.device}")
    for t in (q_start, kv_len):
        if (t.dtype != torch.int32 or t.shape != (B,) or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"attention kernel: q_start/kv_len must be "
                             f"contiguous int32 [{B}] on {q.device}")


def _scale_of(sm_scale, D):
    return float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(D))


def attention(q, k_cache, v_cache, q_start, kv_len, *,
              sm_scale: Optional[float] = None, kernels: str = "auto",
              layer: Optional[int] = None,
              window: Optional[int] = None,
              table: Optional[torch.Tensor] = None,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q against the (already updated) KV cache: the cache
    must hold the current tokens' K/V at [q_start, kv_len) (kernel C, I or
    H runs first). See :func:`attention_torch` for shapes; with ``table``
    [B, max_pages] given, k_cache/v_cache are the paged pool and
    ``layer`` is required (:func:`attention_prefill_paged`); with
    ``k_scale``/``v_scale`` given, the cache is int8
    (:func:`attention_int8`)."""
    if table is not None:
        return attention_prefill_paged(q, k_cache, v_cache, q_start, kv_len,
                                       layer, table, sm_scale=sm_scale,
                                       window=window, kernels=kernels,
                                       k_scale=k_scale, v_scale=v_scale)
    if k_scale is not None:
        return attention_int8(q, k_cache, v_cache, q_start, kv_len,
                              k_scale=k_scale, v_scale=v_scale,
                              sm_scale=sm_scale, kernels=kernels,
                              layer=layer, window=window)
    if not use_kernel(kernels, q):
        return attention_torch(q, k_cache, v_cache, q_start, kv_len,
                               sm_scale=sm_scale, layer=layer, window=window)
    if layer is None:                 # a plain [B, S, K, D] cache
        k_cache, v_cache, layer = k_cache[None], v_cache[None], 0
    _check(q, k_cache, v_cache, q_start, kv_len, layer)
    B, T, H, D = q.shape
    _, _, S, K, _ = k_cache.shape
    out = torch.empty_like(q)
    status = _native.library().attention_prefill(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        q_start.data_ptr(), kv_len.data_ptr(), int(layer), B, T, H, K, S, D,
        _scale_of(sm_scale, D), int(window or 0), _native.stream_of(q))
    _native.check(status, "attention_prefill")
    attention.launches += 1
    kernel_output("attention_prefill", out)
    return out


attention.launches = 0


def attention_int8(q, k_cache, v_cache, q_start, kv_len, *, k_scale,
                   v_scale, sm_scale: Optional[float] = None,
                   kernels: str = "auto", layer: Optional[int] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """Kernel D's int8 prefill mode over the slot cache: int8 values
    [(L,) B, S, K, D] with scale planes [(L,) B, S, K] (the int8 mode of
    ``_attn_kernel``)."""
    if not use_kernel(kernels, q):
        return attention_torch(q, k_cache, v_cache, q_start, kv_len,
                               sm_scale=sm_scale, layer=layer, window=window,
                               k_scale=k_scale, v_scale=v_scale)
    if layer is None:
        k_cache, v_cache, layer = k_cache[None], v_cache[None], 0
        k_scale, v_scale = k_scale[None], v_scale[None]
    _check(q, k_cache, v_cache, q_start, kv_len, layer, k_scale=k_scale,
           v_scale=v_scale)
    B, T, H, D = q.shape
    _, _, S, K, _ = k_cache.shape
    out = torch.empty_like(q)
    status = _native.library().attention_prefill_int8(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
        q_start.data_ptr(), kv_len.data_ptr(), int(layer), B, T, H, K, S, D,
        _scale_of(sm_scale, D), int(window or 0), _native.stream_of(q))
    _native.check(status, "attention_prefill_int8")
    attention_int8.launches += 1
    kernel_output("attention_prefill_int8", out)
    return out


attention_int8.launches = 0


def _launch_paged(entry: str, q, k_pool, v_pool, q_start, kv_len, layer,
                  table, sm_scale, window, k_scale=None, v_scale=None):
    _check(q, k_pool, v_pool, q_start, kv_len, layer, table, k_scale,
           v_scale)
    B, T, H, D = q.shape
    _, P, page, K, _ = k_pool.shape
    out = torch.empty_like(q)
    shape = (B, T, H, K) if entry.startswith("attention_prefill") \
        else (B, H, K)
    scales = () if k_scale is None else (k_scale.data_ptr(),
                                         v_scale.data_ptr())
    status = getattr(_native.library(), entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
        out.data_ptr(), q_start.data_ptr(), kv_len.data_ptr(),
        table.data_ptr(), int(layer), *shape, P, page, table.shape[1], D,
        _scale_of(sm_scale, D), int(window or 0), _native.stream_of(q))
    _native.check(status, entry)
    return out


def attention_prefill_paged(q, k_pool, v_pool, q_start, kv_len, layer: int,
                            table, *, sm_scale: Optional[float] = None,
                            window: Optional[int] = None,
                            kernels: str = "auto",
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Kernel D's prefill mode through the block table (the counterpart of
    ``_attn_kernel`` under the paged index map): q [B, T, H, D] against the
    pool [L, P, page, K, D] at ``layer``, key row j of sequence b at page
    table[b, j // page]. Table entries at or past ceil(kv_len / page) are
    never read. An int8 pool (scale planes given) takes
    :func:`attention_prefill_paged_int8`."""
    if k_scale is not None:
        return attention_prefill_paged_int8(
            q, k_pool, v_pool, q_start, kv_len, layer, table,
            k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale,
            window=window, kernels=kernels)
    if not use_kernel(kernels, q):
        return attention_paged_torch(q, k_pool, v_pool, q_start, kv_len,
                                     layer, table, sm_scale=sm_scale,
                                     window=window)
    out = _launch_paged("attention_prefill_paged", q, k_pool, v_pool,
                        q_start, kv_len, layer, table, sm_scale, window)
    attention_prefill_paged.launches += 1
    kernel_output("attention_prefill_paged", out)
    return out


attention_prefill_paged.launches = 0


def attention_prefill_paged_int8(q, k_pool, v_pool, q_start, kv_len,
                                 layer: int, table, *, k_scale, v_scale,
                                 sm_scale: Optional[float] = None,
                                 window: Optional[int] = None,
                                 kernels: str = "auto") -> torch.Tensor:
    """Kernel D's int8 paged prefill mode: the int8 pool [L, P, page, K, D]
    with its scale planes [L, P, page, K], through the table."""
    if not use_kernel(kernels, q):
        return attention_paged_torch(q, k_pool, v_pool, q_start, kv_len,
                                     layer, table, sm_scale=sm_scale,
                                     window=window, k_scale=k_scale,
                                     v_scale=v_scale)
    out = _launch_paged("attention_prefill_paged_int8", q, k_pool, v_pool,
                        q_start, kv_len, layer, table, sm_scale, window,
                        k_scale, v_scale)
    attention_prefill_paged_int8.launches += 1
    kernel_output("attention_prefill_paged_int8", out)
    return out


attention_prefill_paged_int8.launches = 0


def _check_decode_q(q):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"attention_decode: q must be [B, 1, H, D], got "
                         f"{tuple(q.shape)}")


def attention_decode(q, k_pool, v_pool, q_start, kv_len, layer: int, *,
                     table, sm_scale: Optional[float] = None,
                     window: Optional[int] = None,
                     kernels: str = "auto",
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attend-only decode over the paged pool (the counterpart of
    ``_decode_mxu_kernel``): q [B, 1, H, D]; the pool must already hold
    the token's K/V at q_start (kernel H runs first); decode rows use
    kv_len = q_start + active. Returns [B, 1, H, D]. An int8 pool (scale
    planes given) takes :func:`attention_decode_int8`."""
    if k_scale is not None:
        return attention_decode_int8(
            q, k_pool, v_pool, q_start, kv_len, layer, table=table,
            k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale,
            window=window, kernels=kernels)
    _check_decode_q(q)
    if not use_kernel(kernels, q):
        return attention_paged_torch(q, k_pool, v_pool, q_start, kv_len,
                                     layer, table, sm_scale=sm_scale,
                                     window=window)
    out = _launch_paged("attention_decode_paged", q, k_pool, v_pool,
                        q_start, kv_len, layer, table, sm_scale, window)
    attention_decode.launches += 1
    kernel_output("attention_decode_paged", out)
    return out


attention_decode.launches = 0


def attention_decode_int8(q, k_pool, v_pool, q_start, kv_len, layer: int,
                          *, table, k_scale, v_scale,
                          sm_scale: Optional[float] = None,
                          window: Optional[int] = None,
                          kernels: str = "auto") -> torch.Tensor:
    """Kernel D's int8 attend-only paged decode (the int8 mode of
    ``_decode_mxu_kernel``), after kernel H's int8 mode wrote the token."""
    _check_decode_q(q)
    if not use_kernel(kernels, q):
        return attention_paged_torch(q, k_pool, v_pool, q_start, kv_len,
                                     layer, table, sm_scale=sm_scale,
                                     window=window, k_scale=k_scale,
                                     v_scale=v_scale)
    out = _launch_paged("attention_decode_paged_int8", q, k_pool, v_pool,
                        q_start, kv_len, layer, table, sm_scale, window,
                        k_scale, v_scale)
    attention_decode_int8.launches += 1
    kernel_output("attention_decode_paged_int8", out)
    return out


attention_decode_int8.launches = 0


def decode_plan(B: int, H: int, K: int, D: int, *, int8: bool = False,
                page: int = 0, max_pages: int = 0) -> dict:
    """Kernel D's split plan for a decode launch at these shapes (a paged
    pool: ``page`` and ``max_pages`` > 0), from the built library on the
    card: blocks a cluster along the keys, query heads a block, tile keys,
    ring stages, dynamic shared memory a block, blocks an SM holds and
    clusters the card holds at once."""
    import ctypes
    out = (ctypes.c_int * 7)()
    status = _native.library().attention_decode_plan(
        B, H, K, D, int(int8), page, max_pages, out)
    _native.check(status, "attention_decode_plan")
    return dict(zip(("nsplit", "heads_per_block", "tile_keys", "stages",
                     "smem_bytes", "blocks_per_sm", "max_active_clusters"),
                    out))


def prefill_plan(D: int, *, int8: bool = False) -> dict:
    """Kernel D2's tiling at head_dim ``D`` (the paged modes tile alike),
    from the built library on the card: tile keys, ring stages and dynamic
    shared memory a block."""
    import ctypes
    out = (ctypes.c_int * 3)()
    status = _native.library().attention_prefill_plan(D, int(int8), out)
    _native.check(status, "attention_prefill_plan")
    return dict(zip(("tile_keys", "stages", "smem_bytes"), out))


def can_fuse_decode(q_shape, cache) -> bool:
    """Fused-decode gate: one new token against a bf16 or int8 SLOT cache
    (the paged pool writes through kernel H, then attends). The JAX
    package fuses only its embedded-scale int8 cache; the port's one scale
    layout makes both int8 numerics fusible."""
    return (q_shape[1] == 1 and not isinstance(cache, PagedKVCache)
            and (cache.k.dtype == torch.bfloat16 or cache.quantized))


def attention_decode_fused_torch(q, k_new, v_new, k_cache, v_cache, q_start,
                                 kv_len, layer: int, *,
                                 sm_scale: Optional[float] = None,
                                 window: Optional[int] = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None,
                                 snapped: bool = False):
    """Plain version of the decode mode of kernel D: write k_new/v_new
    [B, 1, K, D] at q_start for rows with kv_len > q_start (in place; an
    int8 cache gets them quantized, snapped or absmax, with their scales),
    then attend. Returns (out [B, 1, H, D], k_cache, v_cache)."""
    active = (kv_len > q_start).to(torch.int32)
    if k_scale is None:
        _write_rows_torch(k_cache, k_new, layer, q_start, active)
        _write_rows_torch(v_cache, v_new, layer, q_start, active)
    else:
        for new, vals, scales in ((k_new, k_cache, k_scale),
                                  (v_new, v_cache, v_scale)):
            qv, sc = quantize_rows(new, snapped)
            _write_rows_torch(vals, qv, layer, q_start, active)
            _write_rows_torch(scales, sc, layer, q_start, active)
    out = attention_torch(q, k_cache, v_cache, q_start, kv_len,
                          sm_scale=sm_scale, layer=layer, window=window,
                          k_scale=k_scale, v_scale=v_scale)
    return out, k_cache, v_cache


def _check_new_rows(q, k_new, v_new, k_cache):
    B, T, H, D = q.shape
    K = k_cache.shape[3]
    if T != 1 or k_new.shape != (B, 1, K, D) or v_new.shape != k_new.shape:
        raise ValueError(f"decode kernel: q {tuple(q.shape)}, new rows "
                         f"{tuple(k_new.shape)} for cache "
                         f"{tuple(k_cache.shape)}")
    for t in (k_new, v_new):
        if (t.dtype != torch.bfloat16 or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("decode kernel: new rows must be contiguous, "
                             "16-byte aligned bf16 on q's device")


def attention_decode_fused(q, k_new, v_new, k_cache, v_cache, q_start,
                           kv_len, layer: int, *,
                           sm_scale: Optional[float] = None,
                           window: Optional[int] = None,
                           kernels: str = "auto",
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           snapped: bool = False):
    """Fused decode write + attend on the stacked cache (counterpart of
    the JAX package's ``attention_decode_fused_mxu``).

    q [B, 1, H, D]; k_new/v_new [B, 1, K, D]; caches [L, B, S, K, D],
    updated in place; decode rows use q_start = cache lengths and
    kv_len = q_start + active, so inactive rows neither write nor see a
    new token. An int8 cache (scale planes given; ``snapped`` picks the
    numerics) takes :func:`attention_decode_fused_int8`. Returns
    (out [B, 1, H, D], k_cache, v_cache)."""
    if k_scale is not None:
        return attention_decode_fused_int8(
            q, k_new, v_new, k_cache, v_cache, q_start, kv_len, layer,
            k_scale=k_scale, v_scale=v_scale, snapped=snapped,
            sm_scale=sm_scale, window=window, kernels=kernels)
    if not use_kernel(kernels, q):
        return attention_decode_fused_torch(
            q, k_new, v_new, k_cache, v_cache, q_start, kv_len, layer,
            sm_scale=sm_scale, window=window)
    _check(q, k_cache, v_cache, q_start, kv_len, layer)
    _check_new_rows(q, k_new, v_new, k_cache)
    B, _, H, D = q.shape
    _, _, S, K, _ = k_cache.shape
    out = torch.empty_like(q)
    status = _native.library().attention_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), q_start.data_ptr(),
        kv_len.data_ptr(), int(layer), B, H, K, S, D,
        _scale_of(sm_scale, D), int(window or 0), _native.stream_of(q))
    _native.check(status, "attention_decode")
    attention_decode_fused.launches += 1
    kernel_output("attention_decode", out)
    kernel_output("attention_decode", k_cache, v_cache, layer=layer)
    return out, k_cache, v_cache


attention_decode_fused.launches = 0


def attention_decode_fused_int8(q, k_new, v_new, k_cache, v_cache, q_start,
                                kv_len, layer: int, *, k_scale, v_scale,
                                snapped: bool,
                                sm_scale: Optional[float] = None,
                                window: Optional[int] = None,
                                kernels: str = "auto"):
    """Kernel D's fused int8 decode (the embedded-scale mode of
    ``_decode_fused_mxu_kernel``): the kernel quantizes the bf16 rows
    k_new/v_new [B, 1, K, D] with kernel I's row quantizer (``snapped``:
    log2-snapped scales, else absmax / 127), writes values and scales at
    q_start for active rows and attends the token in its dequantized
    form. Returns (out [B, 1, H, D], k_cache, v_cache)."""
    if not use_kernel(kernels, q):
        return attention_decode_fused_torch(
            q, k_new, v_new, k_cache, v_cache, q_start, kv_len, layer,
            sm_scale=sm_scale, window=window, k_scale=k_scale,
            v_scale=v_scale, snapped=snapped)
    _check(q, k_cache, v_cache, q_start, kv_len, layer, k_scale=k_scale,
           v_scale=v_scale)
    _check_new_rows(q, k_new, v_new, k_cache)
    B, _, H, D = q.shape
    _, _, S, K, _ = k_cache.shape
    out = torch.empty_like(q)
    status = _native.library().attention_decode_int8(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), q_start.data_ptr(), kv_len.data_ptr(), int(layer), B,
        H, K, S, D, _scale_of(sm_scale, D), int(window or 0), int(snapped),
        _native.stream_of(q))
    _native.check(status, "attention_decode_int8")
    attention_decode_fused_int8.launches += 1
    kernel_output("attention_decode_int8", out)
    kernel_output("attention_decode_int8", k_scale, v_scale, layer=layer)
    return out, k_cache, v_cache


attention_decode_fused_int8.launches = 0

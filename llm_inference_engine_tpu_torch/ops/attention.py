"""Causal attention over the stacked token-major KV cache, GQA-native.

Port of the bf16 paths of ``llm_inference_engine_tpu/ops/attention.py``:

- :func:`attention_torch` is the plain version, a port of
  ``attention_xla`` (dense mask, f32 math);
- :func:`attention` (prefill and chunked prefill) runs kernel D
  (``csrc/attention.cu``, ``attention_prefill``) in place of the TPU
  kernel ``_attn_kernel``;
- :func:`attention_decode_fused` (one new token per sequence) runs kernel
  D in decode mode (``attention_decode``) in place of the TPU kernel
  ``_decode_fused_mxu_kernel`` (the JAX package's
  ``attention_decode_fused_mxu``): it writes the new K/V row into the
  cache IN PLACE and attends history plus the new token.

Row semantics (all versions): query row (t, h) at position
p = q_start[b] + t attends key j iff j < kv_len[b], j <= p and, with a
sliding window W, j > p - W, using kv head h // G. A row with no visible
key gives 0, not NaN. The decode kernel reads ``kv_len`` per sequence, so
the JAX package's static ``kv_hi`` watermark has no counterpart.

Not ported yet: int8 KV scales, the paged block table and the attend-only
``_decode_mxu_kernel`` (ROADMAP.md, queue 1, "INT8 KV cache" and
"Paged KV and prefix cache").
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from llm_inference_engine_tpu_torch.utils import use_kernel

__all__ = ["attention", "attention_torch", "attention_decode_fused",
           "attention_decode_fused_torch", "can_fuse_decode"]


def attention_torch(q, k_cache, v_cache, q_start, kv_len, *,
                    sm_scale: Optional[float] = None,
                    layer: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Dense-masked causal attention (plain reference; O(Sq*Skv) memory).

    q:       [B, Sq, H, D]
    k_cache: [B, Skv, K, D], v_cache: same; with ``layer`` given, a
             stacked [L, B, Skv, K, D] cache read at that layer
    q_start: [B] int absolute position of q[:, 0]
    kv_len:  [B] int valid kv length (history + new tokens)
    returns  [B, Sq, H, D] in q's dtype
    """
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
    B, Sq, H, D = q.shape
    Skv, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)

    qf = q.float().reshape(B, Sq, K, G, D)
    kf = k_cache.float()
    vf = v_cache.float()
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


def _check(q, k_cache, v_cache, q_start, kv_len, layer):
    if q.dim() != 4 or k_cache.dim() != 5:
        raise ValueError(f"attention kernel: need q [B,T,H,D] and a stacked "
                         f"cache [L,B,S,K,D], got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    B, T, H, D = q.shape
    L, Bc, S, K, Dc = k_cache.shape
    if Bc != B or Dc != D or H % K:
        raise ValueError(f"attention kernel: q {tuple(q.shape)} does not fit "
                         f"cache {tuple(k_cache.shape)}")
    if D not in (64, 128):
        raise NotImplementedError(f"attention kernel: head_dim {D} (built "
                                  "for 64 and 128)")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside [0, {L})")
    for t in (q, k_cache, v_cache):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention kernel: bf16 only, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention kernel: tensors must be contiguous "
                             "and 16-byte aligned")
        if t.device != q.device:
            raise ValueError("attention kernel: tensors on different devices")
    if v_cache.shape != k_cache.shape:
        raise ValueError("attention kernel: k and v caches differ in shape")
    for t in (q_start, kv_len):
        if (t.dtype != torch.int32 or t.shape != (B,) or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"attention kernel: q_start/kv_len must be "
                             f"contiguous int32 [{B}] on {q.device}")


def attention(q, k_cache, v_cache, q_start, kv_len, *,
              sm_scale: Optional[float] = None, kernels: str = "auto",
              layer: Optional[int] = None,
              window: Optional[int] = None) -> torch.Tensor:
    """Attention of q against the (already updated) KV cache: the cache
    must hold the current tokens' K/V at [q_start, kv_len) (kernel C runs
    first). See :func:`attention_torch` for shapes."""
    if not use_kernel(kernels, q):
        return attention_torch(q, k_cache, v_cache, q_start, kv_len,
                               sm_scale=sm_scale, layer=layer, window=window)
    if layer is None:                 # a plain [B, S, K, D] cache
        k_cache, v_cache, layer = k_cache[None], v_cache[None], 0
    _check(q, k_cache, v_cache, q_start, kv_len, layer)
    from llm_inference_engine_tpu_torch.ops import _native
    B, T, H, D = q.shape
    _, _, S, K, _ = k_cache.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    status = _native.library().attention_prefill(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        q_start.data_ptr(), kv_len.data_ptr(), int(layer), B, T, H, K, S, D,
        float(scale), int(window or 0), _native.stream_of(q))
    _native.check(status, "attention_prefill")
    attention.launches += 1
    return out


attention.launches = 0


def can_fuse_decode(q_shape, cache) -> bool:
    """Fused-decode gate: one new token against a bf16 slot cache."""
    return q_shape[1] == 1 and cache.k.dtype == torch.bfloat16


def attention_decode_fused_torch(q, k_new, v_new, k_cache, v_cache, q_start,
                                 kv_len, layer: int, *,
                                 sm_scale: Optional[float] = None,
                                 window: Optional[int] = None):
    """Plain version of the decode mode of kernel D: write k_new/v_new
    [B, 1, K, D] at q_start for rows with kv_len > q_start (in place),
    then attend. Returns (out [B, 1, H, D], k_cache, v_cache)."""
    active = (kv_len > q_start).to(torch.int32)
    from llm_inference_engine_tpu_torch.ops.kv_cache import _write_rows_torch
    _write_rows_torch(k_cache, k_new, layer, q_start, active)
    _write_rows_torch(v_cache, v_new, layer, q_start, active)
    out = attention_torch(q, k_cache, v_cache, q_start, kv_len,
                          sm_scale=sm_scale, layer=layer, window=window)
    return out, k_cache, v_cache


def attention_decode_fused(q, k_new, v_new, k_cache, v_cache, q_start,
                           kv_len, layer: int, *,
                           sm_scale: Optional[float] = None,
                           window: Optional[int] = None,
                           kernels: str = "auto"):
    """Fused decode write + attend on the stacked bf16 cache (counterpart
    of the JAX package's ``attention_decode_fused_mxu``).

    q [B, 1, H, D]; k_new/v_new [B, 1, K, D]; caches [L, B, S, K, D],
    updated in place; decode rows use q_start = cache lengths and
    kv_len = q_start + active, so inactive rows neither write nor see a
    new token. Returns (out [B, 1, H, D], k_cache, v_cache)."""
    if not use_kernel(kernels, q):
        return attention_decode_fused_torch(
            q, k_new, v_new, k_cache, v_cache, q_start, kv_len, layer,
            sm_scale=sm_scale, window=window)
    _check(q, k_cache, v_cache, q_start, kv_len, layer)
    B, T, H, D = q.shape
    _, _, S, K, _ = k_cache.shape
    if T != 1 or k_new.shape != (B, 1, K, D) or v_new.shape != k_new.shape:
        raise ValueError(f"decode kernel: q {tuple(q.shape)}, new rows "
                         f"{tuple(k_new.shape)} for cache "
                         f"{tuple(k_cache.shape)}")
    for t in (k_new, v_new):
        if (t.dtype != torch.bfloat16 or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("decode kernel: new rows must be contiguous, "
                             "16-byte aligned bf16 on q's device")
    from llm_inference_engine_tpu_torch.ops import _native
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    status = _native.library().attention_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), q_start.data_ptr(),
        kv_len.data_ptr(), int(layer), B, H, K, S, D, float(scale),
        int(window or 0), _native.stream_of(q))
    _native.check(status, "attention_decode")
    attention_decode_fused.launches += 1
    return out, k_cache, v_cache


attention_decode_fused.launches = 0

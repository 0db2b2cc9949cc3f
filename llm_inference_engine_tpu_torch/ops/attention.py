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
- :func:`attention_decode_paged_fused` (one new token per sequence,
  a paged pool of q's dtype or int8) runs kernel D's fused paged mode
  (``attention_decode_paged_fused``, int8:
  :func:`attention_decode_paged_fused_int8`) in place of the TPU kernels
  ``_paged_write_kernel`` and ``_decode_mxu_kernel`` (``_attention_decode_mxu``
  with a table), which the JAX package runs one after the other: it
  writes the new K/V row through the block table IN PLACE, with kernel
  H's rules (an int8 pool's row quantized with snapped scales, kernel H's
  int8 bits), and attends;
- :func:`attention_decode` (one token per sequence, paged pool, written
  by kernel H first) runs kernel D's attend-only mode
  (``attention_decode_paged``: the fused paged instance given no new
  rows; int8: :func:`attention_decode_int8`) in place of
  ``_decode_mxu_kernel``; the engine runs it on no path: it is the JAX
  package's order that the fused mode is held against. The paged modes'
  split plan and summation order are the slot mode's
  (:func:`decode_plan`), so a paged engine reproduces a slot engine bit
  for bit.

Every bf16 kernel is built for the head dims ``_native.HEAD_DIMS`` (64,
80, 96, 128, 256); another head_dim raises ``NotImplementedError`` on a
CUDA tensor.

A float16 or float32 q (and a cache of its dtype, or int8) takes the
float instances D2f and Df of the same kernels (head_dim
``_native.FLOAT_HEAD_DIMS``; the entry points of the bf16 ones with the
dtype's suffix, ``_native.ATTENTION_SUFFIX``): float16 prefill on D2's
tensor-core template (``csrc/attention_prefill_f16.cu``), float32 prefill
on a register-tiled CUDA-core kernel (``csrc/attention_prefill_f32.cu``),
both decodes on D's split-KV template (``csrc/attention_decode_f16.cu``,
``_f32.cu``). Each wrapper below hands such a q to its counted launcher
(``attention_prefill_float``, ``..._float_int8``,
``attention_prefill_paged_float[_int8]``, ``attention_decode_float[_int8]``
for the fused slot decode, ``attention_decode_paged_fused_float[_int8]``
for the fused paged decode, ``attention_decode_paged_float[_int8]`` for
the attend-only paged decode). Any other dtype raises, naming the
instances.

Each int8 mode is a wrapper of its own with its own launch counter.

Row semantics (all versions): query row (t, h) at position
p = q_start[b] + t attends key j iff j < kv_len[b], j <= p and, with a
sliding window W, j > p - W, using kv head h // G. A row with no visible
key gives 0, not NaN. The decode kernel reads ``kv_len`` per sequence, so
the JAX package's static ``kv_hi`` watermark has no counterpart.

Under tensor parallelism every mode runs on a model rank's local heads
(``parallel/sharding.py``), the decode fused as on one device. The
engine never runs the attend-only decode: it fuses every decode
(:func:`can_fuse_decode`, :func:`can_fuse_paged_decode`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from llm_inference_engine_tpu_torch.ops import _native
from llm_inference_engine_tpu_torch.ops.kv_cache import (
    _write_rows_torch, quantize_rows)
from llm_inference_engine_tpu_torch.ops.paged_kv import (
    PagedKVCache, _write_rows_torch as _write_pool_rows_torch, gather_pages)
from llm_inference_engine_tpu_torch.utils import use_kernel
from llm_inference_engine_tpu_torch.utils.checks import kernel_output

# the dtypes of q that the float instances D2f/Df take
FLOAT_DTYPES = (torch.float16, torch.float32)

__all__ = ["attention", "attention_torch", "attention_paged_torch",
           "attention_int8", "attention_prefill_paged",
           "attention_prefill_paged_int8", "attention_decode",
           "attention_decode_int8", "attention_decode_fused",
           "attention_decode_fused_int8", "attention_decode_fused_torch",
           "attention_decode_paged_fused",
           "attention_decode_paged_fused_int8",
           "attention_decode_paged_fused_torch", "can_fuse_decode",
           "can_fuse_paged_decode", "decode_plan", "decode_plan_mirror",
           "decode_residency", "prefill_plan", "H100_DECODE_CLUSTERS"]


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
    """Validate a launch; the instance follows from q's dtype: a bf16 q
    takes kernels D2/D (``_native.HEAD_DIMS``), a float16 or float32 q
    their float instances D2f/Df (``_native.FLOAT_HEAD_DIMS``, a cache of
    q's dtype or int8). Any other dtype raises, naming the instances."""
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
    if q.dtype in FLOAT_DTYPES:
        head_dims, q_dtype = _native.FLOAT_HEAD_DIMS, q.dtype
    elif q.dtype == torch.bfloat16:
        head_dims, q_dtype = _native.HEAD_DIMS, torch.bfloat16
    else:
        raise TypeError(f"attention kernel: no {q.dtype} instance (kernels "
                        f"D2 and D take bfloat16, D2f and Df float16 and "
                        f"float32)")
    if D not in head_dims:
        raise NotImplementedError(f"attention kernel: head_dim {D} (built "
                                  f"for {head_dims})")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside [0, {L})")
    int8 = k_scale is not None
    kv_dtype = torch.int8 if int8 else q_dtype
    for t, want in ((q, q_dtype), (k_cache, kv_dtype), (v_cache, kv_dtype)):
        if t.dtype != want:
            raise TypeError(f"attention kernel: need {q_dtype} q and a "
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


def _launch(entry: str, q, k_cache, v_cache, q_start, kv_len, layer, *,
            table=None, k_scale=None, v_scale=None, k_new=None, v_new=None,
            snapped: Optional[bool] = None,
            sm_scale: Optional[float] = None,
            window: Optional[int] = None) -> torch.Tensor:
    """One launch of the C entry point ``entry`` of kernel D2 or D
    (``csrc/attention_*.cu``) in q's dtype: the bf16 instance, or the
    float16 / float32 one (``entry`` with ``_native.ATTENTION_SUFFIX``).
    ``table`` picks the pool, scale planes an int8 cache, ``k_new`` /
    ``v_new`` a fused decode that writes the token first (in place),
    ``snapped`` an int8 slot decode's numerics. Returns out."""
    _check(q, k_cache, v_cache, q_start, kv_len, layer, table, k_scale,
           v_scale)
    if k_new is not None:
        _check_new_rows(q, k_new, v_new, k_cache)
    B, T, H, D = q.shape
    K = k_cache.shape[3]
    out = torch.empty_like(q)
    args = [q.data_ptr()]
    if k_new is not None:
        args += [k_new.data_ptr(), v_new.data_ptr()]
    args += [k_cache.data_ptr(), v_cache.data_ptr()]
    if k_scale is not None:
        args += [k_scale.data_ptr(), v_scale.data_ptr()]
    args += [out.data_ptr(), q_start.data_ptr(), kv_len.data_ptr()]
    if table is not None:
        args.append(table.data_ptr())
    args += [int(layer), B] + ([T] if entry.startswith("attention_prefill")
                               else []) + [H, K]
    if table is None:                  # [L, B, S, K, D]: S
        args.append(k_cache.shape[2])
    else:                              # [L, P, page, K, D]: P, page, pages
        args += [k_cache.shape[1], k_cache.shape[2], table.shape[1]]
    args += [D, _scale_of(sm_scale, D), int(window or 0)]
    if snapped is not None:
        args.append(int(snapped))
    name = _native.entry_name(entry, q.dtype)
    status = getattr(_native.library(), name)(*args, _native.stream_of(q))
    _native.check(status, name)
    return out


def _float_instance(name: str, entry: str, doc: str):
    """A counted launcher of one mode of D2f/Df (its own ``launches``):
    the wrappers below call it on a float16 or float32 CUDA q; it runs
    ``entry`` of q's dtype."""
    def instance(q, k_cache, v_cache, q_start, kv_len, layer, **kw):
        if q.dtype not in FLOAT_DTYPES:
            raise TypeError(f"{name}: the float instance takes a float16 or "
                            f"float32 q, got {q.dtype}")
        out = _launch(entry, q, k_cache, v_cache, q_start, kv_len, layer,
                      **kw)
        instance.launches += 1
        kernel_output(name, out)
        if kw.get("k_new") is not None:
            written = ((kw["k_scale"], kw["v_scale"])
                       if kw.get("k_scale") is not None
                       else (k_cache, v_cache))
            kernel_output(name, *written, layer=layer)
        return out
    instance.__name__ = instance.__qualname__ = name
    instance.__doc__ = doc
    instance.launches = 0
    return instance


attention_prefill_float = _float_instance(
    "attention_prefill_float", "attention_prefill",
    "Kernel D2f over a float slot cache (prefill, chunk, mixed steps).")
attention_prefill_float_int8 = _float_instance(
    "attention_prefill_float_int8", "attention_prefill_int8",
    "Kernel D2f over an int8 slot cache with its scale planes.")
attention_prefill_paged_float = _float_instance(
    "attention_prefill_paged_float", "attention_prefill_paged",
    "Kernel D2f over a float pool through the block table.")
attention_prefill_paged_float_int8 = _float_instance(
    "attention_prefill_paged_float_int8", "attention_prefill_paged_int8",
    "Kernel D2f over an int8 pool through the block table.")
attention_decode_float = _float_instance(
    "attention_decode_float", "attention_decode",
    "Kernel Df over a float slot cache: write the token's row, attend.")
attention_decode_float_int8 = _float_instance(
    "attention_decode_float_int8", "attention_decode_int8",
    "Kernel Df over an int8 slot cache: quantize and write the token's "
    "row (kernel If's bits), attend.")
attention_decode_paged_fused_float = _float_instance(
    "attention_decode_paged_fused_float", "attention_decode_paged_fused",
    "Kernel Df over a float pool: write the token's row through the block "
    "table (kernel H's rules), attend.")
attention_decode_paged_fused_float_int8 = _float_instance(
    "attention_decode_paged_fused_float_int8",
    "attention_decode_paged_fused_int8",
    "Kernel Df over an int8 pool: quantize the token's row (snapped, "
    "kernel If's bits), write it through the block table (kernel H's "
    "rules), attend.")
attention_decode_paged_float = _float_instance(
    "attention_decode_paged_float", "attention_decode_paged",
    "Kernel Df's attend-only decode over a float pool (kernel H wrote the "
    "token): the fused paged instance given no new rows.")
attention_decode_paged_float_int8 = _float_instance(
    "attention_decode_paged_float_int8", "attention_decode_paged_int8",
    "Kernel Df's attend-only decode over an int8 pool (kernel If wrote "
    "the token): the fused int8 paged instance given no new rows.")


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
    if q.dtype in FLOAT_DTYPES:
        return attention_prefill_float(q, k_cache, v_cache, q_start, kv_len,
                                       layer, sm_scale=sm_scale,
                                       window=window)
    out = _launch("attention_prefill", q, k_cache, v_cache, q_start, kv_len,
                  layer, sm_scale=sm_scale, window=window)
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
    if q.dtype in FLOAT_DTYPES:
        return attention_prefill_float_int8(
            q, k_cache, v_cache, q_start, kv_len, layer, k_scale=k_scale,
            v_scale=v_scale, sm_scale=sm_scale, window=window)
    out = _launch("attention_prefill_int8", q, k_cache, v_cache, q_start,
                  kv_len, layer, k_scale=k_scale, v_scale=v_scale,
                  sm_scale=sm_scale, window=window)
    attention_int8.launches += 1
    kernel_output("attention_prefill_int8", out)
    return out


attention_int8.launches = 0


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
    if q.dtype in FLOAT_DTYPES:
        return attention_prefill_paged_float(
            q, k_pool, v_pool, q_start, kv_len, layer, table=table,
            sm_scale=sm_scale, window=window)
    out = _launch("attention_prefill_paged", q, k_pool, v_pool, q_start,
                  kv_len, layer, table=table, sm_scale=sm_scale,
                  window=window)
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
    if q.dtype in FLOAT_DTYPES:
        return attention_prefill_paged_float_int8(
            q, k_pool, v_pool, q_start, kv_len, layer, table=table,
            k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale,
            window=window)
    out = _launch("attention_prefill_paged_int8", q, k_pool, v_pool,
                  q_start, kv_len, layer, table=table, k_scale=k_scale,
                  v_scale=v_scale, sm_scale=sm_scale, window=window)
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
    if q.dtype in FLOAT_DTYPES:
        return attention_decode_paged_float(
            q, k_pool, v_pool, q_start, kv_len, layer, table=table,
            sm_scale=sm_scale, window=window)
    out = _launch("attention_decode_paged", q, k_pool, v_pool, q_start,
                  kv_len, layer, table=table, sm_scale=sm_scale,
                  window=window)
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
    ``_decode_mxu_kernel``), after kernel H's int8 mode wrote the token:
    the fused int8 paged instance given no new rows."""
    _check_decode_q(q)
    if not use_kernel(kernels, q):
        return attention_paged_torch(q, k_pool, v_pool, q_start, kv_len,
                                     layer, table, sm_scale=sm_scale,
                                     window=window, k_scale=k_scale,
                                     v_scale=v_scale)
    if q.dtype in FLOAT_DTYPES:
        return attention_decode_paged_float_int8(
            q, k_pool, v_pool, q_start, kv_len, layer, table=table,
            k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale,
            window=window)
    out = _launch("attention_decode_paged_int8", q, k_pool, v_pool,
                  q_start, kv_len, layer, table=table, k_scale=k_scale,
                  v_scale=v_scale, sm_scale=sm_scale, window=window)
    attention_decode_int8.launches += 1
    kernel_output("attention_decode_paged_int8", out)
    return out


attention_decode_int8.launches = 0


def decode_plan(B: int, H: int, K: int, D: int, *, int8: bool = False,
                page: int = 0, max_pages: int = 0,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Kernel D's split plan for a decode launch at these shapes (a paged
    pool: ``page`` and ``max_pages`` > 0) for a q of ``dtype`` (bf16: D,
    float16 / float32: Df), from the built library on the card: blocks a
    cluster along the keys, query heads a block, tile keys, ring stages,
    dynamic shared memory a block, blocks an SM holds and clusters the card
    holds at once."""
    import ctypes
    out = (ctypes.c_int * 7)()
    name = _native.entry_name("attention_decode_plan", dtype)
    status = getattr(_native.library(), name)(
        B, H, K, D, int(int8), page, max_pages, out)
    _native.check(status, name)
    return dict(zip(("nsplit", "heads_per_block", "tile_keys", "stages",
                     "smem_bytes", "blocks_per_sm", "max_active_clusters"),
                    out))


# Kernel D's plan (``make_plan`` in csrc/attention_decode.cuh)
_DEC_TARGET_BLOCKS_PER_SM = 8   # kTargetBlocksPerSm, at G = 1
_DEC_MAX_SPLIT = 8              # kMaxSplit, the portable cluster size


# The residency kernel D's plan reads on an H100 80GB HBM3 (recorded by
# ``tools/plan_sweep.py --only residency``; a card test holds it equal to
# the library's on such a card): the clusters of n = 1 .. 8 blocks it holds
# at once at 1-4 blocks an SM (its GPCs hold fewer clusters of 3, 5, 6 and
# 7 blocks than the SM count alone gives), and the blocks an SM of D's
# R = 4 and R = 8 slot instances, 4 and 2 but where named
_H100_CLUSTERS_AT = {1: (132, 66, 39, 30, 22, 17, 15, 15),
                     2: (264, 132, 79, 62, 47, 39, 32, 30),
                     3: (396, 198, 124, 92, 69, 62, 47, 45),
                     4: (528, 264, 163, 124, 94, 79, 69, 62)}
_H100_BLOCKS_PER_SM = {("bfloat16", 256, False): (3, 2),
                       ("float16", 16, True): (4, 3),
                       ("float16", 256, False): (3, 2),
                       ("float32", 16, True): (4, 3),
                       ("float32", 128, False): (3, 2),
                       ("float32", 256, False): (1, 1)}
# (dtype name, head_dim, int8) -> {R: clusters of n = 1 .. 8 blocks}
H100_DECODE_CLUSTERS = {
    (dt, D, int8): {R: _H100_CLUSTERS_AT[b] for R, b in zip(
        (4, 8), _H100_BLOCKS_PER_SM.get((dt, D, int8), (4, 2)))}
    for dt, dims in (("bfloat16", _native.HEAD_DIMS),
                     ("float16", _native.FLOAT_HEAD_DIMS),
                     ("float32", _native.FLOAT_HEAD_DIMS))
    for D in dims for int8 in (False, True)}


def decode_plan_mirror(B: int, K: int, G: int, *, clusters: dict,
                       esize: int = 2, sms: int = 132) -> dict:
    """Kernel D's split plan (``make_plan`` in csrc/attention_decode.cuh)
    in pure Python, for the CPU tests: at G = 1 one query head a block and
    nsplit blocks along the keys so that the grid holds about 8 blocks an
    SM (4 for float32, ``esize`` 4); at G > 1 each candidate R (4 up to
    G = 4, else 8 then 4) takes the largest nsplit up to that target whose
    B * K * ceil(G / R) clusters the card holds in one wave, and the
    candidate with the most blocks wins (the first on a tie). ``clusters``
    is the compiled instance's residency: R (4, 8) -> the clusters of
    n = 1 .. 8 blocks of R's slot instance that the card holds at once
    (:func:`decode_residency` reads it from the library;
    ``H100_DECODE_CLUSTERS`` holds an H100's). Never a function of S, the
    page size or kv_len. Returns nsplit, heads_per_block, row_blocks."""
    want = _DEC_TARGET_BLOCKS_PER_SM * 2 // esize * sms

    def target(c):
        return max(1, min(_DEC_MAX_SPLIT, (want + c // 2) // max(c, 1)))
    if G == 1:
        return dict(nsplit=target(B * K), heads_per_block=1, row_blocks=1)
    best = None
    for R in ((4,) if G <= 4 else (8, 4)):
        rb = -(-G // R)
        c = B * K * rb
        n = target(c)
        while n > 1 and c > clusters[R][n - 1]:
            n -= 1
        if best is None or c * n > best[0]:
            best = (c * n, dict(nsplit=n, heads_per_block=R, row_blocks=rb))
    return best[1]


def decode_residency(D: int, *, int8: bool = False,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """The residency kernel D's plan reads at head_dim ``D``, from the
    built library on the card: R (4, 8) -> the clusters of n = 1 .. 8
    blocks of R's slot instance (q's ``dtype``; int8 or not) that the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    import ctypes
    out = (ctypes.c_int * 16)()
    name = _native.entry_name("attention_decode_clusters", dtype)
    status = getattr(_native.library(), name)(D, int(int8), out)
    _native.check(status, name)
    return {4: tuple(out[:8]), 8: tuple(out[8:])}


def prefill_plan(D: int, *, int8: bool = False,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """Kernel D2's tiling at head_dim ``D`` (the paged modes tile alike)
    for a q of ``dtype`` (bf16: D2, float16 / float32: D2f), from the built
    library on the card: tile keys, ring stages and dynamic shared memory a
    block."""
    import ctypes
    out = (ctypes.c_int * 3)()
    name = _native.entry_name("attention_prefill_plan", dtype)
    status = getattr(_native.library(), name)(D, int(int8), out)
    _native.check(status, name)
    return dict(zip(("tile_keys", "stages", "smem_bytes"), out))


def can_fuse_decode(q_shape, cache) -> bool:
    """Fused-decode gate: one new token against a bf16, float16, float32
    or int8 SLOT cache (kernel D, or its float instance Df; a pool takes
    :func:`can_fuse_paged_decode`). The JAX package fuses only its
    embedded-scale int8 cache; the port's one scale layout makes both int8
    numerics fusible."""
    return (q_shape[1] == 1 and not isinstance(cache, PagedKVCache)
            and (cache.k.dtype in (torch.bfloat16,) + FLOAT_DTYPES
                 or cache.quantized))


def can_fuse_paged_decode(q_shape, cache) -> bool:
    """Fused paged-decode gate: one new token against a bf16, float16,
    float32 or int8 paged pool (kernel D, or its float instance Df)."""
    return (q_shape[1] == 1 and isinstance(cache, PagedKVCache)
            and (cache.k.dtype in (torch.bfloat16,) + FLOAT_DTYPES
                 or cache.quantized))


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
        if (t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"decode kernel: new rows must be contiguous, "
                             f"16-byte aligned {q.dtype} (q's dtype) on "
                             f"q's device")


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
    if q.dtype in FLOAT_DTYPES:
        out = attention_decode_float(
            q, k_cache, v_cache, q_start, kv_len, layer, k_new=k_new,
            v_new=v_new, sm_scale=sm_scale, window=window)
        return out, k_cache, v_cache
    out = _launch("attention_decode", q, k_cache, v_cache, q_start, kv_len,
                  layer, k_new=k_new, v_new=v_new, sm_scale=sm_scale,
                  window=window)
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
    if q.dtype in FLOAT_DTYPES:
        out = attention_decode_float_int8(
            q, k_cache, v_cache, q_start, kv_len, layer, k_new=k_new,
            v_new=v_new, k_scale=k_scale, v_scale=v_scale, snapped=snapped,
            sm_scale=sm_scale, window=window)
        return out, k_cache, v_cache
    out = _launch("attention_decode_int8", q, k_cache, v_cache, q_start,
                  kv_len, layer, k_new=k_new, v_new=v_new, k_scale=k_scale,
                  v_scale=v_scale, snapped=snapped, sm_scale=sm_scale,
                  window=window)
    attention_decode_fused_int8.launches += 1
    kernel_output("attention_decode_int8", out)
    kernel_output("attention_decode_int8", k_scale, v_scale, layer=layer)
    return out, k_cache, v_cache


attention_decode_fused_int8.launches = 0


def attention_decode_paged_fused_torch(q, k_new, v_new, k_pool, v_pool,
                                       q_start, kv_len, layer: int, *,
                                       table,
                                       sm_scale: Optional[float] = None,
                                       window: Optional[int] = None,
                                       k_scale: Optional[torch.Tensor] = None,
                                       v_scale: Optional[torch.Tensor] = None):
    """Plain version of kernel D's fused paged decode: kernel H's plain
    write of k_new/v_new [B, 1, K, D] at q_start through ``table`` for rows
    with kv_len > q_start (in place; an int8 pool, scale planes given, gets
    them quantized with snapped scales, with their scales), then the paged
    attention. Returns (out [B, 1, H, D], k_pool, v_pool)."""
    active = (kv_len > q_start).to(torch.int32)
    if k_scale is None:
        for pool, new in ((k_pool, k_new), (v_pool, v_new)):
            _write_pool_rows_torch(pool, new, layer, q_start, active, table)
    else:
        for new, vals, scales in ((k_new, k_pool, k_scale),
                                  (v_new, v_pool, v_scale)):
            qv, sc = quantize_rows(new, True)
            _write_pool_rows_torch(vals, qv, layer, q_start, active, table)
            _write_pool_rows_torch(scales, sc, layer, q_start, active, table)
    out = attention_paged_torch(q, k_pool, v_pool, q_start, kv_len, layer,
                                table, sm_scale=sm_scale, window=window,
                                k_scale=k_scale, v_scale=v_scale)
    return out, k_pool, v_pool


def attention_decode_paged_fused(q, k_new, v_new, k_pool, v_pool, q_start,
                                 kv_len, layer: int, *, table,
                                 sm_scale: Optional[float] = None,
                                 window: Optional[int] = None,
                                 kernels: str = "auto",
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None):
    """Fused decode write + attend over a paged pool of q's dtype (the
    counterpart of the JAX package's ``_paged_write_kernel`` followed by
    ``_decode_mxu_kernel``): kernel D over a bf16 pool, its float instance
    (:func:`attention_decode_paged_fused_float`) over a float16 or
    float32 one; an int8 pool (scale planes given) takes
    :func:`attention_decode_paged_fused_int8`.

    q [B, 1, H, D]; k_new/v_new [B, 1, K, D]; pools [L, P, page, K, D],
    updated in place; ``table`` [B, max_pages]. The token's row goes to
    [layer, table[b, q_start // page], q_start % page] when kv_len >
    q_start, 0 <= q_start < max_pages * page and the entry lies in [0, P)
    (kernel H's rules), then the row attends as in
    :func:`attention_decode`. Returns (out [B, 1, H, D], k_pool, v_pool)."""
    if k_scale is not None:
        return attention_decode_paged_fused_int8(
            q, k_new, v_new, k_pool, v_pool, q_start, kv_len, layer,
            table=table, k_scale=k_scale, v_scale=v_scale,
            sm_scale=sm_scale, window=window, kernels=kernels)
    if not use_kernel(kernels, q):
        return attention_decode_paged_fused_torch(
            q, k_new, v_new, k_pool, v_pool, q_start, kv_len, layer,
            table=table, sm_scale=sm_scale, window=window)
    if q.dtype in FLOAT_DTYPES:
        out = attention_decode_paged_fused_float(
            q, k_pool, v_pool, q_start, kv_len, layer, table=table,
            k_new=k_new, v_new=v_new, sm_scale=sm_scale, window=window)
        return out, k_pool, v_pool
    out = _launch("attention_decode_paged_fused", q, k_pool, v_pool,
                  q_start, kv_len, layer, table=table, k_new=k_new,
                  v_new=v_new, sm_scale=sm_scale, window=window)
    attention_decode_paged_fused.launches += 1
    kernel_output("attention_decode_paged_fused", out)
    kernel_output("attention_decode_paged_fused", k_pool, v_pool,
                  layer=layer)
    return out, k_pool, v_pool


attention_decode_paged_fused.launches = 0


def attention_decode_paged_fused_int8(q, k_new, v_new, k_pool, v_pool,
                                      q_start, kv_len, layer: int, *, table,
                                      k_scale, v_scale,
                                      sm_scale: Optional[float] = None,
                                      window: Optional[int] = None,
                                      kernels: str = "auto"):
    """Kernel D's fused decode over an int8 pool (the counterpart of the
    JAX package's int8 ``_paged_write_kernel`` followed by the int8
    ``_decode_mxu_kernel``): the kernel quantizes the rows k_new/v_new
    [B, 1, K, D] of q's dtype with snapped scales (kernel H's int8 mode's
    bits, or If's for float16 / float32 rows: its float instance
    :func:`attention_decode_paged_fused_float_int8`), writes values and
    scales through ``table`` with kernel H's rules, and attends as
    :func:`attention_decode_int8`. Returns (out [B, 1, H, D], k_pool,
    v_pool)."""
    _check_decode_q(q)
    if not use_kernel(kernels, q):
        return attention_decode_paged_fused_torch(
            q, k_new, v_new, k_pool, v_pool, q_start, kv_len, layer,
            table=table, sm_scale=sm_scale, window=window, k_scale=k_scale,
            v_scale=v_scale)
    if q.dtype in FLOAT_DTYPES:
        out = attention_decode_paged_fused_float_int8(
            q, k_pool, v_pool, q_start, kv_len, layer, table=table,
            k_new=k_new, v_new=v_new, k_scale=k_scale, v_scale=v_scale,
            sm_scale=sm_scale, window=window)
        return out, k_pool, v_pool
    out = _launch("attention_decode_paged_fused_int8", q, k_pool, v_pool,
                  q_start, kv_len, layer, table=table, k_new=k_new,
                  v_new=v_new, k_scale=k_scale, v_scale=v_scale,
                  sm_scale=sm_scale, window=window)
    attention_decode_paged_fused_int8.launches += 1
    kernel_output("attention_decode_paged_fused_int8", out)
    kernel_output("attention_decode_paged_fused_int8", k_scale, v_scale,
                  layer=layer)
    return out, k_pool, v_pool


attention_decode_paged_fused_int8.launches = 0

"""KV cache: preallocated token-major [L, B, S, K, D] tensors, updated in place.

Port of the slot cache of ``llm_inference_engine_tpu/ops/kv_cache.py``,
bf16 and int8.
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

The int8 cache keeps int8 values [L, B, S, K, D] and one f32 scale per
(token, head) in planes ``k_scale``/``v_scale`` [L, B, S, K]. The JAX
package has two layouts for it: separate scale planes with absmax / 127
scales (``_quantize_kv``), and scales embedded as log2-snapped 16-bit
codes in 8 pad rows per token (``quantize_kv_embedded``), a TPU DMA
workaround. The port keeps both numerics in the one plane layout: the
``snapped`` flag picks them, and every reader dequantizes value * scale.
As the JAX package picks on its own device, the cache is snapped where it
lies on a CUDA device and :func:`embedded_supported` holds, absmax
elsewhere. Kernel I (CUDA, ``csrc/kv_write_quant.cu``) replaces the TPU
kernel ``_write_kernel_quant``: it quantizes the new bf16 rows and writes
values and scales in one launch (the JAX package quantizes in XLA first).

Not ported yet: head-group sharding (ROADMAP.md, queue 1, "Parallelism").
The TPU tile padding of K and D is dropped: it was a DMA-layout
workaround.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from llm_inference_engine_tpu_torch.ops._native import HEAD_DIMS
from llm_inference_engine_tpu_torch.utils import cdiv, use_kernel
from llm_inference_engine_tpu_torch.utils.checks import kernel_output

__all__ = ["KVCache", "new_kv_cache", "update_cache_at_layer",
           "update_cache_at_layer_torch", "kv_write_quant",
           "embedded_supported", "quantize_kv", "quantize_kv_snapped",
           "quantize_rows", "kv_scales_from_numpy"]


@dataclasses.dataclass
class KVCache:
    """k/v: [L, B, S, K, D] token-major; lengths: [B] int32 valid tokens
    per slot (on the cache's device). The int8 cache adds f32 scale planes
    k_scale/v_scale [L, B, S, K]; ``snapped`` says which numerics its
    writes quantize with (see the module docstring)."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    snapped: bool = False

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def embedded_supported(num_kv_heads: int, head_dim: int) -> bool:
    """The JAX package's gate for its embedded-scale (snapped) cache: the
    K scale codes' two bytes fit one D-lane row, and the TPU tiling holds
    (its ``embedded_supported``)."""
    return (2 * num_kv_heads <= head_dim and num_kv_heads % 8 == 0
            and head_dim % 128 == 0)


def new_kv_cache(num_layers: int, batch_size: int, num_kv_heads: int,
                 max_seq_len: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None,
                 quantized: bool = False,
                 snapped: Optional[bool] = None) -> KVCache:
    """Zero-filled cache on ``device``; ``quantized`` gives int8 values
    and scale planes of ones (``dtype`` is then unused). ``snapped=None``
    picks the numerics as the JAX package does on its device: snapped on a
    CUDA device where :func:`embedded_supported` holds, absmax elsewhere."""
    shape = (num_layers, batch_size, max_seq_len, num_kv_heads, head_dim)
    lengths = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    if not quantized:
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device),
                       lengths)
    if snapped is None:
        snapped = (torch.device(device or "cpu").type == "cuda"
                   and embedded_supported(num_kv_heads, head_dim))
    return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape, dtype=torch.int8, device=device),
                   lengths,
                   torch.ones(shape[:-1], dtype=torch.float32, device=device),
                   torch.ones(shape[:-1], dtype=torch.float32, device=device),
                   snapped=bool(snapped))


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as an IEEE divide, as the JAX package and kernel I compute
    it: PyTorch on a CUDA tensor turns a divide by a Python number into a
    multiply by its reciprocal, which can differ in the last bit."""
    return t / torch.full_like(t, 127.0)


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) absmax int8 quantization (the JAX package's
    ``_quantize_kv``). x: [..., D] -> (int8 [..., D], f32 scales [...])."""
    xf = x.float()
    scale = _div127(torch.clamp_min(xf.abs().amax(dim=-1), 1e-8))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_kv_snapped(x: torch.Tensor):
    """Per-(token, head) int8 quantization against a log2-snapped scale
    (the numerics of the JAX package's ``quantize_kv_embedded``): code =
    round(log2(absmax / 127) * 256) as int16, scale = 2^(code / 256), floor
    1e-30, values quantized against the snapped scale. x: [..., D] ->
    (int8 [..., D], f32 scales [...])."""
    xf = x.float()
    scale = _div127(torch.clamp_min(xf.abs().amax(dim=-1), 1e-30))
    code = torch.clamp(torch.round(torch.log2(scale) * 256.0), -32768, 32767)
    snapped = torch.exp2(code / 256.0)            # / 256 is exact
    q = torch.clamp(torch.round(xf / snapped[..., None]), -127, 127)
    return q.to(torch.int8), snapped


def kv_scales_from_numpy(packed: np.ndarray, num_kv_heads: int):
    """A JAX embedded-scale array (int8 [..., K + 8, D]: values in rows
    [0, K), row K carrying the 16-bit codes, hi byte in lanes [0, K), low
    byte in [K, 2K)) -> (int8 values [..., K, D], f32 scales [..., K]) in
    the port's layout. The port's own copy of ``decode_embedded_scales``."""
    K = num_kv_heads
    packed = np.asarray(packed)
    hi = torch.from_numpy(packed[..., K, :K].astype(np.int32))
    lo = torch.from_numpy(packed[..., K, K:2 * K].astype(np.int32)) & 255
    code = hi * 256 + lo
    return (torch.from_numpy(np.ascontiguousarray(packed[..., :K, :])),
            torch.exp2(code.float() / 256.0))


def _write_rows_torch(cache_t, new, layer: int, starts, new_len):
    """cache_t[layer, b, starts[b] + t] = new[b, t] for t < new_len[b] and
    starts[b] + t < S (in place; ``new`` may carry fewer trailing dims, as
    a scale plane does). Reads nothing on the host (a captured decode step
    runs it with kernels="torch"): every (b, t) is stored, an entry past
    the real rows where its row stores t = 0, with that value, or, in a
    row that stores nothing, onto its own place with the value there."""
    B, T = new.shape[:2]
    S = cache_t.shape[2]
    t = torch.arange(T, device=new.device)
    pos = starts.long()[:, None] + t[None, :]                     # [B, T]
    valid = (t[None, :] < new_len.long()[:, None]) & (pos < S)
    stores = valid[:, :1]                  # the row stores t = 0 (or none)
    dest = torch.where(valid, pos, torch.where(stores, pos[:, :1],
                                               pos.clamp(0, S - 1)))
    rows = torch.arange(B, device=new.device)[:, None].expand(B, T)
    layer_t = cache_t[layer]
    lead = (B, T) + (1,) * (new.dim() - 2)
    new = new.to(cache_t.dtype)
    layer_t[rows, dest] = torch.where(
        valid.view(lead), new,
        torch.where(stores.view(B, 1, *lead[2:]), new[:, :1],
                    layer_t[rows, dest]))


def quantize_rows(new: torch.Tensor, snapped: bool):
    """The new rows in the snapped or the absmax numerics: (int8 values,
    f32 scales)."""
    return (quantize_kv_snapped if snapped else quantize_kv)(new)


def update_cache_at_layer_torch(cache: KVCache, layer: int,
                                new_k: torch.Tensor, new_v: torch.Tensor,
                                starts: torch.Tensor,
                                new_len: Optional[torch.Tensor] = None
                                ) -> KVCache:
    """Plain version of kernels C and I (the semantics of the JAX
    package's ``_update_one_at_layer`` on real rows): rows with
    ``new_len == 0`` are left untouched; an int8 cache gets the rows
    quantized in its numerics, values and scales."""
    if new_len is None:
        new_len = torch.full_like(starts, new_k.shape[1])
    if cache.quantized:
        for new, vals, scales in ((new_k, cache.k, cache.k_scale),
                                  (new_v, cache.v, cache.v_scale)):
            q, sc = quantize_rows(new, cache.snapped)
            _write_rows_torch(vals, q, layer, starts, new_len)
            _write_rows_torch(scales, sc, layer, starts, new_len)
        return cache
    _write_rows_torch(cache.k, new_k, layer, starts, new_len)
    _write_rows_torch(cache.v, new_v, layer, starts, new_len)
    return cache


def _check_write(cache, layer, new_k, new_v, starts, new_len,
                 name="kv_write"):
    L, B, S, K, D = cache.k.shape
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside [0, {L})")
    if new_k.dim() != 4 or new_k.shape[0] != B or new_k.shape[2:] != (K, D):
        raise ValueError(f"{name}: new rows {tuple(new_k.shape)} do not "
                         f"fit cache {tuple(cache.k.shape)}")
    # an int8 cache takes bf16 rows (the kernel quantizes them)
    new_dtype = torch.bfloat16 if cache.quantized else cache.k.dtype
    for t, want in ((new_k, new_dtype), (new_v, new_dtype),
                    (cache.k, cache.k.dtype), (cache.v, cache.k.dtype)):
        if t.dtype != want or t.device != cache.k.device:
            raise TypeError(f"{name}: new rows must be {new_dtype}, on the "
                            "cache's device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if cache.quantized:
        for t in (cache.k_scale, cache.v_scale):
            if (t.dtype != torch.float32 or t.shape != (L, B, S, K)
                    or t.device != cache.k.device or not t.is_contiguous()):
                raise ValueError(f"{name}: scale planes must be contiguous "
                                 f"float32 [{L}, {B}, {S}, {K}]")
        if D not in HEAD_DIMS:
            raise NotImplementedError(f"{name}: head_dim {D} (built for "
                                      f"{HEAD_DIMS})")
    if new_v.shape != new_k.shape or cache.v.shape != cache.k.shape:
        raise ValueError(f"{name}: k and v shapes differ")
    for t in (starts, new_len):
        if (t.dtype != torch.int32 or t.shape != (B,)
                or t.device != cache.k.device or not t.is_contiguous()):
            raise ValueError(f"{name}: starts/new_len must be contiguous "
                             f"int32 [{B}] on the cache's device")
    row_bytes = K * D * cache.k.element_size()
    if row_bytes % 16:
        raise ValueError(f"{name}: a token row of {row_bytes} bytes is not "
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
    refuses such prefill chunks on the host before calling this. An int8
    cache takes :func:`kv_write_quant`.
    """
    if new_len is None:
        new_len = torch.full_like(starts, new_k.shape[1])
    if cache.quantized:
        return kv_write_quant(cache, layer, new_k, new_v, starts, new_len,
                              kernels=kernels)
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
    kernel_output("kv_write", cache.k, cache.v, layer=layer)
    return cache


update_cache_at_layer.launches = 0


_WRITE_THREADS = 256
_WRITE_PLAN_KEYS = ("threads", "lanes", "rows_per_block", "blocks_x",
                    "blocks_y")


def write_quant_plan(B: int, T: int, K: int, D: int) -> dict:
    """The launch of kernel I (and of kernel H's int8 mode) for new rows
    [B, T, K, D], as ``csrc/kv_write_quant.cu`` makes it: ``lanes`` lanes
    hold a row of D values, 32 bytes each, so a block of ``threads``
    holds rows_per_block = threads // lanes rows; block (x, y) takes rows
    [x * rows_per_block, (x + 1) * rows_per_block) of sequence y's flat
    order r = (t * 2 + kv) * K + head, thread i its row i // lanes. Pure
    Python: the CPU tests call it; :func:`write_quant_plan_native` asks the
    built library."""
    lanes = 4 if D == 64 else 16 if D == 256 else 8
    rb = _WRITE_THREADS // lanes
    return dict(zip(_WRITE_PLAN_KEYS, (_WRITE_THREADS, lanes, rb,
                                       cdiv(2 * T * K, rb), B)))


def write_quant_plan_native(B: int, T: int, K: int, D: int) -> dict:
    """The plan from the built library on the card
    (``kv_write_quant_plan``)."""
    import ctypes
    from llm_inference_engine_tpu_torch.ops import _native
    out = (ctypes.c_int * len(_WRITE_PLAN_KEYS))()
    _native.check(_native.library().kv_write_quant_plan(B, T, K, D, out),
                  "kv_write_quant_plan")
    return dict(zip(_WRITE_PLAN_KEYS, out))


def kv_write_quant(cache: KVCache, layer: int, new_k: torch.Tensor,
                   new_v: torch.Tensor, starts: torch.Tensor,
                   new_len: torch.Tensor, kernels: str = "auto") -> KVCache:
    """The int8 write (kernel I, in place of ``_write_kernel_quant``):
    quantize bf16 new rows [B, T, K, D] in the cache's numerics and write
    values and scales at ``starts`` for rows t < new_len (the rules of
    :func:`update_cache_at_layer`)."""
    if not use_kernel(kernels, new_k):
        return update_cache_at_layer_torch(cache, layer, new_k, new_v,
                                           starts, new_len)
    from llm_inference_engine_tpu_torch.ops import _native
    _check_write(cache, layer, new_k, new_v, starts, new_len,
                 "kv_write_quant")
    L, B, S, K, D = cache.k.shape
    status = _native.library().kv_write_quant(
        new_k.data_ptr(), new_v.data_ptr(), cache.k.data_ptr(),
        cache.v.data_ptr(), cache.k_scale.data_ptr(),
        cache.v_scale.data_ptr(), starts.data_ptr(), new_len.data_ptr(),
        int(layer), B, new_k.shape[1], K, S, D, int(cache.snapped),
        _native.stream_of(new_k))
    _native.check(status, "kv_write_quant")
    kv_write_quant.launches += 1
    kernel_output("kv_write_quant", cache.k_scale, cache.v_scale,
                  layer=layer)
    return cache


kv_write_quant.launches = 0

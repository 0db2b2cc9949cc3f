"""Weight-only INT8 / INT4 quantization with the dequant fused into the matmul.

Port of ``llm_inference_engine_tpu/ops/quant.py``. Storage layouts and
numerics are the JAX package's:

- INT8: per-output-channel absmax scales. ``q`` int8 [in, out], ``scale``
  f32 [1, out]. The product accumulates in f32 over the exact int8 -> bf16
  cast of the weights; the scale multiplies the f32 result once.
- INT4: two signed 4-bit values per byte along the contraction axis (byte
  r holds row 2r in the low nibble and row 2r+1 in the high one), grouped
  scales. ``q`` int8 [in/2, out], ``scale`` f32 [in/group, out]. Each
  scale group's f32 partial product is multiplied by that group's scale and
  accumulated in f32.

Stacked weights carry a leading [L]; the gate|up stack is [L, 2, in', I]
with the 2-axis leading. Indexing a :class:`QuantizedTensor` by layer
gives one of views (no copy): the torch counterpart of the JAX package's
scalar-prefetched layer index.

Routing follows the JAX package: at m < 1024 rows the fused kernels run,
E (``int4_matmul``) or F (``int8_matmul``), CUDA C++ in
``csrc/quant_matmul.cu``, in one of two modes that
:func:`quant_matmul_plan` describes (a decode mode at m <= 16, split-K
over a thread-block cluster; a prefill mode on wgmma above); at m >= 1024
(``_PREFILL_M``) the weight is dequantized once to bf16 (INT4: kernel G, ``dequant_int4``, Triton in
``_triton_kernels.py``; INT8: an exact cast) and a plain bf16
``torch.matmul`` with f32 accumulation runs, as the JAX package's
``_large_m_linear`` leaves that product to XLA. The INT4 large-m path
bakes the scale into the bf16 weight: one extra rounding (~2^-9 relative)
that the fused path does not have.

On CPU tensors, or with ``kernels="torch"``, every op runs its plain
version (same routing, same rounding points). On a CUDA tensor the
kernels launch or the wrapper raises. The TPU block planning
(``_plan_blocks``, ``_pick_bk``, ``_plan_dequant_blocks``, ``_pad_rows8``)
has no counterpart: it budgeted VMEM and Mosaic tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from llm_inference_engine_tpu_torch.utils import cdiv, use_kernel
from llm_inference_engine_tpu_torch.utils.checks import kernel_output

__all__ = [
    "QuantizedTensor",
    "quantize_tensor",
    "search_clip",
    "dequantize_tensor",
    "quantized_linear",
    "quantized_linear_torch",
    "int4_matmul",
    "int4_matmul_torch",
    "int8_matmul",
    "int8_matmul_torch",
    "dequant_int4",
    "dequant_int4_torch",
    "quant_matmul_plan",
    "quant_matmul_plan_native",
    "cluster_k_ranges",
]

_PREFILL_M = 1024   # m >= this dequantizes once and runs a bf16 matmul

# The plan of kernels E and F (``make_plan`` in csrc/quant_matmul.cu; a
# card test holds the two equal).
_DECODE_M = 16             # m <= this: the decode mode
_DEC_COLS = 64             # output columns of a decode block
_INT8_UNIT = 128           # K rows of an INT8 split unit
_DEC_STAGE_K = {True: 256, False: 128}   # K rows a decode stage (INT4, INT8)
_DEC_STAGES = {True: 3, False: 4}        # decode ring stages
_MAX_CLUSTER = 8
_PRE_COLS = 128            # output columns of a prefill block
_PRE_K = 128               # K elements a prefill stage
_PRE_STAGES = 4
_PLAN_KEYS = ("mode", "rows", "cols", "cluster", "blocks", "stages",
              "smem_bytes")


@dataclasses.dataclass
class QuantizedTensor:
    """Quantized [in, out] weight (optionally stacked).

    mode="int8": q int8 [..., in, out], scale f32 [..., 1, out]
    mode="int4": q int8 [..., in//2, out] (row 2r in the low nibble of byte
                 r, row 2r+1 in the high nibble), scale f32
                 [..., in//group, out]
    A 3-D ``q`` seen by :func:`quantized_linear` is one layer of the
    gate|up stack, [2, in', I].
    """

    q: torch.Tensor
    scale: torch.Tensor
    mode: str = "int8"
    group_size: int = 128

    @property
    def shape(self):
        if self.mode == "int4":
            return (*self.q.shape[:-2], self.q.shape[-2] * 2,
                    self.q.shape[-1])
        return tuple(self.q.shape)

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4

    def numel(self) -> int:
        """Stored elements (q and scale), as the JAX package counts leaves."""
        return self.q.numel() + self.scale.numel()

    def __getitem__(self, i) -> "QuantizedTensor":
        """Index the leading axis of q and scale alike (views, no copy)."""
        return QuantizedTensor(self.q[i], self.scale[i], self.mode,
                               self.group_size)


def _pack_int4(qvals: torch.Tensor, group_size: int = 0) -> torch.Tensor:
    """[in, out] int8 in [-8, 7] -> [in//2, out] packed: byte r =
    (row 2r & 0xF) | (row 2r+1 << 4). ``group_size`` is accepted for API
    symmetry; the packing is group-agnostic."""
    del group_size
    lo = qvals[0::2].to(torch.int32) & 0xF
    hi = (qvals[1::2].to(torch.int32) & 0xF) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def _unpack_int4(packed: torch.Tensor, group_size: int = 0) -> torch.Tensor:
    """[..., in//2, out] packed -> [..., in, out] int8 (signed nibbles);
    inverse of :func:`_pack_int4`."""
    del group_size
    *lead, k2, n = packed.shape
    b = packed.to(torch.int32)
    lo = (b << 28) >> 28                  # sign-extend the low nibble
    hi = b >> 4                           # high nibble (signed)
    out = torch.stack([lo, hi], dim=-2)   # [..., k2, 2, n]
    return out.reshape(*lead, k2 * 2, n).to(torch.int8)


def quantize_tensor(w: torch.Tensor, mode: str = "int8",
                    group_size: int = 128,
                    clip: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Quantize a [in, out] weight (absmax, symmetric), bit for bit as the
    JAX package does.

    ``clip``: optional per-scale-block factors in (0, 1], [1, out] for
    int8 and [in/group, out] for int4 (from :func:`search_clip`), that
    shrink the absmax before the scale is derived."""
    w = w.to(torch.float32)
    k, n = w.shape
    if mode == "int8":
        absmax = w.abs().amax(dim=0, keepdim=True)                 # [1, out]
        if clip is not None:
            absmax = absmax * clip.reshape(1, n)
        scale = absmax.clamp_min(1e-8) / 127.0
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return QuantizedTensor(q=q, scale=scale, mode="int8",
                               group_size=group_size)
    if mode == "int4":
        if k % group_size:
            raise ValueError(f"in dim {k} not divisible by group {group_size}")
        wg = w.reshape(k // group_size, group_size, n)
        absmax = wg.abs().amax(dim=1, keepdim=True)                # [G,1,N]
        if clip is not None:
            absmax = absmax * clip.reshape(k // group_size, 1, n)
        scale = absmax.clamp_min(1e-8) / 7.0
        q = torch.clamp(torch.round(wg / scale), -8, 7).to(torch.int8)
        return QuantizedTensor(q=_pack_int4(q.reshape(k, n)),
                               scale=scale[:, 0, :], mode="int4",
                               group_size=group_size)
    raise ValueError(f"unknown quant mode {mode!r}")


_CLIP_GRID = tuple(1.0 - 0.05 * i for i in range(11))    # 1.00 .. 0.50


def search_clip(w: torch.Tensor, mode: str = "int4", group_size: int = 128,
                act_sq: Optional[torch.Tensor] = None,
                grid=_CLIP_GRID) -> torch.Tensor:
    """Clip factors for :func:`quantize_tensor` minimizing the
    ``act_sq``-weighted weight error per scale block (the JAX package's
    AWQ-lite grid search). Returns [1, out] (int8) or [in/group, out]
    (int4)."""
    w = w.to(torch.float32)
    k, n = w.shape
    g = group_size if mode == "int4" else k
    if k % g:
        raise ValueError(f"in dim {k} not divisible by group {g}")
    qmax = 7.0 if mode == "int4" else 127.0
    wg = w.reshape(k // g, g, n)
    d = (torch.ones((k,), dtype=torch.float32, device=w.device)
         if act_sq is None else act_sq.to(torch.float32).reshape(k))
    dg = d.reshape(k // g, g, 1)
    absmax = wg.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)

    best_err = best_clip = None
    for alpha in grid:
        scale = absmax * alpha / qmax                              # [G,1,N]
        q = torch.clamp(torch.round(wg / scale), -qmax - 1, qmax)
        err = torch.sum(dg * (wg - q * scale) ** 2, dim=1)         # [G, N]
        if best_err is None:
            best_err, best_clip = err, torch.full_like(err, alpha)
        else:
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_clip = torch.where(take, torch.full_like(err, alpha),
                                    best_clip)
    return best_clip if mode == "int4" else best_clip.reshape(1, n)


def dequantize_tensor(t: QuantizedTensor) -> torch.Tensor:
    """Full dequantization to f32 (golden reference / debugging only)."""
    if t.mode == "int8":
        return t.q.to(torch.float32) * t.scale
    q = _unpack_int4(t.q).to(torch.float32)                        # [in, out]
    k, n = q.shape
    qg = q.reshape(k // t.group_size, t.group_size, n)
    return (qg * t.scale[:, None, :]).reshape(k, n)


# ---------------------------------------------------------------------------
# plain versions of kernels E, F and G
# ---------------------------------------------------------------------------

def _halves(q: torch.Tensor, scale: torch.Tensor):
    """[(q, scale)] for a 2-D weight, two pairs for the [2, in', I] stack."""
    if q.dim() == 3:
        return [(q[0], scale[0]), (q[1], scale[1])]
    return [(q, scale)]


def _cat(outs):
    """Concatenate the halves' outputs (no copy for a single one)."""
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def int4_matmul_torch(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      group_size: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of kernel E: x2 [m, k] times the int4 weight (2-D or
    the [2, k/2, I] gate|up stack, flat [m, gate | up] out). One f32
    partial product per scale group, times that group's scale, summed in
    f32 (group chunks are batched to bound the temporaries)."""
    m, k = x2.shape
    G = k // group_size
    xg = x2.to(torch.float32).reshape(m, G, group_size).transpose(0, 1)
    outs = []
    for qh, sh in _halves(q, scale):
        n = qh.shape[-1]
        wg = _unpack_int4(qh).to(torch.float32).reshape(G, group_size, n)
        acc = torch.zeros((m, n), dtype=torch.float32, device=x2.device)
        step = max(1, (1 << 24) // max(1, m * n))
        for g0 in range(0, G, step):
            part = torch.bmm(xg[g0:g0 + step], wg[g0:g0 + step])   # [s, m, n]
            acc += (part * sh[g0:g0 + step, None, :]).sum(0)
        outs.append(acc)
    return _cat(outs).to(out_dtype)


def int8_matmul_torch(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of kernel F: f32 accumulation of x2 times the int8
    weight (exact cast), the per-channel scale applied once at the end."""
    xf = x2.to(torch.float32)
    outs = [(xf @ qh.to(torch.float32)) * sh.reshape(1, -1)
            for qh, sh in _halves(q, scale)]
    return _cat(outs).to(out_dtype)


def dequant_int4_torch(q: torch.Tensor, scale: torch.Tensor,
                       group_size: int) -> torch.Tensor:
    """Plain version of kernel G: packed [k/2, n] + scales [k/group, n] ->
    bf16 [k, n] = bf16(f32(nibble) * scale), rounded once."""
    qi = _unpack_int4(q).to(torch.float32)
    k, n = qi.shape
    qg = qi.reshape(k // group_size, group_size, n)
    return (qg * scale[:, None, :]).reshape(k, n).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the plan of kernels E and F
# ---------------------------------------------------------------------------

def _decode_split(m: int, k: int, n: int, halves: int, int4: bool,
                  group: int, sms: int):
    """(split unit in K rows, split units, blocks a cluster) of the decode
    mode: the smallest power-of-two cluster (<= 8, >= 2 units a rank) that
    gives >= 2 blocks an SM."""
    su = group if int4 else _INT8_UNIT
    nsu = cdiv(k, su)
    tiles = cdiv(n, _DEC_COLS) * halves
    cs = 1
    while cs < _MAX_CLUSTER and 2 * cs <= nsu and tiles * cs < 2 * sms:
        cs *= 2
    return su, nsu, cs


def quant_matmul_plan(m: int, k: int, n: int, halves: int = 1, *,
                      int4: bool = True, group: int = 128,
                      sms: int = 132) -> dict:
    """Kernel E's (``int4``) or F's plan for x [m, k] times a [k, n] weight
    (``halves`` = 2: the gate|up stack) on ``sms`` SMs, as
    ``csrc/quant_matmul.cu`` makes it: mode ("decode" at m <= 16 with
    INT4 groups of 64 or 128, else "prefill"), x rows and output columns a
    block, blocks a cluster along K, blocks, ring stages and dynamic shared
    memory a block. Pure Python: the CPU tests call it;
    :func:`quant_matmul_plan_native` asks the built library."""
    if m <= _DECODE_M and (not int4 or group in (64, 128)):
        rows = 8 if m <= 8 else 16
        _, _, cs = _decode_split(m, k, n, halves, int4, group, sms)
        stages, kk = _DEC_STAGES[int4], _DEC_STAGE_K[int4]
        stage = (128 * _DEC_COLS + rows * (kk * 2 + 16)
                 + (kk // 64 * _DEC_COLS * 4 if int4 else 0))
        return dict(mode="decode", rows=rows, cols=_DEC_COLS, cluster=cs,
                    blocks=cdiv(n, _DEC_COLS) * halves * cs, stages=stages,
                    smem_bytes=1024 + stages * stage + 8 * stages)
    rows = 64 if m <= 64 else 128
    stage = rows * _PRE_K * 2 + (_PRE_K // 2 if int4 else _PRE_K) * _PRE_COLS
    return dict(mode="prefill", rows=rows, cols=_PRE_COLS, cluster=1,
                blocks=cdiv(n, _PRE_COLS) * halves * cdiv(m, rows),
                stages=_PRE_STAGES,
                smem_bytes=1024 + _PRE_STAGES * stage + 2 * _PRE_STAGES * 8)


def cluster_k_ranges(m: int, k: int, n: int, halves: int = 1, *,
                     int4: bool = True, group: int = 128,
                     sms: int = 132) -> list:
    """The K rows [lo, hi) of each cluster rank in the decode mode: whole
    split units, balanced (rank r takes units [r u / c, (r + 1) u / c))."""
    su, nsu, cs = _decode_split(m, k, n, halves, int4, group, sms)
    return [(r * nsu // cs * su, min((r + 1) * nsu // cs * su, k))
            for r in range(cs)]


def quant_matmul_plan_native(m: int, k: int, n: int, halves: int = 1, *,
                             int4: bool = True, group: int = 128) -> dict:
    """The plan from the built library on the card (``quant_matmul_plan``
    in ``csrc/quant_matmul.cu``), with the blocks an SM holds."""
    import ctypes
    from llm_inference_engine_tpu_torch.ops import _native
    out = (ctypes.c_int * 8)()
    status = _native.library().quant_matmul_plan(m, k, n, halves, int(int4),
                                                 group, out)
    _native.check(status, "quant_matmul_plan")
    plan = dict(zip(_PLAN_KEYS + ("blocks_per_sm",), out))
    plan["mode"] = ("decode", "prefill")[plan["mode"]]
    return plan


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_fused(name, x2, q, scale, out_dtype, int4: bool, group_size: int):
    """Validate the inputs of kernels E/F; returns (halves, k, n)."""
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x2.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: need int8 q and float32 scale, got "
                        f"{q.dtype} / {scale.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: out dtype must be bf16 or f32, got "
                        f"{out_dtype}")
    if q.dim() not in (2, 3) or scale.dim() != q.dim():
        raise ValueError(f"{name}: q {tuple(q.shape)} / scale "
                         f"{tuple(scale.shape)} are not [k', n] or "
                         "[2, k', I]")
    for t in (x2, q, scale):
        if t.device != x2.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    halves = 2 if q.dim() == 3 else 1
    if halves == 2 and q.shape[0] != 2:
        raise ValueError(f"{name}: a 3-D q must be the [2, k', I] stack")
    m, k = x2.shape
    n = q.shape[-1]
    kr = k // 2 if int4 else k
    groups = k // group_size if int4 else 1
    if q.shape[-2] != kr or scale.shape[-2:] != (groups, n):
        raise ValueError(f"{name}: x [{m}, {k}] does not fit q "
                         f"{tuple(q.shape)} / scale {tuple(scale.shape)}")
    if int4 and (group_size % 64 or k % group_size):
        raise ValueError(f"{name}: the kernel needs group_size % 64 == 0 "
                         f"and k % group_size == 0 (k {k}, group "
                         f"{group_size})")
    if k % 8 or n % 16:
        raise ValueError(f"{name}: the kernel's 16-byte copies need k % 8 "
                         f"== 0 and n % 16 == 0 (k {k}, n {n})")
    if x2.data_ptr() % 16 or q.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError(f"{name}: x, q and scale must be 16-byte aligned")
    return halves, k, n


def _launch_fused(name, x2, q, scale, out_dtype, int4, group_size):
    from llm_inference_engine_tpu_torch.ops import _native
    halves, k, n = _check_fused(name, x2, q, scale, out_dtype, int4,
                                group_size)
    m = x2.shape[0]
    out = torch.empty((m, halves * n), dtype=out_dtype, device=x2.device)
    if m == 0:
        return out
    q_half = q.shape[-2] * n if halves == 2 else 0
    s_half = scale.shape[-2] * n if halves == 2 else 0
    lib = _native.library()
    args = (x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, halves, q_half, s_half)
    if int4:
        status = lib.int4_matmul(*args, group_size,
                                 int(out_dtype == torch.float32),
                                 _native.stream_of(x2))
    else:
        status = lib.int8_matmul(*args, int(out_dtype == torch.float32),
                                 _native.stream_of(x2))
    _native.check(status, name)
    return out


def int4_matmul(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                group_size: int, out_dtype: torch.dtype, *,
                kernels: str = "auto") -> torch.Tensor:
    """Kernel E (W4A16 fused dequant-matmul, ``csrc/quant_matmul.cu``):
    x2 bf16 [m, k] times the packed int4 weight [k/2, n] (or the
    [2, k/2, I] gate|up stack in one launch, flat [m, 2I] out) with
    grouped scales; out bf16 or f32."""
    if not use_kernel(kernels, x2):
        return int4_matmul_torch(x2, q, scale, group_size, out_dtype)
    out = _launch_fused("int4_matmul", x2, q, scale, out_dtype, True,
                        group_size)
    int4_matmul.launches += 1
    kernel_output("int4_matmul", out)
    return out


int4_matmul.launches = 0


def int8_matmul(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype, *,
                kernels: str = "auto") -> torch.Tensor:
    """Kernel F (W8A16 fused dequant-matmul, ``csrc/quant_matmul.cu``):
    x2 bf16 [m, k] times int8 [k, n] (or [2, k, I]) with the per-channel
    scale [1, n] applied to the f32 accumulator."""
    if not use_kernel(kernels, x2):
        return int8_matmul_torch(x2, q, scale, out_dtype)
    out = _launch_fused("int8_matmul", x2, q, scale, out_dtype, False, 0)
    int8_matmul.launches += 1
    kernel_output("int8_matmul", out)
    return out


int8_matmul.launches = 0


def dequant_int4(q: torch.Tensor, scale: torch.Tensor, group_size: int, *,
                 kernels: str = "auto") -> torch.Tensor:
    """Kernel G (Triton): packed int4 [k/2, n] + scales [k/group, n] ->
    bf16 [k, n]. The [2, k/2, I] gate|up stack gives the flat [k, 2I]
    weight (one launch per half, each writing its columns in place)."""
    if not use_kernel(kernels, q):
        return _cat([dequant_int4_torch(qh, sh, group_size)
                     for qh, sh in _halves(q, scale)])
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"dequant_int4: need int8 q and float32 scale, got "
                        f"{q.dtype} / {scale.dtype}")
    if q.dim() not in (2, 3) or scale.dim() != q.dim():
        raise ValueError(f"dequant_int4: q {tuple(q.shape)} / scale "
                         f"{tuple(scale.shape)} are not [k/2, n] or "
                         "[2, k/2, I]")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequant_int4: q and scale must be contiguous")
    if scale.device != q.device:
        raise ValueError("dequant_int4: q and scale on different devices")
    k, n = q.shape[-2] * 2, q.shape[-1]
    if group_size % 2 or k % group_size or scale.shape[-2:] != (
            k // group_size, n):
        raise ValueError(f"dequant_int4: scale {tuple(scale.shape)} does not "
                         f"fit q {tuple(q.shape)} at group {group_size}")
    from llm_inference_engine_tpu_torch.ops import _native
    _native.triton()
    from llm_inference_engine_tpu_torch.ops import _triton_kernels
    pairs = _halves(q, scale)
    out = torch.empty((k, len(pairs) * n), dtype=torch.bfloat16,
                      device=q.device)
    for h, (qh, sh) in enumerate(pairs):
        _triton_kernels.dequant_int4(qh, sh, out[:, h * n:], group_size)
        dequant_int4.launches += 1
    kernel_output("dequant_int4", out)
    return out


dequant_int4.launches = 0


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result: bf16 products accumulate in f32 and are
    never rounded through bf16 (``preferred_element_type=f32``)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)   # bf16 products exact


def _large_m_linear(x2, t: QuantizedTensor, out_dtype, kernels):
    """m >= _PREFILL_M: dequantize the weight once to bf16 and run one
    plain bf16 matmul with f32 accumulation (JAX ``_large_m_linear``).
    INT8 casts exactly and scales the f32 result; INT4 bakes the grouped
    scales into the bf16 weight (kernel G)."""
    if t.mode == "int4":
        w = dequant_int4(t.q, t.scale, t.group_size, kernels=kernels)
        post = None
    else:
        w = _cat([qh.to(torch.bfloat16) for qh, _ in _halves(t.q, t.scale)])
        post = _cat([sh.reshape(1, -1) for _, sh in _halves(t.q, t.scale)])
    y = _mm_f32(x2.to(torch.bfloat16), w)
    if post is not None:
        y = y * post
    return y.to(out_dtype)


def quantized_linear(x: torch.Tensor, t: QuantizedTensor,
                     out_dtype: Optional[torch.dtype] = None, *,
                     kernels: str = "auto") -> torch.Tensor:
    """y = x @ dequant(t). x: [..., in]; ``t.q`` [in', out] or one layer of
    the gate|up stack [2, in', I] (then y is the flat [..., gate | up]).

    m = prod(x.shape[:-1]) < 1024 runs kernel E (int4) or F (int8);
    larger m dequantizes once (kernel G for int4) and runs a bf16 matmul.
    ``out_dtype=torch.float32`` (the lm_head) is never rounded to bf16."""
    out_dtype = out_dtype or x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    halves = 2 if t.q.dim() == 3 else 1
    n_out = halves * t.q.shape[-1]
    if t.mode not in ("int8", "int4"):
        raise ValueError(f"unknown quant mode {t.mode!r}")
    if x2.shape[0] >= _PREFILL_M:
        y = _large_m_linear(x2, t, out_dtype, kernels)
    elif t.mode == "int4":
        y = int4_matmul(x2, t.q, t.scale, t.group_size, out_dtype,
                        kernels=kernels)
    else:
        y = int8_matmul(x2, t.q, t.scale, out_dtype, kernels=kernels)
    return y.reshape(*lead, n_out)


def quantized_linear_torch(x: torch.Tensor, t: QuantizedTensor,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Plain version of :func:`quantized_linear`: the same routing and
    rounding points, every kernel replaced by its plain version."""
    return quantized_linear(x, t, out_dtype, kernels="torch")

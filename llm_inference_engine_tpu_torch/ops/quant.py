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
``csrc/quant_matmul.cuh`` (built for bf16 by ``quant_matmul.cu``), in one
of two modes that
:func:`quant_matmul_plan` describes (a decode mode at m <= 16 and at
17-48 where n is narrow, split-K over a thread-block cluster; a prefill
mode on wgmma otherwise); at m >= 1024
(``_PREFILL_M``) the weight is dequantized once to bf16 (INT4: kernel
G, ``dequant_int4``; INT8: kernel G8, ``dequant_int8``, an exact cast
written in place for both halves of the gate|up stack, its per-column
scale applied to the f32 product and rounded in one pass,
``int8_scale_cast``; all Triton in ``_triton_kernels.py``) and a plain
bf16 ``torch.matmul`` with f32 accumulation runs, as the JAX package's
``_large_m_linear`` leaves that product to XLA. The INT4 large-m path
bakes the scale into the bf16 weight: one extra rounding (~2^-9 relative)
that the fused path does not have.

At m <= 16 an INT4 bf16 or float16 x takes E's fragment mode, which
reads a second copy of the weight in tensor-core fragment order
(:func:`repack_int4_decode`, kept on the card as ``QuantizedTensor.qd``
beside ``q``, built once per weight by :func:`add_decode_layouts` when an
engine is made): a call there without it raises.

A float16 or float32 x takes the float instances Ef / Ff
(:func:`int4_matmul_float`, :func:`int8_matmul_float`; the C entry points
suffixed ``_f16`` / ``_f32``): float16 is E/F's template over ``__half``
(``csrc/quant_matmul_f16.cu``, the same tensor-core modes), float32 runs
on the CUDA cores with E/F's decode skeleton and a register-tiled prefill
mode (``csrc/quant_matmul_f32.cu``); one launch a matmul, no workspace,
the plan :func:`quant_matmul_plan` with ``dtype``. At m >= 1024 x is cast
to bf16 as the JAX package's large-m path does.

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
    "int4_matmul_float",
    "int8_matmul_float",
    "dequant_int4",
    "dequant_int4_torch",
    "dequant_int8",
    "dequant_int8_torch",
    "int8_scale_cast",
    "int8_scale_cast_torch",
    "quant_matmul_plan",
    "quant_matmul_plan_native",
    "cluster_k_ranges",
    "fragment_k_slices",
    "repack_int4_decode",
    "unpack_int4_decode",
    "int4_matmul_decode_torch",
    "needs_decode_layout",
    "add_decode_layout",
    "add_decode_layouts",
]

_PREFILL_M = 1024   # m >= this dequantizes once and runs a bf16 matmul
# the x dtypes of the float instances Ef / Ff (csrc/quant_matmul_f16.cu,
# csrc/quant_matmul_f32.cu)
FLOAT_X_DTYPES = (torch.float16, torch.float32)

# The plan of kernels E and F and of their float instances (``make_plan``
# in csrc/quant_matmul.cuh; a card test holds the two equal).
_DECODE_M = 48             # m <= this: the decode mode
_DECODE_M_F32 = 16         # the same for the float32 instances
_DEC_COLS = 64             # output columns of a decode block
_INT8_UNIT = 128           # K rows of an INT8 split unit
_DEC_STAGE_K = {True: 256, False: 128}   # K rows a decode stage (INT4, INT8)
_DEC_STAGES = {True: 3, False: 4}        # decode ring stages (INT8 3 at
                                         # 32 and 48 rows)
_MAX_CLUSTER = 8
_MIN_RANK_K = 256          # K rows a decode cluster rank keeps at least
_PRE_COLS = 128            # output columns of a prefill block
_PRE_K = 128               # K elements a prefill stage
_PRE_STAGES = 4
_F32_SLICES = 8            # K slices of a float32 decode block
_PRE_F32_ROWS, _PRE_F32_K, _PRE_F32_STAGES = 128, 32, 4   # float32 prefill
_PLAN_KEYS = ("mode", "rows", "cols", "cluster", "blocks", "stages",
              "smem_bytes")
_PLAN_MODES = ("decode", "prefill", "fragment")
# E's fragment mode (INT4, bf16 / float16 x, m <= 16; ``frag_plan`` in
# csrc/quant_matmul.cuh): warps of 64 columns (four m16 tiles), 4 a block
# split into WC column groups x 4 / WC K slices, a cluster of CS blocks
# along K; chunks of 64 K rows (a lane's 16 bytes a tile)
_FRAG_WARP_COLS = 64
_FRAG_TILE_COLS = 16
_FRAG_CHUNK_K = 64
_FRAG_BUFS = 3             # chunks a lane holds: two in flight, one in use
_FRAG_MIN_SLICE_K = 128    # K rows a warp's slice keeps on average
_FRAG_FILL_SLICE_K = 256   # ... to count as filling the card
_FRAG_OCC = {8: 4, 16: 3}  # blocks an SM its launch bounds allow (rows)
_FRAG_FILL = 256           # blocks (1024 warps) that fill the card
_RED_PITCH = _DEC_COLS + 4
_SMEM_MAX = 232448


@dataclasses.dataclass
class QuantizedTensor:
    """Quantized [in, out] weight (optionally stacked).

    mode="int8": q int8 [..., in, out], scale f32 [..., 1, out]
    mode="int4": q int8 [..., in//2, out] (row 2r in the low nibble of byte
                 r, row 2r+1 in the high nibble), scale f32
                 [..., in//group, out]
    A 3-D ``q`` seen by :func:`quantized_linear` is one layer of the
    gate|up stack, [2, in', I].

    ``qd`` (INT4, on the card only): ``q``'s bytes in tensor-core fragment
    order (:func:`repack_int4_decode`), what kernel E's fragment mode
    reads at m <= 16; None until :func:`add_decode_layout` builds it.
    ``q`` stays the layout of checkpoints, shards and every other route.
    """

    q: torch.Tensor
    scale: torch.Tensor
    mode: str = "int8"
    group_size: int = 128
    qd: Optional[torch.Tensor] = None

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
        """Index the leading axis of q, scale (and qd) alike (views, no
        copy)."""
        return QuantizedTensor(self.q[i], self.scale[i], self.mode,
                               self.group_size,
                               None if self.qd is None else self.qd[i])

    def to(self, device) -> "QuantizedTensor":
        """The same weight on ``device``: itself where it is there already
        (so a fragment-order copy built later is built once), else a copy
        that takes ``qd`` along to another CUDA device and drops it
        elsewhere."""
        q, scale = self.q.to(device), self.scale.to(device)
        if q is self.q and scale is self.scale:
            return self
        qd = self.qd.to(device) if (self.qd is not None
                                    and q.is_cuda) else None
        return QuantizedTensor(q, scale, self.mode, self.group_size, qd)

    def columns(self, start: int, stop: int) -> "QuantizedTensor":
        """Output columns [start, stop) of q and scale alike: a column
        shard (contiguous copies; a shard builds its own ``qd``)."""
        return QuantizedTensor(self.q[..., start:stop].contiguous(),
                               self.scale[..., start:stop].contiguous(),
                               self.mode, self.group_size)

    def rows(self, start: int, stop: int) -> "QuantizedTensor":
        """Contraction rows [start, stop): a row shard (contiguous copies).
        INT4 takes q's byte rows [start/2, stop/2) and the scale groups
        [start/group, stop/group), so both ends must be whole groups; INT8
        keeps its per-output-channel scale whole."""
        if self.mode == "int4":
            g = self.group_size
            if start % g or stop % g:
                raise ValueError(
                    f"int4 row shard [{start}, {stop}) splits a scale group "
                    f"of {g}: a shard's rows must be whole groups")
            return QuantizedTensor(
                self.q[..., start // 2:stop // 2, :].contiguous(),
                self.scale[..., start // g:stop // g, :].contiguous(),
                self.mode, g)
        return QuantizedTensor(self.q[..., start:stop, :].contiguous(),
                               self.scale.contiguous(), self.mode,
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


# ---------------------------------------------------------------------------
# the fragment order of kernel E's fragment mode
# ---------------------------------------------------------------------------
#
# One matrix's bytes (q [k/2, n], k % 64 == 0, n % 16 == 0) in the order
# [n/16 tiles][k/64 chunks][32 lanes][4 k16 steps][4 bytes]: the 512 bytes
# of a (tile, chunk) are the JAX tile of 32 stored rows x 16 columns, and
# lane l = 4g + t holds, for each k16 step j of the chunk, one 32-bit word:
# the A fragment of mma.sync m16n8k16 for the tile's 16 columns (A rows g
# and g + 8 are columns 2g and 2g + 1) at K rows 64c + 16j + ...: register
# i (0..3) holds K rows (2t, 2t + 1) + 8 (i >> 1) of column 2g + (i & 1),
# its even row's nibble at bits 4i of the word and its odd row's at bits
# 16 + 4i. So one 128-bit load gives a lane a tile's four k16 steps, and
# (w >> 4i) & 0x000F000F lifts register i's two K rows into the two
# halves of a pair. The permuted axes, K = 64c + 16j + 8kh + 2t + odd and
# column = 16T + 2g + jl, word nibble = 4 odd + 2 kh + jl:
_FRAG_SPLIT = (4, 2, 4, 2)        # K within a chunk: j, kh, t, odd
_FRAG_COLS = (8, 2)               # columns within a tile: g, jl
_FRAG_PERM = (5, 0, 6, 3, 1, 4, 2, 7)   # (c, j, kh, t, odd, T, g, jl) ->
                                        # (T, c, g, t, j, odd, kh, jl)
_FRAG_INV = tuple(_FRAG_PERM.index(i) for i in range(8))


def _frag_check(name: str, q: torch.Tensor) -> tuple:
    if q.dtype != torch.int8 or q.dim() < 2:
        raise ValueError(f"{name}: need an int8 [..., k/2, n] tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    k2, n = q.shape[-2:]
    if (2 * k2) % _FRAG_CHUNK_K or n % _FRAG_TILE_COLS:
        raise ValueError(f"{name}: the fragment order needs k % 64 == 0 "
                         f"and n % 16 == 0 (k {2 * k2}, n {n})")
    return k2, n


def _nibbles(b: torch.Tensor) -> torch.Tensor:
    """uint8 bytes [...] -> their nibbles [..., 2] (low first)."""
    return torch.stack([b & 0xF, b >> 4], dim=-1)


def _repack_one(q: torch.Tensor) -> torch.Tensor:
    k2, n = q.shape
    k = 2 * k2
    nib = _nibbles(q.contiguous().view(torch.uint8))     # [k2, n, 2]
    nib = nib.transpose(1, 2).reshape(k, n)              # row 2r, 2r + 1
    v = nib.reshape(k // _FRAG_CHUNK_K, *_FRAG_SPLIT, n // _FRAG_TILE_COLS,
                    *_FRAG_COLS).permute(_FRAG_PERM).reshape(-1, 2)
    return (v[:, 0] | (v[:, 1] << 4)).view(torch.int8).reshape(k2, n)


def _unrepack_one(qd: torch.Tensor) -> torch.Tensor:
    k2, n = qd.shape
    k = 2 * k2
    v = _nibbles(qd.contiguous().view(torch.uint8).reshape(-1))
    nib = v.reshape(n // _FRAG_TILE_COLS, k // _FRAG_CHUNK_K, _FRAG_COLS[0],
                    _FRAG_SPLIT[2], _FRAG_SPLIT[0], _FRAG_SPLIT[3],
                    _FRAG_SPLIT[1], _FRAG_COLS[1]).permute(_FRAG_INV)
    nib = nib.reshape(k, n)
    return (nib[0::2] | (nib[1::2] << 4)).view(torch.int8)


def _per_matrix(fn, t: torch.Tensor) -> torch.Tensor:
    """``fn`` over each [k/2, n] matrix of ``t`` [..., k/2, n] (a matrix at
    a time, to bound the temporaries)."""
    flat = t.reshape(-1, *t.shape[-2:])
    out = torch.empty_like(flat)
    for i in range(flat.shape[0]):
        out[i] = fn(flat[i])
    return out.reshape(t.shape)


def repack_int4_decode(q: torch.Tensor) -> torch.Tensor:
    """The packed INT4 weight q int8 [..., k/2, n] (the JAX layout: a
    matrix, the [2, k/2, I] gate|up stack, or either stacked over layers)
    in the fragment order kernel E's fragment mode reads: the same shape
    and bytes, each matrix's nibbles permuted within its tiles of 32
    stored rows x 16 columns (k % 64 == 0, n % 16 == 0). Pure torch, on
    q's device; :func:`unpack_int4_decode` inverts it bit for bit."""
    _frag_check("repack_int4_decode", q)
    return _per_matrix(_repack_one, q)


def unpack_int4_decode(qd: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`repack_int4_decode`: the JAX layout again."""
    _frag_check("unpack_int4_decode", qd)
    return _per_matrix(_unrepack_one, qd)


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d as an IEEE divide, as the JAX package computes it on every
    device: PyTorch on a CUDA tensor turns a divide by a Python number
    into a multiply by its reciprocal, which can differ in the last bit
    (and then move a quantized value across a rounding edge)."""
    return t / torch.full_like(t, d)


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
        scale = _div(absmax.clamp_min(1e-8), 127.0)
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
        scale = _div(absmax.clamp_min(1e-8), 7.0)
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
        scale = _div(absmax * alpha, qmax)                         # [G,1,N]
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

def _parts(t: torch.Tensor):
    """[t] for a 2-D weight (or its scales), the two halves of the
    [2, in', I] stack."""
    return [t[0], t[1]] if t.dim() == 3 else [t]


def _halves(q: torch.Tensor, scale: torch.Tensor):
    """[(q, scale)] for a 2-D weight, two pairs for the [2, in', I] stack."""
    return list(zip(_parts(q), _parts(scale)))


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


def int4_matmul_decode_torch(x2: torch.Tensor, qd: torch.Tensor,
                             scale: torch.Tensor, group_size: int,
                             out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of kernel E's fragment mode: the fragment-order
    weight ``qd`` back in the JAX layout (:func:`unpack_int4_decode`),
    then :func:`int4_matmul_torch`. The tests and chip_smoke hold the
    kernel against it; no main path runs it."""
    return int4_matmul_torch(x2, unpack_int4_decode(qd), scale, group_size,
                             out_dtype)


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


def dequant_int8_torch(q: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel G8: int8 [k, n] (or the [2, k, I] gate|up
    stack) -> bf16 [k, n] (flat [k, 2I]), each value cast exactly."""
    return _cat([qh.to(torch.bfloat16) for qh in _parts(q)])


def int8_scale_cast_torch(y: torch.Tensor, scale: torch.Tensor,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of G8's epilogue: the f32 product y [m, n] times the
    per-column scale [1, n], rounded once to ``out_dtype``."""
    return (y * scale).to(out_dtype)


# ---------------------------------------------------------------------------
# the plan of kernels E and F
# ---------------------------------------------------------------------------

def _decode_split(m: int, k: int, n: int, halves: int, int4: bool,
                  group: int, sms: int):
    """(split unit in K rows, split units, blocks a cluster) of the decode
    mode: the smallest power-of-two cluster (<= 8, every rank >= 256 K rows
    of whole units) that gives >= 2 blocks an SM at m <= 16; at m 17-48,
    >= 1 block on 7/8 of the SMs (INT4) or >= 4/3 blocks an SM (INT8)."""
    su = group if int4 else _INT8_UNIT
    nsu = cdiv(k, su)
    tiles = cdiv(n, _DEC_COLS) * halves
    if m <= 16:
        fill = 2 * sms
    else:
        fill = sms - sms // 8 if int4 else sms + sms // 3
    cs = 1
    while (cs < _MAX_CLUSTER and nsu // (2 * cs) * su >= _MIN_RANK_K
           and tiles * cs < fill):
        cs *= 2
    return su, nsu, cs


def _decode_mode(m: int, n: int, halves: int, int4: bool, group: int,
                 sms: int, f32: bool) -> bool:
    """Whether the plan takes the decode mode: m <= 16, and 17-48 (not
    float32) where the prefill mode's grid (128 columns a block) would
    hold at most half the SMs; INT4 groups of 64 or 128 only."""
    narrow = 2 * cdiv(n, _PRE_COLS) * halves <= sms
    return ((m <= _DECODE_M_F32 or (not f32 and m <= _DECODE_M and narrow))
            and (not int4 or group in (64, 128)))


def _fragment_mode(m: int, int4: bool, group: int, dtype) -> bool:
    """Whether kernel E takes its fragment mode: INT4 with groups of 64 or
    128, a bf16 or float16 x, m <= 16."""
    return (int4 and m <= 16 and group in (64, 128)
            and dtype in (torch.bfloat16, torch.float16))


def _frag_smem(rows: int, k: int, group: int, cs: int, wc: int) -> int:
    """Dynamic shared memory of a fragment-mode block: the x rows of its K
    range ([rows][K range] at a pitch 16 bytes past it) and the scales of
    its groups and columns, which the warps' partial sums [4][rows][68]
    f32 reuse after the K loop, then an mbarrier a round of x (a chunk of
    every slice)."""
    groups = cdiv(k // group, cs)
    x = rows * (groups * group * 2 + 16)
    scales = groups * wc * _FRAG_WARP_COLS * 4
    bars = cdiv(k // group, cs * (4 // wc)) * (group // _FRAG_CHUNK_K) * 8
    return max(x + scales, 4 * rows * _RED_PITCH * 4) + bars


def _frag_split(m: int, k: int, n: int, halves: int, group: int,
                sms: int) -> tuple:
    """(rows, wc, cs, blocks, smem) of the fragment mode, as
    ``frag_plan`` makes it. Candidates: every (wc, cs) whose warp K
    slices are whole scale groups of >= 128 rows on average (or all of K)
    and whose shared memory fits, in the order wc = 4, 2, 1 (1, 2, 4 at m
    <= 4, where x is half as many bytes) then cs = 1, 2, 4, 8. The first
    whose slices keep >= 256 rows on average (a slice of two chunks pays
    its prologue twice over) and whose blocks fill the card (>=
    _FRAG_FILL) in one wave (<= sms x the blocks an SM holds by registers
    and shared memory, less a tenth for clusters of 4 and 8) wins; else,
    where every candidate is more than a wave (the widest vocabularies),
    of those with wc >= 2 and cs <= 2 the one that fills its waves best,
    then holds most blocks an SM; else the one of most blocks within a
    wave, then the smallest cluster. Chosen from tools/plan_sweep.py on
    an H100."""
    rows = 8 if m <= 8 else 16
    ncg = cdiv(n, _FRAG_WARP_COLS) * halves
    G = k // group
    cands = []
    for wc in ((1, 2, 4) if m <= 4 else (4, 2, 1)):
        for cs in (1, 2, 4, 8):
            S = cs * (4 // wc)
            if S > G or G * group < S * min(_FRAG_MIN_SLICE_K, k):
                continue
            smem = _frag_smem(rows, k, group, cs, wc)
            occ = min(_FRAG_OCC[rows], (_SMEM_MAX + 1024) // (smem + 1024))
            if occ == 0:
                continue
            cap = sms * occ
            if cs >= 4:
                cap -= cap // 10
            cands.append((wc, cs, cdiv(ncg, wc) * cs, cap, occ, smem))
    for wc, cs, blocks, cap, occ, smem in cands:
        S = cs * (4 // wc)
        if (_FRAG_FILL <= blocks <= cap
                and G * group >= S * min(_FRAG_FILL_SLICE_K, k)):
            return rows, wc, cs, blocks, smem
    if all(c[2] > c[3] for c in cands):
        wide = [c for c in cands if c[0] >= 2 and c[1] <= 2] or cands
        best = max(wide, key=lambda c: (
            c[2] * 100 // (cdiv(c[2], c[3]) * c[3]), c[4]))
    else:
        best = max(cands, key=lambda c: (min(c[2], c[3]), -c[1]))
    wc, cs, blocks, _, _, smem = best
    return rows, wc, cs, blocks, smem


def fragment_k_slices(m: int, k: int, n: int, halves: int = 1, *,
                      group: int = 128, sms: int = 132) -> list:
    """The K rows [lo, hi) of each warp slice of a fragment-mode column
    group, in K order (cluster rank r's block holds slices r x 4 / wc ..):
    whole scale groups, balanced (slice i takes groups [i G / S,
    (i + 1) G / S))."""
    _, wc, cs, _, _ = _frag_split(m, k, n, halves, group, sms)
    S, G = cs * (4 // wc), k // group
    return [(i * G // S * group, (i + 1) * G // S * group) for i in range(S)]


def quant_matmul_plan(m: int, k: int, n: int, halves: int = 1, *,
                      int4: bool = True, group: int = 128,
                      sms: int = 132,
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """Kernel E's (``int4``) or F's plan for x [m, k] of ``dtype`` times a
    [k, n] weight (``halves`` = 2: the gate|up stack) on ``sms`` SMs, as
    ``csrc/quant_matmul.cuh`` makes it: mode ("decode" at m <= 16 and at
    17-48 where n is narrow, float32 m <= 16, with INT4 groups of 64 or
    128, else "prefill"; x tiles of 8, 16, 32 or 48 rows), x rows and
    output columns a
    block, blocks a cluster along K, blocks, ring stages and dynamic shared
    memory a block. float16 takes bf16's plan; float32 (Ef / Ff on the
    CUDA cores) stages 4-byte x rows in the decode mode, 8 K slices 16
    bytes apart, and takes 128-row prefill tiles of 32 K rows. Pure
    Python: the CPU tests call it; :func:`quant_matmul_plan_native` asks
    the built library."""
    f32 = dtype == torch.float32
    if _fragment_mode(m, int4, group, dtype):
        rows, wc, cs, blocks, smem = _frag_split(m, k, n, halves, group, sms)
        return dict(mode="fragment", rows=rows, cols=wc * _FRAG_WARP_COLS,
                    cluster=cs, blocks=blocks, stages=_FRAG_BUFS,
                    smem_bytes=smem)
    if _decode_mode(m, n, halves, int4, group, sms, f32):
        rows = next(r for r in (8, 16, 32, 48) if m <= r)
        _, _, cs = _decode_split(m, k, n, halves, int4, group, sms)
        stages = _DEC_STAGES[int4] if rows <= 16 else 3
        kk = _DEC_STAGE_K[int4]
        x_pitch = kk * 4 + _F32_SLICES * 16 + 16 if f32 else kk * 2 + 16
        stage = (128 * _DEC_COLS + rows * x_pitch
                 + (kk // 64 * _DEC_COLS * 4 if int4 else 0))
        return dict(mode="decode", rows=rows, cols=_DEC_COLS, cluster=cs,
                    blocks=cdiv(n, _DEC_COLS) * halves * cs, stages=stages,
                    smem_bytes=1024 + stages * stage + 8 * stages)
    if f32:
        rows, kk = _PRE_F32_ROWS, _PRE_F32_K
        stage = rows * (kk * 4 + 16) + (kk // 2 if int4 else kk) * _PRE_COLS
        smem = 128 + _PRE_F32_STAGES * stage + 2 * kk * _PRE_COLS * 4
        stages = _PRE_F32_STAGES
    else:
        rows = 64 if m <= 64 else 128
        stage = (rows * _PRE_K * 2
                 + (_PRE_K // 2 if int4 else _PRE_K) * _PRE_COLS)
        smem = 1024 + _PRE_STAGES * stage + 2 * _PRE_STAGES * 8
        stages = _PRE_STAGES
    return dict(mode="prefill", rows=rows, cols=_PRE_COLS, cluster=1,
                blocks=cdiv(n, _PRE_COLS) * halves * cdiv(m, rows),
                stages=stages, smem_bytes=smem)


def cluster_k_ranges(m: int, k: int, n: int, halves: int = 1, *,
                     int4: bool = True, group: int = 128,
                     sms: int = 132) -> list:
    """The K rows [lo, hi) of each cluster rank in the decode mode: whole
    split units, balanced (rank r takes units [r u / c, (r + 1) u / c))."""
    su, nsu, cs = _decode_split(m, k, n, halves, int4, group, sms)
    return [(r * nsu // cs * su, min((r + 1) * nsu // cs * su, k))
            for r in range(cs)]


def quant_matmul_plan_native(m: int, k: int, n: int, halves: int = 1, *,
                             int4: bool = True, group: int = 128,
                             dtype: torch.dtype = torch.bfloat16) -> dict:
    """The plan from the built library on the card (``quant_matmul_plan``
    of x's ``dtype``, ``csrc/quant_matmul.cuh``), with the blocks an SM
    holds."""
    import ctypes
    from llm_inference_engine_tpu_torch.ops import _native
    out = (ctypes.c_int * 8)()
    name = _native.entry_name("quant_matmul_plan", dtype)
    status = getattr(_native.library(), name)(m, k, n, halves, int(int4),
                                              group, out)
    _native.check(status, name)
    plan = dict(zip(_PLAN_KEYS + ("blocks_per_sm",), out))
    plan["mode"] = _PLAN_MODES[plan["mode"]]
    return plan


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_fused(name, x2, q, scale, out_dtype, int4: bool, group_size: int):
    """Validate the inputs of kernels E/F (a bf16 x) or of their float
    instances Ef/Ff (a float16 or float32 x); returns (halves, k, n)."""
    if x2.dtype not in (torch.bfloat16,) + FLOAT_X_DTYPES:
        raise TypeError(f"{name}: x must be bfloat16 (kernels E/F), float16 "
                        f"or float32 (Ef/Ff), got {x2.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: need int8 q and float32 scale, got "
                        f"{q.dtype} / {scale.dtype}")
    if out_dtype not in (x2.dtype, torch.float32):
        raise TypeError(f"{name}: out dtype must be x's ({x2.dtype}) or "
                        f"f32, got {out_dtype}")
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


def _check_layout(name, x2, q, qd, group_size):
    """At the fragment mode's m (INT4, bf16 / float16 x, m <= 16, groups of
    64 or 128) the launch reads ``qd``, the weight's fragment-order copy:
    it must be there, shaped and placed as q. Returns the pointer (0 where
    the mode does not run)."""
    if not _fragment_mode(x2.shape[0], True, group_size, x2.dtype):
        return 0
    if qd is None:
        raise ValueError(
            f"{name}: an INT4 matmul at m = {x2.shape[0]} <= 16 on the card "
            "runs kernel E's fragment mode, which reads the weight's "
            "fragment-order copy QuantizedTensor.qd, and this weight has "
            "none: build it with ops.quant.add_decode_layout(weight) "
            "(engines build theirs: ops.quant.add_decode_layouts)")
    if (qd.dtype != torch.int8 or qd.shape != q.shape
            or qd.device != q.device or not qd.is_contiguous()
            or qd.data_ptr() % 16):
        raise ValueError(f"{name}: qd must be a contiguous, 16-byte aligned "
                         f"int8 tensor of q's shape {tuple(q.shape)} on its "
                         f"device, got {qd.dtype} {tuple(qd.shape)}")
    return qd.data_ptr()


def _launch_fused(name, x2, q, scale, out_dtype, int4, group_size, qd=None):
    from llm_inference_engine_tpu_torch.ops import _native
    halves, k, n = _check_fused(name, x2, q, scale, out_dtype, int4,
                                group_size)
    qd_ptr = _check_layout(name, x2, q, qd, group_size) if int4 else 0
    m = x2.shape[0]
    out = torch.empty((m, halves * n), dtype=out_dtype, device=x2.device)
    if m == 0:
        return out
    q_half = q.shape[-2] * n if halves == 2 else 0
    s_half = scale.shape[-2] * n if halves == 2 else 0
    # E / F, or their float16 / float32 instance Ef / Ff: one launch
    entry = getattr(_native.library(), _native.entry_name(
        "int4_matmul" if int4 else "int8_matmul", x2.dtype))
    out_f32, stream = int(out_dtype == torch.float32), _native.stream_of(x2)
    if int4:
        status = entry(x2.data_ptr(), q.data_ptr(), qd_ptr, scale.data_ptr(),
                       out.data_ptr(), m, k, n, halves, q_half, s_half,
                       group_size, out_f32, stream)
    else:
        status = entry(x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
                       out.data_ptr(), m, k, n, halves, q_half, s_half,
                       out_f32, stream)
    _native.check(status, name)
    return out


def int4_matmul(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                group_size: int, out_dtype: torch.dtype, *,
                qd: Optional[torch.Tensor] = None,
                kernels: str = "auto") -> torch.Tensor:
    """Kernel E (W4A16 fused dequant-matmul, ``csrc/quant_matmul.cuh``):
    x2 bf16 [m, k] times the packed int4 weight [k/2, n] (or the
    [2, k/2, I] gate|up stack in one launch, flat [m, 2I] out) with
    grouped scales; out bf16 or f32. At m <= 16 (groups of 64 or 128) the
    fragment mode reads ``qd``, q in fragment order
    (:func:`repack_int4_decode`), and raises without it; the plain route
    reads q."""
    if not use_kernel(kernels, x2):
        return int4_matmul_torch(x2, q, scale, group_size, out_dtype)
    if x2.dtype in FLOAT_X_DTYPES:
        return int4_matmul_float(x2, q, scale, group_size, out_dtype, qd=qd)
    out = _launch_fused("int4_matmul", x2, q, scale, out_dtype, True,
                        group_size, qd)
    int4_matmul.launches += 1
    kernel_output("int4_matmul", out)
    return out


int4_matmul.launches = 0


def int8_matmul(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype, *,
                kernels: str = "auto") -> torch.Tensor:
    """Kernel F (W8A16 fused dequant-matmul, ``csrc/quant_matmul.cuh``):
    x2 bf16 [m, k] times int8 [k, n] (or [2, k, I]) with the per-channel
    scale [1, n] applied to the f32 accumulator."""
    if not use_kernel(kernels, x2):
        return int8_matmul_torch(x2, q, scale, out_dtype)
    if x2.dtype in FLOAT_X_DTYPES:
        return int8_matmul_float(x2, q, scale, out_dtype)
    out = _launch_fused("int8_matmul", x2, q, scale, out_dtype, False, 0)
    int8_matmul.launches += 1
    kernel_output("int8_matmul", out)
    return out


int8_matmul.launches = 0


def _need_float_x(name, x2):
    if x2.dtype not in FLOAT_X_DTYPES:
        raise TypeError(f"{name}: the float instance takes a float16 or "
                        f"float32 x, got {x2.dtype}")


def int4_matmul_float(x2: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor, group_size: int,
                      out_dtype: torch.dtype, *,
                      qd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel Ef (``csrc/quant_matmul_f16.cu``, ``_f32.cu``): what
    :func:`int4_matmul` runs for a float16 or float32 x on the card; out
    x's dtype or f32. A float16 x at m <= 16 reads ``qd`` (the fragment
    mode); float32 never does."""
    _need_float_x("int4_matmul_float", x2)
    out = _launch_fused("int4_matmul_float", x2, q, scale, out_dtype, True,
                        group_size, qd)
    int4_matmul_float.launches += 1
    kernel_output("int4_matmul_float", out)
    return out


int4_matmul_float.launches = 0


def int8_matmul_float(x2: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel Ff (``csrc/quant_matmul_f16.cu``, ``_f32.cu``): what
    :func:`int8_matmul` runs for a float16 or float32 x on the card; out
    x's dtype or f32."""
    _need_float_x("int8_matmul_float", x2)
    out = _launch_fused("int8_matmul_float", x2, q, scale, out_dtype, False,
                        0)
    int8_matmul_float.launches += 1
    kernel_output("int8_matmul_float", out)
    return out


int8_matmul_float.launches = 0


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


def dequant_int8(q: torch.Tensor, *, kernels: str = "auto") -> torch.Tensor:
    """Kernel G8 (Triton): int8 [k, n] -> bf16 [k, n], each value cast
    exactly. The [2, k, I] gate|up stack gives the flat [k, 2I] weight
    (one launch per half, each writing its columns in place: no
    concatenation)."""
    if not use_kernel(kernels, q):
        return dequant_int8_torch(q)
    if q.dtype != torch.int8:
        raise TypeError(f"dequant_int8: need int8 q, got {q.dtype}")
    if q.dim() not in (2, 3) or (q.dim() == 3 and q.shape[0] != 2):
        raise ValueError(f"dequant_int8: q {tuple(q.shape)} is not [k, n] "
                         "or [2, k, I]")
    if not q.is_contiguous():
        raise ValueError("dequant_int8: q must be contiguous")
    from llm_inference_engine_tpu_torch.ops import _native
    _native.triton()
    from llm_inference_engine_tpu_torch.ops import _triton_kernels
    parts = _parts(q)
    k, n = parts[0].shape
    out = torch.empty((k, len(parts) * n), dtype=torch.bfloat16,
                      device=q.device)
    for h, qh in enumerate(parts):
        _triton_kernels.dequant_int8(qh, out[:, h * n:])
        dequant_int8.launches += 1
    kernel_output("dequant_int8", out)
    return out


dequant_int8.launches = 0


def int8_scale_cast(y: torch.Tensor, scale: torch.Tensor,
                    out_dtype: torch.dtype, *,
                    kernels: str = "auto") -> torch.Tensor:
    """G8's epilogue (Triton): f32 y [m, n] times the f32 scale [1, n],
    rounded once to ``out_dtype`` in one pass, bit for bit
    :func:`int8_scale_cast_torch`."""
    if not use_kernel(kernels, y):
        return int8_scale_cast_torch(y, scale, out_dtype)
    if y.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"int8_scale_cast: need float32 y and scale, got "
                        f"{y.dtype} / {scale.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"int8_scale_cast: unsupported out dtype {out_dtype}")
    if (y.dim() != 2 or scale.numel() != y.shape[1]
            or not (y.is_contiguous() and scale.is_contiguous())
            or scale.device != y.device):
        raise ValueError(f"int8_scale_cast: need a contiguous [m, n] y and "
                         f"an [n] scale on its device, got "
                         f"{tuple(y.shape)} / {tuple(scale.shape)}")
    from llm_inference_engine_tpu_torch.ops import _native
    _native.triton()
    from llm_inference_engine_tpu_torch.ops import _triton_kernels
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    if y.numel():
        _triton_kernels.int8_scale_cast(y, scale, out)
        int8_scale_cast.launches += 1
    kernel_output("int8_scale_cast", out)
    return out


int8_scale_cast.launches = 0


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result: bf16 products accumulate in f32 and are
    never rounded through bf16 (``preferred_element_type=f32``)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)   # bf16 products exact


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one cuBLAS call with a bf16 result: bf16 products summed in
    f32 and rounded once. cuBLAS's reduced-precision reduction (split-K
    partial sums kept in bf16) is switched off for the call, so no partial
    sum is rounded before the end."""
    flags = torch.backends.cuda.matmul
    allow = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        return torch.mm(a, b)
    finally:
        flags.allow_bf16_reduced_precision_reduction = allow


def _large_m_linear(x2, t: QuantizedTensor, out_dtype, kernels):
    """m >= _PREFILL_M: dequantize the weight once to bf16 and run one
    plain bf16 matmul with f32 accumulation (JAX ``_large_m_linear``).
    INT8 casts exactly (kernel G8) and scales the f32 result, rounding it
    once in the same pass (G8's epilogue); INT4 bakes the grouped scales
    into the bf16 weight (kernel G). The kernel route takes a bf16 INT4
    result from cuBLAS with a bf16 output (``_mm_bf16``), without the f32
    product's cast pass; the plain route casts the f32 product, as JAX
    does. The two may sum in another order: chip_smoke 4v and a card test
    hold them bit for bit at the m >= 1024 shapes the models give (only
    there is that measured)."""
    x2 = x2.to(torch.bfloat16)
    if t.mode == "int4":
        w = dequant_int4(t.q, t.scale, t.group_size, kernels=kernels)
        if use_kernel(kernels, x2) and out_dtype == torch.bfloat16:
            return _mm_bf16(x2, w)
        return _mm_f32(x2, w).to(out_dtype)
    w = dequant_int8(t.q, kernels=kernels)
    post = _cat([sh.reshape(1, -1) for sh in _parts(t.scale)])
    return int8_scale_cast(_mm_f32(x2, w), post, out_dtype, kernels=kernels)


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
        y = int4_matmul(x2, t.q, t.scale, t.group_size, out_dtype, qd=t.qd,
                        kernels=kernels)
    else:
        y = int8_matmul(x2, t.q, t.scale, out_dtype, kernels=kernels)
    return y.reshape(*lead, n_out)


def needs_decode_layout(t: QuantizedTensor, dtype: torch.dtype) -> bool:
    """Whether weight ``t`` under a model of ``dtype`` runs kernel E's
    fragment mode at m <= 16, so that it needs ``qd``: INT4 with groups of
    64 or 128 on a CUDA device, a bf16 or float16 model."""
    return (isinstance(t, QuantizedTensor) and t.mode == "int4"
            and t.q.is_cuda and _fragment_mode(1, True, t.group_size, dtype))


def add_decode_layout(t: QuantizedTensor,
                      dtype: torch.dtype = torch.bfloat16) -> QuantizedTensor:
    """Build ``t.qd`` (:func:`repack_int4_decode` of ``t.q``, on its
    device) where :func:`needs_decode_layout` says so and it is missing,
    in place; returns ``t``. A layer-stacked weight builds one copy, and
    ``t[layer]`` gives its layer's view."""
    if t.qd is None and needs_decode_layout(t, dtype):
        t.qd = repack_int4_decode(t.q)
    return t


def add_decode_layouts(tree, dtype: torch.dtype):
    """:func:`add_decode_layout` on every weight of a params tree (dicts,
    lists and tuples of leaves), in place: what an engine on the card
    builds once, after its tensor-parallel sharding (each rank's shard).
    Returns ``tree``."""
    if isinstance(tree, QuantizedTensor):
        add_decode_layout(tree, dtype)
    elif isinstance(tree, dict):
        for v in tree.values():
            add_decode_layouts(v, dtype)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            add_decode_layouts(v, dtype)
    return tree


def quantized_linear_torch(x: torch.Tensor, t: QuantizedTensor,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Plain version of :func:`quantized_linear`: the same routing and
    rounding points, every kernel replaced by its plain version."""
    return quantized_linear(x, t, out_dtype, kernels="torch")

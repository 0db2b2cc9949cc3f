"""Triton kernels G (dequant_int4) and G8 (dequant_int8, and its
epilogue int8_scale_cast).

This module imports ``triton`` at its top, so only the launching
function in ``ops/quant.py`` imports it, and only on a CUDA tensor (after
``_native.triton()`` has pointed Triton's compile cache into the
checkout's build directory).

The kernel is memory-bound on Hopper (a few FLOPs per byte against the
card's ~295 bf16 FLOP/byte balance point), so the design goal is one
read and one write of each element: no shared-memory staging, no tensor
cores, masked block loads over the ragged edge, f32 math in registers.
"""

from __future__ import annotations

import triton
import triton.language as tl


@triton.jit
def _dequant_int4_kernel(q_ptr, s_ptr, o_ptr, kr, n, ldo,
                         GROUP: tl.constexpr, BLOCK_R: tl.constexpr,
                         BLOCK_N: tl.constexpr):
    """Program (packed-row block, column block) of the packed int4 weight
    [kr = k/2, n]. Replaces ``ops/quant.py::_dequant_int4_kernel`` of the
    JAX package: byte r holds K row 2r in its low nibble and 2r+1 in its
    high nibble, both signed; out[2r + i, c] = bf16(f32(nibble) *
    scale[(2r) // GROUP, c]), one f32 product rounded once. Bound: bytes
    (0.5 B read, 2 B written per element); each program reads one
    coalesced [BLOCK_R, BLOCK_N] byte tile and writes the two bf16 rows
    of every byte row as contiguous runs of BLOCK_N columns (row stride
    ``ldo``, so a half of the gate|up stack lands in its own columns)."""
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    c = tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)
    mask = (r[:, None] < kr) & (c[None, :] < n)
    b = tl.load(q_ptr + r[:, None].to(tl.int64) * n + c[None, :], mask=mask,
                other=0).to(tl.int32)
    lo = (b << 28) >> 28
    hi = b >> 4
    grp = (2 * r) // GROUP
    s = tl.load(s_ptr + grp[:, None].to(tl.int64) * n + c[None, :],
                mask=mask, other=0.0)
    out = o_ptr + (2 * r[:, None]).to(tl.int64) * ldo + c[None, :]
    tl.store(out, (lo.to(tl.float32) * s).to(tl.bfloat16), mask=mask)
    tl.store(out + ldo, (hi.to(tl.float32) * s).to(tl.bfloat16), mask=mask)


def dequant_int4(q, scale, out, group_size: int) -> None:
    """Launch kernel G: contiguous packed q [k/2, n] and scale [k/group, n]
    into ``out`` [k, n] bf16 (row stride ``out.stride(0)``, unit column
    stride)."""
    kr, n = q.shape
    block_r, block_n = 32, 128
    _dequant_int4_kernel[(triton.cdiv(kr, block_r), triton.cdiv(n, block_n))](
        q, scale, out, kr, n, out.stride(0), GROUP=group_size,
        BLOCK_R=block_r, BLOCK_N=block_n, num_warps=4)


@triton.jit
def _dequant_int8_kernel(q_ptr, o_ptr, k, n, ldo, BLOCK_R: tl.constexpr,
                         BLOCK_N: tl.constexpr):
    """Program (row block, column block) of the int8 weight [k, n]: G8,
    the INT8 counterpart of G. Replaces no TPU kernel: the JAX package
    casts in XLA (``ops/quant.py::_dequant_bf16``). out[r, c] =
    bf16(q[r, c]), exact (|q| <= 127 fits bf16's mantissa); the scale is
    applied to the f32 product after the matmul. Bound: bytes (1 B read,
    2 B written per element); rows of ``out`` lie ``ldo`` apart, so each
    half of the gate|up stack lands in its own columns of one buffer and
    no concatenation follows."""
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    c = tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)
    mask = (r[:, None] < k) & (c[None, :] < n)
    rows = r[:, None].to(tl.int64)
    b = tl.load(q_ptr + rows * n + c[None, :], mask=mask, other=0)
    tl.store(o_ptr + rows * ldo + c[None, :], b.to(tl.bfloat16), mask=mask)


def dequant_int8(q, out) -> None:
    """Launch G8: contiguous int8 q [k, n] into ``out`` [k, n] bf16 (row
    stride ``out.stride(0)``, unit column stride)."""
    k, n = q.shape
    block_r, block_n = 32, 256
    _dequant_int8_kernel[(triton.cdiv(k, block_r), triton.cdiv(n, block_n))](
        q, out, k, n, out.stride(0), BLOCK_R=block_r, BLOCK_N=block_n,
        num_warps=4)


@triton.jit
def _int8_scale_cast_kernel(y_ptr, s_ptr, o_ptr, m, n,
                            BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr):
    """Program (row block, column block) of the f32 product y [m, n] of
    G8's bf16 weight: out[r, c] = (y[r, c] * s[c]) rounded once to out's
    dtype, the per-column INT8 scale applied to the f32 sum (the JAX
    package's ``acc * scale`` after the dot). One f32 product and one
    round-to-nearest-even conversion: bit for bit torch's ``(y *
    s).to(dtype)``, in one pass (4 B read, 2 B written a bf16 value)
    where torch takes two."""
    r = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    c = tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)
    mask = (r[:, None] < m) & (c[None, :] < n)
    at = r[:, None].to(tl.int64) * n + c[None, :]
    y = tl.load(y_ptr + at, mask=mask, other=0.0)
    s = tl.load(s_ptr + c, mask=c < n, other=0.0)
    tl.store(o_ptr + at, (y * s[None, :]).to(o_ptr.dtype.element_ty),
             mask=mask)


def int8_scale_cast(y, scale, out) -> None:
    """Launch G8's epilogue: contiguous f32 y [m, n] times the f32
    per-column scale [n] into contiguous ``out`` [m, n]."""
    m, n = y.shape
    block_m, block_n = 16, 256
    _int8_scale_cast_kernel[(triton.cdiv(m, block_m),
                             triton.cdiv(n, block_n))](
        y, scale, out, m, n, BLOCK_M=block_m, BLOCK_N=block_n, num_warps=4)

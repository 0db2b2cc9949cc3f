"""Triton kernels A (rmsnorm), B (silu_and_mul) and G (dequant_int4).

This module imports ``triton`` at its top, so only the launching
functions in ``ops/rmsnorm.py``, ``ops/activations.py`` and
``ops/quant.py`` import it, and only on a CUDA tensor (after
``_native.triton()`` has pointed Triton's compile cache into the
checkout's build directory).

All three kernels are memory-bound on Hopper (a few FLOPs per byte
against the card's ~295 bf16 FLOP/byte balance point), so the design goal
is one read and one write of each element: no shared-memory staging, no
tensor cores, masked block loads over the ragged edge, f32 math in
registers.
"""

from __future__ import annotations

import triton
import triton.language as tl


@triton.jit
def _rmsnorm_kernel(x_ptr, r_ptr, w_ptr, y_ptr, h_ptr, H, eps,
                    HAS_RESIDUAL: tl.constexpr, BLOCK: tl.constexpr):
    """One program per row of [N, H]. Replaces the TPU kernels
    ``ops/rmsnorm.py::_rmsnorm_kernel`` and (HAS_RESIDUAL)
    ``::_add_residual_rmsnorm_kernel`` of the JAX package: h = x + r is
    added in f32 and stored in the storage dtype, and the norm reads the
    stored h, exactly as the plain version does."""
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < H
    off = row * H + cols
    x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    if HAS_RESIDUAL:
        r = tl.load(r_ptr + off, mask=mask, other=0.0).to(tl.float32)
        h = (x + r).to(h_ptr.dtype.element_ty)
        tl.store(h_ptr + off, h, mask=mask)
        x = h.to(tl.float32)
    var = tl.sum(x * x, axis=0) / H
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = (x * rstd) * w
    tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=mask)


@triton.jit
def _silu_mul_kernel(gu_ptr, o_ptr, inter, BLOCK: tl.constexpr):
    """Program (row, column block) of the packed [N, 2I] gate|up buffer.
    Replaces ``ops/activations.py::_silu_mul_kernel`` of the JAX
    package: silu(gate) * up in f32, rounded once on store."""
    row = tl.program_id(0).to(tl.int64)
    cols = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    mask = cols < inter
    g = tl.load(gu_ptr + row * 2 * inter + cols, mask=mask,
                other=0.0).to(tl.float32)
    u = tl.load(gu_ptr + row * 2 * inter + inter + cols, mask=mask,
                other=0.0).to(tl.float32)
    y = g / (1.0 + tl.exp(-g)) * u
    tl.store(o_ptr + row * inter + cols, y.to(o_ptr.dtype.element_ty),
             mask=mask)


def rmsnorm(x, residual, weight, y, h, eps: float) -> None:
    """Launch kernel A over 2-D contiguous [N, H] tensors (``residual`` and
    ``h`` are None without a residual)."""
    n, hidden = x.shape
    block = triton.next_power_of_2(hidden)
    has_res = residual is not None
    _rmsnorm_kernel[(n,)](
        x, residual if has_res else x, weight, y, h if has_res else y,
        hidden, eps, HAS_RESIDUAL=has_res, BLOCK=block,
        num_warps=min(max(block // 256, 1), 16))


def silu_and_mul(gate_up, out) -> None:
    """Launch kernel B over contiguous [N, 2I] -> [N, I]."""
    n, inter = out.shape
    block = 1024
    _silu_mul_kernel[(n, triton.cdiv(inter, block))](
        gate_up, out, inter, BLOCK=block, num_warps=4)


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

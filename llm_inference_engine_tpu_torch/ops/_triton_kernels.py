"""Triton kernels A (rmsnorm) and B (silu_and_mul).

This module imports ``triton`` at its top, so only the launching
functions in ``ops/rmsnorm.py`` and ``ops/activations.py`` import it, and
only on a CUDA tensor (after ``_native.triton()`` has pointed Triton's
compile cache into the checkout's build directory).

Both kernels are memory-bound on Hopper (a few FLOPs per byte against the
card's ~295 bf16 FLOP/byte balance point), so the design goal is one
read and one write of each element: no shared-memory staging, no tensor
cores, masked block loads over the ragged edge, f32 math in registers.
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

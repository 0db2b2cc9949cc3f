"""Triton kernel G (dequant_int4).

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

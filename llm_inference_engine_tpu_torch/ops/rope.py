"""Rotary position embeddings and the QKV split.

Port of ``llm_inference_engine_tpu/ops/rope.py``, which runs XLA at every
shape: the split is a view there and XLA fuses the rotation into it. The
decoder's counterpart of that fused pass is kernel J (CUDA C,
``csrc/norm_act.cu``), :func:`split_qkv_rope_fused`: it reads the packed
qkv once and writes q and k rotated and v, each contiguous, in one
launch, bit for bit its plain version (the split, two rotations and a
copy of v: about twenty eager launches a layer). cos/sin stay torch,
computed once a forward (``models/llama.py``'s ``rope_tables``). Kept
from the JAX package:

- cos/sin by a Cody-Waite modular reconstruction from the integer
  position (see :func:`rope_cos_sin`): plain f32 ``cos(pos * inv_freq)``
  loses ~5e-2 of angle at position ~30k;
- linear and llama3 frequency scaling (host-side float64);
- the half-split (HF Llama) rotation pairing (x[i], x[i + d/2]);
- the GROUP-MAJOR packed QKV layout: per KV group g the columns are
  [q_{gG} .. q_{(g+1)G-1}, k_g, v_g], i.e. the projection output reshapes
  to [..., K, G+2, D].
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from llm_inference_engine_tpu_torch.utils import use_kernel
from llm_inference_engine_tpu_torch.utils.checks import kernel_output

__all__ = ["apply_rope", "rope_cos_sin", "rotate", "split_qkv",
           "split_qkv_rope", "split_qkv_rope_fused",
           "split_qkv_rope_fused_torch"]


def _llama3_inv_freq_np(inv_freq, rs):
    """Llama-3.1 frequency-dependent scaling (HF rope_type "llama3")."""
    orig = float(rs.original_max_position_embeddings)
    wavelen = (2.0 * math.pi) / inv_freq
    smooth = np.clip((orig / wavelen - rs.low_freq_factor)
                     / (rs.high_freq_factor - rs.low_freq_factor), 0.0, 1.0)
    scaled = (1.0 - smooth) * inv_freq / rs.factor + smooth * inv_freq
    return np.where(wavelen < orig / rs.high_freq_factor, inv_freq,
                    np.where(wavelen > orig / rs.low_freq_factor,
                             inv_freq / rs.factor, scaled))


_TWO_PI = 2.0 * math.pi
# Cody-Waite split of 2*pi: P1 keeps 12 mantissa bits (k*P1 exact for
# k < 2^12), P2/P3 carry the remainder at full/residual f32 precision.
_P1 = float(np.float64(int(_TWO_PI * 4096.0) / 4096.0))
_P2 = float(np.float32(_TWO_PI - _P1))
_P3 = float(np.float64(_TWO_PI) - _P1 - np.float64(np.float32(_TWO_PI - _P1)))


@functools.lru_cache(maxsize=64)
def _modular_constants(head_dim: int, theta: float, scaling,
                       device: torch.device) -> torch.Tensor:
    """[3, head_dim//2] f32: (2^16 f, 2^8 f, f) mod 2*pi per inverse
    frequency f, from float64 on the host."""
    half = head_dim // 2
    freq_exp = np.arange(half, dtype=np.float64) * (2.0 / head_dim)
    inv64 = 1.0 / (float(theta) ** freq_exp)
    if isinstance(scaling, (int, float)):
        inv64 = inv64 / float(scaling)
    elif scaling is not None:
        inv64 = _llama3_inv_freq_np(inv64, scaling)
    consts = np.stack([np.mod(inv64 * 65536.0, _TWO_PI),
                       np.mod(inv64 * 256.0, _TWO_PI),
                       np.mod(inv64, _TWO_PI)]).astype(np.float32)
    return torch.from_numpy(consts).to(device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling=None):
    """cos/sin [..., head_dim//2] (f32) for integer positions [...].

    The position is decomposed into bytes ``pos = a*2^16 + b*2^8 + r``
    and the angle rebuilt mod 2*pi from host-precomputed constants, so
    every term stays < 256*2*pi; one Cody-Waite reduction then brings it
    to [-pi, pi] where f32 trig is accurate. Angle error ~2e-4 for
    positions up to 2^20."""
    c2, c1, c0 = _modular_constants(head_dim, float(theta), scaling,
                                    positions.device)
    pos_i = positions.to(torch.int32)
    sign = torch.where(pos_i < 0, -1.0, 1.0).to(torch.float32)[..., None]
    pos_i = pos_i.abs()
    a = (pos_i >> 16).to(torch.float32)[..., None]
    b = ((pos_i >> 8) & 255).to(torch.float32)[..., None]
    r = (pos_i & 255).to(torch.float32)[..., None]
    angles = a * c2 + b * c1 + r * c0            # [..., half], < ~4824
    k = torch.round(angles * (1.0 / _TWO_PI))
    angles = ((angles - k * _P1) - k * _P2) - k * _P3
    # cos is even, sin odd: negative positions via the sign factor
    return torch.cos(angles), sign * torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x [..., D] by cos/sin broadcastable to
    [..., D/2], in f32, rounded once to x.dtype."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, scaling=None) -> torch.Tensor:
    """Apply RoPE to x: [..., S, H, D] with positions [..., S]."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta, scaling)
    return rotate(x, cos[..., None, :], sin[..., None, :])


def split_qkv(qkv: torch.Tensor, num_heads: int, num_kv_heads: int,
              head_dim: int):
    """Group-major packed qkv [..., K*(G+2)*D] -> views q [..., H, D],
    k/v [..., K, D]."""
    lead = qkv.shape[:-1]
    G = num_heads // num_kv_heads
    z = qkv.reshape(*lead, num_kv_heads, G + 2, head_dim)
    q = z[..., :G, :].reshape(*lead, num_heads, head_dim)
    k = z[..., G, :]
    v = z[..., G + 1, :]
    return q, k, v


def split_qkv_rope(qkv, positions, num_heads: int, num_kv_heads: int,
                   head_dim: int, theta: float = 10000.0, scaling=None):
    """Split group-major packed qkv [..., T, K*(G+2)*D] -> q [.., T, H, D],
    k/v [.., T, K, D] with RoPE applied to q and k at ``positions``."""
    cos, sin = rope_cos_sin(positions, head_dim, theta, scaling)
    q, k, v = split_qkv(qkv, num_heads, num_kv_heads, head_dim)
    cos, sin = cos[..., None, :], sin[..., None, :]
    return rotate(q, cos, sin), rotate(k, cos, sin), v


def split_qkv_rope_fused_torch(qkv: torch.Tensor, cos: torch.Tensor,
                               sin: torch.Tensor, num_heads: int,
                               num_kv_heads: int, head_dim: int,
                               bias: Optional[torch.Tensor] = None):
    """Plain version of kernel J: the packed ``bias`` added first (Qwen2:
    ``qkv + bqkv.to(qkv.dtype)``, the JAX package's add), then
    :func:`split_qkv`, :func:`rotate` of q and of k by cos/sin
    (broadcastable to [..., 1, D/2]), and v made contiguous."""
    if bias is not None:
        qkv = qkv + bias.to(qkv.dtype)
    q, k, v = split_qkv(qkv, num_heads, num_kv_heads, head_dim)
    return rotate(q, cos, sin), rotate(k, cos, sin), v.contiguous()


def split_qkv_rope_fused(qkv: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, num_heads: int, num_kv_heads: int,
                         head_dim: int, *, bias: Optional[torch.Tensor] = None,
                         kernels: str = "auto"):
    """Kernel J: group-major packed qkv [..., K*(G+2)*D] -> q [..., H, D]
    and k [..., K, D] rotated by cos/sin (f32, one [D/2] row a token:
    ``rope_tables``' [B, T, 1, D/2]) and v [..., K, D], each contiguous;
    with ``bias`` ([K*(G+2)*D], Qwen2's ``bqkv``), added to every row
    first inside the kernel, rounded as the plain add rounds."""
    if not use_kernel(kernels, qkv):
        return split_qkv_rope_fused_torch(qkv, cos, sin, num_heads,
                                          num_kv_heads, head_dim, bias)
    if qkv.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"split_qkv_rope kernel: unsupported dtype "
                        f"{qkv.dtype}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise TypeError(f"split_qkv_rope kernel: cos/sin must be float32, "
                        f"got {cos.dtype} / {sin.dtype}")
    K = num_kv_heads
    G = num_heads // K if K > 0 else 0
    if (head_dim <= 0 or head_dim % 2 or G * K != num_heads or G <= 0
            or qkv.shape[-1] != K * (G + 2) * head_dim
            or not qkv.is_contiguous()):
        raise ValueError(f"split_qkv_rope kernel: need a contiguous "
                         f"[..., K*(G+2)*D] qkv with D even, got "
                         f"{tuple(qkv.shape)} at H {num_heads}, K {K}, D "
                         f"{head_dim}")
    lead = qkv.shape[:-1]
    n = qkv.numel() // qkv.shape[-1]
    half = head_dim // 2
    for name, t in (("cos", cos), ("sin", sin)):
        if (not t.is_contiguous() or t.numel() != n * half
                or t.shape[-1] != half or t.device != qkv.device):
            raise ValueError(f"split_qkv_rope kernel: {name} "
                             f"{tuple(t.shape)} is not a contiguous "
                             f"[{n} tokens, {half}] row set on {qkv.device}")
    if bias is not None:
        bias = bias.to(qkv.dtype)
        if (not bias.is_contiguous() or bias.shape != qkv.shape[-1:]
                or bias.device != qkv.device):
            raise ValueError(f"split_qkv_rope kernel: bias "
                             f"{tuple(bias.shape)} is not a contiguous "
                             f"[{qkv.shape[-1]}] row on {qkv.device}")
    from llm_inference_engine_tpu_torch.ops import _native
    q = torch.empty((*lead, num_heads, head_dim), dtype=qkv.dtype,
                    device=qkv.device)
    k = torch.empty((*lead, K, head_dim), dtype=qkv.dtype, device=qkv.device)
    v = torch.empty_like(k)
    status = _native.library().split_qkv_rope(
        qkv.data_ptr(), None if bias is None else bias.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), n, K, G, head_dim,
        _native.dtype_code(qkv.dtype), _native.stream_of(qkv))
    _native.check(status, "split_qkv_rope")
    split_qkv_rope_fused.launches += 1
    kernel_output("split_qkv_rope", q, k, v)
    return q, k, v


split_qkv_rope_fused.launches = 0

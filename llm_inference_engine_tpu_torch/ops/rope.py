"""Rotary position embeddings and the QKV split (plain torch).

Port of ``llm_inference_engine_tpu/ops/rope.py``, which runs XLA at every
shape. Kept from it:

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

import numpy as np
import torch

__all__ = ["apply_rope", "rope_cos_sin", "rotate", "split_qkv",
           "split_qkv_rope"]


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

"""SwiGLU activation and residual add.

Port of ``llm_inference_engine_tpu/ops/activations.py``. The packed
[tokens, 2*inter] convention is kept: gate = [:, :inter], up =
[:, inter:]. Kernel B (CUDA C, ``csrc/norm_act.cu``) replaces the TPU
kernel ``_silu_mul_kernel``: one thread per 8 output columns, launched
as a programmatic dependent of the kernel before it; on a CUDA tensor it
runs at every token count (the JAX package's 64 < tokens < 2048 gate was
a TPU measurement). ``add_residual`` stays the plain counterpart of the
JAX package's residual add; the decoder no longer calls it, since kernel
A's residual mode adds each layer's output to its residual
(``models/llama.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llm_inference_engine_tpu_torch.utils import use_kernel
from llm_inference_engine_tpu_torch.utils.checks import kernel_output

__all__ = ["silu_and_mul", "silu_and_mul_torch", "add_residual"]


def silu_and_mul_torch(gate_up: torch.Tensor) -> torch.Tensor:
    """gate_up: [..., 2*inter] packed (gate then up) -> [..., inter]."""
    inter = gate_up.shape[-1] // 2
    gate = gate_up[..., :inter].float()
    up = gate_up[..., inter:].float()
    return (F.silu(gate) * up).to(gate_up.dtype)


def silu_and_mul(gate_up: torch.Tensor, *, kernels: str = "auto") -> torch.Tensor:
    """SwiGLU: silu(gate) * up over packed [..., 2*inter] input."""
    if not use_kernel(kernels, gate_up):
        return silu_and_mul_torch(gate_up)
    if gate_up.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"silu_and_mul kernel: unsupported dtype "
                        f"{gate_up.dtype}")
    if gate_up.shape[-1] % 2 or not gate_up.is_contiguous():
        raise ValueError(f"silu_and_mul kernel: need a contiguous [..., 2I] "
                         f"input, got {tuple(gate_up.shape)}")
    from llm_inference_engine_tpu_torch.ops import _native
    inter = gate_up.shape[-1] // 2
    out = torch.empty((*gate_up.shape[:-1], inter), dtype=gate_up.dtype,
                      device=gate_up.device)
    status = _native.library().silu_and_mul(
        gate_up.data_ptr(), out.data_ptr(), out.numel() // inter if inter
        else 0, inter, _native.dtype_code(gate_up.dtype),
        _native.stream_of(gate_up))
    _native.check(status, "silu_and_mul")
    silu_and_mul.launches += 1
    kernel_output("silu_and_mul", out)
    return out


silu_and_mul.launches = 0


def add_residual(x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """Residual add in f32, rounded once (plain torch at every shape, as
    the JAX package leaves it to XLA)."""
    return (x.float() + residual.float()).to(x.dtype)

"""RMSNorm and fused add-residual + RMSNorm.

Port of ``llm_inference_engine_tpu/ops/rmsnorm.py``. Kernel A (Triton,
``ops/_triton_kernels.py::_rmsnorm_kernel``) replaces both TPU kernels of
that module, ``_rmsnorm_kernel`` and ``_add_residual_rmsnorm_kernel``:
one program per row, f32 accumulation, one read and one write of each
element. The plain versions below are the reference for CPU tensors and
for ``kernels="torch"``.
"""

from __future__ import annotations

import torch

from llm_inference_engine_tpu_torch.utils import use_kernel

__all__ = ["rmsnorm", "rmsnorm_torch", "add_residual_rmsnorm",
           "add_residual_rmsnorm_torch"]


def rmsnorm_torch(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """y = x / rms(x) * weight, accumulating in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def add_residual_rmsnorm_torch(x: torch.Tensor, residual: torch.Tensor,
                               weight: torch.Tensor, eps: float = 1e-5):
    """h = x + residual (f32 add, stored in x.dtype); return (rmsnorm(h), h)."""
    h = (x.float() + residual.float()).to(x.dtype)
    return rmsnorm_torch(h, weight, eps), h


def _check(x, weight, residual=None):
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"rmsnorm kernel: unsupported dtype {x.dtype}")
    if weight.shape != (x.shape[-1],) or weight.device != x.device:
        raise ValueError(f"rmsnorm kernel: weight {tuple(weight.shape)} on "
                         f"{weight.device} for x {tuple(x.shape)} on "
                         f"{x.device}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm kernel: inputs must be contiguous")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError("rmsnorm kernel: residual must match x in shape, "
                         "dtype, device and be contiguous")


def _launch(x, residual, weight, eps):
    from llm_inference_engine_tpu_torch.ops import _native
    _native.triton()
    from llm_inference_engine_tpu_torch.ops import _triton_kernels
    x2 = x.view(-1, x.shape[-1])
    y = torch.empty_like(x2)
    h = torch.empty_like(x2) if residual is not None else None
    r2 = residual.view(-1, x.shape[-1]) if residual is not None else None
    _triton_kernels.rmsnorm(x2, r2, weight, y, h, float(eps))
    return y.view(x.shape), (h.view(x.shape) if h is not None else None)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *,
            kernels: str = "auto") -> torch.Tensor:
    """RMSNorm over the last axis. Accepts any leading batch dims."""
    if not use_kernel(kernels, x):
        return rmsnorm_torch(x, weight, eps)
    _check(x, weight)
    y, _ = _launch(x, None, weight, eps)
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0


def add_residual_rmsnorm(x: torch.Tensor, residual: torch.Tensor,
                         weight: torch.Tensor, eps: float = 1e-5, *,
                         kernels: str = "auto"):
    """Fused residual add + RMSNorm. Returns (normed, new_residual)."""
    if not use_kernel(kernels, x):
        return add_residual_rmsnorm_torch(x, residual, weight, eps)
    _check(x, weight, residual)
    y, h = _launch(x, residual, weight, eps)
    add_residual_rmsnorm.launches += 1
    return y, h


add_residual_rmsnorm.launches = 0

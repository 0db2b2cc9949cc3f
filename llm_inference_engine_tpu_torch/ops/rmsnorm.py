"""RMSNorm and fused add-residual + RMSNorm.

Port of ``llm_inference_engine_tpu/ops/rmsnorm.py``. Kernel A (CUDA C,
``csrc/norm_act.cu``) replaces both TPU kernels of that module,
``_rmsnorm_kernel`` and ``_add_residual_rmsnorm_kernel``: one block a
row, the row held in registers, f32 accumulation, one read and one write
of each element, launched as a programmatic dependent of the kernel
before it. The decoder hands each layer's final residual add to the next
norm (``models/llama.py``), so the residual mode also does the work of
``activations.add_residual``. The plain versions below are the reference
for CPU tensors and for ``kernels="torch"``.
"""

from __future__ import annotations

import torch

from llm_inference_engine_tpu_torch.utils import use_kernel
from llm_inference_engine_tpu_torch.utils.checks import kernel_output

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


# kernel A holds a row in registers: at most 16384 loads of a thread block,
# each 16 bytes where the row's bytes allow, else one value
MAX_ROW_LOADS = 16384


def _check(x, weight, residual=None):
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"rmsnorm kernel: unsupported dtype {x.dtype}")
    hidden, per_load = x.shape[-1], 16 // x.element_size()
    if hidden > MAX_ROW_LOADS * (per_load if hidden % per_load == 0 else 1):
        raise ValueError(f"rmsnorm kernel: a row of {hidden} values is "
                         "wider than kernel A holds")
    if weight.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel: weight dtype {weight.dtype} is not "
                        f"x's {x.dtype}")
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
    y = torch.empty_like(x)
    h = torch.empty_like(x) if residual is not None else None
    n = x.numel() // x.shape[-1] if x.shape[-1] else 0
    status = _native.library().rmsnorm(
        x.data_ptr(), residual.data_ptr() if h is not None else None,
        weight.data_ptr(), y.data_ptr(), h.data_ptr() if h is not None
        else None, n, x.shape[-1], _native.dtype_code(x.dtype), float(eps),
        _native.stream_of(x))
    _native.check(status, "rmsnorm")
    return y, h


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *,
            kernels: str = "auto") -> torch.Tensor:
    """RMSNorm over the last axis. Accepts any leading batch dims."""
    if not use_kernel(kernels, x):
        return rmsnorm_torch(x, weight, eps)
    _check(x, weight)
    y, _ = _launch(x, None, weight, eps)
    rmsnorm.launches += 1
    kernel_output("rmsnorm", y)
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
    kernel_output("add_residual_rmsnorm", y, h)
    return y, h


add_residual_rmsnorm.launches = 0

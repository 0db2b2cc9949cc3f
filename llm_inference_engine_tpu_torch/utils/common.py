"""Small shared helpers: integer tile math and the kernel-dispatch rule."""

from __future__ import annotations

import torch

KERNEL_CHOICES = ("auto", "torch", "cuda")


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def use_kernel(kernels: str, t: torch.Tensor) -> bool:
    """Whether an op runs its hand-written kernel on tensor ``t``.

    ``"auto"`` runs the kernel iff ``t`` lies on a CUDA device; ``"torch"``
    always runs the plain PyTorch version (the tests' and the chip
    check's reference); ``"cuda"`` always runs the kernel and raises for a
    CPU tensor. There is no silent fallback: on a CUDA tensor a wrapper
    either launches its kernel or raises.
    """
    if kernels == "auto":
        return t.is_cuda
    if kernels == "torch":
        return False
    if kernels == "cuda":
        if not t.is_cuda:
            raise ValueError(f"kernels='cuda' needs a CUDA tensor, got one on "
                             f"{t.device}")
        return True
    raise ValueError(f"kernels must be one of {KERNEL_CHOICES}, got "
                     f"{kernels!r}")

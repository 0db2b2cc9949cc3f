"""Numerical-safety instrumentation (the sanitizer tier).

Port of ``llm_inference_engine_tpu/utils/checks.py``. The JAX package
wraps a jitted step with ``jax.experimental.checkify``, which checks the
result of every floating primitive in the compiled program. Here:

- ``nan_guard(fn)`` runs ``fn`` under a ``TorchDispatchMode`` that checks
  the floating result of every aten op, and raises at the first NaN
  (with ``div``, also at an Inf from a division), naming the op. The hand
  kernels launch through ``ctypes`` and Triton, out of the dispatcher's
  sight, so each kernel wrapper hands its outputs to
  :func:`kernel_output` right after the launch, and the guard checks them
  there, naming the kernel. Factory ops (``torch.empty``: arbitrary bits
  until a kernel writes them) and views (they compute nothing) are not
  checked. While a guard is active the decode programs run their eager
  bodies (``runtime/decode_graph.py``): a graph replay runs no Python;
- ``assert_finite(name, x)`` prints the JAX package's
  ``[checks] <name>: <n> non-finite of <size>`` line when ``x`` holds a
  non-finite value, and does not abort.

Both read values on the host, which a CUDA graph capture cannot do: under
capture they raise, naming themselves. A disabled guard adds nothing: a
wrapper's :func:`kernel_output` call returns at once.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["nan_guard", "assert_finite", "kernel_output", "guarding",
           "NonFiniteError"]

_aten = torch.ops.aten
# ops whose result holds whatever bits the allocator gave it
_FACTORIES = {_aten.empty, _aten.empty_like, _aten.empty_strided,
              _aten.new_empty, _aten.new_empty_strided}
# ops that divide: an Inf out of one is a division by zero
_DIVISIONS = {_aten.div, _aten.div_, _aten.reciprocal, _aten.reciprocal_,
              _aten.rsqrt, _aten.rsqrt_, _aten.remainder, _aten.fmod,
              _aten.floor_divide}


class NonFiniteError(FloatingPointError):
    """A guarded function produced a NaN (or, with ``div``, an Inf)."""


def refuse_capture(what: str, t: Optional[torch.Tensor] = None) -> None:
    """Raise if the current CUDA stream is being captured into a graph:
    ``what`` reads values on the host, which a replay would not do."""
    if ((t is None or t.is_cuda) and torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(f"{what} reads device values on the host and "
                           "cannot run under CUDA graph capture")


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


class _Guard(TorchDispatchMode):
    """Checks the floating results of every aten op (and of every kernel,
    through :func:`kernel_output`)."""

    def __init__(self, div: bool):
        super().__init__()
        self.div = div

    def check(self, what: str, out, inf: bool) -> None:
        for t in _tensors(out):
            if not t.is_floating_point() or t.numel() == 0:
                continue
            refuse_capture("nan_guard", t)
            nan = int(torch.isnan(t).sum())
            infs = int(torch.isinf(t).sum()) if inf else 0
            if nan or infs:
                kind = "NaN" if nan else "Inf"
                raise NonFiniteError(
                    f"nan_guard: {kind} generated by {what} ({nan} NaN, "
                    f"{infs} Inf of {t.numel()} values, shape "
                    f"{tuple(t.shape)})")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = func.overloadpacket
        if op not in _FACTORIES and not func.is_view:
            self.check(str(func), out, self.div and op in _DIVISIONS)
        return out


_active: Optional[_Guard] = None


def guarding() -> bool:
    """Whether a :func:`nan_guard` is running."""
    return _active is not None


def kernel_output(name: str, *outputs, layer: Optional[int] = None) -> None:
    """Called by each kernel wrapper right after its launch: under an
    active guard, check the kernel's outputs (``[layer]`` of each, for a
    write into a stacked cache), naming the kernel; else return at once."""
    guard = _active
    if guard is None:
        return
    for t in outputs:
        if t is not None:
            guard.check(f"kernel {name}", t if layer is None else t[layer],
                        guard.div)


def nan_guard(fn, *, div: bool = True):
    """Wrap ``fn`` so every floating result produced inside it is checked
    for NaN (and, with ``div``, for an Inf from a division or a kernel).

    Returns a callable with the same signature; on a bad value it raises
    :class:`NonFiniteError` naming the aten op or the kernel that first
    produced it. Every op's result is read on the host, so use it for
    debugging runs, not serving."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        global _active
        refuse_capture("nan_guard")
        prev, guard = _active, _Guard(div)
        _active = guard
        try:
            with guard:
                return fn(*args, **kwargs)
        finally:
            _active = prev

    return run


def assert_finite(name: str, x: torch.Tensor) -> None:
    """Spot check: print a warning iff ``x`` has any non-finite entries
    (does not abort)."""
    refuse_capture("assert_finite", x)
    bad = x.numel() - int(torch.isfinite(x).sum())
    if bad > 0:
        print(f"[checks] {name}: {bad} non-finite of {x.numel()}",
              flush=True)

"""Profiling / timing utilities.

Port of ``llm_inference_engine_tpu/utils/profiling.py``:

- ``trace``: a ``torch.profiler`` context (CPU ops and, on the card, CUDA
  activity) that writes a Chrome / Perfetto trace into ``log_dir`` and
  yields the profiler, whose ``key_averages()`` sum the time by kernel;
- ``Timer`` / ``timeit``: wall-clock timing with a real execution fence
  (``fence``: the card drained and one element read on the host, the JAX
  fence's meaning).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["trace", "Timer", "timeit", "fence"]


def fence(tree) -> None:
    """Force completion of a computation: synchronize the card (when one
    is in use) and read one element of the first tensor in ``tree`` on
    the host."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t = next((x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)),
             None)
    if t is not None and t.numel():
        t.reshape(-1)[:1].cpu()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace context: ``<log_dir>/trace.json`` (Chrome
    trace format, opens in Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            fence(None)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Accumulating named wall-clock sections."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: {tot*1e3:.2f} ms total, {n} calls, "
                         f"{tot/n*1e3:.3f} ms/call")
        return "\n".join(lines)


def timeit(fn: Callable, *args, repeats: int = 5, warmup: int = 1,
           **kwargs) -> float:
    """Best-of-N wall time of fn(*args) with execution fences. Returns
    seconds."""
    for _ in range(warmup):
        fence(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fence(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best

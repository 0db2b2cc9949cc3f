"""Intermediate-tensor dump / compare utilities.

Port of ``llm_inference_engine_tpu/utils/debug.py``, with the same
switches (``LLM_TPU_SAVE_DATA``, ``LLM_TPU_SAVE_LAYERS``) and the same
file names (``{counter:04d}_{name}.npy``, per-layer names
``L{i}_{name}``), so a directory dumped by either package diffs against
the other's with :func:`compare_dumps`:

- ``TensorDumper``: one ``.npy`` per named intermediate (bf16 values are
  widened to f32, exactly: numpy has no bf16);
- ``DebugTap`` / ``tap``: the forward pass's dump hook
  (``models/llama.py`` calls it at every kernel boundary). Disabled (the
  default) the forward does not call it, and adds no op and no launch.
  Enabled, the values are copied to the host as they are made, so the
  decode programs run their eager bodies (``runtime/decode_graph.py``);
- ``compare_dumps``: the offline diff;
- ``peek``: print the first elements of a tensor.

Dumping and ``peek`` read device values on the host: under a CUDA graph
capture they raise, naming themselves.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from llm_inference_engine_tpu_torch.utils.checks import refuse_capture

__all__ = ["TensorDumper", "DebugTap", "tap", "set_dump_dir",
           "compare_dumps", "peek"]


def _host(value, what: str) -> np.ndarray:
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)
    refuse_capture(what, value)
    value = value.detach()
    if value.dtype in (torch.bfloat16, torch.float16):
        value = value.float()
    return value.cpu().numpy()


class TensorDumper:
    """Dump named intermediates; enabled by constructing with a directory
    (or the LLM_TPU_SAVE_DATA env var), a no-op otherwise."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or os.environ.get("LLM_TPU_SAVE_DATA")
        self._counter = 0
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return bool(self.directory)

    def _path(self, name: str) -> str:
        self._counter += 1
        return os.path.join(self.directory, f"{self._counter:04d}_{name}.npy")

    def dump(self, name: str, value) -> None:
        """Write ``value`` now (files appear in call order)."""
        if not self.enabled:
            return
        np.save(self._path(name), _host(value, "TensorDumper.dump"))

    # the port runs no traced programs: a dump "inside jit" is a dump
    dump_in_jit = dump


class DebugTap:
    """The forward pass's dump hook, at the JAX package's tap points.
    Per-layer values are kept for the first ``max_layers`` layers (the
    LLM_TPU_SAVE_LAYERS env var overrides it)."""

    def __init__(self, directory: Optional[str] = None,
                 max_layers: int = 3):
        self.dumper = TensorDumper(directory)
        self.max_layers = int(os.environ.get("LLM_TPU_SAVE_LAYERS",
                                             max_layers))

    @property
    def enabled(self) -> bool:
        return self.dumper.enabled

    def wants(self, layer: Optional[int] = None) -> bool:
        """Whether a value at ``layer`` (None: a model-level value) would
        be kept: the forward computes a value only for the tap (a
        layer's output) only then."""
        return self.enabled and (layer is None or layer < self.max_layers)

    def __call__(self, name: str, value, layer: Optional[int] = None) -> None:
        if not self.wants(layer):
            return
        self.dumper.dump(name if layer is None else f"L{layer}_{name}",
                         value)


class _SinkTap(DebugTap):
    """A tap that hands every value of every layer to ``sink(name, value,
    layer)`` on the device, writing no file (calibration's statistics,
    ``models/weights.calibrate_act_sq``)."""

    def __init__(self, sink: Callable, num_layers: int):
        self.max_layers = num_layers
        self.sink = sink

    @property
    def enabled(self) -> bool:
        return True

    def __call__(self, name: str, value, layer: Optional[int] = None) -> None:
        if self.wants(layer):
            self.sink(name, value, layer)


#: process-wide tap consulted by the model forward; reconfigure with
#: set_dump_dir (tests) or the LLM_TPU_SAVE_DATA env var (CLI).
tap = DebugTap()


def set_dump_dir(directory: Optional[str], max_layers: int = 3) -> DebugTap:
    """(Re)point the global tap at ``directory`` (None disables, unless
    LLM_TPU_SAVE_DATA is set). Returns the new tap; the next forward uses
    it."""
    global tap
    tap = DebugTap(directory, max_layers)
    return tap


def compare_dumps(dir_a: str, dir_b: str, atol: float = 1e-3,
                  rtol: float = 1e-3) -> list[str]:
    """Diff two dump directories by matching file suffix (name after the
    counter). Returns list of mismatching names (empty = all close)."""

    def index(d):
        out = {}
        for f in sorted(os.listdir(d)):
            if f.endswith(".npy"):
                out[f.split("_", 1)[1]] = os.path.join(d, f)
        return out

    a, b = index(dir_a), index(dir_b)
    bad = []
    for name in sorted(set(a) & set(b)):
        x, y = np.load(a[name]), np.load(b[name])
        if x.shape != y.shape or not np.allclose(
                x.astype(np.float64), y.astype(np.float64), atol=atol,
                rtol=rtol):
            bad.append(name)
    bad += [f"missing:{n}" for n in sorted(set(a) ^ set(b))]
    return bad


def peek(name: str, value, num: int = 8) -> None:
    """Print the first ``num`` elements of a tensor."""
    print(f"{name}: {_host(value.reshape(-1)[:num], 'peek')}", flush=True)

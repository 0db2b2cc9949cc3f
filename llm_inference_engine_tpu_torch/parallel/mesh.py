"""Device mesh construction.

Port of ``llm_inference_engine_tpu/parallel/mesh.py`` for the data and
model axes. The JAX package's mesh is a ``jax.sharding.Mesh`` that one
program drives through ``shard_map``; here a :class:`Mesh` is an array
``[dp, tp]`` of ``torch.device``s that one controller drives
(``parallel/sharding.py``): each (data, model) rank holds its shard
tensors on its device and runs its layer body on its local shapes.

Axes:
- ``data``  — batch-slot parallelism: data rank d owns the slots
  ``[d * B / dp, (d + 1) * B / dp)`` and their rows of the KV cache;
- ``model`` — tensor parallelism: column-sharded QKV and gate|up,
  row-sharded o and down with a cross-rank sum after each, the KV cache
  sharded over kv-head groups, a vocab-sharded lm_head.

A mesh's devices need not differ: ``devices=[torch.device("cpu")] * n``
(the CPU tests, the counterpart of the JAX tests' virtual CPU devices)
and ``[torch.device("cuda", 0)] * n`` (one card) are meshes too. The
context-parallel ``seq`` axis is not ported (ROADMAP.md, queue 1,
"Context parallelism").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "local_config", "validate_mesh",
           "DATA_AXIS", "MODEL_AXIS"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """devices: object array [dp, tp] of ``torch.device``; the data axis
    first, the model axis innermost, as in the JAX package."""

    devices: np.ndarray

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them."""
        dp, tp = self.devices.shape
        return {DATA_AXIS: dp, MODEL_AXIS: tp}

    @property
    def dp(self) -> int:
        return self.devices.shape[0]

    @property
    def tp(self) -> int:
        return self.devices.shape[1]

    @property
    def home(self) -> torch.device:
        """Rank (0, 0)'s device: where the engine keeps what every rank
        shares (the batch's inputs, sampling state, logits)."""
        return self.devices[0, 0]

    @property
    def one_device(self) -> bool:
        """Whether every rank lies on the same device."""
        return len(set(self.devices.flat)) == 1

    def same_as(self, other: "Mesh") -> bool:
        """Whether ``other`` has this mesh's shape and each rank's device
        (the same ranks on the same devices)."""
        return (self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat)))


def make_mesh(dp: int = 1, tp: int = 1,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Build a (data=dp, model=tp) mesh. ``devices`` defaults to
    ``cuda:0 ... cuda:n-1``; pass ``[torch.device("cpu")] * n`` for the
    CPU, or ``[torch.device("cuda", 0)] * n`` for n ranks on one card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = dp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices for dp={dp} tp={tp}, "
                         f"have {len(devices)}")
    arr = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devices[:n]):
        arr[i // tp, i % tp] = torch.device(d)
    return Mesh(arr)


def validate_mesh(config, engine_config, mesh: Mesh) -> None:
    """Static divisibility checks for the TP/DP layout (the JAX package's
    problem strings), and one more: under INT4 weights, a row shard's
    contraction length must be a whole number of scale groups."""
    tp, dp = mesh.tp, mesh.dp
    problems = []
    if config.num_kv_heads % tp:
        problems.append(f"num_kv_heads {config.num_kv_heads} % tp {tp}")
    if config.intermediate_size % tp:
        problems.append(
            f"intermediate_size {config.intermediate_size} % tp {tp}")
    if config.vocab_size % tp:
        problems.append(f"vocab_size {config.vocab_size} % tp {tp}")
    if engine_config.max_batch_size % dp:
        problems.append(
            f"max_batch_size {engine_config.max_batch_size} % dp {dp}")
    if engine_config.quant_mode == "int4":
        # a row shard of wo / w_down must hold whole scale groups
        g = engine_config.quant_group_size
        for name, k in (("wo", config.q_size),
                        ("w_down", config.intermediate_size)):
            if (k // tp) % g:
                problems.append(f"int4 {name} row shard k {k} / tp {tp} = "
                                f"{k // tp} % group_size {g}")
    if problems:
        raise ValueError("mesh/config mismatch: " + "; ".join(problems))


def local_config(config, mesh: Mesh):
    """The per-rank model shape under tensor parallelism (what each
    rank's layer body computes with)."""
    tp = mesh.tp
    return config.replace(
        num_heads=config.num_heads // tp,
        num_kv_heads=config.num_kv_heads // tp,
    )

"""Device mesh construction.

Port of ``llm_inference_engine_tpu/parallel/mesh.py``. The JAX package's
mesh is a ``jax.sharding.Mesh`` that one program drives through
``shard_map``; here a :class:`Mesh` is an array ``[dp, cp, tp]`` of
``torch.device``s that one controller drives (``parallel/sharding.py``,
``parallel/cp_engine.py``): each (data, seq, model) rank holds its shard
tensors on its device and runs its layer body on its local shapes.

Axes, in the JAX package's order:
- ``data``  — batch-slot parallelism: data rank d owns the slots
  ``[d * B / dp, (d + 1) * B / dp)`` and their rows of the KV cache;
- ``seq``   — context parallelism: the KV cache's token capacity splits
  over the seq ranks, each holding an append log of ``S / cp`` rows;
  prefill runs ring attention, decode split-KV
  (``parallel/context_parallel.py``, ``parallel/cp_engine.py``);
- ``model`` — tensor parallelism: column-sharded QKV and gate|up,
  row-sharded o and down with a cross-rank sum after each, the KV cache
  sharded over kv-head groups, a vocab-sharded lm_head.

A mesh's devices need not differ: ``devices=[torch.device("cpu")] * n``
(the CPU tests, the counterpart of the JAX tests' virtual CPU devices)
and ``[torch.device("cuda", 0)] * n`` (one card) are meshes too.
:attr:`Mesh.devices` is the ``[dp, tp]`` face of seq rank 0 (every rank
of a mesh with cp = 1), which the data and model code indexes as
``devices[d, r]``; :meth:`Mesh.device` takes all three indices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "local_config", "validate_mesh",
           "DATA_AXIS", "SEQ_AXIS", "MODEL_AXIS"]

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """grid: object array [dp, cp, tp] of ``torch.device``; the data axis
    first, the model axis innermost, as in the JAX package."""

    grid: np.ndarray

    @property
    def devices(self) -> np.ndarray:
        """[dp, tp]: seq rank 0's devices, ``devices[d, r]``."""
        return self.grid[:, 0, :]

    def device(self, d: int, s: int, r: int) -> torch.device:
        """Rank (d, s, r)'s device."""
        return self.grid[d, s, r]

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them
        (``seq`` only where cp > 1)."""
        if self.cp == 1:
            return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}
        return {DATA_AXIS: self.dp, SEQ_AXIS: self.cp, MODEL_AXIS: self.tp}

    @property
    def dp(self) -> int:
        return self.grid.shape[0]

    @property
    def cp(self) -> int:
        return self.grid.shape[1]

    @property
    def tp(self) -> int:
        return self.grid.shape[2]

    @property
    def home(self) -> torch.device:
        """Rank (0, 0, 0)'s device: where the engine keeps what every rank
        shares (the batch's inputs, sampling state, logits)."""
        return self.grid[0, 0, 0]

    @property
    def one_device(self) -> bool:
        """Whether every rank lies on the same device."""
        return len(set(self.grid.flat)) == 1

    def __str__(self) -> str:
        axes = " ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"mesh {axes} over {[str(d) for d in self.grid.flat]}"

    def same_as(self, other: "Mesh") -> bool:
        """Whether ``other`` has this mesh's shape and each rank's device
        (the same ranks on the same devices)."""
        return (self.grid.shape == other.grid.shape
                and all(a == b for a, b in zip(self.grid.flat,
                                               other.grid.flat)))


def make_mesh(dp: int = 1, tp: int = 1, cp: int = 1,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Build a (data=dp, seq=cp, model=tp) mesh. ``devices`` defaults to
    ``cuda:0 ... cuda:n-1``; pass ``[torch.device("cpu")] * n`` for the
    CPU, or ``[torch.device("cuda", 0)] * n`` for n ranks on one card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = dp * cp * tp
    if len(devices) < n:
        axes = f"dp={dp} tp={tp}" if cp == 1 else f"dp={dp} cp={cp} tp={tp}"
        raise ValueError(f"need {n} devices for {axes}, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(arr.reshape(dp, cp, tp))


def validate_mesh(config, engine_config, mesh: Mesh) -> None:
    """Static divisibility checks for the TP/DP/CP layout (the JAX
    package's problem strings), and one more: under INT4 weights, a row
    shard's contraction length must be a whole number of scale groups."""
    tp, dp, cp = mesh.tp, mesh.dp, mesh.cp
    problems = []
    if cp > 1 and engine_config.max_seq_len % cp:
        problems.append(f"max_seq_len {engine_config.max_seq_len} % cp {cp}")
    if cp > 1 and max(1, engine_config.max_prefill_len) % cp:
        problems.append(
            f"max_prefill_len {engine_config.max_prefill_len} % cp {cp}")
    if cp > 1 and engine_config.max_prefill_len < 2 * cp:
        # a prefill chunk gives every rank >= 2 query rows (a 1-row chunk
        # is indistinguishable from the decode path)
        problems.append(
            f"max_prefill_len {engine_config.max_prefill_len} < 2*cp")
    if cp > 1 and (cp & (cp - 1) or cp > 8):
        # prefill chunk buckets are powers of two >= 16, and every bucket
        # splits evenly over the seq axis
        problems.append(f"cp {cp} must be a power of two <= 8")
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

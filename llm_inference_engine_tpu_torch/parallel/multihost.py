"""Multi-host serving support: the process group and the lockstep plan.

Port of ``llm_inference_engine_tpu/parallel/multihost.py``. The JAX
package brings up ``jax.distributed`` and builds one mesh over every
host's devices, which one program drives. Here each process drives its
own devices (``parallel/mesh.py``: one controller over a mesh of torch
devices), and the processes of a deployment form a ``torch.distributed``
group on gloo, over which they exchange scheduler metadata only:

- tensor parallelism stays inside a host: its two sums a layer are on
  the token path;
- data parallelism crosses hosts: each host runs its own engine over its
  local slots, and only the per-step plan (:func:`agree_step_plan`, three
  int32 a host) crosses the network;
- hosts in lockstep (``runtime/multihost_scheduler.py``) enter the same
  step kind with the same chunk length every step, and exit together.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from llm_inference_engine_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["initialize_multihost", "make_multihost_mesh", "StepPlan",
           "agree_step_plan", "process_count"]


def process_count() -> int:
    """Processes in the group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Join the gloo process group at ``coordinator_address``
    ("host:port"), else at ``MASTER_ADDR``:``MASTER_PORT``, with
    ``num_processes`` (else ``WORLD_SIZE``) processes as ``process_id``
    (else ``RANK``). A no-op when the group is up already, or in one
    process: no address, or a world of one. The group is destroyed at
    exit, before the interpreter tears down its threads."""
    if process_count() > 1 or not dist.is_available():
        return
    address = coordinator_address
    if address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    if address is None or world <= 1:
        return
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    atexit.register(_destroy_group)


def _destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_multihost_mesh(dp: int = 1, tp: int = 1,
                        devices: Optional[Sequence[torch.device]] = None
                        ) -> Mesh:
    """This process's part of a (data=dp, model=tp) mesh over the whole
    group: dp / processes data ranks over this host's ``devices`` (default
    ``cuda:0 ... cuda:n-1``), each a tp group of them. The model axis must
    not cross hosts: tp has to tile the devices a host has."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    hosts = process_count()
    if dp % hosts:
        raise ValueError(f"dp={dp} does not split over {hosts} hosts")
    c = len(devices)
    if tp > c and tp % c != 0 and c % tp != 0:
        raise ValueError(
            f"tp={tp} does not tile the {c} devices per host; model-"
            f"axis collectives would cross hosts")
    return make_mesh(dp // hosts, tp, devices=devices)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """The per-step choice every host agrees on.

    ``prefill_len``: the padded chunk-length bucket this step (0 = no host
    has a chunk in flight: the pure decode step); hosts without admissions
    still run the mixed step at that length. ``kv_hi``: the largest
    context length over hosts after this step, agreed as the JAX package
    agrees its attention watermark; the port's attention reads ``kv_len``
    per sequence, so nothing reads it. ``any_work``: False only when every
    host is idle (hosts exit in lockstep).
    """

    prefill_len: int
    kv_hi: int
    any_work: bool


def agree_step_plan(local_prefill_len: int, local_kv_hi: int,
                    local_has_work: bool) -> StepPlan:
    """All-gather each host's three int32 over the group (on the CPU, over
    gloo) and reduce them the same way on every host: ``prefill_len``
    max, ``kv_hi`` max, ``any_work`` any. In one process the gathered rows
    are this process's."""
    vec = torch.tensor([int(local_prefill_len), int(local_kv_hi),
                        int(bool(local_has_work))], dtype=torch.int32)
    n = process_count()
    if n > 1:
        rows = [torch.empty_like(vec) for _ in range(n)]
        dist.all_gather(rows, vec)
        vec = torch.stack(rows)
    rows = vec.reshape(-1, 3)
    return StepPlan(prefill_len=int(rows[:, 0].max()),
                    kv_hi=int(rows[:, 1].max()),
                    any_work=bool(rows[:, 2].any()))

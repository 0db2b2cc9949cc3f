"""CUDA-graph capture and replay of the engine's decode programs.

The JAX engine runs its decode step (``_decode_step``), its greedy rollout
(``_decode_rollout``, a ``lax.scan``) and its sampled rollout
(``_sampled_rollout``, a ``while_loop``) as jitted device programs
(``llm_inference_engine_tpu/runtime/engine.py``). PyTorch's counterpart
of a jitted program is a captured CUDA graph. :func:`capture` runs a body
once eagerly to warm it up (Triton's JIT, the kernel library's build and
first-call attributes, cuBLAS's workspace on the capture stream), then
records it into a graph with a memory pool of its own; :class:`Program`
replays it. A graph replays fixed addresses, so a body reads every
per-step input from static device buffers, and keeps all its state in
them, which the engine updates in place (``runtime/engine.py``).

What a replay cannot do by itself is handled here:

- launch counters: a replay calls no wrapper, so :func:`capture` records
  how many launches of each counted wrapper (``ops.counted_wrappers``) the
  body made, and :meth:`Program.replay` adds them on every replay;
- host reads: a body that reads a device value on the host cannot be
  captured. :class:`NoHostReads` raises on such an op, naming it; the
  capture runs under it, and the CPU tests run the bodies under it;
- early exit: the JAX while-loop stops once no row is active. Here the
  host replays a rollout's step and reads a device "any row active" flag
  every ``FLAG_EVERY`` replays through :class:`FlagPoll`, the flag of the
  block before the one just enqueued, so it never waits on the card's
  newest step. Steps after every row stopped change nothing (no row
  writes K/V, lengths and counts stay, every row emits -1), so stopping
  late wastes at most 2 * FLAG_EVERY - 1 steps and changes no output.

On the CPU the engine runs the bodies eagerly (graphs need a card);
:func:`run_eagerly` does the same on the card, as the reference the
replays are held against. So does :func:`run` while the debug tap
(``utils/debug.py``) or a ``nan_guard`` (``utils/checks.py``) is active:
both read each value on the host as it is made, and a replay runs no
Python.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from llm_inference_engine_tpu_torch.ops import counted_wrappers
from llm_inference_engine_tpu_torch.utils import checks, debug

__all__ = ["FLAG_EVERY", "FlagPoll", "HostReadError", "NoHostReads",
           "Program", "capture", "run", "run_eagerly"]

# replays between two reads of a rollout's "any row active" flag
FLAG_EVERY = 4

_aten = torch.ops.aten
# ops whose result is a host value read from the device
_READS = {_aten._local_scalar_dense, _aten.item, _aten.is_nonzero,
          _aten.equal, _aten.nonzero, _aten.masked_select,
          _aten.lift_fresh, _aten.lift_fresh_copy}
_INDEXING = {_aten.index, _aten.index_put, _aten.index_put_,
             _aten._index_put_impl_}


class HostReadError(RuntimeError):
    """A decode body read a device value on the host."""


def _host_read(func, args, kwargs) -> Optional[str]:
    """Why ``func(*args, **kwargs)`` reads the device on the host, or
    None."""
    op = func.overloadpacket
    if op in _READS:
        return "returns a device value to the host"
    if op in _INDEXING:
        indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(isinstance(i, torch.Tensor)
               and i.dtype in (torch.bool, torch.uint8) for i in indices):
            return "indexes with a mask (its size is read on the host)"
    if op is _aten._to_copy:
        device = kwargs.get("device")
        if device is not None and torch.device(device).type == "cpu":
            return "copies to the CPU"
    if op is _aten.copy_ and len(args) > 1:
        dst, src = args[0], args[1]
        if (isinstance(src, torch.Tensor) and dst.device.type == "cpu"
                and src.device.type != "cpu"):
            return "copies to the CPU"
    return None


class NoHostReads(TorchDispatchMode):
    """Raise :class:`HostReadError`, naming the op and the program, on any
    op that reads a device value on the host: ``.item()`` and everything
    built on it (``bool(t)``, ``int(t)``), ``nonzero``, indexing with a
    mask, a tensor made from host data, a copy to the CPU."""

    def __init__(self, program: str):
        super().__init__()
        self.program = program

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        why = _host_read(func, args, kwargs)
        if why is not None:
            raise HostReadError(f"decode program {self.program!r}: {func} "
                                f"{why}; a captured graph cannot")
        return func(*args, **kwargs)


class Program:
    """One captured decode program: its graph, and the launches of each
    counted wrapper that one run of it makes."""

    def __init__(self, graph, launches):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n


def capture(name: str, body: Callable[[], None],
            generator: Optional[torch.Generator] = None) -> Program:
    """Warm ``body`` up once eagerly, then capture it into a graph with a
    memory pool of its own. The caller puts the state where one run of the
    body changes nothing (no row active); ``generator``'s state is put back
    after the warm-up, and the generator is registered with the graph, so
    each replay draws fresh noise in the order eager steps would. Raises
    :class:`HostReadError` naming the op if the body reads a device value
    on the host, and RuntimeError for any other capture failure."""
    wrappers = counted_wrappers()
    state = generator.get_state() if generator is not None else None
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        body()
    torch.cuda.current_stream().wait_stream(stream)
    if generator is not None:
        generator.set_state(state)
    warm = [w.launches for w in wrappers]
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    try:
        with NoHostReads(name), torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"):
            body()
    except HostReadError:
        raise
    except Exception as e:
        raise RuntimeError(f"capture of decode program {name!r} failed: "
                           f"{e}") from e
    finally:
        # a capture launches nothing: its wrapper calls are not launches
        launches = [(w, w.launches - n) for w, n in zip(wrappers, warm)]
        for w, n in zip(wrappers, warm):
            w.launches = n
    return Program(graph, [(w, n) for w, n in launches if n])


def run(owner, name: str, keep=(), quiet: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None) -> None:
    """Run ``owner``'s body ``_<name>_body`` once: eagerly where
    ``owner._programs`` is None (the CPU, :func:`run_eagerly`) or a tap or
    guard watches the values, else replay its program, captured at the first run. The capture's warm-up
    runs with ``quiet`` (the body's "row active" input) zeroed, so that it
    writes no K/V; then the ``keep`` tensors (the state the warm-up would
    move, ``quiet`` among them or inside one) are put back."""
    body = getattr(owner, f"_{name}_body")
    if owner._programs is None or debug.tap.enabled or checks.guarding():
        body()
        return
    program = owner._programs.get(name)
    if program is None:
        saved = [t.clone() for t in keep]
        if quiet is not None:
            quiet.zero_()
        program = owner._programs[name] = capture(name, body, generator)
        for t, v in zip(keep, saved):
            t.copy_(v)
    program.replay()


class FlagPoll:
    """Reads a rollout's device "any row active" flag on the host every
    ``every`` replays. On the card the flag of each block of ``every``
    replays is copied to pinned memory behind the block, and the host
    reads the copy of the block before, so it never waits on the newest
    step; on the CPU the flag is read at once."""

    def __init__(self, flag: torch.Tensor, every: int = FLAG_EVERY):
        self.flag, self.every = flag, every
        if flag.is_cuda:
            self.host = torch.zeros((2, *flag.shape), dtype=flag.dtype,
                                    pin_memory=True)
            self.copied = [torch.cuda.Event(), torch.cuda.Event()]

    def running(self, done: int) -> bool:
        """After ``done`` replays of this rollout: False once a flag read
        says no row is active."""
        if done % self.every:
            return True
        if not self.flag.is_cuda:
            return bool(self.flag.any())
        block = done // self.every
        slot = block % 2
        self.host[slot].copy_(self.flag, non_blocking=True)
        self.copied[slot].record()
        if block < 2:
            return True
        self.copied[1 - slot].synchronize()
        return bool(self.host[1 - slot].any())


@contextlib.contextmanager
def run_eagerly(engine):
    """Inside, ``engine`` (an engine, a ``SpeculativeDecoder`` or a
    ``BeamSearch``: whatever holds ``_programs``) runs its decode bodies
    eagerly on the card, as on the CPU: the reference that replays are
    held against (chip_smoke.py, the card tests). Nothing in the package
    enters it."""
    programs, engine._programs = engine._programs, None
    try:
        yield engine
    finally:
        engine._programs = programs

"""Multi-host continuous batching: lockstep scheduling and request routing.

Port of ``llm_inference_engine_tpu/runtime/multihost_scheduler.py``. Two
deployment shapes (``parallel/multihost.py``):

1. **Data parallelism across hosts**: every host runs its own engine and
   ``ContinuousBatchingScheduler``; nothing crosses hosts on the token
   path. :class:`RequestRouter` spreads an open request stream over the
   hosts' schedulers, least loaded first.

2. **Hosts in lockstep**: every host must take the same step each time
   (the mixed chunked-prefill step at one agreed chunk length, or the pure
   decode step) although requests reach each host on their own.
   :class:`MultiHostScheduler` agrees before every step on three scalars
   over the process group (``agree_step_plan``): hosts without local
   admissions run the agreed prefill with their live rows' decode tokens
   or none, hosts without work run the decode step with no row active,
   and all hosts exit together once no host has work. The plan's ``kv_hi``
   is agreed as in the JAX package, but the port's attention reads
   ``kv_len`` per sequence, so nothing uses it.

In one process the agreement is the identity, so the lockstep scheduler
does what ``ContinuousBatchingScheduler`` does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from llm_inference_engine_tpu_torch.config import SamplingParams
from llm_inference_engine_tpu_torch.parallel.multihost import agree_step_plan
from llm_inference_engine_tpu_torch.runtime.engine import _bucket_len
from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler, Request)

__all__ = ["MultiHostScheduler", "RequestRouter"]


class MultiHostScheduler(ContinuousBatchingScheduler):
    """ContinuousBatchingScheduler with every step gated on the agreed
    ``StepPlan`` (shape 2 of the module docstring)."""

    def __init__(self, engine, eos_token_id=2, prefix_store=None):
        if getattr(engine, "paged", False):
            raise NotImplementedError(
                "paged KV + lockstep multihost scheduling: preemption and "
                "page allocation are host-local; use the DP router shape")
        super().__init__(engine, eos_token_id, prefix_store)

    def step(self) -> list[Request]:
        """One lockstep step: the mixed chunked-prefill step at the agreed
        chunk length when any host has a chunk in flight (local chunks pad
        to it; hosts without admissions feed their live rows' pending
        decode tokens as one-token chunks, idle hosts nothing), else the
        pure decode step."""
        before = [r for r in self.slots if r is not None]
        done: list[Request] = list(self._dropped)
        self._dropped = []

        admitted = self._assign_slots()
        for r in admitted:
            r.prefill_pos = 0
        if admitted:
            self.engine.reset([r.slot for r in admitted])
        done += [r for r in admitted if r.finished]

        C = max(1, self.engine.engine_config.max_prefill_len)
        prefilling = [r for r in self.slots
                      if r is not None and r.prefill_pos is not None]

        # the lockstep point: this step's chunk-length bucket (0 on hosts
        # with nothing mid-prefill) and the longest context after this
        # step's writes (a chunk for prefilling rows, one for decoding rows)
        local_chunk = max([min(len(r.prompt_ids) - r.prefill_pos, C)
                           for r in prefilling] or [0])
        local_len = _bucket_len(local_chunk, cap=C) if local_chunk else 0
        projected = self.engine._lengths.copy()
        for r in self.slots:
            if r is None:
                continue
            if r.prefill_pos is not None:
                projected[r.slot] += min(len(r.prompt_ids) - r.prefill_pos, C)
            else:
                projected[r.slot] += 1
        plan = agree_step_plan(local_len, int(projected.max()),
                               self.has_work)
        self._plan = plan
        if not plan.any_work:
            return done

        if plan.prefill_len > 0:
            chunks: list[list[int]] = []
            call_slots: list[int] = []
            decode_rows: list[Request] = []
            for r in self.slots:
                if r is None:
                    continue
                if r.prefill_pos is not None:
                    chunk = r.prompt_ids[r.prefill_pos:r.prefill_pos + C]
                    r.prefill_pos += len(chunk)
                    chunks.append(chunk)
                else:
                    chunks.append([int(self._last_token[r.slot])])
                    decode_rows.append(r)
                call_slots.append(r.slot)
            logits = self.engine.prefill(chunks, slots=call_slots,
                                         pad_to=plan.prefill_len)
            count_mask = np.zeros((self.B,), bool)
            for r in decode_rows:
                count_mask[r.slot] = True
            for r in prefilling:
                count_mask[r.slot] = r.prefill_pos >= len(r.prompt_ids)
            nxt, lp = self.engine.sample(
                logits, self._temp, self._topk, self._topp,
                extras=self._samp_arrays[3], count_mask=count_mask,
                return_logprobs=True)
            nxt, lp = nxt.cpu().numpy(), lp.cpu().numpy()
            for r in decode_rows:
                self._accept_token(r, int(nxt[r.slot]), float(lp[r.slot]))
            for r in prefilling:
                if r.prefill_pos >= len(r.prompt_ids):
                    r.prefill_pos = None
                    self._accept_token(r, int(nxt[r.slot]),
                                       float(lp[r.slot]))
        else:
            active_mask = np.array([r is not None and not r.finished
                                    for r in self.slots], bool)
            nxt, lp = self.engine.decode_step(
                self._last_token, active_mask, self._samp_arrays,
                return_logprobs=True)
            nxt, lp = nxt.cpu().numpy(), lp.cpu().numpy()
            for slot in np.nonzero(active_mask)[0]:
                req = self.slots[slot]
                if req is not None:
                    self._accept_token(req, int(nxt[slot]),
                                       float(lp[slot]))

        done += [r for r in before + admitted
                 if r.finished and r not in done]
        return done

    def run(self, max_steps: int = 1_000_000) -> list[Request]:
        """Drive until NO host has work (the agreed ``any_work``: hosts
        exit in lockstep, not when their own queue drains)."""
        finished: list[Request] = []
        self._plan = None
        for _ in range(max_steps):
            finished += self.step()
            if not self._plan.any_work:
                break
        return finished


class RequestRouter:
    """Front door of data parallelism across hosts (shape 1): requests go
    to the least-loaded of independent schedulers."""

    def __init__(self, schedulers: Sequence[ContinuousBatchingScheduler]):
        if not schedulers:
            raise ValueError("need at least one scheduler")
        self.schedulers = list(schedulers)

    def _load(self, s: ContinuousBatchingScheduler) -> tuple[int, int]:
        return (len(s.waiting), s.num_active)

    def submit(self, prompt_ids: Sequence[int],
               sampling: SamplingParams = SamplingParams(),
               stream_callback=None) -> Request:
        target = min(self.schedulers, key=self._load)
        return target.submit(prompt_ids, sampling, stream_callback)

    @property
    def has_work(self) -> bool:
        return any(s.has_work for s in self.schedulers)

    def step(self) -> list[Request]:
        """One step on every scheduler that has work (in a deployment each
        host steps its own; this drives them all in one process)."""
        done: list[Request] = []
        for s in self.schedulers:
            if s.has_work:
                done += s.step()
        return done

    def run(self, max_steps: int = 1_000_000) -> list[Request]:
        finished: list[Request] = []
        for _ in range(max_steps):
            if not self.has_work:
                break
            finished += self.step()
        return finished

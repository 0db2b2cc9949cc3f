"""Continuous batching with speculative decoding.

Port of ``llm_inference_engine_tpu/runtime/speculative_scheduler.py``:
the scheduler multiplexes a request stream onto batch slots
(``scheduler.py``), and every pure-decode step is a speculative round
(``speculative.py``, a captured device program on the card) that can emit
up to k + 1 tokens per target forward.

The draft cache's lengths equal the target's at every round boundary:
admissions prefill the same chunks into both engines (the base
scheduler's ``_mirror_reset`` / ``_mirror_prefill`` hooks; a mixed step's
live rows go to both as one-token chunks), and a freshly accepted token
is ingested by neither cache: it is the next round's ``last``, which the
round's draft steps ingest first and the verify block alongside the
drafts. Greedy and sampled requests both run (a batch whose active slots
are all greedy takes the cheaper greedy round); penalties run with the
counts frozen at each round's start. A slot needs k + 2 rows of headroom
a round, so requests finish with reason 'capacity' slightly earlier than
under the plain scheduler. Prefix caching restores paired snapshots into
both caches (``prefix_cache.DualPrefixStore``). Paged engines are
refused, as in the JAX package, with its messages. Two engines on one
dp x tp mesh run as two one-device engines do: the mixed steps prefill
both through their sharded forwards, the rounds run over the mesh
(``speculative.py``), and the paired snapshots are taken and restored
per shard.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)
from llm_inference_engine_tpu_torch.runtime.speculative import (
    SpeculativeDecoder)

__all__ = ["SpeculativeScheduler"]


class SpeculativeScheduler(ContinuousBatchingScheduler):
    def __init__(self, target, draft, eos_token_id: Optional[int] = 2,
                 num_draft: int = 4):
        if (target.engine_config.max_batch_size
                != draft.engine_config.max_batch_size):
            raise ValueError("target/draft max_batch_size mismatch")
        if target.paged or draft.paged:
            raise NotImplementedError(
                "speculative scheduling uses the slot KV layout")
        # refuses a vocabulary mismatch, engines on other devices or
        # meshes, and context-parallel engines
        self._spec = SpeculativeDecoder(target, draft, num_draft)
        super().__init__(target, eos_token_id)
        self.draft = draft
        self.k = num_draft
        self.num_drafted = 0
        self.num_accepted = 0

    @property
    def acceptance_rate(self) -> float:
        return self.num_accepted / max(self.num_drafted, 1)

    def register_prefix(self, tokens):
        """Register a shared prefix as a pair of snapshots (target and
        draft) restored into both caches (``DualPrefixStore``)."""
        if self.prefix_store is None:
            from llm_inference_engine_tpu_torch.runtime.prefix_cache import (
                DualPrefixStore)
            self.prefix_store = DualPrefixStore(self.engine, self.draft)
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free:
            raise RuntimeError("no free slot to register a prefix on")
        return self.prefix_store.register(tokens, slot=free[0])

    # -- base-scheduler hooks: keep the draft cache in lockstep ----------

    def _mirror_reset(self, slots):
        self.draft.reset(slots)

    def _mirror_prefill(self, chunks, slots):
        self.draft.prefill(chunks, slots=slots)

    # -- decode steps become draft/verify rounds -------------------------

    def _decode_phase(self) -> None:
        """One draft/verify round over every live slot; accepts up to
        k + 1 tokens a slot, with their target logprobs."""
        target, k = self.engine, self.k
        max_room = target.engine_config.max_seq_len - k - 2
        active = np.array([r is not None and not r.finished
                           for r in self.slots], bool)
        # rows without a round's headroom cannot draft: finish them
        for slot in np.nonzero(active)[0]:
            if target._lengths[slot] >= max_room:
                self._finish(self.slots[slot], "capacity")
                active[slot] = False
        if not active.any():
            return
        # the all-greedy batch takes the exact-argmax round (no [B, k, V]
        # distributions)
        sampled = not (self._temp[active] <= 0.0).all()
        emitted, emitted_lp, n_acc = self._spec.run_round(
            self._last_token, active, self._samp_arrays, sampled)

        for slot in np.nonzero(active)[0]:
            req = self.slots[slot]
            if req is None:
                continue
            self.num_drafted += k
            self.num_accepted += int(n_acc[slot])
            for j in range(int(n_acc[slot]) + 1):
                self._accept_token(req, int(emitted[slot, j]),
                                   float(emitted_lp[slot, j]))
                if req.finished:
                    break

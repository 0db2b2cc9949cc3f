"""Continuous batching scheduler.

Port of ``llm_inference_engine_tpu/runtime/scheduler.py``, which is
framework-free: only the imports changed, and the engine's sampled ids
and logprobs (tensors on the engine's device) are copied to the host
explicitly. The hooks ``_mirror_reset`` and ``_mirror_prefill`` and
``_decode_phase`` are filled by ``SpeculativeScheduler``
(``speculative_scheduler.py``).

The capability the reference explicitly lacked: its batch size is pinned to
1 (reference: llama.h:31) and one request owns the whole engine for its
lifetime. Here the engine exposes ``max_batch_size`` static slots and this
scheduler multiplexes an open-ended request stream onto them:

- admission: free slots are filled from the waiting queue; the admitted
  prompts are prefilled *into their slots* in one batched call while other
  slots keep decoding state untouched (slot-targeted prefill writes past
  live slots' frontiers, which the next decode step overwrites — see
  InferenceEngine.prefill);
- every step all live slots decode together, each with its own sampling
  parameters (per-slot temperature/top-k/top-p arrays — no recompile per
  request mix);
- completion: EOS, per-request max_new_tokens, or cache-capacity exhaustion
  frees the slot for the next admission.

Shapes stay static (a requirement of the JAX package, and what lets a
later CUDA-graph capture replay one step shape): variable load changes
array *contents* (active mask, lengths), never shapes.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from llm_inference_engine_tpu_torch.config import SamplingParams

__all__ = ["Request", "ContinuousBatchingScheduler"]


@dataclasses.dataclass
class Request:
    id: int
    prompt_ids: list[int]
    sampling: SamplingParams
    stream_callback: Optional[Callable[[int], None]] = None
    output_ids: list[int] = dataclasses.field(default_factory=list)
    token_logprobs: list[float] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str = ""           # eos | length | capacity | rejected |
                                      # cancelled
    slot: int = -1
    prefill_pos: Optional[int] = None  # mid-prefill progress (chunked admit)
    reused_prefix_len: int = 0         # prompt tokens served from PrefixStore
    preemptions: int = 0               # paged-pool recompute preemptions
    # serving latency accounting (time.monotonic seconds)
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        """Submit -> first generated token (None until it exists)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def e2e_latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.submit_time


class ContinuousBatchingScheduler:
    def __init__(self, engine, eos_token_id: Optional[int] = 2,
                 prefix_store=None, auto_prefix_cache: bool = False,
                 auto_prefix_pages: Optional[int] = None):
        self.engine = engine
        self.eos_token_id = eos_token_id
        self.prefix_store = prefix_store
        self.auto_prefix = None
        if auto_prefix_cache:
            from llm_inference_engine_tpu_torch.runtime.prefix_cache import (
                AutoPrefixCache)
            if auto_prefix_pages is None:
                # default to half the actual pool: the cache is evicted
                # under allocation pressure anyway (evict_for), the cap
                # only bounds steady-state HBM held by idle prefixes
                alloc = getattr(engine, "_allocator", None)
                auto_prefix_pages = (max(1, alloc.num_pages // 2)
                                     if alloc is not None else 1024)
            self.auto_prefix = AutoPrefixCache(engine,
                                               max_pages=auto_prefix_pages)
        self.B = engine.engine_config.max_batch_size
        self.max_seq = engine.engine_config.max_seq_len
        self.waiting: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * self.B
        self._ids = itertools.count()
        self._dropped: list[Request] = []   # finished outside a slot
                                            # (reported by the next step)
        # per-slot decoding state (host mirrors)
        self._last_token = np.zeros((self.B,), np.int32)
        self._temp = np.zeros((self.B,), np.float32)
        self._topk = np.ones((self.B,), np.int32)
        self._topp = np.ones((self.B,), np.float32)
        self._minp = np.zeros((self.B,), np.float32)
        self._rep = np.ones((self.B,), np.float32)
        self._pres = np.zeros((self.B,), np.float32)
        self._freq = np.zeros((self.B,), np.float32)

    @property
    def _samp_arrays(self):
        return (self._temp, self._topk, self._topp,
                (self._minp, self._rep, self._pres, self._freq))

    # ------------------------------------------------------------------

    def submit(self, prompt_ids: Sequence[int],
               sampling: SamplingParams = SamplingParams(),
               stream_callback: Optional[Callable[[int], None]] = None
               ) -> Request:
        req = Request(id=next(self._ids), prompt_ids=list(prompt_ids),
                      sampling=sampling, stream_callback=stream_callback,
                      submit_time=time.monotonic())
        # reject prompts that can NEVER fit (max_seq, or the whole paged
        # pool) — they would head-of-line block the admission gate forever
        too_long = (len(req.prompt_ids) >= self.max_seq
                    or len(req.prompt_ids) + 1
                    > self.engine.max_pool_tokens())
        if too_long:
            req.finished = True
            req.finish_reason = "rejected"
            req.finish_time = req.submit_time
        else:
            self.waiting.append(req)
        return req

    def cancel(self, req: Request) -> bool:
        """Abort a request: drop it from the waiting queue, or free its
        slot mid-flight (mid-prefill included — the slot's cache rows are
        simply reused by the next admission). Returns False if it already
        finished. The reference had no cancellation at all (one blocking
        response() call per request, llama.cpp:322)."""
        if req.finished:
            return False
        if req.slot < 0:
            try:
                self.waiting.remove(req)
            except ValueError:
                return False
        self._finish(req, "cancelled")
        return True

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or self.num_active > 0

    # ------------------------------------------------------------------

    def _stop_set(self, req: Request) -> set[int]:
        s = set(req.sampling.stop_token_ids)
        if self.eos_token_id is not None:
            s.add(self.eos_token_id)
        return s

    def _full_context(self, req: Request) -> list[int]:
        """Tokens to prefill: the prompt plus anything already generated
        (non-empty only after a paged-pool preemption, which recomputes)."""
        return req.prompt_ids + req.output_ids

    def _assign_slots(self) -> list[Request]:
        """Move waiting requests into free slots and mirror their sampling
        params (shared by the single-host and multi-host schedulers).
        Paged engines also gate admission on pool capacity (the whole
        prompt + one decode page must fit)."""
        free = [i for i, r in enumerate(self.slots) if r is None]
        admitted: list[Request] = []
        paged = getattr(self.engine, "paged", False)
        budget = self.engine.free_pages if paged else 0
        while free and self.waiting:
            if paged:
                head = self.waiting[0]
                if (len(self._full_context(head)) + 1
                        > self.engine.max_pool_tokens()):
                    # grown past what the pool can EVER hold (preempted
                    # request with a long partial output): finish it
                    # rather than head-of-line block the queue forever
                    self.waiting.popleft()
                    self._finish(head, "capacity")
                    self._dropped.append(head)   # step() must report it
                    continue
                ctx = self._full_context(head)
                need = self.engine.pages_needed(len(ctx) + 1)
                # pages served by a cached prefix are adopted (shared),
                # not newly allocated — don't charge them at admission,
                # or cache-hit requests get gated as if they cost full
                # price while the cache pins exactly those pages
                reuse = 0
                if self.prefix_store is not None and hasattr(
                        self.prefix_store, "match_len"):
                    reuse = self.prefix_store.match_len(ctx)
                if self.auto_prefix is not None:
                    reuse = max(reuse, self.auto_prefix.match_len(ctx))
                need -= reuse // self.engine.engine_config.page_size
                if need > budget and self.auto_prefix is not None:
                    # cached-but-idle pages must not starve admission
                    budget += self.auto_prefix.evict_for(need - budget)
                if need > budget:
                    break
                budget -= need
            req = self.waiting.popleft()
            slot = free.pop(0)
            req.slot = slot
            self.slots[slot] = req
            self._temp[slot] = (0.0 if req.sampling.greedy
                                else req.sampling.temperature)
            self._topk[slot] = req.sampling.top_k
            self._topp[slot] = req.sampling.top_p
            self._minp[slot] = req.sampling.min_p
            self._rep[slot] = req.sampling.repetition_penalty
            self._pres[slot] = req.sampling.presence_penalty
            self._freq[slot] = req.sampling.frequency_penalty
            admitted.append(req)
        return admitted

    def register_prefix(self, tokens: Sequence[int]):
        """Prefill + snapshot a shared prompt prefix (e.g. the system
        prompt) so later submissions starting with it skip its prefill.
        Creates the store on first use (storage-form snapshots for the
        slot layout; zero-copy shared pool pages for the paged layout);
        needs one currently-free slot as scratch."""
        if self.prefix_store is None:
            from llm_inference_engine_tpu_torch.runtime.prefix_cache import (
                PagedPrefixStore, PrefixStore)
            cls = (PagedPrefixStore if getattr(self.engine, "paged", False)
                   else PrefixStore)
            self.prefix_store = cls(self.engine)
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free:
            raise RuntimeError("no free slot to register a prefix on")
        return self.prefix_store.register(tokens, slot=free[0])

    def _accept_token(self, req: Request, token: int,
                      logprob: float | None = None) -> None:
        if req.first_token_time is None:
            req.first_token_time = time.monotonic()
        if token in self._stop_set(req):
            self._finish(req, "eos")
            return
        req.output_ids.append(token)
        if logprob is not None:
            req.token_logprobs.append(logprob)
        self._last_token[req.slot] = token
        if req.stream_callback is not None:
            req.stream_callback(token)
        if len(req.output_ids) >= req.sampling.max_new_tokens:
            self._finish(req, "length")
        elif (len(req.prompt_ids) + len(req.output_ids) >= self.max_seq - 1):
            self._finish(req, "capacity")

    def _preempt(self, req: Request) -> None:
        """Evict a live request from its slot back to the FRONT of the
        waiting queue (vLLM-style recompute preemption): its pages free
        immediately; on re-admission the prompt PLUS already-generated
        tokens re-prefill and generation continues where it stopped."""
        slot = req.slot
        req.slot = -1
        req.prefill_pos = None
        req.preemptions += 1
        self.slots[slot] = None
        self.engine.reset([slot])
        self.waiting.appendleft(req)

    def _fit_or_preempt(self) -> None:
        """Paged engines: make this step's worst-case page demand fit the
        pool by preempting the newest live requests (recompute); a lone
        request that cannot fit finishes with reason 'capacity'."""
        if not getattr(self.engine, "paged", False):
            return
        eng = self.engine
        C = max(1, eng.engine_config.max_prefill_len)
        while True:
            live = [r for r in self.slots if r is not None]
            if not live:
                return
            extra = 0
            for r in live:
                ctx = len(self._full_context(r))
                target = (min(r.prefill_pos + C, ctx)
                          if r.prefill_pos is not None else ctx + 1)
                extra += max(0, eng.pages_needed(target)
                             - len(eng._slot_pages[r.slot]))
            if extra <= eng.free_pages:
                return
            if self.auto_prefix is not None:
                # drop idle cached prefixes before preempting live work
                self.auto_prefix.evict_for(extra - eng.free_pages)
                if extra <= eng.free_pages:
                    return
            victim = max(live, key=lambda r: r.id)
            if len(live) == 1:
                self._finish(victim, "capacity")
                return
            self._preempt(victim)

    def _finish(self, req: Request, reason: str) -> None:
        req.finished = True
        req.finish_reason = req.finish_reason or reason
        req.finish_time = time.monotonic()
        if req.slot >= 0:
            slot = req.slot
            self.slots[slot] = None
            req.slot = -1
            if getattr(self.engine, "paged", False):
                if self.auto_prefix is not None:
                    # donate the page-aligned context to the automatic
                    # prefix cache before the slot releases its pages.
                    # Only tokens actually WRITTEN to the cache may be
                    # donated: a request finishing mid-prefill (cancel /
                    # capacity) has written exactly prefill_pos rows; an
                    # EOS finish has written the full context (the stop
                    # token itself is neither appended nor written); any
                    # other finish accepted one final token that was
                    # never fed back, hence the -1.
                    ctx = req.prompt_ids + req.output_ids
                    if req.prefill_pos is not None:
                        valid = min(req.prefill_pos, len(ctx))
                    elif req.finish_reason == "eos":
                        valid = len(ctx)
                    else:
                        valid = len(ctx) - 1
                    self.auto_prefix.insert(
                        ctx, self.engine._slot_pages[slot], valid)
                self.engine.reset([slot])   # release pages immediately

    # ------------------------------------------------------------------

    def _mirror_reset(self, slots: list[int]) -> None:
        """Hook: subclasses running a second engine (speculative) reset
        its slots alongside the target's."""

    def _mirror_prefill(self, chunks: list[list[int]],
                        slots: list[int]) -> None:
        """Hook: subclasses running a second engine prefill the SAME
        chunks into it so the two caches stay in lockstep."""

    def step(self) -> list[Request]:
        """One scheduler step. Returns requests finished this step.

        When an admission (or a continuing chunked prefill) is in flight,
        the step is a single MIXED ragged forward: admitted slots carry
        their next prompt chunk (up to ``max_prefill_len`` tokens), live
        slots carry their one pending decode token — so long prompts never
        stall ongoing decodes (no head-of-line blocking; the chunked-
        prefill regime). The attention kernel takes per-sequence
        q_start/kv_len, so mixed lengths are native — there is no separate
        "prefill program" and "decode program" to reconcile.

        With no admission in flight the step is the pure decode path
        (``_decode_phase``: single-token fused write+attend kernel, or a
        speculative round in SpeculativeScheduler).
        """
        before = [r for r in self.slots if r is not None]
        done: list[Request] = list(self._dropped)   # finished off-slot
        self._dropped = []

        admitted = self._assign_slots()
        for r in admitted:
            r.prefill_pos = 0
        if admitted:
            slots = [r.slot for r in admitted]
            self.engine.reset(slots)
            self._mirror_reset(slots)
            for r in admitted:
                if r.output_ids:
                    # preempted request re-admitted: its generated-so-far
                    # tokens re-prefill as context; restore their GENERATED
                    # counts so presence/frequency penalties stay exact
                    self.engine.seed_counts(r.slot, gen_tokens=r.output_ids)
            if self.prefix_store is not None or self.auto_prefix is not None:
                # shared-prefix reuse: restore the prefix into the slot
                # (storage-form copy for the slot layout; zero-copy shared
                # pages for the paged layout) and prefill only the tail.
                # Registered prefixes first, then the automatic page cache
                for r in admitted:
                    ctx = self._full_context(r)
                    entry = (self.prefix_store.match(ctx)
                             if self.prefix_store is not None else None)
                    if entry is not None:
                        r.prefill_pos = self.prefix_store.restore(r.slot,
                                                                  entry)
                        r.reused_prefix_len = entry.length
                        seed_tokens = entry.tokens
                    elif self.auto_prefix is not None:
                        m = self.auto_prefix.match(ctx)
                        if m is None:
                            continue
                        r.prefill_pos = self.auto_prefix.restore(r.slot, m)
                        r.reused_prefix_len = r.prefill_pos
                        seed_tokens = m[0]
                    else:
                        continue
                    # the skipped prefix tokens still count as context
                    # for the repetition penalty
                    self.engine.seed_counts(r.slot, ctx_tokens=seed_tokens)
        done += [r for r in admitted if r.finished]

        self._fit_or_preempt()
        prefilling = [r for r in self.slots
                      if r is not None and r.prefill_pos is not None]
        if prefilling:
            C = max(1, self.engine.engine_config.max_prefill_len)
            chunks: list[list[int]] = []
            call_slots: list[int] = []
            decode_rows: list[Request] = []
            for r in self.slots:
                if r is None:
                    continue
                if r.prefill_pos is not None:
                    ctx = self._full_context(r)
                    chunk = ctx[r.prefill_pos:r.prefill_pos + C]
                    r.prefill_pos += len(chunk)
                    chunks.append(chunk)
                else:
                    chunks.append([int(self._last_token[r.slot])])
                    decode_rows.append(r)
                call_slots.append(r.slot)
            logits = self.engine.prefill(chunks, slots=call_slots)
            self._mirror_prefill(chunks, call_slots)
            count_mask = np.zeros((self.B,), bool)
            for r in decode_rows:
                count_mask[r.slot] = True
            for r in prefilling:                  # rows finishing prefill
                count_mask[r.slot] = (
                    r.prefill_pos >= len(self._full_context(r)))
            nxt, lp = self.engine.sample(
                logits, self._temp, self._topk, self._topp,
                extras=self._samp_arrays[3], count_mask=count_mask,
                return_logprobs=True)
            nxt, lp = nxt.cpu().numpy(), lp.cpu().numpy()
            for r in decode_rows:
                self._accept_token(r, int(nxt[r.slot]),
                                   float(lp[r.slot]))
            for r in prefilling:
                if (r.prefill_pos is not None
                        and r.prefill_pos >= len(self._full_context(r))):
                    r.prefill_pos = None          # context fully consumed:
                    self._accept_token(r, int(nxt[r.slot]),
                                       float(lp[r.slot]))
        else:
            self._decode_phase()

        done += [r for r in before + admitted
                 if r.finished and r not in done]
        return done

    def _decode_phase(self) -> None:
        """Pure decode step over all live slots (no admission in flight).
        SpeculativeScheduler overrides this with a draft/verify round."""
        active_mask = np.array([r is not None and not r.finished
                                for r in self.slots], bool)
        if active_mask.any():
            nxt, lp = self.engine.decode_step(
                self._last_token, active_mask, self._samp_arrays,
                return_logprobs=True)
            nxt, lp = nxt.cpu().numpy(), lp.cpu().numpy()
            for slot in np.nonzero(active_mask)[0]:
                req = self.slots[slot]
                if req is not None:
                    self._accept_token(req, int(nxt[slot]),
                                       float(lp[slot]))

    def run(self, max_steps: int = 1_000_000) -> list[Request]:
        """Drive until all submitted work completes; returns finished
        requests in completion order."""
        finished: list[Request] = []
        for _ in range(max_steps):
            if not self.has_work:
                break
            finished += self.step()
        return finished

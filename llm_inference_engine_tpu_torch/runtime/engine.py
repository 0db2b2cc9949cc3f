"""Inference engine: prefill / decode steps + generation loop.

Port of the single-device path of
``llm_inference_engine_tpu/runtime/engine.py``, over the slot cache or
the paged pool. The JAX package's jitted
closures become methods; its device-side ``while_loop`` rollout becomes a
Python loop of decode steps (CUDA graphs come later). Kept from it:
power-of-two prefill buckets (so later CUDA-graph capture per bucket has
steady shapes), chunked prefill with the near-capacity bucket shrink and
the loud capacity refusal, per-slot penalty count planes, logprobs,
multi-round history in the cache, and the one-token top-up of
length-terminated rows.

The KV cache is updated in place. Slot lengths live on the device (the
kernels read them) and in a host mirror that the engine keeps in step,
since it decides every length change on the host.

Paged layout (``kv_layout="paged"``, ``ops/paged_kv.py``): the page
management of the JAX engine — chunk size capped to the page, a
host-side refcounting allocator, page-aligned multi-token writes,
capacity grown before every write (``ensure_capacity``; MemoryError on
exhaustion, where the scheduler preempts), the worst case of a
non-streaming ``generate`` reserved before its first decode step, pages
released by ``reset`` and shared by the prefix caches. The block table
has a host mirror; the device table is updated in place from pinned
memory, and only when the host table changed.

Weights may be dense or quantized (``ops/quant.py``); the engine does
not look at them. ``kv_cache_dtype_name="int8"`` gives an int8 cache or
pool with f32 scale planes (``ops/kv_cache.py``, ``ops/paged_kv.py``);
the slot cache picks its scale numerics by device as the JAX engine
does, the pool is always snapped. Not ported yet (each raises
NotImplementedError): meshes (dp/tp/cp), multi-host lockstep overrides
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingParams, resolve_rope_scaling)
from llm_inference_engine_tpu_torch.models import llama as llama_model
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
from llm_inference_engine_tpu_torch.ops.sampling import (
    apply_penalties, greedy_sample, sample_tokens, token_logprobs)

__all__ = ["InferenceEngine", "GenerationResult", "check_kernel_dtypes"]


@dataclasses.dataclass
class GenerationResult:
    token_ids: list[list[int]]          # per sequence, generated ids only
    num_prompt_tokens: list[int]
    num_generated: list[int]
    # per generated token: log P(token) under the model's (penalized)
    # distribution, aligned with token_ids
    logprobs: Optional[list[list[float]]] = None


def _bucket_len(n: int, floor: int = 16, cap: int | None = None) -> int:
    """Round up to a power of two (bounds the distinct prefill shapes)."""
    b = floor
    while b < n:
        b *= 2
    return min(b, cap) if cap is not None else b


def check_kernel_dtypes(config: ModelConfig, eng: EngineConfig,
                        device) -> None:
    """Refuse, before anything is allocated, an engine whose kernels
    cannot take its dtypes: on a CUDA device with ``kernels`` other than
    "torch", the attention, KV-write and quantized-matmul kernels take a
    bf16 model (and a bf16 or int8 cache) only. Raises ValueError naming
    the dtype."""
    if torch.device(device).type != "cuda" or eng.kernels == "torch":
        return
    cache = eng.kv_cache_dtype or config.dtype
    for what, dtype, allowed in (("model", config.dtype, (torch.bfloat16,)),
                                 ("KV cache", cache,
                                  (torch.bfloat16, torch.int8))):
        if dtype not in allowed:
            raise ValueError(
                f"{config.name}: {what} dtype {dtype} on {device}: the CUDA "
                "kernels (attention, KV write, quantized matmul) take "
                "bfloat16 only (an int8 KV cache too); use a bfloat16 "
                "config or kernels='torch'")


def _refuse_unported(eng: EngineConfig) -> None:
    if eng.dp > 1 or eng.tp > 1 or eng.cp > 1:
        raise NotImplementedError(
            "dp/tp/cp meshes are not ported yet (ROADMAP.md, queue 1, "
            "'Parallelism')")
    if eng.kv_layout not in ("slot", "paged"):
        raise ValueError(f"kv_layout must be 'slot' or 'paged', got "
                         f"{eng.kv_layout!r}")


class InferenceEngine:
    """Single-device engine over one model replica and its slot cache or
    paged pool."""

    def __init__(self, config: ModelConfig, engine_config: EngineConfig,
                 params: dict, rng_seed: int = 0, device=None):
        _refuse_unported(engine_config)
        device = torch.device(device) if device is not None else \
            params["embed"].device
        check_kernel_dtypes(config, engine_config, device)
        # NTK rope scaling folds into rope_theta at the engine's context
        # length (config.NTKScaling: one theta, cached keys consistent)
        config = resolve_rope_scaling(config, engine_config.max_seq_len)
        self.config = config
        self.engine_config = engine_config
        self.device = device
        self.params = params
        B, V = engine_config.max_batch_size, config.vocab_size
        # an int8 cache holds int8 values and f32 scale planes
        quantized = engine_config.kv_cache_dtype == torch.int8
        dtype = engine_config.kv_cache_dtype or config.dtype
        self.paged = engine_config.kv_layout == "paged"
        if self.paged:
            self._init_paged(dtype, quantized)
        else:
            self.cache = kvc.new_kv_cache(
                config.num_layers, B, config.num_kv_heads,
                engine_config.max_seq_len, config.head_dim, dtype=dtype,
                device=self.device, quantized=quantized)
        self._lengths = np.zeros((B,), np.int32)     # host mirror
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)
        # context / generated token-occurrence counts per slot (drive the
        # repetition / presence / frequency penalties; ops/sampling.py)
        self._counts_ctx = torch.zeros((B, V), dtype=torch.int32,
                                       device=self.device)
        self._counts_gen = torch.zeros_like(self._counts_ctx)

    def _init_paged(self, dtype: torch.dtype, quantized: bool) -> None:
        eng = self.engine_config
        page = eng.page_size
        # multi-token writes must stay within one page: the chunk size
        # divides the page (ops/paged_kv.py write invariant)
        C = max(1, eng.max_prefill_len)
        if C > page:
            eng = self.engine_config = eng.replace(max_prefill_len=page)
        elif page % C:
            raise ValueError(f"page_size {page} must be a multiple of "
                             f"max_prefill_len {C}")
        B = eng.max_batch_size
        maxp = -(-eng.max_seq_len // page)
        num_pages = eng.num_pages or (B * maxp + 1)   # +1: reserved page 0
        self.cache = pkv.new_paged_kv_cache(
            self.config.num_layers, B, self.config.num_kv_heads, num_pages,
            page, self.config.head_dim, maxp, dtype=dtype,
            device=self.device, quantized=quantized)
        self._allocator = pkv.PageAllocator(num_pages)
        self._slot_pages: list[list[int]] = [[] for _ in range(B)]
        self._table_host = np.zeros((B, maxp), np.int32)
        if self.device.type == "cuda":
            # staging for in-place uploads; the event marks the last
            # upload's copy done, so the buffer may be overwritten
            self._table_pinned = torch.zeros((B, maxp), dtype=torch.int32,
                                             pin_memory=True)
            self._table_copied = torch.cuda.Event()

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _dev(self, a, dtype=torch.int32) -> torch.Tensor:
        """Host values -> a tensor on the engine's device. Host data goes
        through pinned memory: a copy from pageable memory would wait for
        the card to drain its queue, so the host could never run ahead."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=dtype)
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _set_lengths(self, lengths) -> None:
        self._lengths = np.asarray(lengths, np.int32).copy()
        self.cache.lengths = self._dev(self._lengths)

    def _upload_table(self) -> None:
        """Copy the host block table into the device table, in place. On
        the card the copy leaves from pinned memory and does not make the
        host wait for the card; the staging buffer is rewritten only after
        the previous upload's copy has run."""
        table = self.cache.block_table
        if self.device.type != "cuda":
            table.copy_(torch.from_numpy(self._table_host))
            return
        self._table_copied.synchronize()
        self._table_pinned.numpy()[...] = self._table_host
        table.copy_(self._table_pinned, non_blocking=True)
        self._table_copied.record()

    @staticmethod
    def _count_tokens(counts: torch.Tensor, token_ids: torch.Tensor,
                      valid: torch.Tensor) -> None:
        """counts [B, V] += one-hot sums of token_ids [B, T] where valid
        (in place)."""
        B, T = token_ids.shape
        rows = torch.arange(B, device=counts.device)[:, None].expand(B, T)
        counts.index_put_((rows, token_ids.long()),
                          valid.to(counts.dtype), accumulate=True)

    def _forward(self, token_ids: torch.Tensor, q_start: torch.Tensor,
                 kv_len: torch.Tensor) -> torch.Tensor:
        logits, self.cache = llama_model.forward_hidden(
            self.config, self.engine_config, self.params, token_ids,
            self.cache, q_start, kv_len)
        return logits

    # ------------------------------------------------------------------
    # paged-mode page management (host side; ops/paged_kv.py)
    # ------------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return self._allocator.free_pages if self.paged else 1 << 30

    def max_pool_tokens(self) -> int:
        """Largest context one request can EVER hold: max_seq_len, further
        capped by the whole paged pool (page 0 is reserved). The single
        source of truth for admission and rejection thresholds."""
        cap = self.engine_config.max_seq_len
        if self.paged:
            cap = min(cap, (self._allocator.num_pages - 1)
                      * self.engine_config.page_size)
        return cap

    def pages_needed(self, n_tokens: int) -> int:
        page = self.engine_config.page_size
        return -(-max(n_tokens, 0) // page)

    def _release_pages(self, slots: Sequence[int]) -> None:
        changed = False
        for b in slots:
            if self._slot_pages[b]:
                self._allocator.free(self._slot_pages[b])
                self._slot_pages[b] = []
                self._table_host[b, :] = 0
                changed = True
        if changed:
            self._upload_table()

    def adopt_prefix_pages(self, slot: int, pages: Sequence[int],
                           length: int) -> None:
        """Point a freshly reset slot's block table at SHARED read-only
        prefix pages (zero-copy prefix caching, runtime/prefix_cache.py):
        the allocator refcounts them, the slot's length starts at the
        shared token count, and all later writes land in the slot's own
        pages (length is a page multiple, so the chunk-alignment invariant
        holds)."""
        assert self.paged and not self._slot_pages[slot]
        assert length % self.engine_config.page_size == 0
        self._allocator.share(pages)
        self._slot_pages[slot] = list(pages)
        self._table_host[slot, :len(pages)] = pages
        self._upload_table()
        lengths = self._lengths.copy()
        lengths[slot] = length
        self._set_lengths(lengths)

    def take_slot_pages(self, slot: int, n: int) -> list[int]:
        """Transfer ownership of a slot's first ``n`` pages to the caller
        (prefix registration: the entry keeps them alive after the scratch
        slot resets). The slot keeps its remaining pages; the slot is
        reset right after, which rewrites its table row."""
        assert self.paged
        pages = self._slot_pages[slot][:n]
        self._slot_pages[slot] = self._slot_pages[slot][n:]
        return pages

    def ensure_capacity(self, targets) -> None:
        """Grow each slot's page list to cover ``targets`` [B] tokens
        (host-side allocator + block-table update). Raises MemoryError on
        pool exhaustion; callers (the scheduler) preempt on that."""
        if not self.paged:
            return
        changed = False
        for b, t in enumerate(np.asarray(targets)):
            need = self.pages_needed(int(t))
            have = len(self._slot_pages[b])
            if need > have:
                new = self._allocator.alloc(need - have)
                self._table_host[b, have:have + len(new)] = new
                self._slot_pages[b].extend(new)
                changed = True
        if changed:
            self._upload_table()

    def seed_counts(self, slot: int, ctx_tokens=None, gen_tokens=None):
        """Overwrite one slot's penalty-count rows from explicit token
        lists: bookkeeping for tokens that enter the context WITHOUT
        flowing through prefill/decode counting (a restored prefix's
        tokens; a preempted request's generated-so-far tokens on
        re-admission)."""
        V = self._counts_ctx.shape[1]

        def hist(tokens):
            h = np.bincount(np.asarray(tokens, np.int64), minlength=V)[:V]
            return self._dev(h)

        if ctx_tokens is not None:
            self._counts_ctx[slot] = hist(ctx_tokens)
        if gen_tokens is not None:
            self._counts_gen[slot] = hist(gen_tokens)

    # ------------------------------------------------------------------
    # low-level API
    # ------------------------------------------------------------------

    def reset(self, slots: Optional[Sequence[int]] = None):
        """Clear history (all slots, or specific ones); a paged slot's
        pages go back to the pool."""
        lengths = self._lengths.copy()
        if slots is None:
            rows = list(range(self.engine_config.max_batch_size))
            lengths[:] = 0
            self._counts_ctx.zero_()
            self._counts_gen.zero_()
        else:
            rows = list(slots)
            lengths[rows] = 0
            self._counts_ctx[rows] = 0
            self._counts_gen[rows] = 0
        self._set_lengths(lengths)
        if self.paged:
            self._release_pages(rows)

    def prefill(self, prompts: Sequence[Sequence[int]],
                slots: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Prefill prompt token ids into ``slots`` (default [0, len)).

        Appends to any existing history in those slots (multi-round). Slots
        not listed run with zero new tokens and are untouched. Prompts
        longer than ``max_prefill_len`` run as several chunks, each
        attending the cache its predecessors filled.

        Returns last-token logits [B, V] f32 (rows of untouched slots are
        don't-care)."""
        eng = self.engine_config
        B = eng.max_batch_size
        if slots is None:
            slots = list(range(len(prompts)))
        if len(prompts) > B or len(slots) != len(prompts):
            raise ValueError(f"{len(prompts)} prompts > {B} slots"
                             if len(prompts) > B else
                             f"{len(slots)} slots for {len(prompts)} prompts")
        C = max(1, eng.max_prefill_len)
        max_len = max([len(p) for p in prompts] or [0])
        lengths_host = self._lengths.copy()

        if len(prompts) > 1:
            # near-capacity appends need a SMALLER padded bucket than fresh
            # admissions can share: run them as a separate call ("near" is
            # judged against the bucket this batch would use)
            T0 = _bucket_len(max((min(len(p), C) for p in prompts
                                  if len(p)), default=1), cap=C)
            near = [i for i, (sl, p) in enumerate(zip(slots, prompts))
                    if len(p) and lengths_host[sl] + T0 > eng.max_seq_len]
            if near and len(near) < sum(1 for p in prompts if len(p)):
                far = [i for i in range(len(prompts)) if i not in near]
                lg_far = self.prefill([prompts[i] for i in far],
                                      slots=[slots[i] for i in far])
                lg_near = self.prefill([prompts[i] for i in near],
                                       slots=[slots[i] for i in near])
                rows_near = np.zeros((B,), bool)
                rows_near[[slots[i] for i in near]] = True
                return torch.where(self._dev(rows_near, torch.bool)[:, None],
                                   lg_near, lg_far)

        final_logits = None
        offset = 0
        S = eng.max_seq_len
        while offset == 0 or offset < max_len:
            chunk_lens = np.zeros((B,), np.int32)
            chunk_max = 0
            for slot, p in zip(slots, prompts):
                n = min(max(len(p) - offset, 0), C)
                chunk_lens[slot] = n
                chunk_max = max(chunk_max, n)
            T = _bucket_len(max(chunk_max, 1), cap=C)
            # near capacity the PADDED window must not cross the cache
            # end: shrink the bucket (down to an exact-fit tail bucket),
            # and refuse loudly if the real tokens cannot fit
            active_rows = chunk_lens > 0
            if active_rows.any():
                qmax = int(lengths_host[active_rows].max())

                def crosses(t):
                    return qmax + t > S

                t_floor = max(chunk_max, 1)
                while T > 1 and T // 2 >= t_floor and crosses(T):
                    T //= 2
                if crosses(T) and chunk_max <= S - qmax:
                    fit = S - qmax
                    if fit >= t_floor and not crosses(fit):
                        T = fit
                if crosses(T):
                    raise ValueError(
                        f"prefill append at history {qmax} cannot fit a "
                        f"{T}-token padded chunk inside max_seq_len {S}; the "
                        "request exceeds the slot's remaining capacity — "
                        "raise max_seq_len or finish the slot")
            token_ids = np.zeros((B, T), np.int32)
            for slot, p in zip(slots, prompts):
                chunk = p[offset:offset + chunk_lens[slot]]
                token_ids[slot, :len(chunk)] = np.asarray(chunk, np.int32)

            if self.paged:
                # kernel H's chunk rows must start page-aligned:
                # multi-token writes start at a multiple of C (true for
                # prompts admitted from 0 or from a shared prefix;
                # multi-round appends at arbitrary history need the slot
                # layout)
                bad = (chunk_lens > 1) & (lengths_host % C != 0)
                if bad.any():
                    raise ValueError(
                        "paged KV: multi-token prefill must start at a "
                        f"multiple of max_prefill_len={C} (slots "
                        f"{np.nonzero(bad)[0].tolist()} are mid-page); "
                        "use kv_layout='slot' for arbitrary-offset appends")
                self.ensure_capacity(lengths_host + chunk_lens)
            ids = self._dev(token_ids)
            q_start = self.cache.lengths
            kv_len = self._dev(lengths_host + chunk_lens)
            valid = (torch.arange(T, device=self.device)[None, :]
                     < (kv_len - q_start)[:, None])
            self._count_tokens(self._counts_ctx, ids, valid)
            logits = self._forward(ids, q_start, kv_len)
            lengths_host = lengths_host + chunk_lens
            self._lengths = lengths_host.copy()

            if final_logits is None:
                final_logits = logits
            else:
                # a slot's logits come from the chunk holding its last token
                had = self._dev(chunk_lens > 0, torch.bool)
                final_logits = torch.where(had[:, None], logits, final_logits)
            offset += C
        return final_logits

    def _neutral_extras(self):
        """(min_p, repetition, presence, frequency) identity values."""
        B = self.engine_config.max_batch_size
        z = torch.zeros((B,), dtype=torch.float32, device=self.device)
        return (z, torch.ones_like(z), z, z)

    def _sampling_arrays(self, sp: SamplingParams):
        """Per-slot tensors (temperature, top_k, top_p) + the extras tuple
        (min_p, repetition, presence, frequency)."""
        B = self.engine_config.max_batch_size

        def full(v, dtype=torch.float32):
            return torch.full((B,), v, dtype=dtype, device=self.device)

        t = 0.0 if sp.greedy else sp.temperature
        extras = (full(sp.min_p), full(sp.repetition_penalty),
                  full(sp.presence_penalty), full(sp.frequency_penalty))
        return full(t), full(sp.top_k, torch.int32), full(sp.top_p), extras

    def _sample_and_count(self, logits, temp, topk, topp, extras,
                          count_mask: torch.Tensor):
        minp, rep, pres, freq = extras
        logits = apply_penalties(logits, self._counts_ctx, self._counts_gen,
                                 rep, pres, freq)
        nxt = sample_tokens(logits, self._gen, temp, topk, topp, minp)
        lp = token_logprobs(logits, nxt)
        self._count_tokens(self._counts_ctx, nxt[:, None], count_mask[:, None])
        self._count_tokens(self._counts_gen, nxt[:, None], count_mask[:, None])
        return nxt, lp

    def sample(self, logits, temperature, top_k, top_p, extras=None,
               count_mask=None, return_logprobs: bool = False):
        """Sample token ids from logits [B, V] with per-slot params [B].

        ``extras``: (min_p, repetition, presence, frequency) per-slot
        tensors (None = neutral). ``count_mask`` [B] bool marks rows whose
        sampled token enters the slot's penalty counts."""
        if extras is None:
            extras = self._neutral_extras()
        B = logits.shape[0]
        mask = self._dev(np.zeros((B,), bool) if count_mask is None
                         else count_mask, torch.bool)
        nxt, lp = self._sample_and_count(
            logits, self._dev(temperature, torch.float32),
            self._dev(top_k, torch.int32), self._dev(top_p, torch.float32),
            tuple(self._dev(e, torch.float32) for e in extras), mask)
        return (nxt, lp) if return_logprobs else nxt

    def decode_step(self, tokens, active, sp_or_arrays,
                    return_logprobs: bool = False):
        """One decode step over all slots. tokens: [B] int tensor or array;
        active: [B] bool (host). ``sp_or_arrays``: a SamplingParams or a
        (temperature, top_k, top_p[, extras]) tuple of per-slot [B]
        values."""
        if isinstance(sp_or_arrays, SamplingParams):
            temp, topk, topp, extras = self._sampling_arrays(sp_or_arrays)
        else:
            temp, topk, topp, *rest = sp_or_arrays
            extras = tuple(rest[0]) if rest else self._neutral_extras()
            temp = self._dev(temp, torch.float32)
            topk = self._dev(topk, torch.int32)
            topp = self._dev(topp, torch.float32)
            extras = tuple(self._dev(e, torch.float32) for e in extras)
        active_host = np.asarray(active, bool)
        self.ensure_capacity(self._lengths + active_host)
        q_start = self.cache.lengths
        kv_len = self._dev(self._lengths + active_host)
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int32)
        logits = self._forward(tokens[:, None], q_start, kv_len)
        self._lengths = self._lengths + active_host.astype(np.int32)
        nxt, lp = self._sample_and_count(
            logits, temp, topk, topp, extras,
            self._dev(active_host, torch.bool))
        return (nxt, lp) if return_logprobs else nxt

    def decode_rollout(self, tokens, num_steps: int) -> torch.Tensor:
        """Greedy decode ``num_steps`` tokens for all slots. Returns
        [num_steps, B] int32 token ids."""
        B = self.engine_config.max_batch_size
        # a paged rollout reserves its pages up front, as the JAX
        # package's device-side loop must
        self.ensure_capacity(self._lengths + num_steps)
        toks = torch.as_tensor(tokens, device=self.device).to(torch.int32)
        out = []
        for _ in range(num_steps):
            q_start = self.cache.lengths
            self._lengths = self._lengths + 1
            logits = self._forward(toks[:, None], q_start,
                                   self._dev(self._lengths))
            toks = greedy_sample(logits)
            out.append(toks)
        return torch.stack(out) if out else torch.zeros(
            (0, B), dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------
    # generation loop
    # ------------------------------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: SamplingParams = SamplingParams(),
                 eos_token_id: int | None = 2,
                 stream_callback: Optional[Callable[[int, int], None]] = None
                 ) -> GenerationResult:
        """Generate completions for up to max_batch_size prompts, appended
        to the slots' history. stream_callback(seq_index, token_id) fires
        per generated token."""
        nseq = len(prompts)
        B = self.engine_config.max_batch_size

        first_logits = self.prefill(prompts)
        temp, topk, topp, extras = self._sampling_arrays(sampling)
        tokens, first_lp = self._sample_and_count(
            first_logits, temp, topk, topp, extras,
            self._dev(np.arange(B) < nseq, torch.bool))
        tok_host = tokens.cpu().numpy()
        lp_host = first_lp.cpu().numpy()

        stop_ids = set(sampling.stop_token_ids)
        if eos_token_id is not None:
            stop_ids.add(eos_token_id)

        out: list[list[int]] = [[] for _ in range(nseq)]
        lp_out: list[list[float]] = [[] for _ in range(nseq)]
        done = np.zeros((B,), bool)
        done[nseq:] = True

        def emit(i, t, lp):
            if t in stop_ids:
                done[i] = True
                return
            out[i].append(t)
            lp_out[i].append(lp)
            if stream_callback:
                stream_callback(i, t)

        for i in range(nseq):
            emit(i, int(tok_host[i]), float(lp_host[i]))

        max_room = self.engine_config.max_seq_len - 1
        steps = sampling.max_new_tokens - 1
        if stream_callback is None and steps > 0 and not done.all():
            # the JAX package runs this tail as one device-side rollout and
            # reserves its worst case first: raise MemoryError here too,
            # before the first decode step
            self.ensure_capacity(np.minimum(
                self._lengths + np.where(done, 0, steps), max_room + 1))
        for _ in range(steps):
            # a row at capacity never advances again, so it stays inactive
            active = ~done & (self._lengths < max_room)
            if not active.any():
                break
            tokens, step_lp = self.decode_step(tokens, active,
                                               (temp, topk, topp, extras),
                                               return_logprobs=True)
            tok_host = tokens.cpu().numpy()
            lp_host = step_lp.cpu().numpy()
            for i in range(nseq):
                if active[i]:
                    emit(i, int(tok_host[i]), float(lp_host[i]))

        # A length-terminated row's FINAL sampled token was never fed back,
        # so its K/V is absent from the cache; top it up with a one-token
        # prefill so multi-round appends see the full conversation.
        # EOS-terminated rows are complete already. The length test uses
        # this round's prompt only, as the JAX package does (so it fires in
        # a slot's first round; ROADMAP.md queue 3).
        pending = [i for i in range(nseq)
                   if out[i] and not done[i]
                   and self._lengths[i] == len(prompts[i]) + len(out[i]) - 1]
        if pending:
            self.prefill([[out[i][-1]] for i in pending], slots=pending)
            # the token was counted when sampled; undo the prefill's
            # context-count increment
            self._counts_ctx[pending, [out[i][-1] for i in pending]] -= 1

        return GenerationResult(
            token_ids=out,
            num_prompt_tokens=[len(p) for p in prompts],
            num_generated=[len(o) for o in out],
            logprobs=lp_out,
        )

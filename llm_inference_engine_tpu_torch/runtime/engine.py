"""Inference engine: prefill / decode steps + generation loop.

Port of the single-device slot-cache path of
``llm_inference_engine_tpu/runtime/engine.py``. The JAX package's jitted
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

Not ported yet (each raises NotImplementedError): meshes (dp/tp/cp),
the paged layout, the int8 KV cache, quantized weights, multi-host
lockstep overrides (ROADMAP.md, queue 1).
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
from llm_inference_engine_tpu_torch.ops.sampling import (
    apply_penalties, greedy_sample, sample_tokens, token_logprobs)

__all__ = ["InferenceEngine", "GenerationResult"]


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


def _refuse_unported(eng: EngineConfig) -> None:
    if eng.dp > 1 or eng.tp > 1 or eng.cp > 1:
        raise NotImplementedError(
            "dp/tp/cp meshes are not ported yet (ROADMAP.md, queue 1, "
            "'Parallelism')")
    if eng.kv_layout != "slot":
        raise NotImplementedError(
            f"kv_layout={eng.kv_layout!r} is not ported yet (ROADMAP.md, "
            "queue 1, 'Paged KV and prefix cache')")
    if eng.kv_cache_dtype == torch.int8:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP.md, queue 1, "
            "'INT8 KV cache')")
    if eng.quant_mode != "none":
        raise NotImplementedError(
            f"quant_mode={eng.quant_mode!r} is not ported yet (ROADMAP.md, "
            "queue 1, 'INT8/INT4 weights')")


class InferenceEngine:
    """Single-device engine over one model replica and its slot cache."""

    def __init__(self, config: ModelConfig, engine_config: EngineConfig,
                 params: dict, rng_seed: int = 0, device=None):
        _refuse_unported(engine_config)
        # NTK rope scaling folds into rope_theta at the engine's context
        # length (config.NTKScaling: one theta, cached keys consistent)
        config = resolve_rope_scaling(config, engine_config.max_seq_len)
        self.config = config
        self.engine_config = engine_config
        self.device = torch.device(device) if device is not None else \
            params["embed"].device
        self.params = params
        B, V = engine_config.max_batch_size, config.vocab_size
        self.cache = kvc.new_kv_cache(
            config.num_layers, B, config.num_kv_heads,
            engine_config.max_seq_len, config.head_dim,
            dtype=engine_config.kv_cache_dtype or config.dtype,
            device=self.device)
        self._lengths = np.zeros((B,), np.int32)     # host mirror
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)
        # context / generated token-occurrence counts per slot (drive the
        # repetition / presence / frequency penalties; ops/sampling.py)
        self._counts_ctx = torch.zeros((B, V), dtype=torch.int32,
                                       device=self.device)
        self._counts_gen = torch.zeros_like(self._counts_ctx)

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
    # low-level API
    # ------------------------------------------------------------------

    def reset(self, slots: Optional[Sequence[int]] = None):
        """Clear history (all slots, or specific ones)."""
        lengths = self._lengths.copy()
        if slots is None:
            lengths[:] = 0
            self._counts_ctx.zero_()
            self._counts_gen.zero_()
        else:
            rows = list(slots)
            lengths[rows] = 0
            self._counts_ctx[rows] = 0
            self._counts_gen[rows] = 0
        self._set_lengths(lengths)

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
        for _ in range(sampling.max_new_tokens - 1):
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

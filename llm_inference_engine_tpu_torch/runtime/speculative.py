"""Speculative decoding: a small draft model proposes, the target verifies.

Port of ``llm_inference_engine_tpu/runtime/speculative.py``. Each round
drafts ``k`` tokens with the draft model, verifies them with one target
forward over ``[last, d_1 .. d_k]`` (``forward_all_logits``), accepts a
prefix and rewinds both caches by their lengths: K/V rows are written at
absolute positions and attention only admits columns below a row's
length, so rejected rows are dead until overwritten.

Greedy acceptance reproduces the target's greedy output token for token
(a draft is accepted iff it equals the target argmax there, and the
first mismatch is replaced by that argmax), assuming the target's logits
do not depend on the forward's token-batch shape: true in f32, while in
bf16 the T = 1 decode path and the T = k + 1 verify path sum in another
order and can flip near-ties. The sampled round applies the
rejection-sampling rule (``ops.sampling.speculative_accept``) over the
processed per-slot distributions, lossless in distribution; greedy slots
degenerate to one-hot p and q, so one sampled round serves a mixed batch.
Penalties run with the counts frozen at each round's start, applied alike
to draft and target; accepted tokens enter the counts between rounds.

The JAX package runs a round as one jitted call (the draft's
``lax.scan``, the verify, the acceptance, both rewinds). Here a round is
one device program (``runtime/decode_graph.py``): on the card a CUDA graph
captured at first use, the draft's k steps unrolled inside it; on the CPU
the same body runs eagerly. It reads its per-round inputs from the target
engine's decode input buffer (``engine.INPUT_ROWS``: the last tokens, the
active rows, the sampling and penalty rows), the counts from the target
engine's count planes, and draws from this decoder's own generator.
Rows that are not active write no K/V (their new length is 0) and keep
their lengths. The JAX round's ``lax.cond(any(full), ingest, ...)``, the
draft's ingest of its own d_k after a fully accepted round, is a second
program here, replayed only when the host, which reads every round's
``n_acc``, sees a fully accepted row.

Over a mesh (dp x tp) the target and the draft must lie on the same mesh
(``Mesh.same_as``): each forward of the round runs every rank's layer
body through the engine's sharded forward, the verify with the lm_head at
every position (``make_sharded_forward(..., all_logits=True)``), and the
acceptance, the rewinds, the counts and the draws stay on the mesh's home
device, where the engines keep their inputs and lengths. The round and
the ingest are replayed on a mesh whose ranks are all on one card, and
run eagerly over several cards, as the engine's decode does. A
context-parallel engine is refused: the JAX package's round runs
``forward_hidden`` over a ``CPCache`` with no ``CPSpec`` and fails there
(ROADMAP.md, queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from llm_inference_engine_tpu_torch.config import SamplingParams
from llm_inference_engine_tpu_torch.models import llama as llama_model
from llm_inference_engine_tpu_torch.ops.sampling import (
    accepted_tokens, apply_penalties, greedy_sample, processed_probs,
    sample_tokens, speculative_accept)
from llm_inference_engine_tpu_torch.parallel import sharding
from llm_inference_engine_tpu_torch.runtime import decode_graph

__all__ = ["SpeculativeDecoder", "SpecResult", "CP_SPEC_REFUSAL"]

CP_SPEC_REFUSAL = (
    "speculative decoding over a context-parallel engine is not ported: "
    "the JAX package's round runs forward_hidden over a CPCache with no "
    "CPSpec and fails ('CPCache requires a CPSpec (cp_engine)'), a fault of "
    "the reference (ROADMAP.md, queue 3); dp/tp meshes speculate")


def _place(engine) -> str:
    return str(engine.device if engine.mesh is None else engine.mesh)


@dataclasses.dataclass
class SpecResult:
    token_ids: list[list[int]]
    num_drafted: int = 0
    num_accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.num_accepted / max(self.num_drafted, 1)


class SpeculativeDecoder:
    """Speculative decoding over two InferenceEngines that share a
    vocabulary, a batch size and a device or a mesh; ``num_draft`` tokens
    are proposed per round."""

    def __init__(self, target, draft, num_draft: int = 4, rng_seed: int = 0):
        if target.config.vocab_size != draft.config.vocab_size:
            raise ValueError("target/draft vocab mismatch")
        B = target.engine_config.max_batch_size
        if draft.engine_config.max_batch_size != B:
            raise ValueError("target/draft max_batch_size mismatch")
        if target.cp > 1 or draft.cp > 1:
            raise NotImplementedError(CP_SPEC_REFUSAL)
        mesh = target.mesh
        if ((mesh is None) != (draft.mesh is None)
                or (mesh is None and draft.device != target.device)
                or (mesh is not None and not mesh.same_as(draft.mesh))):
            raise ValueError(f"target on {_place(target)}, draft on "
                             f"{_place(draft)}: a round runs both on one "
                             "device or one mesh")
        if target.paged or draft.paged:
            raise NotImplementedError(
                "speculative decoding uses the slot KV layout")
        self.target = target
        self.draft = draft
        self.k = num_draft
        # the verify: the target's lm_head at every position
        self._verify = (None if mesh is None else
                        sharding.make_sharded_forward(
                            target.config, target.engine_config, mesh,
                            all_logits=True))
        dev = target.device
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(rng_seed)
        k = num_draft
        # one round's outputs, copied to the host in one go: emitted
        # [B, k+1], their logprobs' f32 bits [B, k+1], n_acc [B, 1]
        self._out = torch.zeros((B, 2 * (k + 1) + 1), dtype=torch.int32,
                                device=dev)
        # the ingest program's inputs: each row's d_k and its new length
        # (1 where the row fully accepted)
        self._ingest = torch.zeros((2, B), dtype=torch.int32, device=dev)
        # graphs by body name on the card; None runs the bodies eagerly
        # (also over a mesh of several cards: a graph is one device's)
        one_device = mesh is None or mesh.one_device
        self._programs: Optional[dict] = (
            {} if dev.type == "cuda" and one_device else None)

    # ------------------------------------------------------------------
    # the round on the device
    # ------------------------------------------------------------------

    @staticmethod
    def _pen(logits, counts_ctx, counts_gen, rep, pres, freq):
        """Frozen-counts penalties on [B, V] or per-position [B, T, V]
        logits against the same [B, V] counts (the round-start state).
        Neutral (1, 0, 0) values are an exact identity."""
        if logits.dim() == 3:
            counts_ctx, counts_gen = counts_ctx[:, None], counts_gen[:, None]
            rep, pres, freq = rep[:, None], pres[:, None], freq[:, None]
        return apply_penalties(logits, counts_ctx, counts_gen, rep, pres,
                               freq)

    def _round(self, sampled: bool) -> None:
        """One round over all rows: k draft steps, one verify, the
        acceptance, both rewinds and the counts. Inputs from the target's
        input buffer; outputs into ``_out`` and ``_ingest``."""
        t, d, k = self.target, self.draft, self.k
        x = t._x
        tc, dc = t.cache, d.cache
        act = x.active
        done = act == 0
        min_p, rep, pres, freq = x.extras
        counts = (t._counts_ctx, t._counts_gen)
        t_len, d_len = tc.lengths.clone(), dc.lengths.clone()

        tok, drafts, qs = x.tokens, [], []
        for _ in range(k):
            lengths = dc.lengths
            logits = d._forward(tok[:, None], lengths, lengths + act)
            logits = self._pen(logits, *counts, rep, pres, freq)
            if sampled:
                qs.append(processed_probs(logits, x.temperature, x.top_k,
                                          x.top_p, min_p))
                tok = sample_tokens(logits, self._gen, x.temperature,
                                    x.top_k, x.top_p, min_p)
            else:
                tok = greedy_sample(logits)
            drafts.append(tok)
        draft_toks = torch.stack(drafts, dim=1)                 # [B, k]

        block = torch.cat([x.tokens[:, None], draft_toks], dim=1)
        if self._verify is not None:
            logits, _ = self._verify(t.params, tc, block, t_len,
                                     t_len + act * (k + 1))
        else:
            logits, _ = llama_model.forward_all_logits(
                t.config, t.engine_config, t.params, block, tc, t_len,
                t_len + act * (k + 1))
        logits = self._pen(logits, *counts, rep, pres, freq)    # [B, k+1, V]
        if sampled:
            def per_pos(a):
                return a[:, None].expand(-1, k + 1)
            p = processed_probs(logits, per_pos(x.temperature),
                                per_pos(x.top_k), per_pos(x.top_p),
                                per_pos(min_p))
            emitted, n_acc = speculative_accept(
                draft_toks, torch.stack(qs, dim=1), p, self._gen)
        else:
            tgt = greedy_sample(logits)                         # [B, k+1]
            eq = (draft_toks == tgt[:, :k]).to(torch.int32)
            n_acc = torch.cumprod(eq, dim=1).sum(dim=1).to(torch.int32)
            bonus = torch.gather(tgt, 1, n_acc.long()[:, None])[:, 0]
            emitted = accepted_tokens(draft_toks, n_acc, bonus)
        # log P(emitted) under the target's post-penalty distribution
        picked = torch.gather(logits, -1, emitted.long()[..., None])[..., 0]
        emitted_lp = picked - torch.logsumexp(logits, dim=-1)   # [B, k+1]

        # rewind both caches to the accepted frontier; the draft ingested
        # [last, d_1 .. d_{k-1}] and on full acceptance still owes d_k
        tc.lengths.copy_(torch.where(done, t_len, t_len + n_acc + 1))
        dc.lengths.copy_(torch.where(done, d_len,
                                     t_len + torch.clamp(n_acc + 1, max=k)))
        self._ingest[0].copy_(draft_toks[:, -1])
        self._ingest[1].copy_((n_acc == k) & ~done)
        # the round's accepted tokens (bonus included) enter the counts
        j = torch.arange(k + 1, device=act.device)[None, :]
        valid = ((j <= n_acc[:, None]) & ~done[:, None]).to(torch.int32)
        for c in counts:
            c.scatter_add_(1, emitted.long(), valid)
        self._out[:, :k + 1].copy_(emitted)
        self._out[:, k + 1:2 * k + 2].view(torch.float32).copy_(emitted_lp)
        self._out[:, -1].copy_(n_acc)

    def _greedy_body(self) -> None:
        self._round(sampled=False)

    def _sampled_body(self) -> None:
        self._round(sampled=True)

    def _ingest_body(self) -> None:
        """The draft ingests d_k in the rows that fully accepted (new
        length 1; 0 elsewhere, which writes nothing)."""
        d = self.draft
        lengths = d.cache.lengths
        d._forward(self._ingest[0][:, None], lengths,
                   lengths + self._ingest[1])

    def run_round(self, last, active, arrays, sampled: bool):
        """One round from ``last`` [B] for the ``active`` [B] rows with the
        per-slot sampling ``arrays`` (temperature, top_k, top_p, (min_p,
        repetition, presence, frequency)); ``sampled`` picks the
        rejection-sampling round. Returns host arrays (emitted [B, k+1],
        their logprobs [B, k+1], n_acc [B]), and keeps both engines' host
        mirrors of the lengths in step."""
        t, d, k = self.target, self.draft, self.k
        active = np.asarray(active, bool)
        t_len, d_len = t._lengths.copy(), d._lengths.copy()
        t._stage(last, active, arrays)
        # the capture's warm-up runs with no row active
        decode_graph.run(self, "sampled" if sampled else "greedy",
                         (t._input_buf,), t._x.active,
                         self._gen if sampled else None)
        host = self._out.cpu().numpy()
        emitted = host[:, :k + 1]
        emitted_lp = host[:, k + 1:2 * k + 2].view(np.float32)
        n_acc = host[:, -1]
        t._lengths = np.where(active, t_len + n_acc + 1, t_len).astype(
            np.int32)
        d._lengths = np.where(active, t_len + np.minimum(n_acc + 1, k),
                              d_len).astype(np.int32)
        full = active & (n_acc == k)
        if full.any():
            decode_graph.run(self, "ingest", (self._ingest,),
                             self._ingest[1])
            d._lengths = d._lengths + full.astype(np.int32)
        return emitted, emitted_lp, n_acc

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = 2,
                 sampling: Optional[SamplingParams] = None) -> SpecResult:
        """Speculative generation (batch = number of prompts; all rows
        draft and verify in lockstep). ``sampling=None`` (or greedy) runs
        the exact greedy round; otherwise the rejection-sampling round.
        Penalties apply with counts frozen at each round's start, so they
        lag a sequential decode by fewer than k + 1 tokens."""
        t, d = self.target, self.draft
        B = t.engine_config.max_batch_size
        nseq = len(prompts)
        if nseq > B:
            raise ValueError(f"{nseq} prompts > {B} slots")
        do_sample = (sampling is not None and not sampling.greedy
                     and sampling.temperature > 0.0)
        sp = sampling or SamplingParams()

        def full(v, dtype=np.float32):
            return np.full((B,), v, dtype)
        arrays = (full(sp.temperature if do_sample else 0.0),
                  full(sp.top_k, np.int32), full(sp.top_p),
                  (full(sp.min_p), full(sp.repetition_penalty),
                   full(sp.presence_penalty), full(sp.frequency_penalty)))

        # the prefill counts the prompts into the target's context counts
        # (the JAX decoder's prompt counts); the generated counts are zero
        t.reset()
        d.reset()
        t_logits = t.prefill(prompts)
        d.prefill(prompts)

        # the first token from the target's prefill logits, penalized
        # against the prompt counts
        dev = t.device
        temp, topk, topp, (min_p, rep, pres, freq) = arrays
        rep_t, pres_t, freq_t = (t._dev(a, torch.float32)
                                 for a in (rep, pres, freq))
        t_logits = apply_penalties(t_logits, t._counts_ctx, t._counts_gen,
                                   rep_t, pres_t, freq_t)
        if do_sample:
            first = sample_tokens(t_logits, self._gen,
                                  t._dev(temp, torch.float32),
                                  t._dev(topk), t._dev(topp, torch.float32),
                                  t._dev(min_p, torch.float32))
        else:
            first = greedy_sample(t_logits)
        valid = (torch.arange(B, device=dev) < nseq).to(torch.int32)
        for c in (t._counts_ctx, t._counts_gen):
            c.scatter_add_(1, first.long()[:, None], valid[:, None])
        last = first.cpu().numpy()
        out = [[int(last[i])] for i in range(nseq)]
        done = np.zeros((B,), bool)
        done[nseq:] = True
        stop = {eos_token_id} if eos_token_id is not None else set()
        for i in range(nseq):
            if last[i] in stop:
                done[i] = True
        drafted = accepted = 0

        max_room = t.engine_config.max_seq_len - self.k - 2
        while not done.all():
            if all(done[i] or len(out[i]) >= max_new_tokens
                   for i in range(nseq)):
                break
            if (t._lengths >= max_room).any():
                break
            emitted, _, n_acc = self.run_round(last, ~done, arrays,
                                               do_sample)
            new_last = last.copy()
            for i in range(nseq):
                if done[i]:
                    continue
                drafted += self.k
                accepted += int(n_acc[i])
                for tok in emitted[i, :n_acc[i] + 1]:
                    if int(tok) in stop or len(out[i]) >= max_new_tokens:
                        done[i] = True
                        if int(tok) in stop:
                            out[i].append(int(tok))
                        break
                    out[i].append(int(tok))
                new_last[i] = out[i][-1]
            last = new_last

        return SpecResult(token_ids=[o[:max_new_tokens] for o in out],
                          num_drafted=drafted, num_accepted=accepted)

"""Top-K / top-p / min-p / temperature sampling and logit penalties.

Port of ``llm_inference_engine_tpu/ops/sampling.py`` (plain torch, as the
JAX package leaves sampling to XLA). Draws take an explicit
``torch.Generator``; they use the Gumbel-max form of a categorical draw,
as ``jax.random.categorical`` does, but the generator is Philox, not
threefry, so sampled ids differ between the packages. Greedy ids and the
processed distributions match. The speculative acceptance rule
(:func:`speculative_accept`) draws from the same kind of generator, so
its parity with the JAX package is exact on one-hot (greedy) rows and
statistical on sampled rows.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["apply_penalties", "greedy_sample", "token_logprobs",
           "top_k_logits", "sample_top_k", "sample_tokens",
           "processed_probs", "speculative_accept", "accepted_tokens",
           "MAX_TOP_K"]

MAX_TOP_K = 64  # static top-k width; per-slot k masks within it


def apply_penalties(logits: torch.Tensor, counts_ctx: torch.Tensor,
                    counts_gen: torch.Tensor, repetition: torch.Tensor,
                    presence: torch.Tensor,
                    frequency: torch.Tensor) -> torch.Tensor:
    """HF-style repetition penalty over the whole context, OpenAI-style
    presence/frequency penalties over generated tokens. logits/counts
    [B, V]; params [B]. Neutral values (1, 0, 0) are an exact identity."""
    lf = logits.float()
    rep = repetition[:, None]
    seen = (counts_ctx + counts_gen) > 0
    penalized = torch.where(lf > 0, lf / rep, lf * rep)
    lf = torch.where(seen, penalized, lf)
    lf = lf - counts_gen.float() * frequency[:, None]
    lf = lf - (counts_gen > 0).float() * presence[:, None]
    return lf


def top_k_logits(logits: torch.Tensor, k: int):
    """Top-K values and indices along the last axis, largest first."""
    return torch.topk(logits, k, dim=-1, sorted=True)


def _categorical(probs: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``probs`` [..., N] (unnormalized is fine) by
    Gumbel-max over log-probabilities, as ``jax.random.categorical``
    draws: [...] int64 indices."""
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.argmax(torch.log(torch.clamp(probs, min=1e-30)) + gumbel,
                        dim=-1)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over vocab (first index on ties): [..., V] -> int32[...]."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def token_logprobs(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """log softmax(logits)[ids]: [B, V], [B] -> [B] f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, ids.long()[:, None])[:, 0]
    return picked - lse


def sample_top_k(logits: torch.Tensor, generator: torch.Generator, *,
                 temperature: float = 1.0, top_k: int = 5,
                 top_p: float = 1.0) -> torch.Tensor:
    """Sample ids from softmax(top_k(logits) / T), optionally top-p
    filtered within the K winners (one static config for the batch).
    logits [B, V] -> int32 [B]; temperature <= 0 is greedy."""
    if temperature <= 0.0:
        return greedy_sample(logits)
    vals, idx = torch.topk(logits.float(), top_k, dim=-1, sorted=True)
    probs = torch.softmax(vals / temperature, dim=-1)
    if top_p < 1.0:
        # nucleus: the smallest prefix of the sorted probs with cum >= p
        cum = torch.cumsum(probs, dim=-1)
        probs = torch.where((cum - probs) < top_p, probs, 0.0)
        probs = probs / probs.sum(dim=-1, keepdim=True)
    choice = _categorical(probs, generator)
    return torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)


def _candidate_probs(logits: torch.Tensor, temperature: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor,
                     min_p: Optional[torch.Tensor]):
    """The full processing chain shared by sampling and by
    :func:`processed_probs`. logits [..., V]; params [...].

    Returns (probs [..., K], idx [..., K], greedy [..., 1]); greedy rows
    (temperature <= 0) get a one-hot distribution on the top candidate."""
    K = min(MAX_TOP_K, logits.shape[-1])
    vals, idx = torch.topk(logits.float(), K, dim=-1, sorted=True)
    t = temperature[..., None]
    greedy = t <= 0.0
    vals_t = vals / torch.where(greedy, torch.ones_like(t), t)

    rank = torch.arange(K, device=logits.device)
    keep = rank < torch.clamp(top_k[..., None], min=1)
    vals_t = torch.where(keep, vals_t, -torch.inf)
    probs = torch.softmax(vals_t, dim=-1)

    if min_p is not None:
        pmax = probs.amax(dim=-1, keepdim=True)
        probs = torch.where(probs >= min_p[..., None] * pmax, probs, 0.0)

    probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-30)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < top_p[..., None]
    probs = torch.where(keep_p, probs, 0.0)
    probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-30)

    probs = torch.where(greedy, (rank == 0).to(probs.dtype), probs)
    return probs, idx, greedy


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor,
                  min_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot-parameterized sampling. logits [B, V]; params [B]
    (temperature <= 0 => greedy). Draws from the top-MAX_TOP_K candidates
    masked down to each slot's k, min-p floor and nucleus p, by Gumbel-max
    with noise from ``generator``."""
    probs, idx, greedy = _candidate_probs(logits, temperature, top_k, top_p,
                                          min_p)
    choice = _categorical(probs, generator)
    choice = torch.where(greedy[..., 0], 0, choice)
    return torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)


def processed_probs(logits: torch.Tensor, temperature: torch.Tensor,
                    top_k: torch.Tensor, top_p: torch.Tensor,
                    min_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The full-vocab probability vector :func:`sample_tokens` draws from.
    logits [..., V], params [...] -> probs [..., V]."""
    probs, idx, _ = _candidate_probs(logits, temperature, top_k, top_p,
                                     min_p)
    return torch.zeros(logits.shape, dtype=probs.dtype,
                       device=logits.device).scatter_(-1, idx, probs)


def speculative_accept(draft_tokens: torch.Tensor, q_probs: torch.Tensor,
                       p_probs: torch.Tensor, generator: torch.Generator):
    """Stochastic speculative acceptance (the rejection-sampling rule,
    lossless in distribution).

    draft_tokens [B, k] drawn from q; q_probs [B, k, V] the draft's
    processed distributions; p_probs [B, k+1, V] the target's. Position j
    accepts with probability min(1, p_j(x_j) / q_j(x_j)); the emitted
    sequence is the accepted prefix, then one token from
    norm(max(p_r - q_r, 0)) at the first rejection r, or from p_k when
    all k drafts were accepted (q extended with zeros at k makes the bonus
    draw the same formula). One-hot (greedy) rows reduce exactly to the
    longest-matching-prefix + argmax-bonus rule.

    Returns (emitted [B, k+1] int32, zero past position n_acc; n_acc [B]
    int32). Capturable: no value is read on the host."""
    B, k = draft_tokens.shape
    d = draft_tokens.long()[..., None]
    qx = torch.gather(q_probs, -1, d)[..., 0]                    # [B, k]
    px = torch.gather(p_probs[:, :k], -1, d)[..., 0]             # [B, k]
    u = torch.rand((B, k), generator=generator, device=q_probs.device)
    # u q <= p  <=>  u <= p / q, without the 0/0 of padding rows
    acc = (u * qx <= px).to(torch.int32)
    n_acc = torch.cumprod(acc, dim=1).sum(dim=1).to(torch.int32)  # [B]
    q_ext = torch.cat([q_probs, torch.zeros_like(p_probs[:, :1])], dim=1)
    at = n_acc.long()[:, None, None].expand(B, 1, p_probs.shape[-1])
    p_r = torch.gather(p_probs, 1, at)[:, 0]                     # [B, V]
    q_r = torch.gather(q_ext, 1, at)[:, 0]
    res = torch.clamp(p_r - q_r, min=0.0)
    tot = res.sum(dim=-1, keepdim=True)
    # p == q leaves no residual (TV distance 0): any draw from p is right
    res = torch.where(tot > 0, res / torch.clamp(tot, min=1e-30), p_r)
    extra = _categorical(res, generator).to(torch.int32)
    return accepted_tokens(draft_tokens, n_acc, extra), n_acc


def accepted_tokens(draft_tokens: torch.Tensor, n_acc: torch.Tensor,
                    bonus: torch.Tensor) -> torch.Tensor:
    """[B, k+1]: the first n_acc drafts, then ``bonus``, then zeros."""
    k = draft_tokens.shape[1]
    j = torch.arange(k + 1, device=draft_tokens.device)[None, :]
    dext = torch.cat([draft_tokens, torch.zeros_like(draft_tokens[:, :1])],
                     dim=1)
    n = n_acc[:, None]
    return torch.where(j < n, dext,
                       torch.where(j == n, bonus[:, None], 0)).to(torch.int32)

"""Top-K / top-p / min-p / temperature sampling and logit penalties.

Port of ``llm_inference_engine_tpu/ops/sampling.py`` (plain torch, as the
JAX package leaves sampling to XLA). Draws take an explicit
``torch.Generator``; they use the Gumbel-max form of a categorical draw,
as ``jax.random.categorical`` does, but the generator is Philox, not
threefry, so sampled ids differ between the packages. Greedy ids and the
processed distributions match.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["apply_penalties", "greedy_sample", "token_logprobs",
           "sample_tokens", "processed_probs", "MAX_TOP_K"]

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


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over vocab (first index on ties): [..., V] -> int32[...]."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def token_logprobs(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """log softmax(logits)[ids]: [B, V], [B] -> [B] f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, ids.long()[:, None])[:, 0]
    return picked - lse


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
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    choice = torch.argmax(torch.log(torch.clamp(probs, min=1e-30)) + gumbel,
                          dim=-1)
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

"""Beam-search decoding.

Port of ``llm_inference_engine_tpu/runtime/beam_search.py``. The beam
dimension is the batch dimension of the forward: one prefill of the
prompt fills every beam's rows (all beams prefill the same prompt), then
each step runs

  forward [num_beams, 1] -> log-softmax -> joint top-K over beam x vocab
  -> reorder the cache rows by parent beam

Finished beams (EOS) are frozen: their score stops accumulating and their
only successor is themselves with a forced pad token. Scores are sums of
log P(token | prefix); the final order divides each by
``generated_len ** length_penalty`` (the HF convention).

The JAX step is one jitted call whose cache reorder is a whole-cache
``jnp.take`` by parent. Here the step is one device program
(``runtime/decode_graph.py``: a CUDA graph on the card, captured at a
search's first step; eager on the CPU) over fixed addresses, so the
reorder gathers into a scratch buffer and copies back. It moves only the
rows a search can have written, the first ``prompt + max_new_tokens`` of
each beam (rows at or past a beam's length are never attended), not all
``max_seq_len``.

Over a mesh engine's params (a ``parallel.sharding.ShardedParams``, dp
x tp, or a context-parallel engine's) the search runs on data group 0's
model ranks of seq rank 0 (``ShardedParams.data_group``): a search is one
sequence, and every data rank holds the same weights. Its cache is a slot
``MeshCache`` over those ranks, each holding its kv heads of every beam,
the step's forward is the sharded forward (``make_sharded_forward``), and
the reorder runs on every rank. The JAX package runs its search over
sharded params through GSPMD. The step stays a CUDA-graph replay on a
mesh whose ranks are all on one card, and runs eagerly over several
cards, as the engine's decode does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from llm_inference_engine_tpu_torch.config import EngineConfig, ModelConfig
from llm_inference_engine_tpu_torch.models import llama as llama_model
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.parallel import sharding
from llm_inference_engine_tpu_torch.runtime import decode_graph
from llm_inference_engine_tpu_torch.runtime.engine import (
    add_decode_layouts, check_kernel_dtypes, kv_cache_dtype_of)

__all__ = ["BeamSearchResult", "BeamSearch", "beam_search"]

_NEG_INF = -1e30
# rows of the step's state buffer, int32 [len(_ROWS), num_beams]; scores
# hold f32 bits
_ROWS = ("tokens", "scores", "finished", "lengths", "parents")


@dataclasses.dataclass
class BeamSearchResult:
    sequences: list[list[int]]      # generated ids per beam, best first
    scores: list[float]             # total log-prob (length-penalized)


class BeamSearch:
    """A beam search's cache, its step's state buffers and (on the card)
    the step's captured program, for ``num_beams`` beams of one model.
    :meth:`search` may run several times; the step is captured again
    when the rows to reorder change."""

    def __init__(self, config: ModelConfig, engine_config: EngineConfig,
                 params, num_beams: int = 4, device=None):
        """``params``: one device's params, or a mesh engine's
        ``ShardedParams`` (``device`` is then the mesh's home)."""
        self.config = config
        eng = engine_config.replace(max_batch_size=num_beams)
        self.mesh = mesh = None
        self._fwd = None
        if isinstance(params, sharding.ShardedParams):
            params = params.data_group()
            self.mesh = mesh = params.mesh
            eng = eng.replace(dp=1, cp=1, tp=mesh.tp)
            self._fwd = sharding.make_sharded_forward(config, eng, mesh)
            device = mesh.home
        self.engine_config = eng
        self.params = params
        self.num_beams = num_beams
        self.device = device = torch.device(
            device if device is not None else params["embed"].device)
        check_kernel_dtypes(config, eng, device)
        add_decode_layouts(config, eng, params, device)

        dtype, quantized = kv_cache_dtype_of(config, eng)

        def new(batch, kv_heads, dev):
            return kvc.new_kv_cache(
                config.num_layers, batch, kv_heads, eng.max_seq_len,
                config.head_dim, dtype=dtype, device=dev,
                quantized=quantized)
        self.cache = (new(num_beams, config.num_kv_heads, device)
                      if mesh is None else sharding.sharded_cache(
                          mesh, new, num_beams, config.num_kv_heads))
        self._state = torch.zeros((len(_ROWS), num_beams), dtype=torch.int32,
                                  device=device)
        # eos (-1: none) and pad, read by the step on the device
        self._ids = torch.zeros((2,), dtype=torch.int32, device=device)
        self._rows = 0
        self._scratch: list = []
        # the step's graph on the card (None runs it eagerly, as over a
        # mesh of several cards: a graph is one device's), and the rows it
        # reorders
        one_device = mesh is None or mesh.one_device
        self._programs: Optional[dict] = (
            {} if device.type == "cuda" and one_device else None)
        self._captured_rows = 0

    def _planes(self) -> list:
        """The cache tensors whose rows follow their beam, every rank's."""
        shards = ([self.cache] if self.mesh is None
                  else [s for row in self.cache.shards for s in row])
        return [t for c in shards for t in (c.k, c.v, c.k_scale, c.v_scale)
                if t is not None]

    def _set_rows(self, rows: int) -> None:
        """Reorder the first ``rows`` rows of each beam from now on."""
        if rows == self._rows:
            return
        self._rows = rows
        self._scratch = [torch.empty_like(t[:, :, :rows])
                         for t in self._planes()]

    def gather_bytes(self) -> int:
        """Bytes one step's reorder reads and writes: each plane's rows
        gathered into the scratch and copied back, on every rank."""
        return 4 * sum(s.numel() * s.element_size() for s in self._scratch)

    def _forward(self, token_ids, q_start, kv_len) -> torch.Tensor:
        """The model's last-token logits over the beams' cache (the sharded
        forward over a mesh)."""
        if self._fwd is not None:
            return self._fwd(self.params, self.cache, token_ids, q_start,
                             kv_len)[0]
        return llama_model.forward_hidden(
            self.config, self.engine_config, self.params, token_ids,
            self.cache, q_start, kv_len)[0]

    def _step_body(self) -> None:
        """One beam step on the state buffer (tokens, scores, finished,
        lengths -> the same, and the parents)."""
        c, B = self.cache, self.num_beams
        st = self._state
        tokens, scores = st[0], st[1].view(torch.float32)
        finished, lengths = st[2] != 0, st[3]
        q_start = c.lengths
        logits = self._forward(tokens[:, None], q_start, q_start + 1)
        logp = torch.log_softmax(logits.float(), dim=-1)          # [B, V]
        V = logp.shape[-1]
        # finished beams: only successor is themselves with pad at the
        # same score; alive beams: score + logp
        eos, pad = self._ids[0], self._ids[1]
        frozen = torch.where(torch.arange(V, device=logp.device) == pad,
                             0.0, _NEG_INF)
        cand = torch.where(finished[:, None], scores[:, None] + frozen,
                           scores[:, None] + logp)
        top_scores, top_idx = torch.topk(cand.reshape(-1), B)
        parents = top_idx // V
        toks = (top_idx % V).to(torch.int32)

        rows = self._rows
        for plane, scratch in zip(self._planes(), self._scratch):
            live = plane[:, :, :rows]
            torch.index_select(live, 1, parents.to(plane.device),
                               out=scratch)
            live.copy_(scratch)
        c.lengths.copy_(c.lengths.index_select(0, parents))
        new_finished = finished.index_select(0, parents)
        just_done = ~new_finished & (toks == eos)
        st[0].copy_(torch.where(new_finished, pad, toks))
        st[1].view(torch.float32).copy_(top_scores)
        st[3].copy_(lengths.index_select(0, parents)
                    + (~(new_finished | just_done)).to(torch.int32))
        st[2].copy_(new_finished | just_done)
        st[4].copy_(parents)

    def step(self) -> np.ndarray:
        """One step (a replay on the card); returns the host state."""
        if self._programs is not None and self._captured_rows != self._rows:
            # a graph of other rows reorders other scratch buffers
            self._programs.clear()
            self._captured_rows = self._rows
        # the capture's warm-up runs right after the prefill, when every
        # beam holds the same rows: its reorder changes none of them, and
        # the row it writes is written again by the step; the state and
        # the lengths are put back
        decode_graph.run(self, "step", (self._state, self.cache.lengths))
        return self._state.cpu().numpy()

    def search(self, prompt_ids: Sequence[int], max_new_tokens: int = 64,
               eos_token_id: Optional[int] = 2, length_penalty: float = 1.0,
               pad_token_id: int = 0) -> BeamSearchResult:
        """Beam-search one prompt. Returns the beams sorted by
        length-penalized score, best first."""
        B, S = self.num_beams, self.engine_config.max_seq_len
        P = len(prompt_ids)
        if P + max_new_tokens > S:
            raise ValueError(f"prompt {P} + {max_new_tokens} new > max_seq "
                             f"{S}")
        self._set_rows(P + max_new_tokens)
        dev = self.device
        self._ids.copy_(torch.tensor(
            [-1 if eos_token_id is None else eos_token_id, pad_token_id],
            dtype=torch.int32))

        # every beam prefills the same prompt
        ids = torch.tensor(list(prompt_ids), dtype=torch.int32)
        ids = ids.to(dev)[None, :].expand(B, P).contiguous()
        self.cache.lengths.zero_()
        logits = self._forward(
            ids, torch.zeros((B,), dtype=torch.int32, device=dev),
            torch.full((B,), P, dtype=torch.int32, device=dev))
        logp0 = torch.log_softmax(logits.float(), dim=-1)
        # first expansion: the beams are identical, so the top B tokens of
        # beam 0 (a joint top-K over identical rows would pick duplicates)
        s0, t0 = torch.topk(logp0[0], B)
        st = self._state
        st[0].copy_(t0)
        st[1].view(torch.float32).copy_(s0)
        st[2].copy_(t0 == (-1 if eos_token_id is None else eos_token_id))
        st[3].fill_(1)
        host = st.cpu().numpy()

        hyp = [[int(t)] for t in host[0]]
        for _ in range(max_new_tokens - 1):
            if host[2].all():
                break
            host = self.step()
            new_hyp = []
            for b in range(B):
                seq = list(hyp[host[4, b]])
                t = int(host[0, b])
                # append unless the beam is frozen and padding along
                if not (host[2, b] and t == pad_token_id):
                    seq.append(t)
                new_hyp.append(seq)
            hyp = new_hyp

        scores = host[1].view(np.float32).astype(np.float64)
        lengths = host[3].astype(np.float64)
        final = scores / np.maximum(lengths, 1.0) ** length_penalty
        order = np.argsort(-final)
        out_seqs, out_scores = [], []
        for b in order:
            seq = hyp[b]
            if eos_token_id is not None and eos_token_id in seq:
                seq = seq[:seq.index(eos_token_id) + 1]
            out_seqs.append(seq)
            out_scores.append(float(final[b]))
        return BeamSearchResult(sequences=out_seqs, scores=out_scores)


def beam_search(config: ModelConfig, engine_config: EngineConfig, params,
                prompt_ids: Sequence[int], num_beams: int = 4,
                max_new_tokens: int = 64, eos_token_id: Optional[int] = 2,
                length_penalty: float = 1.0,
                pad_token_id: int = 0) -> BeamSearchResult:
    """Beam-search a single prompt on the device of ``params``, or on data
    group 0's ranks of a mesh engine's ``ShardedParams`` (see
    :class:`BeamSearch`). Returns the beams sorted by length-penalized
    score, best first."""
    return BeamSearch(config, engine_config, params, num_beams).search(
        prompt_ids, max_new_tokens, eos_token_id, length_penalty,
        pad_token_id)

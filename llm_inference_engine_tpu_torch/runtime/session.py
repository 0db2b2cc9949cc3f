"""Multi-round chat session over one engine slot.

Port of ``llm_inference_engine_tpu/runtime/session.py`` (framework-free
but for its imports). History lives in the KV cache and each round
prefills only its new tokens; the streaming callback follows the
reference's index protocol (0 first chunk, >0 continuation, -1 end). A
paged engine carries the history's full pages across the slot reset
(``_paged_carry_history``). The engine's one-token top-up of a
length-terminated row is mirrored as it is (ROADMAP.md, queue 3), so the
session's ids equal the JAX session's. ``response_beam`` decodes a
round with beam search (``beam_search.py``; over a mesh engine's sharded
weights, on its data group 0) and re-prefills the winning turn into the
session's slot.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

from llm_inference_engine_tpu_torch.config import SamplingParams
from llm_inference_engine_tpu_torch.runtime.chat_template import (
    ChatTemplate, get_chat_template, resolve_stop_ids)

__all__ = ["ChatSession"]


class ChatSession:
    def __init__(self, engine, tokenizer, slot: int = 0,
                 system_prompt: str = "",
                 template: Union[str, ChatTemplate] = "plain"):
        self.engine = engine
        self.tokenizer = tokenizer
        self.slot = slot
        self.round = 0
        self.token_history: list[int] = []
        self.system_prompt = system_prompt
        self.template = (get_chat_template(template)
                         if isinstance(template, str) else template)
        self._stop_ids = tuple(resolve_stop_ids(
            tokenizer, self.template.stop_strings))

    def reset(self):
        self.engine.reset([self.slot])
        self.round = 0
        self.token_history = []

    def make_input(self, user_input: str) -> list[int]:
        """Render this round through the chat template (round-0 carries
        the system block; later rounds only the new turn — history lives
        in the KV cache) and tokenize."""
        text = self.template.render(self.round, self.system_prompt,
                                    user_input)
        return self.tokenizer.encode(
            text, add_bos=(self.round == 0 and self.template.add_bos))

    def _paged_carry_history(self) -> list[int]:
        """Carry the history's full pages across a slot reset (paged
        engines): share them with the allocator so the reset cannot free
        them, re-adopt them into the fresh slot, and return the partial
        tail tokens the caller must re-prefill (page-aligned appends are
        legal; mid-page ones are not). Falls back to full re-prefill when
        less than one page of history exists."""
        eng = self.engine
        page = eng.engine_config.page_size
        hist = self.token_history
        n_full = min(len(hist) // page, len(eng._slot_pages[self.slot]))
        if n_full == 0:
            eng.reset([self.slot])
            return list(hist)
        pages = list(eng._slot_pages[self.slot][:n_full])
        eng._allocator.share(pages)          # survive the reset
        eng.reset([self.slot])
        eng.adopt_prefix_pages(self.slot, pages, n_full * page)
        eng._allocator.free(pages)           # drop our temporary ref
        # penalty counts for the carried tokens (reset cleared them)
        eng.seed_counts(self.slot, ctx_tokens=hist[:n_full * page])
        return list(hist[n_full * page:])

    def _with_stops(self, sampling: SamplingParams) -> SamplingParams:
        if not self._stop_ids:
            return sampling
        merged = tuple(sorted(set(sampling.stop_token_ids)
                              | set(self._stop_ids)))
        return dataclasses.replace(sampling, stop_token_ids=merged)

    def response(self, user_input: str,
                 sampling: SamplingParams = SamplingParams(),
                 callback: Optional[Callable[[int, str], None]] = None) -> str:
        """Generate one reply, streaming text chunks through ``callback``
        (reference CallBack index protocol: 0 first, >0 next, -1 done)."""
        input_ids = self.make_input(user_input)
        prompt_history = self.token_history + input_ids

        if getattr(self.engine, "paged", False) and self.token_history:
            # paged pools take multi-token writes only at page-aligned
            # starts, so a mid-page append is illegal. Instead of
            # re-prefilling the whole history (round-2 behavior; the
            # reference's makeHistory recomputed everything,
            # llama.cpp:137-155), carry the history's FULL pages across
            # the slot reset via the allocator's refcounts (the zero-copy
            # prefix machinery) and re-prefill only the partial tail page
            # + this round's new tokens.
            input_ids = self._paged_carry_history() + input_ids

        pieces: list[str] = []

        def on_token(_slot: int, token_id: int) -> None:
            ids_so_far = prompt_history + [
                tid for tid in gen_ids]
            text = self.tokenizer.decode_incremental(ids_so_far, token_id)
            gen_ids.append(token_id)
            if callback is not None:
                callback(len(pieces), text)
            pieces.append(text)

        gen_ids: list[int] = []
        result = self.engine.generate(
            [input_ids], self._with_stops(sampling),
            eos_token_id=getattr(self.tokenizer, "eos_id", 2),
            stream_callback=on_token)
        if callback is not None:
            callback(-1, "")

        out_ids = result.token_ids[0]
        self.token_history = prompt_history + out_ids
        self.round += 1
        return "".join(pieces)

    def response_beam(self, user_input: str, num_beams: int = 4,
                      max_new_tokens: int = 64, length_penalty: float = 1.0,
                      callback: Optional[Callable[[int, str], None]] = None
                      ) -> str:
        """Generate one reply with beam search (no streaming: the winning
        beam is known only at the end; the callback receives the final
        text as one chunk). The search replays the whole token history as
        its prompt, in beam caches of its own, then the winning turn is
        re-prefilled into this session's slot so that later rounds
        continue from it."""
        from llm_inference_engine_tpu_torch.runtime.beam_search import (
            beam_search)
        input_ids = self.make_input(user_input)
        prompt_history = self.token_history + input_ids

        res = beam_search(
            self.engine.config, self.engine.engine_config, self.engine.params,
            prompt_history, num_beams=num_beams,
            max_new_tokens=max_new_tokens,
            eos_token_id=getattr(self.tokenizer, "eos_id", 2),
            length_penalty=length_penalty)
        out_ids = res.sequences[0]
        # decode the whole reply relative to the history
        full = self.tokenizer.decode(prompt_history + out_ids)
        base = self.tokenizer.decode(prompt_history)
        text = full[len(base):] if full.startswith(base) else \
            self.tokenizer.decode(out_ids)
        if callback is not None:
            callback(0, text)
            callback(-1, "")

        # resync the engine slot: replay this round into the live cache
        self.engine.reset([self.slot])
        self.engine.prefill([prompt_history + out_ids], slots=[self.slot])
        self.token_history = prompt_history + out_ids
        self.round += 1
        return text

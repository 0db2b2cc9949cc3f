"""Command-line helpers.

Of ``llm_inference_engine_tpu/cli.py`` only the id tokenizer is ported:
the server uses it for dummy weights. The interactive REPL and its chat
session wait for ROADMAP.md, queue 1, "Host-side serving".
"""

from __future__ import annotations

__all__ = ["_IdTokenizer"]


class _IdTokenizer:
    """Fallback for dummy mode: tokens are whitespace-separated ints."""

    bos_id = 1
    eos_id = 2

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False):
        ids = [int(t) % self.vocab_size for t in text.split() if
               t.lstrip("-").isdigit()]
        if not ids:
            ids = [(abs(hash(t)) % (self.vocab_size - 3)) + 3
                   for t in text.split()]
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    def decode_incremental(self, prev_ids, new_id):
        return (" " if prev_ids else "") + str(int(new_id))

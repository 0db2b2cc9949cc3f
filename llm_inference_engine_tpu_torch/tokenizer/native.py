"""Native (C++) BPE tokenizer wrapper.

Same algorithm and vocab formats as the pure-Python BPETokenizer
(tokenizer/bpe.py) — the Python side parses the vocab file, the C++ side
(csrc/tokenizer.cc: trie index + score-ordered heap merges, the design of
the reference's C++ tokenizer, src/models/tokenizer.h:57-348) runs the
per-request encode/decode hot path. Exact output parity with the Python
implementation is enforced by tests/test_torch_tokenizer.py (and, for the
JAX package's copy, by tests/test_native.py). The C++ source is the port's
own copy, llm_inference_engine_tpu_torch/csrc/tokenizer.cc.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, Sequence

from llm_inference_engine_tpu_torch.native import load_native
from llm_inference_engine_tpu_torch.tokenizer.bpe import BPETokenizer

__all__ = ["NativeBPETokenizer", "wrap_native"]


class NativeBPETokenizer:
    """Drop-in replacement for BPETokenizer backed by libllm_native."""

    def __init__(self, pieces: dict[str, tuple[int, float]],
                 bos_id: int = 1, eos_id: int = 2, unk_id: int = 0,
                 add_leading_blank: bool = True):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.unk_id = unk_id
        self.add_leading_blank = add_leading_blank
        self.id_to_piece = {i: p for p, (i, _) in pieces.items()}
        self._h = lib.llm_tok_new(bos_id, eos_id, unk_id,
                                  int(add_leading_blank))
        for piece, (tid, score) in pieces.items():
            b = piece.encode("utf-8")
            lib.llm_tok_add_piece(self._h, b, len(b), tid, float(score))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and getattr(self, "_lib", None):
            self._lib.llm_tok_free(h)

    @property
    def vocab_size(self) -> int:
        return max(self.id_to_piece) + 1 if self.id_to_piece else 0

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> list[int]:
        b = text.encode("utf-8")
        cap = max(16, 2 * len(b) + 8)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.llm_tok_encode(self._h, b, len(b), int(add_bos),
                                     int(add_eos), buf, cap)
        if n < 0:
            cap = -n
            buf = (ctypes.c_int32 * cap)()
            n = self._lib.llm_tok_encode(self._h, b, len(b), int(add_bos),
                                         int(add_eos), buf, cap)
        return list(buf[:n])

    def decode(self, ids: Iterable[int]) -> str:
        ids = [int(i) for i in ids]
        arr = (ctypes.c_int32 * len(ids))(*ids)
        cap = max(16, 8 * len(ids))
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.llm_tok_decode(self._h, arr, len(ids), buf, cap)
        if n < 0:
            cap = -n
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.llm_tok_decode(self._h, arr, len(ids), buf, cap)
        text = buf.raw[:n].decode("utf-8", errors="replace")
        if self.add_leading_blank and text.startswith(" "):
            text = text[1:]
        return text

    def decode_incremental(self, prev_ids: Sequence[int], new_id: int) -> str:
        before = self.decode(prev_ids)
        after = self.decode(list(prev_ids) + [int(new_id)])
        return after[len(before):] if after.startswith(before) else after


def wrap_native(tok: BPETokenizer) -> "NativeBPETokenizer | BPETokenizer":
    """Upgrade a Python BPETokenizer to the native encoder when the C++
    library is available; otherwise return the tokenizer unchanged."""
    if load_native() is None:
        return tok
    pieces = {p: (i, tok.piece_score[p]) for p, i in tok.piece_to_id.items()}
    return NativeBPETokenizer(pieces, bos_id=tok.bos_id, eos_id=tok.eos_id,
                              unk_id=tok.unk_id,
                              add_leading_blank=tok.add_leading_blank)

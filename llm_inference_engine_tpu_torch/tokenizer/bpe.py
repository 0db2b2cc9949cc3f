"""SentencePiece-style BPE tokenizer (score-ordered merges, byte fallback).

A copy of the JAX package's framework-free
``llm_inference_engine_tpu/tokenizer/bpe.py`` (the port imports nothing of
that package); ``tests/test_torch_tokenizer.py`` holds the two to the same
ids.

Capability parity with the reference's hand-rolled tokenizer
(reference: src/models/tokenizer.h:57-348):
- score-ordered pairwise merging driven by a priority queue over adjacent
  symbol pairs (tokenizer.h:168-271);
- ``▁`` (U+2581) whitespace convention with a leading blank
  (tokenizer.h:189-203);
- byte-fallback ``<0xAB>`` pieces for uncovered bytes (tokenizer.h:282-289);
- decode handling of byte pieces and ``<n>`` / ``<|tab|>`` / ``<|blank_N|>``
  specials (tokenizer.h:305-347);
- the reference's custom binary vocab format (``FileBuffer`` layout,
  tokenizer.h:11-55,138-167).

Additions the reference lacks:
- loading real Llama ``tokenizer.model`` files via a minimal embedded
  protobuf reader (no sentencepiece dependency), and HF ``tokenizer.json``
  via the ``tokenizers`` library when present;
- exact byte-level round-tripping (encode(decode(x)) == x for valid text).

This pure-Python implementation is the fallback; tokenizer/native.py wraps
the C++ trie/heap encoder (same algorithm, compiled) when built.
"""

from __future__ import annotations

import heapq
import json
import os
import struct
from typing import Iterable, Optional, Sequence

__all__ = ["BPETokenizer", "load_tokenizer"]

_BLANK = "▁"  # ▁


class BPETokenizer:
    def __init__(self, pieces: dict[str, tuple[int, float]],
                 bos_id: int = 1, eos_id: int = 2, unk_id: int = 0,
                 add_leading_blank: bool = True):
        """pieces: piece string -> (token id, merge score)."""
        self.piece_to_id = {p: i for p, (i, _) in pieces.items()}
        self.piece_score = {p: s for p, (_, s) in pieces.items()}
        self.id_to_piece = {i: p for p, (i, _) in pieces.items()}
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.unk_id = unk_id
        self.add_leading_blank = add_leading_blank
        self._byte_pieces = {
            i: int(p[3:5], 16) for p, (i, _) in pieces.items()
            if len(p) == 6 and p.startswith("<0x") and p.endswith(">")}

    @property
    def vocab_size(self) -> int:
        return max(self.id_to_piece) + 1 if self.id_to_piece else 0

    # ------------------------------------------------------------------
    # encoding
    # ------------------------------------------------------------------

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> list[int]:
        """Score-ordered BPE merge over initial character symbols.

        Same algorithm as the reference's Encode (tokenizer.h:244-295): a
        heap of adjacent candidate pairs ordered by the merged piece's
        score, lazily invalidated when a neighbor was already merged.
        """
        s = text.replace(" ", _BLANK)
        if self.add_leading_blank and not s.startswith(_BLANK):
            s = _BLANK + s

        # doubly-linked symbol list over initial one-char symbols
        pieces = [c for c in s]
        prev = list(range(-1, len(pieces) - 1))
        nxt = list(range(1, len(pieces) + 1))
        alive = [True] * len(pieces)

        counter = 0
        heap: list[tuple[float, int, int, int, str]] = []

        def push(l: int, r: int):
            nonlocal counter
            if l < 0 or r >= len(pieces):
                return
            merged = pieces[l] + pieces[r]
            score = self.piece_score.get(merged)
            if score is None:
                return
            # max-heap by score; tie-break on insertion order (leftmost-
            # earliest, matching SentencePiece behavior closely enough for
            # score-distinct vocabs)
            heapq.heappush(heap, (-score, counter, l, r, merged))
            counter += 1

        for i in range(1, len(pieces)):
            push(i - 1, i)

        while heap:
            _, _, l, r, merged = heapq.heappop(heap)
            if not (alive[l] and alive[r]) or pieces[l] + pieces[r] != merged:
                continue
            pieces[l] = merged
            alive[r] = False
            nxt[l] = nxt[r]
            if nxt[r] < len(pieces):
                prev[nxt[r]] = l
            if prev[l] >= 0:
                push(prev[l], l)
            if nxt[l] < len(pieces):
                push(l, nxt[l])

        out: list[int] = []
        if add_bos and self.bos_id is not None:
            out.append(self.bos_id)
        i = 0
        while i < len(pieces):
            if not alive[i]:
                i += 1
                continue
            piece = pieces[i]
            tid = self.piece_to_id.get(piece)
            if tid is not None:
                out.append(tid)
            else:
                # byte fallback (tokenizer.h:282-289)
                for b in piece.encode("utf-8"):
                    bp = f"<0x{b:02X}>"
                    bid = self.piece_to_id.get(bp)
                    out.append(bid if bid is not None else self.unk_id)
            i = nxt[i]
        if add_eos and self.eos_id is not None:
            out.append(self.eos_id)
        return out

    # ------------------------------------------------------------------
    # decoding
    # ------------------------------------------------------------------

    def decode(self, ids: Iterable[int]) -> str:
        """Inverse map with byte-piece assembly and the reference's
        specials (<n>, <|tab|>, <|blank_N|>, tokenizer.h:305-347)."""
        chunks: list[bytes] = []
        for tid in ids:
            tid = int(tid)
            if tid in self._byte_pieces:
                chunks.append(bytes([self._byte_pieces[tid]]))
                continue
            piece = self.id_to_piece.get(tid, "")
            if piece in ("<s>", "</s>", "<unk>"):
                continue
            if piece == "<n>":
                piece = "\n"
            elif piece == "<|tab|>":
                piece = "\t"
            elif piece.startswith("<|blank_") and piece.endswith("|>"):
                piece = " " * int(piece[8:-2])
            chunks.append(piece.encode("utf-8"))
        text = b"".join(chunks).decode("utf-8", errors="replace")
        text = text.replace(_BLANK, " ")
        if self.add_leading_blank and text.startswith(" "):
            text = text[1:]
        return text

    def decode_incremental(self, prev_ids: Sequence[int],
                           new_id: int) -> str:
        """Streaming decode: text emitted by appending new_id (byte pieces
        may hold partial UTF-8 — emitted only once complete)."""
        before = self.decode(prev_ids)
        after = self.decode(list(prev_ids) + [new_id])
        return after[len(before):] if after.startswith(before) else after


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------

def _load_flm_binary(path: str) -> BPETokenizer:
    """The reference's custom binary vocab (tokenizer.h:138-167):
    version; [kv table]; vocab_len; {len, len*int(char), id, score}."""
    with open(path, "rb") as f:
        def rint() -> int:
            return struct.unpack("<i", f.read(4))[0]

        def rfloat() -> float:
            return struct.unpack("<f", f.read(4))[0]

        def rstr() -> str:
            n = rint()
            return f.read(n).decode("utf-8", errors="replace")

        version = rint()
        if version >= 1:
            for _ in range(rint()):
                rstr(), rstr()
        pieces: dict[str, tuple[int, float]] = {}
        for _ in range(rint()):
            n = rint()
            chars = bytes(rint() & 0xFF for _ in range(n))
            piece = chars.decode("utf-8", errors="replace")
            tid = rint()
            score = rfloat()
            pieces[piece] = (tid, score)
    return BPETokenizer(pieces)


def _load_sentencepiece_model(path: str) -> BPETokenizer:
    """Parse a SentencePiece .model protobuf with a minimal embedded
    reader (field 1: repeated SentencePiece{1: piece, 2: score, 3: type}).
    No sentencepiece dependency required."""
    with open(path, "rb") as f:
        data = f.read()

    def read_varint(buf: bytes, i: int) -> tuple[int, int]:
        shift = 0
        val = 0
        while True:
            b = buf[i]
            i += 1
            val |= (b & 0x7F) << shift
            if not b & 0x80:
                return val, i
            shift += 7

    pieces: dict[str, tuple[int, float]] = {}
    tid = 0
    i = 0
    n = len(data)
    while i < n:
        tag, i = read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:          # repeated SentencePiece
            ln, i = read_varint(data, i)
            sub = data[i:i + ln]
            i += ln
            piece, score, ptype = "", 0.0, 1
            j = 0
            while j < ln:
                t2, j = read_varint(sub, j)
                f2, w2 = t2 >> 3, t2 & 7
                if f2 == 1 and w2 == 2:
                    l2, j = read_varint(sub, j)
                    piece = sub[j:j + l2].decode("utf-8", errors="replace")
                    j += l2
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", sub[j:j + 4])[0]
                    j += 4
                elif f2 == 3 and w2 == 0:
                    ptype, j = read_varint(sub, j)
                elif w2 == 0:
                    _, j = read_varint(sub, j)
                elif w2 == 2:
                    l2, j = read_varint(sub, j)
                    j += l2
                elif w2 == 5:
                    j += 4
                elif w2 == 1:
                    j += 8
                else:
                    break
            pieces[piece] = (tid, score)
            tid += 1
        elif wire == 2:                        # skip other length-delimited
            ln, i = read_varint(data, i)
            i += ln
        elif wire == 0:
            _, i = read_varint(data, i)
        elif wire == 5:
            i += 4
        elif wire == 1:
            i += 8
        else:
            break
    return BPETokenizer(pieces)


class HFTokenizerWrapper:
    """tokenizer.json via the `tokenizers` library (same interface)."""

    def __init__(self, path: str, bos_id: int = 1, eos_id: int = 2):
        from tokenizers import Tokenizer as _T
        self._tok = _T.from_file(path)
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.vocab_size = self._tok.get_vocab_size()

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids) -> str:
        return self._tok.decode(list(int(i) for i in ids),
                                skip_special_tokens=True)

    def decode_incremental(self, prev_ids, new_id) -> str:
        before = self.decode(prev_ids)
        after = self.decode(list(prev_ids) + [int(new_id)])
        return after[len(before):] if after.startswith(before) else after


def load_tokenizer(path: str):
    """Auto-detect: tokenizer.json (HF) / tokenizer.model (sentencepiece
    proto) / .bin (reference FLM format) / directory containing any."""
    if os.path.isdir(path):
        for name in ("tokenizer.json", "tokenizer.model", "tokenizer.bin"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"no tokenizer file in {path}")
    if path.endswith(".json"):
        return HFTokenizerWrapper(path)
    if path.endswith(".model"):
        return _load_sentencepiece_model(path)
    return _load_flm_binary(path)

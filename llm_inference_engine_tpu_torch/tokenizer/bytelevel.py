"""Byte-level BPE tokenizer (GPT-2/tiktoken family: Qwen2, Llama3).

A copy of the JAX package's framework-free
``llm_inference_engine_tpu/tokenizer/bytelevel.py``; ``regex`` (for the
pre-tokenizer pattern) is imported only when a tokenizer is built, so the
module imports without it. ``tests/test_torch_tokenizer.py`` holds the two
copies to the same ids.

Own implementation of the second big tokenizer family, complementing the
SentencePiece-style BPE in bpe.py (which mirrors the reference's trie/heap
encoder, tokenizer.h:57-348). Loads HF ``tokenizer.json`` directly:

- byte→unicode alphabet (the GPT-2 table: printable bytes map to
  themselves, the rest to U+0100+n) so every byte sequence is encodable —
  the byte-level counterpart of the reference's ``<0xAB>`` byte-fallback
  pieces (tokenizer.h:282-289);
- regex pre-tokenization (the pattern ships inside tokenizer.json for
  Llama3/Qwen2-style Split pre-tokenizers; plain ByteLevel pre-tokenizers
  use the GPT-2 contraction pattern);
- rank-ordered greedy BPE merges per pre-token with an LRU cache;
- added/special tokens split out of the text before pre-tokenization and
  emitted as their ids; decode drops specials (HF skip_special_tokens
  semantics) and re-assembles bytes with utf-8 replacement.

Parity with the `tokenizers` library is pinned (for the JAX package's
copy) by tests/test_bytelevel_tokenizer.py over unicode/emoji/whitespace/code
corpora for both pre-tokenizer flavors.
"""

from __future__ import annotations

import functools
import json
from typing import Iterable, Optional, Sequence

__all__ = ["ByteLevelBPETokenizer"]

# GPT-2 contraction pattern (tokenizer.json ByteLevel pre-tokenizers)
_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                 r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


@functools.lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 byte→unicode table: visible latin-1 bytes map to
    themselves, the remaining 68 bytes to U+0100.. in order."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache()
def _unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in _bytes_to_unicode().items()}


def _find_pattern(pre_tok: Optional[dict]) -> Optional[str]:
    """Extract the split regex from a tokenizer.json pre_tokenizer spec
    (Split with a Regex pattern, possibly nested in a Sequence); None for
    plain ByteLevel (caller uses the GPT-2 pattern)."""
    if not pre_tok:
        return None
    t = pre_tok.get("type")
    if t == "Sequence":
        for sub in pre_tok.get("pretokenizers", []):
            p = _find_pattern(sub)
            if p is not None:
                return p
        return None
    if t == "Split":
        pat = pre_tok.get("pattern", {})
        return pat.get("Regex") or pat.get("String")
    return None


class ByteLevelBPETokenizer:
    def __init__(self, vocab: dict[str, int], merges: Sequence[tuple[str, str]],
                 pattern: Optional[str] = None,
                 added_tokens: Optional[dict[str, int]] = None,
                 special_ids: Optional[set] = None,
                 bos_id: Optional[int] = None, eos_id: Optional[int] = None):
        import regex
        self.vocab = vocab
        self.id_to_token = {i: t for t, i in vocab.items()}
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.pattern = regex.compile(pattern or _GPT2_PATTERN)
        self.added = dict(added_tokens or {})
        for t, i in self.added.items():
            self.id_to_token.setdefault(i, t)
        self.special_ids = set(special_ids or self.added.values())
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.vocab_size = max(
            [max(vocab.values(), default=-1)]
            + [max(self.added.values(), default=-1)]) + 1
        if self.added:
            self._added_split = regex.compile(
                "(" + "|".join(regex.escape(t) for t in sorted(
                    self.added, key=len, reverse=True)) + ")")
        else:
            self._added_split = None
        self._b2u = _bytes_to_unicode()
        self._u2b = _unicode_to_bytes()
        # per-instance merge cache (an lru_cache on the METHOD would key
        # the process-global cache on self and pin every instance forever)
        self._bpe_cache: dict[str, tuple[int, ...]] = {}

    # ------------------------------------------------------------------

    def _bpe(self, token: str) -> tuple[int, ...]:
        """Greedy rank-ordered merges over one pre-token (already in
        byte-unicode alphabet)."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        parts = list(token)
        while len(parts) > 1:
            best = None
            best_rank = None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts[best:best + 2] = [parts[best] + parts[best + 1]]
        out = []
        for p in parts:
            tid = self.vocab.get(p)
            if tid is None:
                # alphabet chars missing from the vocab: emit per-char ids
                # when present, else skip (mirrors `tokenizers` behavior)
                for c in p:
                    cid = self.vocab.get(c)
                    if cid is not None:
                        out.append(cid)
            else:
                out.append(tid)
        result = tuple(out)
        if len(self._bpe_cache) < 65536:
            self._bpe_cache[token] = result
        return result

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        ids: list[int] = []
        if add_bos and self.bos_id is not None:
            ids.append(self.bos_id)
        segments = (self._added_split.split(text) if self._added_split
                    else [text])
        for seg in segments:
            if not seg:
                continue
            if seg in self.added:
                ids.append(self.added[seg])
                continue
            for tok in self.pattern.findall(seg):
                mapped = "".join(self._b2u[b] for b in tok.encode("utf-8"))
                ids.extend(self._bpe(mapped))
        if add_eos and self.eos_id is not None:
            ids.append(self.eos_id)
        return ids

    # ------------------------------------------------------------------

    def _token_bytes(self, tid: int) -> bytes:
        tok = self.id_to_token.get(int(tid))
        if tok is None:
            return b""
        u2b = self._u2b
        return bytes(u2b[c] for c in tok if c in u2b)

    def decode(self, ids: Iterable[int],
               skip_special_tokens: bool = True) -> str:
        buf = bytearray()
        for tid in ids:
            tid = int(tid)
            if tid in self.special_ids:
                if not skip_special_tokens:
                    buf += self.id_to_token.get(tid, "").encode("utf-8")
                continue
            buf += self._token_bytes(tid)
        return buf.decode("utf-8", errors="replace")

    def decode_incremental(self, prev_ids: Sequence[int], new_id: int) -> str:
        """Streaming decode: the text appended by ``new_id``. Byte-safe —
        a token ending mid-utf8-sequence emits nothing until the sequence
        completes (the replacement char never flickers into the stream)."""
        tail = list(prev_ids[-8:])
        before = self.decode(tail)
        after = self.decode(tail + [int(new_id)])
        # longest common prefix (stop at a replacement char: the new token
        # may complete a previously-incomplete utf-8 sequence there)
        i = 0
        lim = min(len(before), len(after))
        while i < lim and before[i] == after[i] and before[i] != "�":
            i += 1
        return after[i:].replace("�", "")

    # ------------------------------------------------------------------

    @staticmethod
    def from_tokenizer_json(path: str) -> "ByteLevelBPETokenizer":
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec.get("model", {})
        if model.get("type") != "BPE":
            raise ValueError(f"not a BPE tokenizer.json: {model.get('type')}")
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model.get("merges", [])]
        added = {}
        special = set()
        for t in spec.get("added_tokens", []):
            added[t["content"]] = t["id"]
            if t.get("special"):
                special.add(t["id"])
        bos = eos = None
        for name, ref in (("<|begin_of_text|>", "bos"), ("<s>", "bos"),
                          ("<|endoftext|>", "eos"), ("<|end_of_text|>", "eos"),
                          ("</s>", "eos"), ("<|im_end|>", "eos")):
            if name in added:
                if ref == "bos" and bos is None:
                    bos = added[name]
                if ref == "eos" and eos is None:
                    eos = added[name]
        return ByteLevelBPETokenizer(
            vocab=model["vocab"], merges=merges,
            pattern=_find_pattern(spec.get("pre_tokenizer")),
            added_tokens=added, special_ids=special,
            bos_id=bos, eos_id=eos)


def is_bytelevel_tokenizer_json(path: str) -> bool:
    """True when tokenizer.json is the byte-level BPE family this module
    implements (BPE model, no byte_fallback/SP-style artifacts)."""
    try:
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
    except (OSError, ValueError):
        return False
    model = spec.get("model", {})
    if model.get("type") != "BPE" or model.get("byte_fallback"):
        return False

    def has_bytelevel(pt):
        if not pt:
            return False
        t = pt.get("type")
        if t == "ByteLevel":
            return True
        if t == "Sequence":
            return any(has_bytelevel(s) for s in pt.get("pretokenizers", []))
        return False

    return has_bytelevel(spec.get("pre_tokenizer"))

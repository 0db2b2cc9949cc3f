"""Tokenizers: copies of the JAX package's framework-free
``llm_inference_engine_tpu/tokenizer`` modules over the port's own native
library (``llm_inference_engine_tpu_torch/native.py``)."""

from llm_inference_engine_tpu_torch.tokenizer.bpe import BPETokenizer
from llm_inference_engine_tpu_torch.tokenizer.bpe import (
    load_tokenizer as _load_py)
from llm_inference_engine_tpu_torch.tokenizer.bytelevel import (
    ByteLevelBPETokenizer)


def load_tokenizer(path: str, native: bool = True):
    """Load a tokenizer (HF tokenizer.json / sentencepiece .model /
    reference .bin vocab). Byte-level BPE tokenizer.json (Qwen2/Llama3
    family) loads through this package's own implementation
    (tokenizer/bytelevel.py); SentencePiece-style BPE vocabs upgrade to
    the C++ trie/heap encoder (the port's csrc/tokenizer.cc) when the
    native library is available."""
    import os

    from llm_inference_engine_tpu_torch.tokenizer.bytelevel import (
        is_bytelevel_tokenizer_json)

    p = path
    if os.path.isdir(p):
        cand = os.path.join(p, "tokenizer.json")
        if os.path.exists(cand) and is_bytelevel_tokenizer_json(cand):
            return ByteLevelBPETokenizer.from_tokenizer_json(cand)
    elif p.endswith(".json") and is_bytelevel_tokenizer_json(p):
        return ByteLevelBPETokenizer.from_tokenizer_json(p)

    tok = _load_py(path)
    if native and isinstance(tok, BPETokenizer):
        from llm_inference_engine_tpu_torch.tokenizer.native import (
            wrap_native)
        tok = wrap_native(tok)
    return tok


__all__ = ["BPETokenizer", "ByteLevelBPETokenizer", "load_tokenizer"]

"""The PyTorch port's tokenizers (copies of the JAX package's framework-free
modules over the port's own native library) against the JAX package's, on
the CPU: the SentencePiece-style BPE (pure Python and the native C++
encoder) on the hand-built vocab and corpus of
``tests/test_tokenizer_assets.py`` and on the committed asset
``tests/assets/tiny_spm_bpe.model`` with its pinned encodings, and the
byte-level BPE over a ``tokenizer.json`` written here. Ids and text must
be equal.
"""

import json
from pathlib import Path

import pytest

from llm_inference_engine_tpu.tokenizer import load_tokenizer as j_load
from llm_inference_engine_tpu.tokenizer.bpe import (
    _load_sentencepiece_model as j_load_spm)
from llm_inference_engine_tpu.tokenizer.native import wrap_native as j_wrap

from llm_inference_engine_tpu_torch import native
from llm_inference_engine_tpu_torch.tokenizer import (
    BPETokenizer, ByteLevelBPETokenizer, load_tokenizer)
from llm_inference_engine_tpu_torch.tokenizer.bpe import (
    _load_flm_binary, _load_sentencepiece_model)
from llm_inference_engine_tpu_torch.tokenizer.bytelevel import (
    _bytes_to_unicode, is_bytelevel_tokenizer_json)
from llm_inference_engine_tpu_torch.tokenizer.native import (
    NativeBPETokenizer, wrap_native)
from test_tokenizer_assets import (
    CORPUS, _write_flm, _write_spm_proto, build_realistic_vocab)

ASSETS = Path(__file__).resolve().parent / "assets"
SPM = ASSETS / "tiny_spm_bpe.model"
BYTELEVEL_SAMPLES = CORPUS + [
    "def f(x):\n    return x ** 2  # comment\n",
    "don't can't won't it's we're I'll they'd",
    "   leading and trailing   ",
    "ÿþý edge \x00 bytes",
    "<|endoftext|>split around a special<|endoftext|>",
]
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def _same_stream(mine, theirs, ids):
    """decode and decode_incremental equal, token by token."""
    assert mine.decode(ids) == theirs.decode(ids)
    prev = []
    for i in ids:
        assert mine.decode_incremental(prev, i) == \
            theirs.decode_incremental(prev, i)
        prev.append(i)


@pytest.mark.parametrize("use_native", [True, False])
def test_spm_asset_matches_jax_and_its_pinned_ids(use_native):
    want = json.loads((ASSETS / "tiny_spm_bpe.expected.json").read_text())
    mine = load_tokenizer(str(SPM), native=use_native)
    theirs = j_load(str(SPM), native=use_native)
    assert isinstance(mine, NativeBPETokenizer if use_native
                      else BPETokenizer)
    assert (mine.bos_id, mine.eos_id, mine.vocab_size) == \
        (theirs.bos_id, theirs.eos_id, theirs.vocab_size)
    for text, ids in want.items():
        got = mine.encode(text, add_bos=False)
        assert got == ids == theirs.encode(text, add_bos=False), text
        assert mine.encode(text) == theirs.encode(text)   # with bos
        _same_stream(mine, theirs, got)


def test_handbuilt_vocab_every_loader_matches_jax(tmp_path):
    """The hand-serialized ModelProto and the reference's flm binary vocab,
    through the port's Python and native encoders, against the JAX
    package's Python encoder, on the asset test's corpus."""
    pieces = build_realistic_vocab()
    proto, flm = tmp_path / "tokenizer.model", tmp_path / "tokenizer.bin"
    _write_spm_proto(proto, pieces)
    _write_flm(flm, pieces)
    ref = j_load_spm(str(proto))
    py = _load_sentencepiece_model(str(proto))
    encoders = [py, _load_flm_binary(str(flm)), wrap_native(py)]
    assert isinstance(encoders[-1], NativeBPETokenizer)
    for text in CORPUS:
        want = ref.encode(text, add_bos=False, add_eos=True)
        for tok in encoders:
            assert tok.encode(text, add_bos=False, add_eos=True) == want
            _same_stream(tok, ref, want)


def test_native_and_python_encoders_agree_on_random_text(rng):
    """The port's C++ encoder against its Python one (and the JAX
    package's C++ encoder) on random strings over the asset's alphabet,
    emoji and byte-fallback characters included."""
    py = load_tokenizer(str(SPM), native=False)
    nat = wrap_native(py)
    j_nat = j_wrap(j_load_spm(str(SPM)))
    alphabet = list("abcdefghij klmnop .,!?th\t\n") + ["é", "☃", "🎉", "日"]
    for _ in range(40):
        text = "".join(rng.choice(alphabet, size=rng.integers(0, 40)))
        ids = py.encode(text)
        assert nat.encode(text) == ids == j_nat.encode(text), repr(text)
        assert nat.decode(ids) == py.decode(ids)


def test_native_tokenizer_is_refused_without_the_library(monkeypatch):
    py = load_tokenizer(str(SPM), native=False)
    monkeypatch.setattr("llm_inference_engine_tpu_torch.tokenizer.native."
                        "load_native", lambda: None)
    assert wrap_native(py) is py
    with pytest.raises(RuntimeError, match="native library"):
        NativeBPETokenizer({"a": (0, 0.0)})
    assert native.native_available()


def _train_bytelevel(texts, n_merges: int):
    """A tiny byte-level BPE (vocab and merges) learned greedily from
    ``texts``: the GPT-2 alphabet, then the most frequent adjacent pair of
    each round merged."""
    table = _bytes_to_unicode()
    vocab = {c: i for i, c in enumerate(table[b] for b in range(256))}
    words = [[table[b] for b in w.encode()] for t in texts
             for w in t.replace(" ", " \x01").split("\x01") if w]
    merges = []
    for _ in range(n_merges):
        counts: dict = {}
        for w in words:
            for pair in zip(w, w[1:]):
                counts[pair] = counts.get(pair, 0) + 1
        if not counts:
            break
        best = max(sorted(counts), key=counts.get)
        merges.append(" ".join(best))
        vocab.setdefault("".join(best), len(vocab))
        for w in words:
            i = 0
            while i < len(w) - 1:
                if (w[i], w[i + 1]) == best:
                    w[i:i + 2] = ["".join(best)]
                i += 1
    return vocab, merges


@pytest.mark.parametrize("flavor", ["gpt2", "llama3"])
def test_bytelevel_tokenizer_json_matches_jax(tmp_path, flavor):
    vocab, merges = _train_bytelevel(CORPUS * 3, 80)
    added = [{"id": len(vocab), "content": "<|endoftext|>", "special": True},
             {"id": len(vocab) + 1, "content": "<|begin_of_text|>",
              "special": True}]
    pre = {"type": "ByteLevel", "add_prefix_space": False}
    if flavor == "llama3":
        pre = {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated"}, pre]}
    spec = {"model": {"type": "BPE", "vocab": vocab, "merges": merges},
            "pre_tokenizer": pre, "added_tokens": added}
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec), encoding="utf-8")
    assert is_bytelevel_tokenizer_json(str(path))
    mine, theirs = load_tokenizer(str(tmp_path)), j_load(str(tmp_path))
    assert isinstance(mine, ByteLevelBPETokenizer)
    assert (mine.bos_id, mine.eos_id) == (theirs.bos_id, theirs.eos_id) \
        == (len(vocab) + 1, len(vocab))
    for text in BYTELEVEL_SAMPLES:
        for bos in (False, True):
            ids = mine.encode(text, add_bos=bos)
            assert ids == theirs.encode(text, add_bos=bos), text
        assert mine.decode(ids) == theirs.decode(ids)
        _same_stream(mine, theirs, ids)
    # merges were learned: common words take fewer tokens than bytes
    assert len(mine.encode("the cat sat on the mat", add_bos=False)) < 22

"""The PyTorch port's chat path against the JAX package, on the CPU: the
slot layout's ``PrefixStore`` (snapshot and restore of cache rows),
``ChatSession`` over a checkpoint directory and the committed
SentencePiece asset, the chat CLI in-process, and the server's
``--tokenizer``.

The JAX side runs its XLA path on the ``debug`` preset in f32, with the
same weights: crossed over through ``params_from_numpy``, or read by both
packages from one checkpoint directory written here. Ids and text must be
equal; a restore must be an exact byte copy.
"""

import io
import json
import threading

import jax
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu import cli as j_cli
from llm_inference_engine_tpu import server as j_server
from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models import registry as j_registry
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)
from llm_inference_engine_tpu.runtime.prefix_cache import (
    PrefixStore as JPrefixStore)
from llm_inference_engine_tpu.runtime.scheduler import (
    ContinuousBatchingScheduler as JScheduler)
from llm_inference_engine_tpu.runtime.session import (
    ChatSession as JChatSession)
from llm_inference_engine_tpu.tokenizer import load_tokenizer as j_load_tok

from llm_inference_engine_tpu_torch import cli
from llm_inference_engine_tpu_torch import server as port_server
from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models.registry import create_engine
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.runtime import prefix_cache
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)
from llm_inference_engine_tpu_torch.runtime.session import ChatSession
from llm_inference_engine_tpu_torch.tokenizer import load_tokenizer
from test_torch_checkpoint import _hf_tensors, _write_hf

SPM = "tests/assets/tiny_spm_bpe.model"
PREFIX = list(range(5, 21))          # 16 tokens == one chunk at C=16
TAILS = [[40, 41], [50, 51, 52, 53], [60]]
QUESTIONS = ["hello world", "the cat sat on the mat", "and then?"]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jp = j_init_dummy_params(j_get_config("debug"), seed=0)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _engines(weights, batch=2, seq=96, **kw):
    """A JAX and a port engine over the same debug weights."""
    kw = dict(max_batch_size=batch, max_seq_len=seq, max_prefill_len=16,
              **kw)
    je = JInferenceEngine(j_get_config("debug"),
                          JEngineConfig(kernels="xla", **kw), weights[0])
    te = InferenceEngine(get_config("debug"), EngineConfig(**kw), weights[1])
    return je, te


# ---------------------------------------------------------------------------
# the slot layout's PrefixStore
# ---------------------------------------------------------------------------

def _rows(cache, slot, n):
    rows = [cache.k[:, slot, :n], cache.v[:, slot, :n]]
    if cache.k_scale is not None:
        rows += [cache.k_scale[:, slot, :n], cache.v_scale[:, slot, :n]]
    return [r.clone() for r in rows]


@pytest.mark.parametrize("kv", ["", "int8"])
def test_restore_then_tail_matches_full_prefill(weights, kv):
    """restore + tail prefill == full prefill bit for bit (chunk-aligned
    prefix), the JAX package's logits to f32 precision, and the restore is
    an exact copy written into the live cache tensors."""
    je, full = _engines(weights, kv_cache_dtype_name=kv)
    want = full.prefill([PREFIX + TAILS[0]], slots=[0])
    j_want = np.asarray(je.prefill([PREFIX + TAILS[0]], slots=[0]))
    _, eng = _engines(weights, kv_cache_dtype_name=kv)
    store = prefix_cache.PrefixStore(eng)
    entry = store.register(PREFIX, slot=1)
    assert entry.length == len(PREFIX) and entry.padded_length == 64
    assert entry.snapped == eng.cache.snapped
    assert int(eng.cache.lengths[1]) == eng._lengths[1] == 0
    ptrs = [t.data_ptr() for t in (eng.cache.k, eng.cache.v,
                                   eng.cache.lengths)]
    assert store.restore(0, entry) == len(PREFIX)
    assert [t.data_ptr() for t in (eng.cache.k, eng.cache.v,
                                   eng.cache.lengths)] == ptrs
    assert int(eng.cache.lengths[0]) == eng._lengths[0] == len(PREFIX)
    snap = [entry.k, entry.v] + ([entry.k_scale, entry.v_scale]
                                 if kv else [])
    for got, rows in zip(_rows(eng.cache, 0, 64), snap):
        assert torch.equal(got, rows)
    got = eng.prefill([TAILS[0]], slots=[0])
    assert torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[0].numpy(), j_want[0], atol=1e-4,
                               rtol=1e-4)


def test_snapshot_is_a_copy_not_a_view(weights):
    """The slot is overwritten after its snapshot: the entry keeps the
    prefix's rows, and restoring it brings them back."""
    _, eng = _engines(weights)
    store = prefix_cache.PrefixStore(eng)
    eng.prefill([PREFIX], slots=[0])
    before = _rows(eng.cache, 0, 64)
    entry = store.register(PREFIX, slot=0)
    eng.prefill([[90 + i for i in range(30)]], slots=[0])   # overwrite
    assert not torch.equal(eng.cache.k[:, 0, :16], before[0][:, :16])
    assert torch.equal(entry.k[:, :16], before[0][:, :16])
    assert torch.equal(entry.v[:, :16], before[1][:, :16])
    eng.reset([0])
    store.restore(0, entry)
    assert torch.equal(eng.cache.k[:, 0, :16], before[0][:, :16])


def test_restore_into_any_slot(weights):
    _, eng = _engines(weights, batch=3)
    store = prefix_cache.PrefixStore(eng)
    entry = store.register(PREFIX, slot=0)
    for slot in (2, 1, 0):
        store.restore(slot, entry)
        assert int(eng.cache.lengths[slot]) == eng._lengths[slot] \
            == len(PREFIX)
        assert torch.equal(eng.cache.k[:, slot, :64], entry.k)


def test_match_longest_strict_and_lru_eviction(weights):
    """The JAX package's store and the port's, fed the same sequence of
    registrations and matches, keep the same entries."""
    je, te = _engines(weights)
    stores = [JPrefixStore(je, max_tokens=192),
              prefix_cache.PrefixStore(te, max_tokens=192)]
    short = PREFIX[:8]
    for store in stores:
        store.register(short, slot=0)
        long_e = store.register(PREFIX, slot=0)
        assert store.match(PREFIX + [99]) is long_e
        assert store.match(PREFIX).length == len(short)   # strict
        assert store.match([1, 2, 3]) is None
        store.match(list(short) + [7])                    # refresh short
        store.register([70, 71, 72], slot=0)
        store.register([80, 81, 82], slot=0)              # evicts PREFIX
        assert store.match(PREFIX + [99]).length == len(short)
        with pytest.raises(ValueError):
            store.register([], slot=0)
        with pytest.raises(ValueError):
            store.register(list(range(200)), slot=0)
    assert list(stores[0]._entries) == list(stores[1]._entries)
    assert stores[0].stored_tokens == stores[1].stored_tokens == 192


def _run_sched(weights, prompts, sp, prefix=None, **kw):
    je, te = _engines(weights, **kw)
    out = []
    for sched, spc in ((JScheduler(je, eos_token_id=None), JSamplingParams),
                       (ContinuousBatchingScheduler(te, eos_token_id=None),
                        SamplingParams)):
        if prefix is not None:
            sched.register_prefix(prefix)
        reqs = [sched.submit(p, spc(**sp)) for p in prompts]
        sched.run()
        out.append(reqs)
    return out


@pytest.mark.parametrize("case", ["aligned", "int8", "unaligned",
                                  "repetition"])
def test_scheduler_prefix_reuse_token_parity(weights, case):
    """Requests sharing a registered prefix give the tokens of a run
    without it, and the JAX package's tokens, in every variant of the JAX
    package's prefix-cache tests."""
    prefix, kw = PREFIX, {}
    sp = dict(greedy=True, max_new_tokens=6)
    prompts = [PREFIX + t for t in TAILS] + [[3, 1, 4, 1, 5]]
    if case == "int8":
        kw = dict(kv_cache_dtype_name="int8")
        prompts = prompts[:2]
    elif case == "unaligned":
        prefix = list(range(5, 24))                # 19 tokens, C = 16
        prompts = [prefix + [40, 41, 42]]
    elif case == "repetition":
        sp.update(max_new_tokens=8, repetition_penalty=1.5)
        prompts = prompts[:2]
    j_base, t_base = _run_sched(weights, prompts, sp, **kw)
    j_reused, t_reused = _run_sched(weights, prompts, sp, prefix, **kw)
    ids = [r.output_ids for r in t_reused]
    assert ids == [r.output_ids for r in t_base]
    assert ids == [r.output_ids for r in j_reused]
    assert ids == [r.output_ids for r in j_base]
    reused = [r.reused_prefix_len for r in t_reused]
    assert reused == [r.reused_prefix_len for r in j_reused]
    assert reused[0] == len(prefix)
    assert all(r.reused_prefix_len == 0 for r in t_base)


def test_slot_store_refuses_a_paged_engine_or_another_cache(weights):
    _, paged = _engines(weights, kv_layout="paged", page_size=16)
    with pytest.raises(NotImplementedError, match="slot KV layout"):
        prefix_cache.PrefixStore(paged)
    _, eng = _engines(weights)
    entry = prefix_cache.PrefixStore(eng).register(PREFIX, slot=0)
    _, eng8 = _engines(weights, kv_cache_dtype_name="int8")
    with pytest.raises(ValueError, match="does not match"):
        prefix_cache.restore_prefix(eng8.cache, 0, entry)


# ---------------------------------------------------------------------------
# ChatSession, the CLI and the server over a checkpoint directory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chat_ckpt(tmp_path_factory):
    """An HF-format checkpoint of a debug-width model whose vocabulary
    covers the SentencePiece asset's 493 pieces, with its config.json
    (the path names llama2, so the CLI's template is llama2's)."""
    cfg = j_get_config("debug").replace(vocab_size=512)
    path = tmp_path_factory.mktemp("ckpt") / "llama2-tiny"
    _write_hf(path, _hf_tensors(cfg, np.random.default_rng(3),
                                torch.float32))
    conf = {f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "rope_theta",
        "max_position_embeddings", "dtype_name")}
    (path / "config.json").write_text(json.dumps(conf))
    return path


def _chat(session, sampling, rounds=QUESTIONS):
    """Each round's text, its streamed chunks with their indexes, and the
    session's ids."""
    out = []
    for q in rounds:
        chunks = []
        text = session.response(q, sampling,
                                lambda i, c: chunks.append((i, c)))
        out.append((text, chunks))
    return out, session.token_history


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_chat_session_matches_jax_over_three_rounds(chat_ckpt, layout):
    kw = dict(max_batch_size=2, max_seq_len=160, max_prefill_len=16)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=16)
    model = str(chat_ckpt / "config.json")
    je = j_registry.create_engine(model, str(chat_ckpt),
                                  JEngineConfig(kernels="xla", **kw))
    te = create_engine(model, str(chat_ckpt), EngineConfig(**kw),
                       device="cpu")
    sp = dict(greedy=True, max_new_tokens=7)
    js = JChatSession(je, j_load_tok(SPM), system_prompt="be brief",
                      template="llama2")
    ts = ChatSession(te, load_tokenizer(SPM), system_prompt="be brief",
                     template="llama2")
    want, j_hist = _chat(js, JSamplingParams(**sp))
    got, t_hist = _chat(ts, SamplingParams(**sp))
    assert got == want and t_hist == j_hist
    for text, chunks in got:              # index protocol: 0, 1, .., -1
        assert [i for i, _ in chunks] == list(range(len(chunks) - 1)) + [-1]
        assert "".join(c for _, c in chunks) == text
    assert te._lengths[0] == je.cache.lengths[0] == int(te.cache.lengths[0])
    if layout == "slot":
        # only each new turn is prefilled: the slot holds the history less
        # the final token of every later round that ended by length (the
        # mirrored top-up fires in a slot's first round only)
        by_length = [len(chunks) - 1 == sp["max_new_tokens"]
                     for _, chunks in got]
        assert te._lengths[0] == len(t_hist) - sum(by_length[1:])
    ts.reset()
    assert ts.token_history == [] and te._lengths[0] == 0
    # ported: a beam-search round (its text and the history re-prefilled
    # into the slot) equal to the JAX session's
    js.reset()
    beam = dict(num_beams=2, max_new_tokens=5)
    want = js.response_beam(QUESTIONS[0], **beam)
    got = ts.response_beam(QUESTIONS[0], **beam)
    assert got == want and ts.token_history == js.token_history
    assert te._lengths[0] == je.cache.lengths[0] == len(ts.token_history)


def _repl(main, argv, stdin, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    assert main(argv) == 0
    return capsys.readouterr().out


def test_cli_repl_matches_jax(chat_ckpt, monkeypatch, capsys):
    """``cli.main`` in-process with stdin replaced: the same streamed
    replies as the JAX CLI, over the checkpoint and the SPM asset."""
    argv = ["--model", str(chat_ckpt / "config.json"), "--checkpoint",
            str(chat_ckpt), "--tokenizer", SPM, "--greedy",
            "--max-new-tokens", "6", "--max-seq-len", "128"]
    stdin = f"{QUESTIONS[0]}\n{QUESTIONS[1]}\n/reset\n\n{QUESTIONS[2]}\ns\n"
    got = _repl(cli.main, argv + ["--device", "cpu"], stdin, monkeypatch,
                capsys)
    want = _repl(j_cli.main, argv, stdin, monkeypatch, capsys)
    tail = got.split("ready.", 1)[1]
    assert tail == want.split("ready.", 1)[1]
    assert tail.count("please input the question: :") == 3
    assert "(history cleared)" in tail


def test_cli_dummy_mode_and_refusals(chat_ckpt, monkeypatch, capsys):
    out = _repl(cli.main, ["--model", "debug", "--dummy-weights", "--greedy",
                           "--max-new-tokens", "3", "--max-seq-len", "64",
                           "--device", "cpu"], "7 11 13\n", monkeypatch,
                capsys)
    reply = out.split("please input the question: ")[1]
    assert reply.startswith(":") and len(reply[1:].split()) == 3
    # --tp 2 on the CPU: a mesh of two CPU ranks, the one-rank reply
    out_tp = _repl(cli.main, ["--model", "debug", "--dummy-weights",
                              "--greedy", "--max-new-tokens", "3",
                              "--max-seq-len", "64", "--device", "cpu",
                              "--tp", "2"], "7 11 13\n", monkeypatch, capsys)
    assert out_tp.split("please input the question: ")[1] == reply
    for argv, err, match in (
            (["--tp", "2"], RuntimeError, "no CUDA device"),
            (["--dummy-weights", "--device", "cuda"], RuntimeError,
             "no CUDA device")):
        if err is RuntimeError and torch.cuda.is_available():
            continue
        with pytest.raises(err, match=match):
            cli.main(["--model", "debug", *argv])
    assert cli.main(["--model", "debug", "--device", "cpu"]) == 2
    # ported: --beams 2 answers each turn by beam search, the JAX CLI's
    # text over the checkpoint and the SPM asset
    argv = ["--model", str(chat_ckpt / "config.json"), "--checkpoint",
            str(chat_ckpt), "--tokenizer", SPM, "--beams", "2",
            "--max-new-tokens", "5", "--max-seq-len", "128"]
    stdin = f"{QUESTIONS[0]}\n{QUESTIONS[1]}\ns\n"
    got = _repl(cli.main, argv + ["--device", "cpu"], stdin, monkeypatch,
                capsys)
    want = _repl(j_cli.main, argv, stdin, monkeypatch, capsys)
    tail = got.split("ready.", 1)[1]
    assert tail == want.split("ready.", 1)[1]
    assert tail.count("please input the question: :") == 2


def test_cli_over_an_npz_without_a_tokenizer_speaks_ids(tmp_path,
                                                        monkeypatch, capsys):
    """A ``.npz`` with no ``--tokenizer``: the REPL reads and answers token
    ids (the id tokenizer and the plain template), as with dummy weights."""
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_params, save_params)
    npz = tmp_path / "debug.npz"
    save_params(init_dummy_params(get_config("debug"), seed=0), str(npz))
    out = _repl(cli.main, ["--model", "debug", "--checkpoint", str(npz),
                           "--greedy", "--max-new-tokens", "3",
                           "--max-seq-len", "64", "--device", "cpu"],
                "7 11 13\n", monkeypatch, capsys)
    reply = out.split("please input the question: ")[1]
    assert reply.startswith(":") and len(reply[1:].split()) == 3
    assert all(t.isdigit() for t in reply[1:].split())


def _serve_once(module, monkeypatch, argv, body):
    """Run ``module.main(argv)``; its server answers one completion and
    stops as on Ctrl-C. Returns the response."""
    made = {}
    real = module.make_server

    def make_server(sched, *a, **kw):
        httpd, llm = real(sched, *a, **kw)

        def serve_forever():
            threading.Thread(target=type(httpd).serve_forever, args=(httpd,),
                             daemon=True).start()
            import urllib.request
            req = urllib.request.Request(
                "http://%s:%d/v1/completions" % httpd.server_address,
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                made["out"] = json.loads(resp.read())
            httpd.shutdown()
            raise KeyboardInterrupt
        httpd.serve_forever = serve_forever
        return httpd, llm
    monkeypatch.setattr(module, "make_server", make_server)
    assert module.main(argv) == 0
    return made["out"]


def test_server_tokenizer_answers_like_jax(chat_ckpt, monkeypatch):
    argv = ["--model", str(chat_ckpt / "config.json"), "--checkpoint",
            str(chat_ckpt), "--tokenizer", SPM, "--max-batch-size", "2",
            "--max-seq-len", "128", "--port", "0"]
    body = {"prompt": "the cat sat on the mat", "max_tokens": 8,
            "temperature": 0.0}
    got = _serve_once(port_server, monkeypatch, argv + ["--device", "cpu"],
                      body)
    want = _serve_once(j_server, monkeypatch, argv, body)
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"]
    assert got["usage"]["prompt_tokens"] == len(
        load_tokenizer(SPM).encode(body["prompt"]))

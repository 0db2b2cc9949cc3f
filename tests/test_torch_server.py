"""The port's OpenAI-compatible HTTP server (``server.py``) over its
continuous-batching scheduler and a paged engine, on the CPU.

A real ThreadingHTTPServer on an ephemeral 127.0.0.1 port, the engine
thread over a debug-preset paged engine (f32, pages of 16, the automatic
prefix cache on), and clients speaking HTTP (http.client). The same
routes, JSON shapes, streaming, ``n``, logprobs, stop strings, 429
backpressure and ``/metrics`` as the JAX package's server; greedy
completions are held against the JAX server on the same weights.
"""

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.cli import _IdTokenizer as JIdTokenizer
from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.runtime.chat_template import (
    get_chat_template as j_get_chat_template)
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)
from llm_inference_engine_tpu.runtime.scheduler import (
    ContinuousBatchingScheduler as JScheduler)
from llm_inference_engine_tpu.server import make_server as j_make_server

from llm_inference_engine_tpu_torch import server as port_server
from llm_inference_engine_tpu_torch.cli import _IdTokenizer
from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.runtime.chat_template import (
    get_chat_template)
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)

CFG = get_config("debug")
KW = dict(max_batch_size=2, max_seq_len=64, max_prefill_len=8,
          kv_layout="paged", page_size=16)


@pytest.fixture(scope="module")
def weights():
    jp = j_init_dummy_params(j_get_config("debug"), seed=0)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _serve(httpd, llm):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    llm.start()
    return httpd, llm


def _port_server(weights, max_queue=0, **kw):
    torch.set_num_threads(2)
    eng = InferenceEngine(CFG, EngineConfig(**{**KW, **kw}), weights[1],
                          device="cpu")
    sched = ContinuousBatchingScheduler(eng, eos_token_id=None,
                                        auto_prefix_cache=True)
    return _serve(*port_server.make_server(
        sched, _IdTokenizer(CFG.vocab_size), get_chat_template("plain"),
        "debug", host="127.0.0.1", port=0, max_queue=max_queue))


def _stop(pair):
    httpd, llm = pair
    httpd.shutdown()
    httpd.server_close()
    llm.shutdown()


@pytest.fixture(scope="module")
def server(weights):
    pair = _port_server(weights)
    yield pair[0].server_address
    _stop(pair)


def _post(addr, path, body):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp


def _completion(addr, **kw):
    body = {"prompt": "5 9 2", "max_tokens": 6, "temperature": 0.0, **kw}
    status, resp = _post(addr, "/v1/completions", body)
    assert status == 200
    return json.loads(resp.read())


def _sse(resp):
    """The JSON payloads of an SSE response, None for [DONE]."""
    events = []
    for line in resp.read().decode().split("\n"):
        if line.startswith("data: "):
            payload = line[len("data: "):]
            events.append(None if payload == "[DONE]"
                          else json.loads(payload))
    return events


def test_health_models_and_404(server):
    conn = http.client.HTTPConnection(*server, timeout=60)
    conn.request("GET", "/health")
    assert json.loads(conn.getresponse().read())["status"] == "ok"
    conn.request("GET", "/v1/models")
    assert json.loads(conn.getresponse().read())["data"][0]["id"] == "debug"
    conn.request("GET", "/nope")
    resp = conn.getresponse()
    resp.read()
    assert resp.status == 404


def test_completion_shape_and_usage(server):
    out = _completion(server)
    assert out["object"] == "text_completion"
    choice = out["choices"][0]
    assert choice["finish_reason"] == "length"
    assert len(choice["text"].split()) == out["usage"]["completion_tokens"]
    assert out["usage"]["prompt_tokens"] == 4           # bos + 3 ids
    assert out["usage"]["total_tokens"] == 4 + 6


def test_stream_matches_nonstream(server):
    full = _completion(server)["choices"][0]["text"]
    status, resp = _post(server, "/v1/completions",
                         {"prompt": "5 9 2", "max_tokens": 6,
                          "temperature": 0.0, "stream": True})
    assert status == 200
    assert resp.getheader("Content-Type").startswith("text/event-stream")
    events = _sse(resp)
    assert events[-1] is None
    texts = [e["choices"][0]["text"] for e in events[:-1]
             if e["choices"][0]["finish_reason"] is None]
    assert "".join(texts) == full
    assert events[-2]["choices"][0]["finish_reason"] == "length"


def test_chat_completion(server):
    status, resp = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "system", "content": "1 2"},
                     {"role": "user", "content": "7 11"}],
        "max_tokens": 5, "temperature": 0.0})
    assert status == 200
    out = json.loads(resp.read())
    assert out["object"] == "chat.completion"
    msg = out["choices"][0]["message"]
    assert msg["role"] == "assistant" and len(msg["content"].split()) == 5
    assert out["usage"]["prompt_tokens"] == 4       # "1 27 11": bos + 3
    status, resp = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "alien", "content": "x"}]})
    assert status == 400 and "error" in json.loads(resp.read())


def test_concurrent_requests_multiplex(server):
    """Six requests on two slots: all served through the one scheduler,
    and each equals the same request served alone."""
    prompts = [f"{3 + i} {5 + i} " + " ".join(str(7 + j) for j in range(9 * i))
               for i in range(6)]
    results = [None] * len(prompts)

    def go(i):
        results[i] = _completion(server, prompt=prompts[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i, r in enumerate(results):
        assert r["usage"]["completion_tokens"] == 6
        alone = _completion(server, prompt=prompts[i])
        assert alone["choices"][0]["text"] == r["choices"][0]["text"]


def test_n_completions(server):
    status, resp = _post(server, "/v1/completions", {
        "prompt": "5 9 2", "max_tokens": 4, "temperature": 0.0, "n": 3})
    assert status == 200
    out = json.loads(resp.read())
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    assert len({c["text"] for c in out["choices"]}) == 1   # greedy
    assert out["usage"]["completion_tokens"] == 12
    for bad in ({"n": 2, "stream": True}, {"n": "abc"}, {"n": 17}):
        status, resp = _post(server, "/v1/completions",
                             {"prompt": "5 9", "max_tokens": 2, **bad})
        resp.read()
        assert status == 400


def test_logprobs_returned(server):
    out = _completion(server, max_tokens=4, logprobs=1)
    lp = out["choices"][0]["logprobs"]
    assert len(lp["tokens"]) == 4 and len(lp["token_logprobs"]) == 4
    assert all(v <= 0.0 and np.isfinite(v) for v in lp["token_logprobs"])
    assert "".join(lp["tokens"]) == out["choices"][0]["text"]
    status, resp = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "7 11"}],
        "max_tokens": 3, "temperature": 0.0, "logprobs": True})
    content = json.loads(resp.read())["choices"][0]["logprobs"]["content"]
    assert len(content) == 3 and all(c["logprob"] <= 0.0 for c in content)


def test_stop_strings_trim_and_cancel(server):
    full = _completion(server, max_tokens=6)["choices"][0]["text"]
    stop = " " + full.split()[2] + " "
    out = _completion(server, max_tokens=6, stop=[stop], logprobs=1)
    choice = out["choices"][0]
    assert choice["text"] == full[:full.index(stop)]
    assert choice["finish_reason"] == "stop"
    assert "".join(choice["logprobs"]["tokens"]) == choice["text"]
    status, resp = _post(server, "/v1/completions",
                         {"prompt": "5 9 2", "max_tokens": 6,
                          "temperature": 0.0, "stream": True, "stop": stop})
    assert status == 200
    streamed = "".join(e["choices"][0].get("text", "")
                       for e in _sse(resp) if e is not None)
    assert streamed == choice["text"]


def test_context_length_400(server):
    status, resp = _post(server, "/v1/completions",
                         {"prompt": [7] * 64, "max_tokens": 2})
    assert status == 400
    assert json.loads(resp.read())["error"]["type"] == \
        "context_length_exceeded"


def test_metrics_report_pages_and_prefix_cache(server):
    _completion(server, max_tokens=3)
    conn = http.client.HTTPConnection(*server, timeout=60)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    assert resp.status == 200
    text = resp.read().decode()
    lines = dict(line.split(" ", 1) for line in text.strip().splitlines()
                 if not line.startswith("#"))
    assert int(lines["llm_requests_completed_total"]) >= 1
    assert int(lines["llm_batch_slots"]) == 2
    assert int(lines["llm_kv_pages_total"]) == 2 * 4
    assert 0 <= int(lines["llm_kv_pages_free"]) <= 8
    assert "llm_prefix_cache_pages" in lines


def test_backpressure_429(weights):
    """A max_queue=1 server answers a second concurrent request with 429
    while the first is in flight, and an oversized n with 429 at once."""
    pair = _port_server(weights, max_queue=1, max_batch_size=1)
    try:
        addr = pair[0].server_address
        codes = [None, None]

        def go(i, n):
            status, resp = _post(addr, "/v1/completions",
                                 {"prompt": "5 9", "max_tokens": n,
                                  "temperature": 0.0})
            resp.read()
            codes[i] = status

        t1 = threading.Thread(target=go, args=(0, 40))
        t1.start()
        deadline = time.time() + 60
        while pair[1]._inflight == 0 and time.time() < deadline:
            time.sleep(0.01)
        go(1, 2)
        t1.join(timeout=300)
        assert codes == [200, 429]
        status, resp = _post(addr, "/v1/completions",
                             {"prompt": "5", "max_tokens": 2, "n": 4})
        resp.read()
        assert status == 429
        assert _completion(addr, max_tokens=2)["usage"][
            "completion_tokens"] == 2                  # not wedged
    finally:
        _stop(pair)


def test_engine_failure_answers_500_at_once(weights, monkeypatch):
    """A step that raises kills the engine thread: the waiting request
    gets a 500 within seconds (not its 600 s timeout), streaming too, and
    /health turns 503."""
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    pair = _port_server(weights)
    try:
        addr = pair[0].server_address

        def broken_step():
            raise RuntimeError("card lost")
        pair[1].scheduler.step = broken_step
        t0 = time.monotonic()
        status, resp = _post(addr, "/v1/completions",
                             {"prompt": "5 9", "max_tokens": 2})
        assert status == 500
        assert "card lost" in json.loads(resp.read())["error"]["message"]
        status, resp = _post(addr, "/v1/completions",
                             {"prompt": "5 9", "max_tokens": 2,
                              "stream": True})
        resp.read()
        assert status == 500 and time.monotonic() - t0 < 30
        conn = http.client.HTTPConnection(*addr, timeout=60)
        conn.request("GET", "/health")
        resp = conn.getresponse()
        assert resp.status == 503
        assert json.loads(resp.read())["status"] == "failed"
    finally:
        _stop(pair)


_PROMPTS = {"short": "5 9 2",
            "chunked": " ".join(str(i) for i in range(3, 40))}


# each prompt over the bf16 pool and over the int8 pool
@pytest.mark.parametrize("prompt,kv", [
    *[pytest.param(p, "", id=name) for name, p in _PROMPTS.items()],
    *[pytest.param(p, "int8", id=f"{name}-int8")
      for name, p in _PROMPTS.items()]])
def test_greedy_completion_matches_jax_server(weights, prompt, kv):
    """The same request to the JAX server and to the port's, both over a
    paged engine with the same weights: identical greedy tokens, usage and
    finish reason (the second prompt prefills in five chunks)."""
    je = JInferenceEngine(j_get_config("debug"),
                          JEngineConfig(kernels="xla", kv_cache_dtype_name=kv,
                                        **KW), weights[0])
    jpair = _serve(*j_make_server(
        JScheduler(je, eos_token_id=None, auto_prefix_cache=True),
        JIdTokenizer(CFG.vocab_size), j_get_chat_template("plain"), "debug",
        host="127.0.0.1", port=0))
    tpair = _port_server(weights, kv_cache_dtype_name=kv)
    try:
        body = dict(prompt=prompt, max_tokens=12, logprobs=1)
        want = _completion(jpair[0].server_address, **body)
        got = _completion(tpair[0].server_address, **body)
        assert got["choices"][0]["text"] == want["choices"][0]["text"]
        assert got["usage"] == want["usage"]
        assert got["choices"][0]["finish_reason"] == \
            want["choices"][0]["finish_reason"]
        np.testing.assert_allclose(
            got["choices"][0]["logprobs"]["token_logprobs"],
            want["choices"][0]["logprobs"]["token_logprobs"], atol=1e-4)
    finally:
        _stop(jpair)
        _stop(tpair)


def test_main_refuses_what_is_not_ported_and_a_missing_card(capsys):
    for argv, err, match in (
            (["--dummy-weights", "--device", "cuda"], RuntimeError,
             "no CUDA device"),):
        if err is RuntimeError and torch.cuda.is_available():
            continue
        with pytest.raises(err, match=match):
            port_server.main(["--model", "debug", *argv])
    assert port_server.main(["--model", "debug", "--device", "cpu"]) == 2
    # ported: --draft-model serves speculatively (test_torch_speculative.py)
    # over the slot layout, and refuses a paged one as the JAX server does
    assert port_server.main(["--model", "debug", "--dummy-weights",
                             "--device", "cpu", "--draft-model", "debug",
                             "--kv-layout", "paged"]) == 2
    assert "--draft-model requires --kv-layout slot" in \
        capsys.readouterr().err
    # ported: the int8 KV flag is no longer refused before the weights
    assert port_server.main(["--model", "debug", "--device", "cpu",
                             "--kv-cache-dtype", "int8"]) == 2


def test_main_serves_an_int8_kv_engine(monkeypatch):
    """``--kv-cache-dtype int8`` reaches the engine: ``main`` builds an
    int8 pool, and its server answers a completion before it stops as on
    Ctrl-C."""
    made = {}
    real = port_server.make_server

    def make_server(sched, *a, **kw):
        httpd, llm = real(sched, *a, **kw)
        made["engine"] = sched.engine

        def serve_forever():
            threading.Thread(target=type(httpd).serve_forever, args=(httpd,),
                             daemon=True).start()
            made["out"] = _completion(httpd.server_address, max_tokens=4)
            httpd.shutdown()
            raise KeyboardInterrupt
        httpd.serve_forever = serve_forever
        return httpd, llm
    monkeypatch.setattr(port_server, "make_server", make_server)
    torch.set_num_threads(2)
    assert port_server.main([
        "--model", "debug", "--dummy-weights", "--device", "cpu",
        "--kv-cache-dtype", "int8", "--kv-layout", "paged",
        "--page-size", "16", "--max-batch-size", "2", "--max-seq-len", "64",
        "--port", "0"]) == 0
    cache = made["engine"].cache
    assert cache.quantized and cache.k.dtype == torch.int8
    assert made["out"]["usage"]["completion_tokens"] == 4


def test_main_serves_text_through_a_tokenizer(monkeypatch, tmp_path):
    """``--tokenizer`` is ported: ``main`` over dummy weights of a debug-width
    model whose vocabulary covers the SentencePiece asset answers a text
    completion, counting the prompt in the asset's tokens."""
    from llm_inference_engine_tpu_torch.tokenizer import load_tokenizer
    spm = "tests/assets/tiny_spm_bpe.model"
    conf = tmp_path / "config.json"
    conf.write_text(json.dumps({**{f: getattr(CFG, f) for f in (
        "hidden_size", "intermediate_size", "num_layers", "num_heads",
        "num_kv_heads", "head_dim", "dtype_name")}, "vocab_size": 512}))
    made = {}
    real = port_server.make_server

    def make_server(sched, tokenizer, *a, **kw):
        httpd, llm = real(sched, tokenizer, *a, **kw)
        made["tokenizer"] = tokenizer

        def serve_forever():
            threading.Thread(target=type(httpd).serve_forever, args=(httpd,),
                             daemon=True).start()
            made["out"] = _completion(httpd.server_address, max_tokens=4,
                                      prompt="the cat sat on the mat")
            httpd.shutdown()
            raise KeyboardInterrupt
        httpd.serve_forever = serve_forever
        return httpd, llm
    monkeypatch.setattr(port_server, "make_server", make_server)
    torch.set_num_threads(2)
    assert port_server.main([
        "--model", str(conf), "--dummy-weights", "--tokenizer", spm,
        "--device", "cpu", "--max-batch-size", "2", "--max-seq-len", "64",
        "--port", "0"]) == 0
    out, tok = made["out"], made["tokenizer"]
    assert type(tok).__name__ == "NativeBPETokenizer"
    assert out["usage"]["prompt_tokens"] == len(
        load_tokenizer(spm).encode("the cat sat on the mat"))
    assert out["usage"]["completion_tokens"] == 4
    assert isinstance(out["choices"][0]["text"], str)


def test_main_serves_ids_from_an_npz_without_a_tokenizer(weights, monkeypatch,
                                                         tmp_path):
    """A ``save_params`` ``.npz`` holds no tokenizer: with no
    ``--tokenizer``, ``main`` serves token ids as text through the id
    tokenizer (only a checkpoint directory lends its own tokenizer)."""
    from llm_inference_engine_tpu_torch.models.weights import save_params
    npz = tmp_path / "debug.npz"
    save_params(weights[1], str(npz))
    made = {}
    real = port_server.make_server

    def make_server(sched, tokenizer, *a, **kw):
        httpd, llm = real(sched, tokenizer, *a, **kw)
        made["tokenizer"] = tokenizer

        def serve_forever():
            threading.Thread(target=type(httpd).serve_forever, args=(httpd,),
                             daemon=True).start()
            made["out"] = _completion(httpd.server_address, max_tokens=3)
            httpd.shutdown()
            raise KeyboardInterrupt
        httpd.serve_forever = serve_forever
        return httpd, llm
    monkeypatch.setattr(port_server, "make_server", make_server)
    torch.set_num_threads(2)
    assert port_server.main([
        "--model", "debug", "--checkpoint", str(npz), "--device", "cpu",
        "--max-batch-size", "2", "--max-seq-len", "64", "--port", "0"]) == 0
    out = made["out"]
    assert isinstance(made["tokenizer"], _IdTokenizer)
    assert out["usage"]["prompt_tokens"] == 4          # bos + "5 9 2"
    assert out["usage"]["completion_tokens"] == 3
    assert all(t.isdigit() for t in out["choices"][0]["text"].split())

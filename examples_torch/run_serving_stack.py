"""Serving-stack driver: continuous batching over the slot cache and over
a paged KV pool, prefix caching, speculative rounds, cancellation, and
the HTTP server on localhost, all over dummy-weight engines. Every
scheduler's greedy tokens are held against a teacher-forced forward, and
on the CPU equal to the plain scheduler's.

    python -m examples_torch.run_serving_stack [--device cpu]
"""

import http.client
import json
import threading

from llm_inference_engine_tpu_torch import server
from llm_inference_engine_tpu_torch.cli import _IdTokenizer
from llm_inference_engine_tpu_torch.config import EngineConfig, SamplingParams
from llm_inference_engine_tpu_torch.models.weights import init_dummy_params
from llm_inference_engine_tpu_torch.runtime.chat_template import (
    get_chat_template)
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)
from llm_inference_engine_tpu_torch.runtime.speculative_scheduler import (
    SpeculativeScheduler)

from examples_torch._common import check_greedy, model_config, parse, report

SP = SamplingParams(greedy=True, max_new_tokens=6)
PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [4, 4, 5, 5], list(range(3, 25))]


def serve_once(scheduler, prompt, max_tokens: int) -> list:
    """The server over ``scheduler`` on 127.0.0.1 (a free port): one
    greedy completion of the pre-tokenized ``prompt``; its ids."""
    vocab = scheduler.engine.config.vocab_size
    httpd, llm = server.make_server(scheduler, _IdTokenizer(vocab),
                                    get_chat_template("plain"), "debug",
                                    host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    llm.start()
    try:
        conn = http.client.HTTPConnection(*httpd.server_address, timeout=300)
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": prompt, "max_tokens": max_tokens,
             "temperature": 0.0}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        if resp.status != 200:
            raise RuntimeError(f"server answered {resp.status}: {body}")
        return [int(t) for t in body["choices"][0]["text"].split()]
    finally:
        httpd.shutdown()
        httpd.server_close()
        llm.shutdown()
        thread.join(timeout=60)


def main(argv=None) -> None:
    dev = parse(argv, __doc__)
    cfg = model_config(dev)
    weights = {s: init_dummy_params(cfg, seed=s, device=dev) for s in (0, 1)}

    def engine(layout="slot", seed=0):
        return InferenceEngine(cfg, EngineConfig(
            max_batch_size=2, max_seq_len=64, max_prefill_len=8,
            kv_layout=layout, page_size=16), weights[seed])

    def outputs(reqs):
        return [r.output_ids for r in reqs]

    # 1. baseline: plain continuous batching
    plain = ContinuousBatchingScheduler(engine(), eos_token_id=None)
    want = [plain.submit(p, SP) for p in PROMPTS]
    plain.run()
    want = outputs(want)
    check_greedy("continuous batching (slot cache)", dev, cfg, weights[0],
                 PROMPTS, want)

    # 2. paged pool (memory bounded by tokens in flight), same tokens
    paged = ContinuousBatchingScheduler(engine("paged"), eos_token_id=None)
    got = [paged.submit(p, SP) for p in PROMPTS]
    paged.run(max_steps=1000)
    check_greedy(f"paged KV serving matches slot layout (pool free again: "
                 f"{paged.engine.free_pages} pages)", dev, cfg, weights[0],
                 PROMPTS, outputs(got), want)

    # 3. prefix caching: register a shared prefix, reuse across requests
    pref = ContinuousBatchingScheduler(engine(), eos_token_id=None)
    prefix = list(range(5, 21))
    pref.register_prefix(prefix)
    tails = [prefix + [40 + i] for i in range(3)]
    reqs = [pref.submit(p, SP) for p in tails]
    pref.run()
    base = ContinuousBatchingScheduler(engine(), eos_token_id=None)
    base_reqs = [base.submit(p, SP) for p in tails]
    base.run()
    check_greedy(f"prefix caching (reuse == recompute; each request "
                 f"skipped {reqs[0].reused_prefix_len} prefix tokens)", dev,
                 cfg, weights[0], tails, outputs(reqs), outputs(base_reqs))

    # 4. speculative serving: disagreeing draft, lossless tokens
    spec = SpeculativeScheduler(engine(), engine(seed=1), eos_token_id=None,
                                num_draft=3)
    sreqs = [spec.submit(p, SP) for p in PROMPTS]
    spec.run(max_steps=1000)
    check_greedy(f"speculative serving lossless vs plain (acceptance "
                 f"{spec.acceptance_rate:.0%}, {spec.num_accepted}/"
                 f"{spec.num_drafted} drafts accepted)", dev, cfg,
                 weights[0], PROMPTS, outputs(sreqs), want)

    # 5. cancellation + latency accounting
    canc = ContinuousBatchingScheduler(engine(), eos_token_id=None)
    a = canc.submit([1, 2, 3], SP)
    b = canc.submit([7, 7, 7], SP)
    canc.step()
    canc.cancel(b)
    canc.run()
    report("cancellation frees the slot; latency accounted",
           a.finished and b.finish_reason == "cancelled"
           and a.ttft is not None and a.e2e_latency >= a.ttft,
           f"a: ttft {a.ttft * 1e3:.0f} ms, e2e {a.e2e_latency * 1e3:.0f} ms")

    # 6. the HTTP server over a paged engine on localhost
    ids = serve_once(ContinuousBatchingScheduler(engine("paged"),
                                                 eos_token_id=None),
                     PROMPTS[0], SP.max_new_tokens)
    check_greedy("HTTP completion on 127.0.0.1 == the scheduler's tokens",
                 dev, cfg, weights[0], PROMPTS[:1], [ids], want[:1])


if __name__ == "__main__":
    main()

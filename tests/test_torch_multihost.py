"""The port's multi-host serving tier against the JAX package's.

In one process ``agree_step_plan`` reduces this process's row alone, so
``MultiHostScheduler`` completes the same work as the plain scheduler
(and as the JAX lockstep scheduler, id for id); ``RequestRouter`` spreads
requests over independent engines; ``aggregate_metrics`` gives the JAX
package's text, character for character, on the same expositions. Two
processes joined by ``initialize_multihost`` over gloo on localhost run
the lockstep with different arrival patterns and exit together, each
request's ids equal to an uncontended run's (the counterpart of
``tests/test_multihost_distributed.py``).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)
from llm_inference_engine_tpu.runtime.multihost_scheduler import (
    MultiHostScheduler as JMultiHostScheduler, RequestRouter as JRouter)
from llm_inference_engine_tpu.runtime.scheduler import (
    ContinuousBatchingScheduler as JScheduler)
from llm_inference_engine_tpu.server import (
    aggregate_metrics as j_aggregate_metrics)
from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.cli import _IdTokenizer
from llm_inference_engine_tpu_torch.models.weights import (
    init_dummy_params, params_from_numpy)
from llm_inference_engine_tpu_torch.parallel import (
    initialize_multihost, make_multihost_mesh)
from llm_inference_engine_tpu_torch.parallel.multihost import (
    StepPlan, agree_step_plan)
from llm_inference_engine_tpu_torch.runtime.chat_template import (
    template_for_model)
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.runtime.multihost_scheduler import (
    MultiHostScheduler, RequestRouter)
from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)
from llm_inference_engine_tpu_torch.server import LLMServer, aggregate_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_config("debug")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _engine(batch=3, seq=64, crossed=True, **kw):
    """A port engine on the JAX package's seed-0 weights (``crossed``) or
    the port's own seed-0 weights."""
    if crossed:
        import jax
        params = params_from_numpy(jax.tree.map(
            np.asarray, j_init_dummy_params(j_get_config("debug"), seed=0)))
    else:
        params = init_dummy_params(CFG, seed=0)
    return InferenceEngine(CFG, EngineConfig(max_batch_size=batch,
                                             max_seq_len=seq, **kw),
                           params, device=CPU)


def _server(sched):
    return LLMServer(sched, _IdTokenizer(CFG.vocab_size),
                     template_for_model("plain"), "debug")


def _j_engine(batch=3, seq=64, **kw):
    cfg = j_get_config("debug")
    return JInferenceEngine(cfg, JEngineConfig(max_batch_size=batch,
                                               max_seq_len=seq,
                                               kernels="xla", **kw),
                            j_init_dummy_params(cfg, seed=0))


def _submit_all(sched, sp, n=5):
    rng = np.random.default_rng(7)
    return [sched.submit(rng.integers(0, CFG.vocab_size, 4 + i).tolist(), sp)
            for i in range(n)]


def test_agree_step_plan_single_process():
    assert agree_step_plan(32, 256, True) == StepPlan(32, 256, True)
    plan = agree_step_plan(0, 128, False)
    assert plan.prefill_len == 0 and not plan.any_work
    initialize_multihost()              # one process: a no-op
    mesh = make_multihost_mesh(dp=2, tp=4, devices=[CPU] * 8)
    assert mesh.shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="does not tile the 2 devices"):
        make_multihost_mesh(dp=1, tp=3, devices=[CPU] * 2)


@pytest.mark.parametrize("mesh", [{}, dict(tp=2)])
def test_lockstep_matches_plain_scheduler_and_jax(mesh):
    """Lockstep ids and finish reasons equal the plain scheduler's, on one
    rank and over a tp = 2 engine, and the JAX lockstep scheduler's."""
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    plain = ContinuousBatchingScheduler(_engine(), eos_token_id=None)
    lock = MultiHostScheduler(_engine(batch=4, **mesh) if mesh else _engine(),
                              eos_token_id=None)
    jlock = JMultiHostScheduler(_j_engine(), eos_token_id=None)
    ra, rb = _submit_all(plain, sp), _submit_all(lock, sp)
    rj = _submit_all(jlock, JSamplingParams(greedy=True, max_new_tokens=6))
    assert len(plain.run()) == len(lock.run()) == len(jlock.run()) == 5
    for a, b, j in zip(ra, rb, rj):
        assert a.output_ids == b.output_ids == j.output_ids
        assert a.finish_reason == b.finish_reason == j.finish_reason


def test_lockstep_idle_host_terminates_and_refuses_paged():
    lock = MultiHostScheduler(_engine(), eos_token_id=None)
    assert lock.run(max_steps=10) == []
    with pytest.raises(NotImplementedError, match="DP router"):
        MultiHostScheduler(_engine(kv_layout="paged", page_size=16,
                                   max_prefill_len=8))


def test_lockstep_chunked_admission_no_stall():
    """A long prompt admits chunk by chunk while a live row decodes every
    mixed step; the ids equal the plain scheduler's and JAX's lockstep."""
    def run(make, lock_cls, plain_cls, sp):
        lock = lock_cls(make(batch=2, seq=96, max_prefill_len=8),
                        eos_token_id=None)
        a = lock.submit([1, 2, 3], sp)
        lock.step()
        b = lock.submit(list(range(3, 27)), sp)     # 3 chunks of 8
        grew = []
        for _ in range(3):
            n0 = len(a.output_ids)
            lock.step()
            grew.append(len(a.output_ids) - n0)
        assert grew == [1, 1, 1]
        assert b.prefill_pos is None and len(b.output_ids) == 1
        lock.run()
        plain = plain_cls(make(batch=2, seq=96, max_prefill_len=8),
                          eos_token_id=None)
        pa = plain.submit([1, 2, 3], sp)
        plain.step()
        pb = plain.submit(list(range(3, 27)), sp)
        plain.run()
        assert (a.output_ids, b.output_ids) == (pa.output_ids, pb.output_ids)
        return a.output_ids, b.output_ids
    got = run(_engine, MultiHostScheduler, ContinuousBatchingScheduler,
              SamplingParams(greedy=True, max_new_tokens=10))
    want = run(_j_engine, JMultiHostScheduler, JScheduler,
               JSamplingParams(greedy=True, max_new_tokens=10))
    assert got == want


def test_router_least_loaded_completion_and_fleet_metrics():
    """Six requests over two replicas (one a dp = 2 engine): both get
    work, all finish with the JAX router's ids; the replicas' /metrics
    merge as the JAX package's aggregate_metrics merges them."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, CFG.vocab_size, 5).tolist() for _ in range(6)]
    hosts = [ContinuousBatchingScheduler(_engine(batch=2), eos_token_id=None),
             ContinuousBatchingScheduler(_engine(batch=2, dp=2),
                                         eos_token_id=None)]
    router = RequestRouter(hosts)
    reqs = [router.submit(p, SamplingParams(greedy=True, max_new_tokens=4))
            for p in prompts]
    assert all(len(h.waiting) + h.num_active > 0 for h in hosts)
    texts_before = [_server(h).metrics_text() for h in hosts]
    assert len(router.run()) == 6
    assert all(r.finished and len(r.output_ids) == 4 for r in reqs)
    jrouter = JRouter([JScheduler(_j_engine(batch=2), eos_token_id=None)
                       for _ in range(2)])
    jreqs = [jrouter.submit(p, JSamplingParams(greedy=True,
                                               max_new_tokens=4))
             for p in prompts]
    jrouter.run()
    assert [r.output_ids for r in reqs] == [r.output_ids for r in jreqs]
    servers = [_server(h) for h in hosts]
    for i, s in enumerate(servers):
        s.requests_completed, s.tokens_generated = 3 + i, 12 + 5 * i
        s.ttft_sum, s.e2e_sum = 0.125 * (i + 1), 1.5 / (i + 3)
    texts = [s.metrics_text() for s in servers]
    for case in (texts, texts_before, texts + texts_before):
        assert aggregate_metrics(case) == j_aggregate_metrics(case)
    with pytest.raises(ValueError):
        RequestRouter([])


def test_aggregate_metrics_exposition_variants_match_jax():
    a = ("# TYPE llm_tokens_generated_total counter\n"
         "llm_tokens_generated_total 10\n"
         "# TYPE llm_spec_acceptance_rate gauge\n"
         "llm_spec_acceptance_rate 0.5\n")
    b = a.replace(" 10\n", " 32\n").replace("0.5", "0.7")
    c = ('# HELP llm_requests_completed_total total\n'
         'llm_requests_completed_total{model="7 b"} 3\n'
         'llm_tokens_generated_total 5 1690000000\n'
         '\n'
         'not a sample\n'
         'llm_bad_value x\n'
         'llm_ratio_rate -0.25\n')
    for case in ([a, b], [c, c], [a, c, b], [], [""]):
        assert aggregate_metrics(case) == j_aggregate_metrics(case)
    assert "llm_tokens_generated_total 42" in aggregate_metrics([a, b])


WORKER = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from llm_inference_engine_tpu_torch.parallel import initialize_multihost
    host = int(sys.argv[1])
    initialize_multihost(sys.argv[2], num_processes=2, process_id=host)
    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_params)
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    from llm_inference_engine_tpu_torch.runtime.multihost_scheduler import (
        MultiHostScheduler)

    cfg = get_config("debug")
    eng = InferenceEngine(
        cfg, EngineConfig(max_batch_size=2, max_seq_len=96,
                          max_prefill_len=8),
        init_dummy_params(cfg, seed=0), device="cpu")
    sched = MultiHostScheduler(eng, eos_token_id=None)
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    reqs, steps = {}, 0
    if host == 0:
        reqs["a"] = sched.submit([1, 2, 3], sp)
    sched.step()                       # host 1 idles in lockstep here
    if host == 1:
        reqs["b"] = sched.submit(list(range(3, 23)), sp)   # 3 chunks of 8
    sched.step()
    if host == 0:
        reqs["c"] = sched.submit([9, 8, 7], sp)
    sched.step()
    sched.run()                        # exits only when no host has work
    print("RESULT" + json.dumps(
        {k: r.output_ids for k, r in reqs.items()}), flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_lockstep_matches_solo(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(h), coord],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env) for h in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = {}
    for out in outs:
        line = [x for x in out.splitlines() if x.startswith("RESULT")][0]
        results.update(json.loads(line[len("RESULT"):]))
    assert set(results) == {"a", "b", "c"}
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    for name, prompt in (("a", [1, 2, 3]), ("b", list(range(3, 23))),
                         ("c", [9, 8, 7])):
        solo = ContinuousBatchingScheduler(
            _engine(batch=2, seq=96, crossed=False, max_prefill_len=8),
            eos_token_id=None)
        r = solo.submit(prompt, sp)
        solo.run()
        assert results[name] == r.output_ids, name

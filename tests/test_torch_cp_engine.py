"""The context-parallel engine of the PyTorch port against the JAX
package's.

``EngineConfig(cp=2)`` on a CPU engine is a mesh of copies of the CPU
with a seq axis; its cache is a set of per-rank append logs
(``parallel/cp_cache.py``), prefill runs ring attention and decode
split-KV (``parallel/cp_engine.py``). Held against the JAX cp = 2 engine
on the conftest's virtual CPU devices, each JAX engine built once per
module (its ``shard_map`` compiles are what cost time), at the JAX tests'
2e-4 on the f32 ``debug`` preset: prefill logits over ragged chunked
prompts, greedy ids of ``generate``, streaming ``decode_step`` and
``decode_rollout``, a multi-round append, a reset of some slots, the
local-capacity guard, a near-capacity append, cp x tp x dp, the int8
log; the refusals and ``validate_mesh``'s strings equal to JAX's, the
host mirror of ``llen`` equal to the device's, the decode bodies under
``NoHostReads``, and the scheduler over a cp engine.
"""

import jax
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.parallel import make_mesh as j_make_mesh
from llm_inference_engine_tpu.parallel.mesh import (
    validate_mesh as j_validate_mesh)
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)
from llm_inference_engine_tpu.runtime.scheduler import (
    ContinuousBatchingScheduler as JScheduler)
from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.parallel import make_mesh
from llm_inference_engine_tpu_torch.parallel.cp_engine import (
    cp_cache_pspecs)
from llm_inference_engine_tpu_torch.parallel.mesh import validate_mesh
from llm_inference_engine_tpu_torch.runtime.decode_graph import NoHostReads
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)

CFG_J = j_get_config("debug")        # 4 heads, 2 kv heads, vocab 256, f32
CFG = get_config("debug")
CPU = torch.device("cpu")
TOL = 2e-4
KW = dict(max_batch_size=4, max_seq_len=64, max_prefill_len=16)
GREEDY = dict(greedy=True, max_new_tokens=10)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jp():
    return j_init_dummy_params(CFG_J, seed=0)


@pytest.fixture(scope="module")
def params(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp))


def _jax_engine(jp, **kw):
    return JInferenceEngine(CFG_J, JEngineConfig(kernels="xla", **KW, **kw),
                            jp, rng_seed=0)


@pytest.fixture(scope="module")
def jcp(jp):
    """The JAX cp = 2 engine (bf16-or-model-dtype log), built once."""
    return _jax_engine(jp, cp=2)


@pytest.fixture(scope="module")
def jcp8(jp):
    """The JAX cp = 2 engine over an int8 log, built once."""
    return _jax_engine(jp, cp=2, kv_cache_dtype_name="int8")


@pytest.fixture()
def fresh(jcp, jcp8):
    """The module's JAX engines, reset before the test."""
    jcp.reset()
    jcp8.reset()
    return jcp, jcp8


def _engine(params, **kw):
    return InferenceEngine(CFG, EngineConfig(**KW, **kw), params,
                           device=CPU)


def _prompts(rng, lens):
    return [rng.integers(0, CFG.vocab_size, size=n).tolist() for n in lens]


def _logits_close(got, want, rows=slice(None)):
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               atol=TOL, rtol=TOL)


def _same_logs(te, je):
    """The port's host mirror and device llen equal the JAX engine's."""
    want = np.asarray(je.cache.llen)
    np.testing.assert_array_equal(te.cache.llen.numpy(), want)
    np.testing.assert_array_equal(te._llen, want)
    np.testing.assert_array_equal(te.cache.lengths.numpy(),
                                  np.asarray(je.cache.lengths))


def test_cp2_builds_a_seq_mesh_of_append_logs(params):
    te = _engine(params, cp=2)
    assert te.mesh.shape == {"data": 1, "seq": 2, "model": 1}
    assert te.engine_config.cp == 2
    log = te.cache.shards[0][1][0]
    assert log.k.shape == (CFG.num_layers, 4, 32, CFG.num_kv_heads,
                           CFG.head_dim)
    assert te.cache.llen.shape == (4, 2)
    assert (te.cache.kv_pos[0][1][0] == -1).all()
    # seq ranks on one device share every weight tensor
    assert te.params.shard(0, 0, 0) is te.params.shard(0, 1, 0)
    # the splits of the JAX package's cp_cache_pspecs, by axis name
    specs = cp_cache_pspecs(te.cache)
    assert specs["k"] == (None, "data", "seq", "model", None)
    assert specs["kv_pos"] == ("data", "seq") and specs["k_scale"] is None
    assert cp_cache_pspecs(_engine(params, cp=2, kv_cache_dtype_name="int8")
                           .cache)["v_scale"] == (None, "data", "seq",
                                                  "model")


def test_cp2_prefill_logits_match_jax(rng, params, fresh):
    """Chunked ragged prefill (lengths straddle the 16-token chunk)."""
    jcp, _ = fresh
    te = _engine(params, cp=2)
    prompts = _prompts(rng, [7, 16, 23, 3])
    _logits_close(te.prefill(prompts), jcp.prefill(prompts))
    _same_logs(te, jcp)
    for _, s, _, shard, kv_pos in te.cache.ranks():
        np.testing.assert_array_equal(shard.lengths.numpy(),
                                      te._llen[:, s])
        np.testing.assert_array_equal((kv_pos >= 0).sum(1).numpy(),
                                      te._llen[:, s])


def test_cp2_generate_ids_match_jax(rng, params, fresh):
    jcp, _ = fresh
    te = _engine(params, cp=2)
    prompts = _prompts(rng, [9, 17, 5, 12])
    got = te.generate(prompts, SamplingParams(**GREEDY), eos_token_id=None)
    want = jcp.generate(prompts, JSamplingParams(**GREEDY),
                        eos_token_id=None)
    assert got.token_ids == want.token_ids
    np.testing.assert_allclose(np.array(got.logprobs),
                               np.array(want.logprobs), atol=TOL)
    _same_logs(te, jcp)


def test_cp2_decode_steps_and_rollout_match_jax(rng, params, fresh):
    """decode_step with a partially active batch (the least-full-rank
    rule on ties and skews), then a greedy decode_rollout."""
    jcp, _ = fresh
    te = _engine(params, cp=2)
    prompts = _prompts(rng, [6, 11, 3, 19])
    sp, jsp = SamplingParams(greedy=True), JSamplingParams(greedy=True)
    tt = te.prefill(prompts).argmax(-1).to(torch.int32)
    tj = jax.numpy.argmax(jcp.prefill(prompts), -1).astype(jax.numpy.int32)
    active = np.array([True, True, False, True])
    for _ in range(6):
        tt = te.decode_step(tt, active, sp)
        tj = jcp.decode_step(tj, active, jsp)
        np.testing.assert_array_equal(tt.numpy()[active],
                                      np.asarray(tj)[active])
    _same_logs(te, jcp)
    np.testing.assert_array_equal(te.decode_rollout(tt, 5).numpy(),
                                  np.asarray(jcp.decode_rollout(tj, 5)))
    _same_logs(te, jcp)


def test_cp2_multiround_append_matches_jax(rng, params, fresh):
    """Round 2 prefill appends on top of the decode-extended logs."""
    jcp, _ = fresh
    te = _engine(params, cp=2)
    r1 = _prompts(rng, [8, 5, 14, 7])
    sp = dict(greedy=True, max_new_tokens=6)
    assert (te.generate(r1, SamplingParams(**sp), eos_token_id=None)
            .token_ids == jcp.generate(r1, JSamplingParams(**sp),
                                       eos_token_id=None).token_ids)
    r2 = _prompts(rng, [6, 9, 4, 11])
    _logits_close(te.prefill(r2), jcp.prefill(r2))
    _same_logs(te, jcp)


def test_cp2_reset_slots_matches_jax(rng, params, fresh):
    jcp, _ = fresh
    te = _engine(params, cp=2)
    prompts = _prompts(rng, [12, 8, 6, 10])
    te.prefill(prompts)
    jcp.prefill(prompts)
    te.reset([1, 3])
    jcp.reset([1, 3])
    _same_logs(te, jcp)
    for _, _, _, _, kv_pos in te.cache.ranks():
        assert (kv_pos[[1, 3]] == -1).all()
    p2 = _prompts(rng, [5, 9])
    _logits_close(te.prefill(p2, slots=[1, 3]),
                  jcp.prefill(p2, slots=[1, 3]), rows=[1, 3])
    _same_logs(te, jcp)


def test_cp_local_capacity_guard(params, fresh):
    """Ragged chunked prefill that would overflow rank 0's log raises
    (the padded-window shrink check or the llen mirror), as in JAX, and
    writes nothing past the log."""
    jcp, _ = fresh
    te = _engine(params, cp=2)
    for e in (te, jcp):
        with pytest.raises(ValueError, match="local KV log|cannot fit"):
            for _ in range(8):
                e.prefill([[1] * 9, [], [], []], slots=[0, 1, 2, 3])
    _same_logs(te, jcp)


def test_cp_near_capacity_append_matches_jax(rng, params, fresh):
    """48 tokens (logs 24/24), + 6 (30/24), + 4: rank 0 has 2 rows left,
    so the 4-token append shrinks its bucket to 4 (t_local 2)."""
    jcp, _ = fresh
    te = _engine(params, cp=2)
    toks = rng.integers(0, CFG.vocab_size, size=58).tolist()
    for e in (te, jcp):
        e.prefill([toks[:48], [], [], []], slots=[0, 1, 2, 3])
        e.prefill([toks[48:54], [], [], []], slots=[0, 1, 2, 3])
    last = [toks[54:58], [], [], []]
    _logits_close(te.prefill(last, slots=[0, 1, 2, 3]),
                  jcp.prefill(last, slots=[0, 1, 2, 3]), rows=[0])
    _same_logs(te, jcp)
    assert te._llen[0].max() <= 32


@pytest.mark.parametrize("tp,dp", [(2, 1), (1, 2), (2, 2)])
def test_cp_composes_with_tp_dp(rng, params, fresh, tp, dp):
    """cp = 2 with tp and dp: greedy ids equal the JAX cp = 2 engine's
    (which equal its cp = 1 engine's, tests/test_cp_engine.py)."""
    jcp, _ = fresh
    te = _engine(params, cp=2, tp=tp, dp=dp)
    assert te.mesh.shape == {"data": dp, "seq": 2, "model": tp}
    prompts = _prompts(rng, [7, 13, 4, 9])
    sp = dict(greedy=True, max_new_tokens=8)
    got = te.generate(prompts, SamplingParams(**sp), eos_token_id=None)
    want = jcp.generate(prompts, JSamplingParams(**sp), eos_token_id=None)
    assert got.token_ids == want.token_ids
    _same_logs(te, jcp)


def test_cp2_int8_log_matches_jax(rng, params, fresh):
    """The int8 log (absmax scale planes on the CPU, the JAX package's
    separate-scale log): prefill logits, generate's ids and a second
    round's logits."""
    _, jcp8 = fresh
    te = _engine(params, cp=2, kv_cache_dtype_name="int8")
    log = te.cache.shards[0][0][0]
    assert log.k.dtype == torch.int8 and log.quantized and not log.snapped
    prompts = _prompts(rng, [9, 17, 5, 12])
    _logits_close(te.prefill(prompts), jcp8.prefill(prompts))
    te.reset()
    jcp8.reset()
    got = te.generate(prompts, SamplingParams(**GREEDY), eos_token_id=None)
    want = jcp8.generate(prompts, JSamplingParams(**GREEDY),
                         eos_token_id=None)
    assert got.token_ids == want.token_ids
    r2 = _prompts(rng, [6, 9, 4, 11])
    _logits_close(te.prefill(r2), jcp8.prefill(r2))
    _same_logs(te, jcp8)


def test_cp_refusals_match_jax(jp, params):
    """cp + paged, and a log neither bf16 (the model dtype) nor int8, are
    refused with the JAX package's messages."""
    for kw, match in ((dict(kv_layout="paged"), "paged"),
                      (dict(kv_cache_dtype_name="float16"), "bf16 or int8")):
        with pytest.raises(NotImplementedError) as want:
            _jax_engine(jp, cp=2, **kw)
        with pytest.raises(NotImplementedError, match=match) as got:
            _engine(params, cp=2, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cp,eng_kw", [
    (4, dict(max_seq_len=66)), (2, dict(max_prefill_len=3)),
    (4, dict(max_prefill_len=4)), (3, {})])
def test_validate_mesh_cp_messages_match_jax(cp, eng_kw):
    """max_seq_len % cp, max_prefill_len % cp and < 2*cp, and cp a power
    of two <= 8, in the JAX package's words."""
    jmesh = j_make_mesh(dp=1, tp=1, cp=cp, devices=jax.devices("cpu"))
    mesh = make_mesh(1, 1, cp, devices=[CPU] * cp)
    eng = {**KW, **eng_kw}
    with pytest.raises(ValueError) as want:
        j_validate_mesh(CFG_J, JEngineConfig(**eng), jmesh)
    with pytest.raises(ValueError, match="mesh/config mismatch") as got:
        validate_mesh(CFG, EngineConfig(**eng), mesh)
    assert str(got.value) == str(want.value)


def test_cp_decode_bodies_read_nothing_on_the_host(rng, params):
    """The step, the greedy and the sampled rollout step of a cp = 2,
    tp = 2 engine under NoHostReads (the CPU proxy for a body the card
    captures into a CUDA graph): the write plan, the kv_pos append, the
    llen update and the split-KV combine run on the device."""
    te = _engine(params, cp=2, tp=2)
    te.prefill(_prompts(rng, [7, 13, 4, 9]))
    arrays = te._host_arrays(SamplingParams(temperature=0.7, top_k=5,
                                            repetition_penalty=1.2))
    te._stage(np.array([5, 6, 7, 8]), np.ones(4, bool), arrays)
    for name in ("step", "greedy", "sampled"):
        with NoHostReads(name):
            getattr(te, f"_{name}_body")()


def test_scheduler_over_a_cp_engine(rng, params):
    """The scheduler runs over a cp engine, as the JAX package's does
    (prefill, decode_step and reset are all it calls): ids equal those
    of the same scheduler over a one-rank engine."""
    prompts = _prompts(rng, [12, 3, 20, 7, 9])
    ids = []
    for kw in (dict(), dict(cp=2)):
        sched = ContinuousBatchingScheduler(_engine(params, **kw),
                                            eos_token_id=None)
        reqs = [sched.submit(p, SamplingParams(greedy=True,
                                               max_new_tokens=6))
                for p in prompts]
        sched.run()
        ids.append([r.output_ids for r in reqs])
    assert ids[0] == ids[1]


def test_prefix_snapshots_speculation_and_beams_refuse_a_cp_engine(params):
    """On a cp engine the slot prefix store and speculation stay refused,
    naming the reference's fault (its snapshot carries no kv_pos/llen; its
    round fails its CPSpec assertion: see the next test); beams over the
    cp engine's params run (on the seq-rank-0 face) and give the one-rank
    engine's sequences (the JAX package's, in
    ``test_torch_mesh_decoding.py``)."""
    from llm_inference_engine_tpu_torch.runtime.beam_search import (
        beam_search)
    from llm_inference_engine_tpu_torch.runtime.prefix_cache import (
        DualPrefixStore, PrefixStore)
    from llm_inference_engine_tpu_torch.runtime.speculative import (
        SpeculativeDecoder)
    te = _engine(params, cp=2)
    with pytest.raises(NotImplementedError,
                       match="without their kv_pos or llen"):
        PrefixStore(te)
    with pytest.raises(NotImplementedError,
                       match="without their kv_pos or llen"):
        DualPrefixStore(_engine(params), te)
    with pytest.raises(NotImplementedError,
                       match=r"CPCache requires a CPSpec \(cp_engine\)"):
        SpeculativeDecoder(te, te)
    got = beam_search(CFG, te.engine_config, te.params, [1, 2, 3],
                      num_beams=2, max_new_tokens=4, eos_token_id=None)
    one = _engine(params)
    want = beam_search(CFG, one.engine_config, one.params, [1, 2, 3],
                       num_beams=2, max_new_tokens=4, eos_token_id=None)
    assert got.sequences == want.sequences
    np.testing.assert_allclose(got.scores, want.scores, atol=TOL, rtol=TOL)


def test_jax_prefix_store_on_a_cp_engine_gives_other_ids(fresh, params):
    """The reference's fault that keeps the port's refusal: the JAX cp = 2
    scheduler with a registered prefix restores log rows without their
    kv_pos/llen, and its greedy ids differ from the same engine's without
    the store, which the port's cp engine reproduces."""
    jcp, _ = fresh
    rng = np.random.default_rng(0)
    prefix = _prompts(rng, [20])[0]
    prompts = [prefix + t for t in _prompts(rng, [5, 3, 9, 2])]
    runs = []
    for store in (False, True):
        jcp.reset()
        sched = JScheduler(jcp, eos_token_id=None)
        if store:
            sched.register_prefix(prefix)
        reqs = [sched.submit(p, JSamplingParams(**GREEDY)) for p in prompts]
        sched.run()
        runs.append([r.output_ids for r in reqs])
        assert [r.reused_prefix_len for r in reqs] == [20 * store] * 4
    jcp.reset()
    assert runs[1] != runs[0]
    sched = ContinuousBatchingScheduler(_engine(params, cp=2),
                                        eos_token_id=None)
    reqs = [sched.submit(p, SamplingParams(**GREEDY)) for p in prompts]
    sched.run()
    assert [r.output_ids for r in reqs] == runs[0]

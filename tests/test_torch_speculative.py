"""The PyTorch port's speculative decoding against the JAX package, on the
CPU: ``forward_all_logits``, the greedy ``SpeculativeDecoder``, the
sampling ops (``top_k_logits``, ``sample_top_k``, ``speculative_accept``),
the sampled round, ``SpeculativeScheduler`` with its paired prefix store,
and the server's ``--draft-model``.

The JAX side runs its XLA path on the ``debug`` preset in f32; the port's
weights cross over from the JAX dummy init through ``params_from_numpy``.
Greedy ids must be equal; logits within 1e-5 and logprobs within 1e-4
(the same f32 math summed in another order). The port draws from a torch
``Generator`` (Philox, not threefry), so sampled rows are held by
statistics with fixed seeds: acceptance min(1, p/q) and the emitted
marginal equal to the target's, as the JAX package's own tests hold it.
On a card the rounds are CUDA-graph replays (``tests/test_torch_kernels.py``
and ``chip_smoke.py`` phase 4l); here they run eagerly, and under
``NoHostReads``, the CPU proxy for "capturable".
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models import llama as j_llama
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.ops import kv_cache as j_kvc
from llm_inference_engine_tpu.ops import sampling as j_sampling
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)
from llm_inference_engine_tpu.runtime.speculative import (
    SpeculativeDecoder as JSpeculativeDecoder)
from llm_inference_engine_tpu.runtime.speculative_scheduler import (
    SpeculativeScheduler as JSpeculativeScheduler)

from llm_inference_engine_tpu_torch import server as port_server
from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models import llama
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops.sampling import (
    sample_top_k, speculative_accept, top_k_logits)
from llm_inference_engine_tpu_torch.runtime.decode_graph import NoHostReads
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)
from llm_inference_engine_tpu_torch.runtime.speculative import (
    SpeculativeDecoder)
from llm_inference_engine_tpu_torch.runtime.speculative_scheduler import (
    SpeculativeScheduler)
from test_torch_server import _completion

CFG = get_config("debug")
PROMPTS = [[1, 17, 93, 5], [1, 9, 41]]
LP_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _weights(seed, scale=0.3):
    """(JAX params, port params) of the debug preset from one seed."""
    jp = j_init_dummy_params(j_get_config("debug"), seed=seed, scale=scale)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _pair(seed, scale=0.3, **kw):
    """A JAX and a port engine over the same weights."""
    kw = {"max_batch_size": 2, "max_seq_len": 96, **kw}
    jp, tp = _weights(seed, scale)
    return (JInferenceEngine(j_get_config("debug"),
                             JEngineConfig(kernels="xla", **kw), jp),
            InferenceEngine(CFG, EngineConfig(**kw), tp))


def test_forward_all_logits_matches_jax():
    """Every position's logits of a 5-token block appended to a ragged
    history, within 1e-5, and the same lengths."""
    jp, tp = _weights(0)
    B, S = 2, 32
    rng = np.random.default_rng(0)
    hist = [rng.integers(3, 256, n).tolist() for n in (7, 3)]
    block = rng.integers(3, 256, (B, 5)).astype(np.int32)
    jeng = JEngineConfig(kernels="xla", max_batch_size=B, max_seq_len=S)
    jc = j_kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads, S,
                            CFG.head_dim, dtype=jnp.float32)
    tc = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads, S,
                          CFG.head_dim, dtype=torch.float32)
    T = max(map(len, hist))
    ids = np.zeros((B, T), np.int32)
    for i, h in enumerate(hist):
        ids[i, :len(h)] = h
    lens = np.array([len(h) for h in hist], np.int32)
    zero = np.zeros((B,), np.int32)
    _, jc = j_llama.forward_hidden(j_get_config("debug"), jeng, jp,
                                   jnp.asarray(ids), jc, jnp.asarray(zero),
                                   jnp.asarray(lens))
    llama.forward_hidden(CFG, EngineConfig(max_batch_size=B, max_seq_len=S),
                         tp, torch.from_numpy(ids), tc,
                         torch.from_numpy(zero), torch.from_numpy(lens))
    want, jc = j_llama.forward_all_logits(
        j_get_config("debug"), jeng, jp, jnp.asarray(block), jc,
        jnp.asarray(lens), jnp.asarray(lens + 5))
    got, tc = llama.forward_all_logits(
        CFG, EngineConfig(max_batch_size=B, max_seq_len=S), tp,
        torch.from_numpy(block), tc, torch.from_numpy(lens),
        torch.from_numpy(lens + 5))
    assert got.dtype == torch.float32 and got.shape == (B, 5, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("draft_seed", [0, 5])
def test_greedy_spec_matches_jax_and_plain(draft_seed, k):
    """Greedy speculative ids equal the JAX decoder's and plain greedy
    decoding's, with the same drafted and accepted counts; a draft equal
    to the target accepts every token."""
    jt, tt = _pair(0)
    jd, td = _pair(draft_seed)
    want = JSpeculativeDecoder(jt, jd, num_draft=k).generate(
        PROMPTS, max_new_tokens=16, eos_token_id=None)
    spec = SpeculativeDecoder(tt, td, num_draft=k)
    got = spec.generate(PROMPTS, max_new_tokens=16, eos_token_id=None)
    assert got.token_ids == want.token_ids
    assert (got.num_drafted, got.num_accepted) == (want.num_drafted,
                                                   want.num_accepted)
    # both caches rewound to the same frontier, host mirrors in step
    assert tt.cache.lengths.tolist() == np.asarray(jt.cache.lengths).tolist()
    assert td.cache.lengths.tolist() == np.asarray(jd.cache.lengths).tolist()
    assert tt._lengths.tolist() == tt.cache.lengths.tolist()
    assert td._lengths.tolist() == td.cache.lengths.tolist()
    tt.reset()
    plain = tt.generate(PROMPTS, SamplingParams(greedy=True,
                                                max_new_tokens=16),
                        eos_token_id=None).token_ids
    assert got.token_ids == plain
    if draft_seed == 0:
        assert got.num_accepted == got.num_drafted > 0


def test_spec_with_eos_matches_jax():
    """A token of the greedy output as the EOS id: the output stops after
    it (EOS included), as the JAX decoder's does."""
    jt, tt = _pair(3, scale=0.35, max_batch_size=1)
    jd, td = _pair(4, scale=0.35, max_batch_size=1)
    base = tt.generate([[1, 2, 3]], SamplingParams(greedy=True,
                                                   max_new_tokens=24),
                       eos_token_id=None).token_ids[0]
    eos = base[min(7, len(base) - 1)]
    want = JSpeculativeDecoder(jt, jd, num_draft=4).generate(
        [[1, 2, 3]], max_new_tokens=24, eos_token_id=int(eos))
    got = SpeculativeDecoder(tt, td, num_draft=4).generate(
        [[1, 2, 3]], max_new_tokens=24, eos_token_id=int(eos))
    assert got.token_ids == want.token_ids
    assert got.token_ids[0] == base[:base.index(eos) + 1]


def test_spec_with_penalties_matches_jax():
    """Penalties frozen at each round's start, alike for draft and target:
    greedy ids and counts equal the JAX decoder's."""
    sp = dict(greedy=True, repetition_penalty=1.4, presence_penalty=0.3,
              frequency_penalty=0.2, max_new_tokens=12)
    jt, tt = _pair(0)
    jd, td = _pair(1)
    want = JSpeculativeDecoder(jt, jd, num_draft=3).generate(
        PROMPTS, max_new_tokens=12, eos_token_id=None,
        sampling=JSamplingParams(**sp))
    got = SpeculativeDecoder(tt, td, num_draft=3).generate(
        PROMPTS, max_new_tokens=12, eos_token_id=None,
        sampling=SamplingParams(**sp))
    assert got.token_ids == want.token_ids
    assert (got.num_drafted, got.num_accepted) == (want.num_drafted,
                                                   want.num_accepted)


# ---------------------------------------------------------------------------
# the sampling ops
# ---------------------------------------------------------------------------

def _dist(rng, V, temp=1.0):
    logits = rng.standard_normal(V) * temp
    e = np.exp(logits - logits.max())
    return e / e.sum()


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_top_k_logits_and_sample_top_k_match_jax():
    """top_k_logits equals JAX's exactly; sample_top_k is greedy at T = 0
    and otherwise draws from softmax(top_k / T) cut to top-p, as JAX's
    (TV distance over 6000 draws)."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 40)).astype(np.float32) * 2
    jv, ji = j_sampling.top_k_logits(jnp.asarray(logits), 5)
    tv, ti = top_k_logits(torch.from_numpy(logits), 5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    greedy = sample_top_k(torch.from_numpy(logits), _gen(0), temperature=0.0)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))

    N = 6000
    row = np.broadcast_to(logits[:1], (N, 40)).copy()
    kw = dict(temperature=0.8, top_k=6, top_p=0.9)
    got = sample_top_k(torch.from_numpy(row), _gen(1), **kw).numpy()
    want = np.asarray(j_sampling.sample_top_k(jnp.asarray(row),
                                              jax.random.PRNGKey(1), **kw))
    h_got = np.bincount(got, minlength=40) / N
    h_want = np.bincount(want, minlength=40) / N
    assert set(np.nonzero(h_got)[0]) <= set(np.argsort(-logits[0])[:6])
    assert 0.5 * np.abs(h_got - h_want).sum() < 0.04


def test_accept_onehot_rows_equal_jax():
    """One-hot p and q (greedy rows): longest matching prefix + the target
    argmax, exactly the JAX rule's output."""
    V = 8
    draft = np.array([[1, 2, 3], [1, 2, 3], [4, 4, 4]], np.int32)
    tgt = np.array([[1, 2, 3, 5], [1, 7, 0, 0], [0, 0, 0, 0]], np.int32)
    q, p = np.eye(V, dtype=np.float32)[draft], np.eye(V,
                                                      dtype=np.float32)[tgt]
    je, jn = j_sampling.speculative_accept(jnp.asarray(draft),
                                           jnp.asarray(q), jnp.asarray(p),
                                           jax.random.PRNGKey(0))
    for seed in range(5):
        te, tn = speculative_accept(torch.from_numpy(draft),
                                    torch.from_numpy(q), torch.from_numpy(p),
                                    _gen(seed))
        assert tn.tolist() == np.asarray(jn).tolist() == [3, 1, 0]
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_accept_draft_equal_to_target_accepts_all():
    """p == q at every position: every draft accepted, any seed."""
    rng = np.random.default_rng(0)
    V, B, k = 32, 4, 5
    q = np.stack([[_dist(rng, V) for _ in range(k)] for _ in range(B)])
    p = np.concatenate([q, q[:, -1:]], axis=1)
    for seed in range(20):
        draft = np.array([[rng.choice(V, p=q[b, j]) for j in range(k)]
                          for b in range(B)], np.int32)
        _, n_acc = speculative_accept(torch.from_numpy(draft),
                                      torch.from_numpy(q).float(),
                                      torch.from_numpy(p).float(),
                                      _gen(seed))
        assert (n_acc == k).all()


def test_accept_probability_is_min_of_one_and_p_over_q():
    """The first position accepts with probability E_q[min(1, p/q)] =
    sum(min(p, q)), within 0.035 over 4000 rows."""
    rng = np.random.default_rng(1)
    V, k, N = 16, 1, 4000
    q0, p0 = _dist(rng, V, temp=2.0), _dist(rng, V, temp=2.0)
    expected = float(np.minimum(q0, p0).sum())
    draft = rng.choice(V, size=(N, k), p=q0).astype(np.int32)
    q = torch.from_numpy(q0).float().expand(N, k, V)
    p = torch.from_numpy(p0).float().expand(N, k + 1, V)
    _, n_acc = speculative_accept(torch.from_numpy(draft), q, p, _gen(7))
    got = (n_acc == 1).float().mean().item()
    assert abs(got - expected) < 0.035, (got, expected)


@pytest.mark.parametrize("position", [0, 1])
def test_emitted_marginal_matches_target(position):
    """The token emitted at position 0 is distributed as p_0; at position
    1, over rows whose position 0 accepted, as p_1 (TV distance < 0.04):
    the chain rule of the lossless proof one level deep."""
    rng = np.random.default_rng(2 + 2 * position)
    V, k, N = (12, 3, 8000) if position == 0 else (10, 2, 12000)
    q_pos = [_dist(rng, V, temp=1.5) for _ in range(k)]
    p_pos = [_dist(rng, V, temp=1.5) for _ in range(k + 1)]
    q = torch.from_numpy(np.stack(q_pos)).float().expand(N, k, V)
    p = torch.from_numpy(np.stack(p_pos)).float().expand(N, k + 1, V)
    draft = np.stack([rng.choice(V, size=N, p=q_pos[j]) for j in range(k)],
                     axis=1).astype(np.int32)
    emitted, n_acc = speculative_accept(torch.from_numpy(draft), q, p,
                                        _gen(3 + position))
    emitted, n_acc = emitted.numpy(), n_acc.numpy()
    rows = n_acc >= position
    hist = np.bincount(emitted[rows, position], minlength=V) / rows.sum()
    assert 0.5 * np.abs(hist - p_pos[position]).sum() < 0.04


# ---------------------------------------------------------------------------
# the sampled round
# ---------------------------------------------------------------------------

def test_sampled_round_at_temperature_0_equals_greedy_round():
    """The rejection-sampling round at temperature 0 (one-hot p and q)
    gives the greedy round's ids and counts."""
    _, tt = _pair(0)
    _, td = _pair(5)
    spec = SpeculativeDecoder(tt, td, num_draft=3)
    want = spec.generate(PROMPTS, max_new_tokens=12, eos_token_id=None)
    got = spec.generate(PROMPTS, max_new_tokens=12, eos_token_id=None,
                        sampling=SamplingParams(temperature=0.0,
                                                max_new_tokens=12))
    assert got.token_ids == want.token_ids
    assert (got.num_drafted, got.num_accepted) == (want.num_drafted,
                                                   want.num_accepted)


def test_sampled_round_identical_models_accept_all():
    """draft == target (the same processed distributions): every sampled
    draft is accepted; the emitted ids lie in each row's top-k."""
    _, tt = _pair(0)
    _, td = _pair(0)
    res = SpeculativeDecoder(tt, td, num_draft=3, rng_seed=4).generate(
        [[1, 4, 9], [1, 2, 3]], max_new_tokens=16, eos_token_id=None,
        sampling=SamplingParams(temperature=0.9, top_k=20,
                                max_new_tokens=16))
    assert res.num_drafted > 0 and res.num_accepted == res.num_drafted
    assert all(len(t) == 16 for t in res.token_ids)


def test_round_bodies_read_nothing_on_the_host():
    """The greedy round, the sampled round and the ingest run under
    NoHostReads with penalties and sampling on and one row inactive: none
    reads a device value on the host, so each can be captured. The
    inactive row writes nothing and keeps its lengths."""
    _, tt = _pair(0, max_batch_size=3)
    _, td = _pair(5, max_batch_size=3)
    spec = SpeculativeDecoder(tt, td, num_draft=3)
    for e in (tt, td):
        e.prefill([[5, 6, 7], [8] * 8, [9, 10]])
    sp = SamplingParams(temperature=0.7, top_k=4, top_p=0.9, min_p=0.05,
                        repetition_penalty=1.2, presence_penalty=0.5,
                        frequency_penalty=0.25)
    tt._stage(np.array([1, 2, 3]), np.array([1, 1, 0]), tt._host_arrays(sp))
    for name in ("greedy", "sampled", "ingest"):
        with NoHostReads(name):
            getattr(spec, f"_{name}_body")()
    assert tt.cache.lengths[2] == td.cache.lengths[2] == 2


# ---------------------------------------------------------------------------
# SpeculativeScheduler
# ---------------------------------------------------------------------------

SCHED_PROMPTS = [[1, 2, 3], [9, 8, 7, 6], list(range(3, 25)), [4, 4],
                 [17, 5]]


def _sched_engine(seed=0, batch=2, seq=96, jax_side=False):
    kw = dict(max_batch_size=batch, max_seq_len=seq, max_prefill_len=8)
    jp, tp = _weights(seed, scale=0.5)
    if jax_side:
        return JInferenceEngine(j_get_config("debug"),
                                JEngineConfig(kernels="xla", **kw), jp)
    return InferenceEngine(CFG, EngineConfig(**kw), tp)


def _run(sched, prompts, sp):
    reqs = [sched.submit(p, sp) for p in prompts]
    sched.run(max_steps=2000)
    return reqs


@pytest.mark.parametrize("draft_seed", [0, 1])
def test_spec_scheduler_matches_plain_greedy(draft_seed):
    """Five requests through two slots (chunks of 8, slot reuse): the same
    ids as the plain greedy scheduler; an identical draft accepts all."""
    sp = SamplingParams(greedy=True, max_new_tokens=9)
    want = _run(ContinuousBatchingScheduler(_sched_engine(),
                                            eos_token_id=None),
                SCHED_PROMPTS, sp)
    spec = SpeculativeScheduler(_sched_engine(), _sched_engine(draft_seed),
                                eos_token_id=None, num_draft=3)
    got = _run(spec, SCHED_PROMPTS, sp)
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    assert spec.num_drafted > 0
    assert (spec.acceptance_rate == 1.0) == (draft_seed == 0)


def test_spec_scheduler_matches_jax_ids_logprobs_and_reasons():
    """Against the JAX SpeculativeScheduler on the same weights: a long
    prompt admitted chunk by chunk while a live request runs rounds, then
    a request at the sequence cap: equal ids, finish reasons ('length',
    'capacity' at k + 2 rows of headroom) and drafted/accepted counts;
    logprobs within 1e-4."""
    sp = SamplingParams(greedy=True, max_new_tokens=12)
    jsp = JSamplingParams(greedy=True, max_new_tokens=12)
    out = {}
    for side in ("jax", "port"):
        j = side == "jax"
        make = (JSpeculativeScheduler if j else SpeculativeScheduler)
        s = make(_sched_engine(jax_side=j, seq=48),
                 _sched_engine(1, jax_side=j, seq=48), eos_token_id=None,
                 num_draft=3)
        a = s.submit([1, 2, 3], jsp if j else sp)
        s.step()
        b = s.submit(list(range(3, 31)), jsp if j else sp)
        c = s.submit([7, 8, 9],
                     (JSamplingParams if j else SamplingParams)(
                         greedy=True, max_new_tokens=100))
        s.run(max_steps=2000)
        out[side] = ([(r.output_ids, r.finish_reason, r.token_logprobs)
                      for r in (a, b, c)], s.num_drafted, s.num_accepted)
    (want, jd, ja), (got, td, ta) = out["jax"], out["port"]
    assert (td, ta) == (jd, ja)
    for (gi, gr, gl), (wi, wr, wl) in zip(got, want):
        assert gi == wi and gr == wr
        np.testing.assert_allclose(gl, wl, atol=LP_ATOL)
    assert [r for _, r, _ in got] == ["length", "length", "capacity"]
    assert 3 + len(got[2][0]) <= 48


def test_spec_scheduler_eos_matches_jax():
    """An id the model emits as EOS: the request stops inside an accepted
    run with reason 'eos', the EOS not appended, as in the JAX package."""
    probe = SpeculativeScheduler(_sched_engine(), _sched_engine(),
                                 eos_token_id=None)
    q = _run(probe, [[1, 2, 3]], SamplingParams(greedy=True,
                                                max_new_tokens=6))[0]
    eos = q.output_ids[3]
    got = _run(SpeculativeScheduler(_sched_engine(), _sched_engine(),
                                    eos_token_id=eos),
               [[1, 2, 3]], SamplingParams(greedy=True, max_new_tokens=6))[0]
    want = _run(JSpeculativeScheduler(_sched_engine(jax_side=True),
                                      _sched_engine(jax_side=True),
                                      eos_token_id=eos),
                [[1, 2, 3]], JSamplingParams(greedy=True,
                                             max_new_tokens=6))[0]
    assert got.finish_reason == want.finish_reason == "eos"
    assert got.output_ids == want.output_ids == \
        q.output_ids[:q.output_ids.index(eos)]


def test_spec_scheduler_sampled_and_penalized_requests_run():
    """Sampled (mixed with greedy) and penalized submissions run to their
    lengths with in-vocabulary ids; the greedy one equals plain greedy."""
    spec = SpeculativeScheduler(_sched_engine(batch=3),
                                _sched_engine(1, batch=3),
                                eos_token_id=None, num_draft=3)
    g = spec.submit([1, 17, 93, 5], SamplingParams(greedy=True,
                                                   max_new_tokens=10))
    s1 = spec.submit([1, 9, 41], SamplingParams(temperature=0.8, top_k=16,
                                                max_new_tokens=10))
    s2 = spec.submit([1, 5], SamplingParams(temperature=1.1, top_p=0.9,
                                            frequency_penalty=0.2,
                                            max_new_tokens=8))
    spec.run(max_steps=500)
    plain = _sched_engine(batch=3).generate(
        [[1, 17, 93, 5]], SamplingParams(greedy=True, max_new_tokens=10),
        eos_token_id=None).token_ids[0]
    assert g.output_ids == plain
    assert len(s1.output_ids) == 10 and len(s2.output_ids) == 8
    assert all(0 <= t < CFG.vocab_size for t in s1.output_ids + s2.output_ids)


def test_spec_scheduler_dual_prefix_restore():
    """A registered prefix restores into both caches: exact copies of both
    snapshots, equal lengths, and the same ids as a cold scheduler."""
    prefix = list(range(1, 25))
    tails = [[30, 31, 32], [40, 41]]
    sp = SamplingParams(greedy=True, max_new_tokens=8)
    cold = _run(SpeculativeScheduler(_sched_engine(), _sched_engine(1),
                                     eos_token_id=None, num_draft=3),
                [prefix + t for t in tails], sp)
    warm = SpeculativeScheduler(_sched_engine(), _sched_engine(1),
                                eos_token_id=None, num_draft=3)
    entry = warm.register_prefix(prefix)
    assert entry.length == len(prefix)
    store = warm.prefix_store
    assert store.restore(1, entry) == len(prefix)
    for e, snap in ((warm.engine, entry.target), (warm.draft, entry.draft)):
        n = snap.padded_length
        assert torch.equal(e.cache.k[:, 1, :n], snap.k)
        assert torch.equal(e.cache.v[:, 1, :n], snap.v)
        assert e._lengths[1] == e.cache.lengths[1] == len(prefix)
    reqs = _run(warm, [prefix + t for t in tails], sp)
    assert [r.output_ids for r in reqs] == [r.output_ids for r in cold]
    assert all(r.reused_prefix_len == len(prefix) for r in reqs)


def test_spec_refuses_paged_engines():
    kw = dict(max_batch_size=2, max_seq_len=64, kv_layout="paged",
              page_size=16)
    paged = InferenceEngine(CFG, EngineConfig(**kw), _weights(0)[1])
    for make in (SpeculativeScheduler, SpeculativeDecoder):
        with pytest.raises(NotImplementedError, match="slot KV layout"):
            make(paged, _sched_engine())


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def test_server_draft_model_answers_and_reports_acceptance(monkeypatch):
    """``--draft-model debug --device cpu``: main builds a
    SpeculativeScheduler whose draft is quantized like the target (the
    same EngineConfig), answers a completion, and /metrics shows
    ``llm_spec_acceptance_rate`` (1.0: the draft is the target's preset
    and seed)."""
    import threading
    import urllib.request
    made = {}
    real = port_server.make_server

    def make_server(sched, *a, **kw):
        httpd, llm = real(sched, *a, **kw)
        made["sched"] = sched

        def serve_forever():
            threading.Thread(target=type(httpd).serve_forever, args=(httpd,),
                             daemon=True).start()
            made["out"] = _completion(httpd.server_address, max_tokens=6)
            host, port = httpd.server_address
            with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                        timeout=60) as r:
                made["metrics"] = r.read().decode()
            httpd.shutdown()
            raise KeyboardInterrupt
        httpd.serve_forever = serve_forever
        return httpd, llm
    monkeypatch.setattr(port_server, "make_server", make_server)
    assert port_server.main([
        "--model", "debug", "--dummy-weights", "--device", "cpu",
        "--draft-model", "debug", "--num-draft", "3", "--quant", "int8",
        "--max-batch-size", "2", "--max-seq-len", "64", "--port", "0"]) == 0
    sched = made["sched"]
    assert isinstance(sched, SpeculativeScheduler) and sched.k == 3
    assert sched.draft.engine_config == sched.engine.engine_config
    assert made["out"]["usage"]["completion_tokens"] == 6
    assert sched.num_drafted > 0
    assert "llm_spec_acceptance_rate 1.0000" in made["metrics"]

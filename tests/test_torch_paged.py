"""Paged-KV slice parity: the PyTorch port's paged pool, paged attention,
paged engine, continuous-batching scheduler and prefix caches against the
JAX package, on the CPU.

Kernels: the JAX side runs its Pallas kernels in interpret mode
(``kernels="pallas"``; conftest sets interpret mode), the port its plain
versions (CPU tensors). Engines and schedulers: the JAX side runs its XLA
path (``kernels="xla"``) on the ``debug`` preset in f32, with the same
weights crossed over through ``params_from_numpy``. Inputs come from a
numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.ops import attention as j_attn
from llm_inference_engine_tpu.ops import paged_kv as j_pkv
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)
from llm_inference_engine_tpu.runtime.scheduler import (
    ContinuousBatchingScheduler as JScheduler)

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models.registry import create_engine
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops import attention
from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
from llm_inference_engine_tpu_torch.runtime import prefix_cache
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)

L, PAGE, K, D = 2, 16, 8, 128
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _table(rng, B, maxp):
    """A shuffled table over pages 1..B*maxp (page 0 stays scratch)."""
    return rng.permutation(np.arange(1, 1 + B * maxp)).reshape(
        B, maxp).astype(np.int32)


# ---------------------------------------------------------------------------
# kernel H: the paged write
# ---------------------------------------------------------------------------

# (starts, new_len, T) per call, B = 2, page 16, as the engine issues
# them: chunk rows start at a multiple of the chunk size 8 (so they stay
# inside one page), decode rows sit at any in-page offset, new_len == 0
# rows write nothing, and calls 3 and 4 mix chunk and decode rows.
# Sequence 0 ends at 28, sequence 1 at 25.
_WRITES = [
    ([0, 0], [16, 16], 16),
    ([16, 16], [8, 5], 8),
    ([24, 21], [0, 1], 8),
    ([24, 22], [3, 1], 8),
    ([27, 23], [1, 1], 1),
    ([28, 24], [0, 1], 1),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_write_matches_jax_kernel(rng, dtype):
    """Pool L=2, P=9, page 16, K=8, D=128 with a shuffled table. The port
    is bit-exact with the JAX Pallas kernel (interpreted) on every row it
    writes; the rows only the JAX kernel writes are its chunk DMA's
    T-window padding, each at or past its sequence's final length, where
    attention never reads."""
    jd, td, _ = DTYPES[dtype]
    B, maxp = 2, 4
    P = 1 + B * maxp
    table = _table(rng, B, maxp)
    base = rng.normal(size=(L, P, PAGE, K, D)).astype(np.float32)
    jcache = j_pkv.PagedKVCache(
        k=jnp.asarray(base, jd), v=jnp.asarray(-base, jd),
        block_table=jnp.asarray(table), lengths=jnp.zeros((B,), jnp.int32))
    tcache = pkv.PagedKVCache(
        k=torch.from_numpy(base.copy()).to(td),
        v=torch.from_numpy(-base).to(td),
        block_table=torch.from_numpy(table.copy()),
        lengths=torch.zeros((B,), dtype=torch.int32))
    # the (layer, page, row) cells a real write reaches
    real = np.zeros((L, P, PAGE), bool)
    final_len = np.zeros((B,), np.int64)
    for starts, new_len, T in _WRITES:
        starts, new_len = np.array(starts, np.int32), np.array(new_len,
                                                                np.int32)
        for layer in (1, 0):
            nk = rng.normal(size=(B, T, K, D)).astype(np.float32)
            nv = rng.normal(size=(B, T, K, D)).astype(np.float32)
            jcache = j_pkv.paged_update_at_layer(
                jcache, jnp.int32(layer), jnp.asarray(nk, jd),
                jnp.asarray(nv, jd), jnp.asarray(starts),
                jnp.asarray(new_len), kernels="pallas")
            out = pkv.paged_update_at_layer(
                tcache, layer, torch.from_numpy(nk).to(td),
                torch.from_numpy(nv).to(td), torch.from_numpy(starts),
                torch.from_numpy(new_len))
            assert out is tcache                          # in place
        for b in range(B):
            for t in range(new_len[b]):
                pos = starts[b] + t
                real[:, table[b, pos // PAGE], pos % PAGE] = True
            final_len[b] = max(final_len[b], starts[b] + new_len[b])
    for name in ("k", "v"):
        got = _as_np(getattr(tcache, name))
        want = _as_np(getattr(jcache, name))
        start = _as_np(torch.from_numpy(base if name == "k" else -base)
                       .to(td))
        np.testing.assert_array_equal(got[real], want[real])
        np.testing.assert_array_equal(got[~real], start[~real])
        # rows only the JAX kernel wrote: padding past the final lengths
        jax_only = np.argwhere((got != want).any(axis=(-2, -1)))
        assert len(jax_only)
        for layer, page, row in jax_only:
            b, j = np.argwhere(table == page)[0]
            assert j * PAGE + row >= final_len[b], (layer, page, row)


def test_paged_write_refuses_bad_input_on_the_kernel_route():
    c = pkv.new_paged_kv_cache(1, 2, 2, 5, 4, 8, 2)
    new = torch.zeros((2, 1, 2, 8), dtype=torch.bfloat16)
    start = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pkv.paged_update_at_layer(c, 0, new, new, start, kernels="cuda")


def test_page_allocator():
    a = pkv.PageAllocator(8)           # page 0 reserved -> 7 usable
    assert a.free_pages == 7
    got = a.alloc(3)
    assert got == [1, 2, 3]
    a.share(got[:1])
    a.free(got[:2])                    # page 1 keeps one reference
    assert a.free_pages == 5
    a.free(got[:1])
    assert a.free_pages == 6
    with pytest.raises(MemoryError):
        a.alloc(7)
    for bad in ([0], [8], [2]):        # reserved, out of range, double free
        with pytest.raises(ValueError):
            a.free(bad)
    with pytest.raises(ValueError, match="not allocated"):
        a.share([5])


# ---------------------------------------------------------------------------
# kernel D through the table: paged prefill and attend-only decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,window", [(8, None), (8, 20), (1, None),
                                      (1, 20)])
def test_paged_attention_matches_jax_kernel(rng, dtype, T, window):
    """GQA H=16, K=8, D=128, page 16, shuffled table, ragged kv_len with
    row 0 on a page boundary. T > 1: the JAX ``_attn_kernel`` under the
    paged index map; T == 1: its ``_attention_decode_mxu`` with the table
    (``_decode_mxu_kernel``). Both interpreted."""
    jd, td, tol = DTYPES[dtype]
    B, maxp, H = 3, 4, 16
    P = 1 + B * maxp
    table = _table(rng, B, maxp)
    kp = rng.normal(size=(L, P, PAGE, K, D)).astype(np.float32)
    vp = rng.normal(size=(L, P, PAGE, K, D)).astype(np.float32)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    kv_len = np.array([32, 45, 9 if T > 1 else 1], np.int32)
    q_start = kv_len - T
    for layer in range(L):
        want = j_attn.attention(
            jnp.asarray(q, jd), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
            jnp.asarray(q_start), jnp.asarray(kv_len), kernels="pallas",
            block_q=16, block_kv=16, layer=jnp.int32(layer),
            table=jnp.asarray(table), window=window)
        args = (torch.from_numpy(q).to(td), torch.from_numpy(kp).to(td),
                torch.from_numpy(vp).to(td), torch.from_numpy(q_start),
                torch.from_numpy(kv_len))
        if T == 1:
            got = attention.attention_decode(
                *args, layer, table=torch.from_numpy(table), window=window)
        else:
            got = attention.attention(*args, layer=layer, window=window,
                                      table=torch.from_numpy(table))
        assert got.dtype == td and got.shape == (B, T, H, D)
        np.testing.assert_allclose(_as_np(got), _as_np(want), **tol)


def test_decode_gate_refuses_the_paged_pool():
    c = pkv.new_paged_kv_cache(1, 2, 2, 5, 16, 16, 2, dtype=torch.bfloat16)
    assert not attention.can_fuse_decode((2, 1, 4, 16), c)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

_KW = dict(max_batch_size=2, max_seq_len=64, max_prefill_len=8,
           kv_layout="paged", page_size=16)


@pytest.fixture(scope="module")
def weights():
    """JAX dummy params of the debug preset (f32) and the same values as
    port params."""
    cfg = j_get_config("debug")
    jp = j_init_dummy_params(cfg, seed=0)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _engines(weights, **kw):
    jp, tp = weights
    kw = {**_KW, **kw}
    return (JInferenceEngine(j_get_config("debug"),
                             JEngineConfig(kernels="xla", **kw), jp),
            InferenceEngine(get_config("debug"), EngineConfig(**kw), tp))


@pytest.mark.parametrize("stream", [False, True])
def test_paged_engine_generate_matches_jax(weights, stream):
    """A chunked (C=8) and a short prompt: greedy ids, the pages each slot
    holds and the free pages match the JAX paged engine, and reset returns
    every page. The port's paged engine also matches its slot engine."""
    je, te = _engines(weights)
    prompts = [list(range(1, 20)), [9, 8, 7]]
    seen = []
    cb = (lambda i, t: seen.append((i, t))) if stream else None
    rj = je.generate(prompts, JSamplingParams(greedy=True, max_new_tokens=10),
                     eos_token_id=None, stream_callback=cb)
    rt = te.generate(prompts, SamplingParams(greedy=True, max_new_tokens=10),
                     eos_token_id=None, stream_callback=cb)
    assert rt.token_ids == rj.token_ids
    assert te._slot_pages == je._slot_pages
    assert [len(p) for p in te._slot_pages] == [2, 1]
    assert te.free_pages == je.free_pages
    np.testing.assert_array_equal(te.cache.block_table.numpy(),
                                  np.asarray(je.cache.block_table))
    te.reset()
    je.reset()
    assert te.free_pages == je.free_pages == te._allocator.num_pages - 1
    assert not te.cache.block_table.any()
    slot = InferenceEngine(get_config("debug"),
                           EngineConfig(**{**_KW, "kv_layout": "slot"}),
                           weights[1])
    assert slot.generate(prompts, SamplingParams(
        greedy=True, max_new_tokens=10), eos_token_id=None).token_ids \
        == rt.token_ids


@pytest.mark.parametrize("prompt_len", [39, 20])
def test_paged_engine_pool_exhaustion_matches_jax(weights, prompt_len):
    """Two usable pages (32 tokens). A 39-token prompt cannot prefill; a
    20-token prompt prefills, but 20 + 19 tokens of a non-streaming
    generate cannot fit, so both engines raise MemoryError before their
    first decode step."""
    je, te = _engines(weights, num_pages=3)
    prompt = list(range(1, 1 + prompt_len))
    with pytest.raises(MemoryError):
        je.generate([prompt], JSamplingParams(greedy=True,
                                              max_new_tokens=20),
                    eos_token_id=None)
    with pytest.raises(MemoryError):
        te.generate([prompt], SamplingParams(greedy=True, max_new_tokens=20),
                    eos_token_id=None)
    assert te.cache.lengths.tolist() == np.asarray(je.cache.lengths).tolist()
    assert te.free_pages == je.free_pages


def test_paged_engine_refuses_mid_page_append_and_bad_configs(weights):
    _, te = _engines(weights)
    te.generate([[1, 2, 3]], SamplingParams(greedy=True, max_new_tokens=2),
                eos_token_id=None)
    with pytest.raises(ValueError, match="multiple of max_prefill_len"):
        te.prefill([list(range(1, 12))], slots=[0])
    cfg = get_config("debug")
    with pytest.raises(ValueError, match="multiple of max_prefill_len"):
        InferenceEngine(cfg, EngineConfig(**{**_KW, "max_prefill_len": 12}),
                        weights[1])
    capped = InferenceEngine(cfg, EngineConfig(**{**_KW,
                                                  "max_prefill_len": 64}),
                             weights[1])
    assert capped.engine_config.max_prefill_len == PAGE
    assert capped.cache.k.shape == (2, 2 * 4 + 1, PAGE, 2, 16)
    # the int8 pool is ported: int8 values, scale planes beside them
    q8 = create_engine("debug", None, EngineConfig(
        **{**_KW, "kv_cache_dtype_name": "int8"}), device="cpu")
    assert q8.cache.k.dtype == torch.int8 and q8.cache.snapped
    assert q8.cache.k_scale.shape == (2, 2 * 4 + 1, PAGE, 2)


def test_create_engine_passes_the_paged_layout_through(tmp_path, weights):
    """Dummy and .npz engines alike get the paged pool of their config."""
    from llm_inference_engine_tpu_torch.models.weights import save_params
    eng = EngineConfig(**{**_KW, "num_pages": 6})
    dummy = create_engine("debug", None, eng, device="cpu")
    path = str(tmp_path / "w.npz")
    save_params(weights[1], path)
    loaded = create_engine("debug", path, eng, device="cpu")
    for e in (dummy, loaded):
        assert e.paged and e.cache.k.shape[1:3] == (6, PAGE)
        assert e.free_pages == 5


def test_decode_rollout_reserves_pages(weights):
    je, te = _engines(weights)
    lj, lt = je.prefill([[5, 6, 7]]), te.prefill([[5, 6, 7]])
    nj = jnp.argmax(lj, -1).astype(jnp.int32)
    rj = je.decode_rollout(nj, 20)
    rt = te.decode_rollout(torch.from_numpy(np.array(nj)), 20)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert te._slot_pages == je._slot_pages
    assert [len(p) for p in te._slot_pages] == [2, 2]


# ---------------------------------------------------------------------------
# scheduler: load, recompute preemption, admission gated on pages,
# oversized requests, penalty counts across preemption
# ---------------------------------------------------------------------------

def _scenario(name):
    """(engine kwargs, sampling kwargs, prompts) of the JAX package's
    paged scheduler tests (tests/test_paged_kv.py)."""
    greedy = dict(greedy=True)
    if name == "load":
        prompts = [[1 + i, 2 + i, 3 + i, 4 + i] for i in range(5)] \
            + [list(range(10, 30))]
        return {}, dict(greedy, max_new_tokens=7), prompts
    if name == "preemption":
        return (dict(num_pages=4), dict(greedy, max_new_tokens=20),
                [[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]])
    if name == "admission":
        return (dict(num_pages=3), dict(greedy, max_new_tokens=4),
                [list(range(1, 17))] * 2)
    if name == "capacity":
        return (dict(num_pages=2), dict(greedy, max_new_tokens=40),
                [[1, 2, 3]])
    if name == "counts":
        return (dict(num_pages=4),
                dict(greedy, max_new_tokens=20, frequency_penalty=0.7,
                     presence_penalty=0.3, repetition_penalty=1.2),
                [[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]])
    raise KeyError(name)


_SCENARIOS = ["load", "preemption", "admission", "capacity", "counts"]


# each scenario over the bf16 pool and over the int8 pool (snapped scales
# in the port, embedded scale rows in the JAX package)
@pytest.mark.parametrize("name,kv", [
    *[pytest.param(n, "", id=n) for n in _SCENARIOS],
    *[pytest.param(n, "int8", id=f"{n}-int8") for n in _SCENARIOS]])
def test_paged_scheduler_matches_jax(weights, name, kv):
    eng_kw, sp_kw, prompts = _scenario(name)
    je, te = _engines(weights, kv_cache_dtype_name=kv, **eng_kw)
    js, ts = (JScheduler(je, eos_token_id=None),
              ContinuousBatchingScheduler(te, eos_token_id=None))
    jr = [js.submit(p, JSamplingParams(**sp_kw)) for p in prompts]
    tr = [ts.submit(p, SamplingParams(**sp_kw)) for p in prompts]
    js.step()
    ts.step()
    assert [r.slot for r in tr] == [r.slot for r in jr]
    js.run(max_steps=500)
    ts.run(max_steps=500)
    assert all(r.finished for r in tr)
    assert [r.output_ids for r in tr] == [r.output_ids for r in jr]
    assert [r.finish_reason for r in tr] == [r.finish_reason for r in jr]
    assert [r.preemptions for r in tr] == [r.preemptions for r in jr]
    assert te.free_pages == je.free_pages == te._allocator.num_pages - 1
    # what each scenario is there to exercise
    if name in ("preemption", "counts"):
        assert tr[1].preemptions > 0 and tr[0].preemptions == 0
    if name == "admission":
        assert tr[1].ttft is not None
        assert tr[0].output_ids == tr[1].output_ids
    if name == "capacity":
        assert tr[0].finish_reason == "capacity"


def test_paged_scheduler_admission_waits_for_pages(weights):
    _, te = _engines(weights, num_pages=3)          # 2 usable pages
    sched = ContinuousBatchingScheduler(te, eos_token_id=None)
    sp = SamplingParams(greedy=True, max_new_tokens=4)
    a = sched.submit(list(range(1, 17)), sp)        # 16 tokens -> 2 pages
    b = sched.submit(list(range(1, 17)), sp)
    sched.step()
    assert a.slot >= 0 and b.slot == -1             # b gated at admission
    big = sched.submit(list(range(1, 50)), sp)      # never fits the pool
    assert big.finished and big.finish_reason == "rejected"
    sched.run(max_steps=200)
    assert a.finished and b.finished


def test_scheduler_cancel_returns_pages(weights):
    _, te = _engines(weights)
    sched = ContinuousBatchingScheduler(te, eos_token_id=None)
    sp = SamplingParams(greedy=True, max_new_tokens=30)
    r1 = sched.submit(list(range(1, 20)), sp)
    r2 = sched.submit([4, 5, 6], sp)
    r3 = sched.submit([7, 8], sp)                   # waits for a slot
    sched.step()
    assert sched.cancel(r1) and sched.cancel(r3)
    assert not sched.cancel(r1)
    sched.run(max_steps=200)
    assert r1.finish_reason == r3.finish_reason == "cancelled"
    assert r2.finished and len(r2.output_ids) == 30
    assert te.free_pages == te._allocator.num_pages - 1


# ---------------------------------------------------------------------------
# prefix caches
# ---------------------------------------------------------------------------

def test_registered_prefix_matches_jax(weights):
    """A 20-token registered prefix shares its one full page; requests
    starting with it adopt the page and prefill only their tails."""
    _registered_prefix(weights, "")


@pytest.mark.parametrize("kv", ["int8"])
def test_registered_prefix_over_int8_pool_matches_jax(weights, kv):
    """As above over the int8 pool: a shared page shares its scale rows
    (the planes are indexed by page)."""
    _registered_prefix(weights, kv)


def _registered_prefix(weights, kv):
    je, te = _engines(weights, kv_cache_dtype_name=kv)
    js, ts = (JScheduler(je, eos_token_id=None),
              ContinuousBatchingScheduler(te, eos_token_id=None))
    prefix = list(range(40, 60))
    ej, et = js.register_prefix(prefix), ts.register_prefix(prefix)
    assert et.length == ej.length == PAGE and et.pages == ej.pages
    prompts = [prefix + [3, 4, 5], prefix[:PAGE] + [9], [1, 2, 3]]
    sp = dict(greedy=True, max_new_tokens=6)
    jr = [js.submit(p, JSamplingParams(**sp)) for p in prompts]
    tr = [ts.submit(p, SamplingParams(**sp)) for p in prompts]
    js.run(max_steps=200)
    ts.run(max_steps=200)
    assert [r.output_ids for r in tr] == [r.output_ids for r in jr]
    assert [r.reused_prefix_len for r in tr] == [PAGE, PAGE, 0]
    assert [r.reused_prefix_len for r in jr] == [PAGE, PAGE, 0]
    # the store's page stays out of the pool until the entry is evicted
    n = te._allocator.num_pages
    assert te.free_pages == je.free_pages == n - 2
    assert ts.prefix_store.evict(et.tokens)
    assert te.free_pages == n - 1


def test_auto_prefix_cache_matches_jax(weights):
    """Wave 1 finishes and donates its pages; wave 2 resends each wave-1
    conversation plus a suffix (a stateless multi-turn client) and reuses
    the cached pages. Ids and reused lengths match the JAX scheduler, and
    every page is accounted for: free + cached == num_pages - 1."""
    _auto_prefix(weights, "")


@pytest.mark.parametrize("kv", ["int8"])
def test_auto_prefix_cache_over_int8_pool_matches_jax(weights, kv):
    """As above over the int8 pool."""
    _auto_prefix(weights, kv)


def _auto_prefix(weights, kv):
    je, te = _engines(weights, kv_cache_dtype_name=kv)
    js = JScheduler(je, eos_token_id=None, auto_prefix_cache=True)
    ts = ContinuousBatchingScheduler(te, eos_token_id=None,
                                     auto_prefix_cache=True)
    sp = dict(greedy=True, max_new_tokens=6)
    wave1 = [list(range(3, 23)), list(range(100, 118)), [5, 6, 7]]
    jr = [js.submit(p, JSamplingParams(**sp)) for p in wave1]
    tr = [ts.submit(p, SamplingParams(**sp)) for p in wave1]
    js.run(max_steps=200)
    ts.run(max_steps=200)
    assert [r.output_ids for r in tr] == [r.output_ids for r in jr]
    wave2 = [p + r.output_ids + [7, 8, 9] for p, r in zip(wave1, tr)]
    jr2 = [js.submit(p, JSamplingParams(**sp)) for p in wave2]
    tr2 = [ts.submit(p, SamplingParams(**sp)) for p in wave2]
    js.run(max_steps=200)
    ts.run(max_steps=200)
    assert [r.output_ids for r in tr2] == [r.output_ids for r in jr2]
    reused = [r.reused_prefix_len for r in tr2]
    assert reused == [r.reused_prefix_len for r in jr2]
    assert reused[:2] == [PAGE, PAGE]
    ap = ts.auto_prefix
    assert (ap.hits, ap.misses, ap.tokens_reused) == (
        js.auto_prefix.hits, js.auto_prefix.misses,
        js.auto_prefix.tokens_reused)
    assert te.free_pages == je.free_pages
    assert te.free_pages + ap.cached_pages == te._allocator.num_pages - 1
    ap.clear()
    assert te.free_pages == te._allocator.num_pages - 1


def test_slot_prefix_store_is_not_ported(weights):
    """The slot layout's store is ported (the name records the refusal it
    replaced): ``register_prefix`` on a slot engine takes a PrefixStore
    snapshot, and the paged stores still refuse a slot engine."""
    te = InferenceEngine(get_config("debug"),
                         EngineConfig(max_batch_size=2, max_seq_len=64),
                         weights[1])
    sched = ContinuousBatchingScheduler(te, eos_token_id=None)
    entry = sched.register_prefix([1, 2, 3])
    assert isinstance(sched.prefix_store, prefix_cache.PrefixStore)
    assert (entry.tokens, entry.length, entry.padded_length) == (
        (1, 2, 3), 3, 64)
    assert te._lengths.tolist() == [0, 0]
    req = sched.submit([1, 2, 3, 4], SamplingParams(greedy=True,
                                                    max_new_tokens=2))
    sched.run()
    assert req.reused_prefix_len == 3 and len(req.output_ids) == 2
    with pytest.raises(ValueError, match="paged engine"):
        prefix_cache.PagedPrefixStore(te)

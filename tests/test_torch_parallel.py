"""Tensor and data parallelism of the PyTorch port against the JAX package.

The JAX mesh engine runs on the conftest's virtual CPU devices; the port's
mesh is n copies of the CPU device (``make_mesh(..., devices=[cpu] * n)``),
one controller driving every rank's layer body on its local shapes and
summing the row-sharded products between them. On the ``debug`` preset at
f32, for (dp, tp) in (1, 2), (2, 1), (2, 2): the sharded forward's logits
within 1e-5 of JAX's sharded forward, and greedy ids of the mesh engines
equal, over INT4/INT8 weights, the int8 slot cache, the paged pool and
the scheduler with a preemption (the cases of ``tests/test_parallel.py``
and ``tests/test_paged_tp.py``); the int8 pool refused under a mesh with
the JAX package's message; ``validate_mesh``'s messages; the decode
bodies of a mesh engine under ``NoHostReads`` (the CPU proxy for a
capturable step).
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
    init_dummy_params as j_init_dummy_params,
    quantize_params as j_quantize_params)
from llm_inference_engine_tpu.ops import kv_cache as j_kvc
from llm_inference_engine_tpu.parallel import make_mesh as j_make_mesh
from llm_inference_engine_tpu.parallel import sharding as j_sharding
from llm_inference_engine_tpu.parallel.mesh import (
    validate_mesh as j_validate_mesh)
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)
from llm_inference_engine_tpu.runtime.scheduler import (
    ContinuousBatchingScheduler as JScheduler)
from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
from llm_inference_engine_tpu_torch.parallel import make_mesh, sharding
from llm_inference_engine_tpu_torch.parallel.mesh import (
    local_config, validate_mesh)
from llm_inference_engine_tpu_torch.runtime.decode_graph import NoHostReads
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)

CFG_J = j_get_config("debug")        # 4 heads, 2 kv heads, vocab 256, f32
CFG = get_config("debug")
MESHES = [(1, 2), (2, 1), (2, 2)]
CPU = torch.device("cpu")
TOL = 1e-5
PROMPTS = [list(range(1, 20)), [9, 8, 7], [30, 31], list(range(40, 52))]


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _crossed(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp))


def _meshes(dp, tp):
    return (j_make_mesh(dp=dp, tp=tp, devices=jax.devices("cpu")),
            make_mesh(dp, tp, devices=[CPU] * (dp * tp)))


def _engines(dp, tp, jp, seed_params=None, **kw):
    """The JAX mesh engine and the port's, same weights and config."""
    jmesh, mesh = _meshes(dp, tp)
    je = JInferenceEngine(CFG_J, JEngineConfig(kernels="xla", **kw), jp,
                          mesh=jmesh)
    te = InferenceEngine(CFG, EngineConfig(**kw),
                         seed_params or _crossed(jp), mesh=mesh)
    return je, te


@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_forward_matches_jax_mesh(rng, dp, tp):
    """make_sharded_forward over shard_params / shard_cache: a slot cache
    holding a ragged history (random keys and values, a row of none) is
    sharded, a ragged prefill appends to it, then a decode step; logits
    within 1e-5 of the JAX package's sharded forward over the same cache,
    the global and the shards' lengths written."""
    jp = j_init_dummy_params(CFG_J, seed=1)
    B, T, S = 4, 8, 32
    L, K, D = CFG.num_layers, CFG.num_kv_heads, CFG.head_dim
    ids = rng.integers(0, CFG.vocab_size, size=(B, T)).astype(np.int32)
    hist = np.array([3, 0, 6, 2], np.int32)
    lens = hist + np.array([8, 5, 8, 3], np.int32)
    nxt = rng.integers(0, CFG.vocab_size, size=(B, 1)).astype(np.int32)
    k0, v0 = (rng.standard_normal((L, B, S, K, D)).astype(np.float32)
              for _ in "kv")
    jmesh, mesh = _meshes(dp, tp)

    jeng = JEngineConfig(max_batch_size=B, max_seq_len=S, kernels="xla")
    jfwd = jax.jit(j_sharding.make_sharded_forward(CFG_J, jeng, jmesh, jp))
    jsp = j_sharding.shard_params(jp, jmesh)
    jc = j_sharding.shard_cache(j_kvc.KVCache(
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(hist)), jmesh)
    want1, jc = jfwd(jsp, jc, jnp.asarray(ids), jnp.asarray(hist),
                     jnp.asarray(lens))
    want2, _ = jfwd(jsp, jc, jnp.asarray(nxt), jnp.asarray(lens),
                    jnp.asarray(lens + 1))

    fwd = sharding.make_sharded_forward(
        CFG, EngineConfig(max_batch_size=B, max_seq_len=S), mesh)
    sp = sharding.shard_params(_crossed(jp), mesh)
    mc = sharding.shard_cache(kvc.KVCache(
        torch.from_numpy(k0), torch.from_numpy(v0), torch.from_numpy(hist)),
        mesh)
    got1, mc = fwd(sp, mc, torch.from_numpy(ids), torch.from_numpy(hist),
                   torch.from_numpy(lens))
    got2, mc = fwd(sp, mc, torch.from_numpy(nxt), torch.from_numpy(lens),
                   torch.from_numpy(lens + 1))
    for got, want in ((got1, want1), (got2, want2)):
        assert got.shape == (B, CFG.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_array_equal(mc.lengths.numpy(), lens + 1)
    loc = local_config(CFG, mesh)
    for d, row in enumerate(mc.shards):
        rows = mc.rows(d)
        for r, shard in enumerate(row):
            assert shard.k.shape == (L, B // dp, S, loc.num_kv_heads, D)
            np.testing.assert_array_equal(shard.lengths.numpy(),
                                          (lens + 1)[rows])
            # the history the forward did not overwrite is the one sharded
            heads = slice(r * loc.num_kv_heads, (r + 1) * loc.num_kv_heads)
            for b in range(B // dp):
                np.testing.assert_array_equal(
                    shard.k[:, b, :hist[rows][b]].numpy(),
                    k0[:, rows][:, b, :hist[rows][b], heads])


@pytest.mark.parametrize("dp,tp", MESHES)
def test_mesh_engine_generate_matches_jax_over_two_rounds(rng, dp, tp):
    """Greedy ids, logprobs and lengths of the mesh engines over two
    rounds on the same slots (chunked prefill, multi-round history)."""
    jp = j_init_dummy_params(CFG_J, seed=3)
    kw = dict(max_batch_size=4, max_seq_len=96, max_prefill_len=32)
    je, te = _engines(dp, tp, jp, **kw)
    for lens in [(5, 40, 17, 9), (3, 9, 20, 2)]:
        prompts = [rng.integers(3, 256, n).tolist() for n in lens]
        rj = je.generate(prompts, JSamplingParams(greedy=True,
                                                  max_new_tokens=12),
                         eos_token_id=None)
        rt = te.generate(prompts, SamplingParams(greedy=True,
                                                 max_new_tokens=12),
                         eos_token_id=None)
        assert rt.token_ids == rj.token_ids
        np.testing.assert_allclose(np.array(rt.logprobs),
                                   np.array(rj.logprobs), atol=TOL)
        np.testing.assert_array_equal(te.cache.lengths.numpy(),
                                      np.asarray(je.cache.lengths))


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_quantized_weights_at_tp2_match_jax(rng, mode):
    """INT4 (group 32: the row shards of wo, k 64 -> 32, and w_down,
    128 -> 64, hold whole groups) and INT8 weights quantized by the JAX
    package, sharded at tp = 2: prefill logits within 1e-5 and greedy ids
    of the mesh engines equal; INT4's scales follow the contraction
    groups, INT8's stay whole on row shards."""
    jq = j_quantize_params(j_init_dummy_params(CFG_J, seed=2), mode, 32)
    kw = dict(max_batch_size=4, max_seq_len=64)
    je, te = _engines(1, 2, jq, **kw)
    wo = te.params.shards[0][1]["layers"]["wo"]
    assert isinstance(wo, QuantizedTensor)
    if mode == "int4":
        assert wo.q.shape[-2:] == (CFG.q_size // 4, CFG.hidden_size)
        assert wo.scale.shape[-2] == CFG.q_size // 2 // 32
    else:
        assert wo.q.shape[-2] == CFG.q_size // 2
        assert wo.scale.shape[-2] == 1
    prompts = [rng.integers(3, 256, n).tolist() for n in (6, 13, 2, 9)]
    np.testing.assert_allclose(te.prefill(prompts).numpy(),
                               np.asarray(je.prefill(prompts)), atol=TOL,
                               rtol=TOL)
    je.reset()
    te.reset()
    sp = dict(greedy=True, max_new_tokens=10)
    assert (te.generate(prompts, SamplingParams(**sp),
                        eos_token_id=None).token_ids
            == je.generate(prompts, JSamplingParams(**sp),
                           eos_token_id=None).token_ids)


def test_int8_slot_cache_at_tp2_matches_jax(rng):
    """The int8 slot cache under tp = 2: each model rank holds its heads'
    int8 values and scale planes (absmax numerics on the CPU, as the JAX
    package's separate-scale cache); logits and ids equal JAX's."""
    jp = j_init_dummy_params(CFG_J, seed=4)
    kw = dict(max_batch_size=4, max_seq_len=64, kv_cache_dtype_name="int8")
    je, te = _engines(1, 2, jp, **kw)
    for shard in te.cache.shards[0]:
        assert shard.k.dtype == torch.int8 and not shard.snapped
        assert shard.k_scale.shape == (CFG.num_layers, 4, 64, 1)
    prompts = [rng.integers(3, 256, n).tolist() for n in (6, 13, 2, 9)]
    np.testing.assert_allclose(te.prefill(prompts).numpy(),
                               np.asarray(je.prefill(prompts)), atol=TOL,
                               rtol=TOL)
    je.reset()
    te.reset()
    sp = dict(greedy=True, max_new_tokens=10)
    assert (te.generate(prompts, SamplingParams(**sp),
                        eos_token_id=None).token_ids
            == je.generate(prompts, JSamplingParams(**sp),
                           eos_token_id=None).token_ids)


PAGED = dict(max_batch_size=4, max_seq_len=64, max_prefill_len=8,
             kv_layout="paged", page_size=16)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_paged_mesh_generate_matches_jax(dp, tp):
    """The paged pool over a mesh: heads over model, a pool replica per
    data group, the block table uploaded to every group. Ids equal the
    JAX mesh engine's and the one-rank port engine's; page accounting is
    the host's and unchanged."""
    jp = j_init_dummy_params(CFG_J, seed=0)
    sp = dict(greedy=True, max_new_tokens=10)
    je, te = _engines(dp, tp, jp, **PAGED)
    want = je.generate(PROMPTS, JSamplingParams(**sp), eos_token_id=None)
    got = te.generate(PROMPTS, SamplingParams(**sp), eos_token_id=None)
    one = InferenceEngine(CFG, EngineConfig(**PAGED), _crossed(jp),
                          device=CPU)
    assert got.token_ids == want.token_ids == one.generate(
        PROMPTS, SamplingParams(**sp), eos_token_id=None).token_ids
    assert [len(p) for p in te._slot_pages] == [len(p) for p in
                                                je._slot_pages]
    for d, row in enumerate(te.cache.shards):
        for shard in row:
            assert torch.equal(shard.block_table,
                               te.cache.block_table[te.cache.rows(d)])


def _sched_ids(engine, scheduler, prompts, sp):
    sched = scheduler(engine, eos_token_id=None)
    reqs = [sched.submit(p, sp) for p in prompts]
    sched.run()
    return [r.output_ids for r in reqs], reqs


@pytest.mark.parametrize("case", ["round_trip", "preemption"])
def test_paged_mesh_scheduler_matches_jax(case):
    """Continuous batching over a paged dp = 2, tp = 2 engine: admissions,
    chunked prefill, decode, completion; and under a pool of 8 pages,
    recompute preemption. Ids equal the JAX mesh scheduler's and, for the
    pressured pool, an unpressured one-rank run's."""
    jp = j_init_dummy_params(CFG_J, seed=0)
    if case == "round_trip":
        prompts, n, kw = PROMPTS, 6, PAGED
    else:
        prompts = [list(range(1, 17)), list(range(20, 36)),
                   list(range(40, 56)), list(range(60, 76))]
        n, kw = 8, dict(PAGED, num_pages=8)
    je, te = _engines(2, 2, jp, **kw)
    want, _ = _sched_ids(je, JScheduler, prompts,
                         JSamplingParams(greedy=True, max_new_tokens=n))
    got, reqs = _sched_ids(te, ContinuousBatchingScheduler, prompts,
                           SamplingParams(greedy=True, max_new_tokens=n))
    assert got == want
    if case == "preemption":
        assert sum(r.preemptions for r in reqs) > 0
        free = InferenceEngine(CFG, EngineConfig(**PAGED), _crossed(jp),
                               device=CPU)
        solo, _ = _sched_ids(free, ContinuousBatchingScheduler, prompts,
                             SamplingParams(greedy=True, max_new_tokens=n))
        assert got == solo


def test_int8_pool_under_a_mesh_is_refused_as_in_jax():
    jp = j_init_dummy_params(CFG_J, seed=0)
    kw = dict(PAGED, kv_cache_dtype_name="int8")
    with pytest.raises(NotImplementedError) as want:
        JInferenceEngine(CFG_J, JEngineConfig(kernels="xla", **kw), jp,
                         mesh=_meshes(1, 2)[0])
    with pytest.raises(NotImplementedError, match="scale") as got:
        InferenceEngine(CFG, EngineConfig(tp=2, **kw), _crossed(jp),
                        device=CPU)
    assert str(got.value) == str(want.value)
    # the slot int8 cache and the bf16 pool are not refused
    InferenceEngine(CFG, EngineConfig(tp=2, **PAGED), _crossed(jp),
                    device=CPU)


@pytest.mark.parametrize("dp,tp,cfg_kw,batch", [
    (1, 4, {}, 4),                                  # 2 kv heads % 4
    (4, 2, {}, 6),                                  # batch 6 % dp 4
    (1, 8, dict(intermediate_size=132, vocab_size=250), 4),
])
def test_validate_mesh_messages_match_jax(dp, tp, cfg_kw, batch):
    jmesh, mesh = _meshes(dp, tp)
    with pytest.raises(ValueError) as want:
        j_validate_mesh(CFG_J.replace(**cfg_kw),
                        JEngineConfig(max_batch_size=batch), jmesh)
    with pytest.raises(ValueError, match="mesh/config mismatch") as got:
        validate_mesh(CFG.replace(**cfg_kw), EngineConfig(
            max_batch_size=batch), mesh)
    assert str(got.value) == str(want.value)


def test_int4_row_shards_must_hold_whole_groups():
    """The check the port adds: llama2-7b's down projection at tp = 4 is
    2752 rows a rank, 21.5 groups of 128."""
    cfg = get_config("llama2-7b")
    mesh = make_mesh(1, 4, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="w_down row shard k 11008 / tp 4 "
                       "= 2752 % group_size 128"):
        validate_mesh(cfg, EngineConfig(quant_mode="int4"), mesh)
    validate_mesh(cfg, EngineConfig(quant_mode="int4"),
                  make_mesh(1, 2, devices=[CPU] * 2))
    t = QuantizedTensor(torch.zeros(64, 8, dtype=torch.int8),
                        torch.ones(4, 8), "int4", 32)
    with pytest.raises(ValueError, match="splits a scale group"):
        t.rows(0, 48)
    with pytest.raises(ValueError, match="need 4 devices for dp=2 tp=2, "
                       "have 1"):
        make_mesh(2, 2, devices=[CPU])


def test_engine_config_describes_the_mesh_it_runs_on():
    """A mesh comes from one place: the engine's config carries the dp/tp
    of a mesh= or of ShardedParams; a mesh= other than the params' mesh,
    or a dp/tp that disagrees with the mesh, raises."""
    jp = j_init_dummy_params(CFG_J, seed=0)
    eng = EngineConfig(max_batch_size=2, max_seq_len=32)
    tp2 = make_mesh(1, 2, devices=[CPU] * 2)
    sp = sharding.shard_params(_crossed(jp), tp2)
    by_params = InferenceEngine(CFG, eng, sp)
    assert by_params.mesh is tp2
    assert (by_params.engine_config.dp, by_params.engine_config.tp) == (1, 2)
    by_mesh = InferenceEngine(CFG, eng, _crossed(jp), mesh=make_mesh(
        2, 1, devices=[CPU] * 2))
    assert (by_mesh.engine_config.dp, by_mesh.engine_config.tp) == (2, 1)
    # the same ranks on the same devices is the same mesh
    InferenceEngine(CFG, eng.replace(tp=2), sp,
                    mesh=make_mesh(1, 2, devices=[CPU] * 2))
    with pytest.raises(ValueError, match="sharded over another mesh"):
        InferenceEngine(CFG, eng, sp, mesh=make_mesh(2, 1,
                                                     devices=[CPU] * 2))
    with pytest.raises(ValueError, match="dp=1 tp=2 disagrees with the "
                       "mesh's dp=2 tp=1"):
        InferenceEngine(CFG, eng.replace(tp=2), _crossed(jp),
                        mesh=make_mesh(2, 1, devices=[CPU] * 2))


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_mesh_decode_bodies_read_nothing_on_the_host(layout):
    """The decode bodies of a dp = 2, tp = 2 engine (the step, the greedy
    and the sampled rollout step) under NoHostReads: a mesh on one card
    captures them into CUDA graphs as a one-rank engine's."""
    kw = dict(max_batch_size=4, max_seq_len=64)
    if layout == "paged":
        kw.update(max_prefill_len=8, kv_layout="paged", page_size=16)
    jp = j_init_dummy_params(CFG_J, seed=0)
    te = InferenceEngine(CFG, EngineConfig(dp=2, tp=2, **kw), _crossed(jp),
                         device=CPU)
    te.prefill(PROMPTS)
    te.ensure_capacity(te._lengths + 4)
    arrays = te._host_arrays(SamplingParams(temperature=0.7, top_k=5,
                                            repetition_penalty=1.2))
    te._stage(np.array([5, 6, 7, 8]), np.ones(4, bool), arrays)
    for name in ("step", "greedy", "sampled"):
        with NoHostReads(name):
            getattr(te, f"_{name}_body")()

"""Pipeline parallelism of the PyTorch port against the JAX package.

A (pipe, data, model) mesh of copies of the CPU: stage s holds layers
[s*L/pp, (s+1)*L/pp) of the weights and the cache, with their
tensor-parallel shards, and hands its (down, residual) pair to the next
stage (``parallel/pipeline.py``). The JAX test's config (64 wide, 4
layers, 8 heads over 4 kv heads, f32), its weights carried across: a
prefill and a decode step within 2e-4 of the JAX single-device forward
for (pp, dp, tp) in (2, 2, 2), (4, 1, 2), (2, 1, 1), and of one JAX
pp = 2 forward; bit for bit against the port's own forward without the
pipe axis (one device at tp = 1, ``make_sharded_forward`` at tp > 1),
the cache rows of every stage included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import ModelConfig as JModelConfig
from llm_inference_engine_tpu.models import llama as JM
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.ops import kv_cache as j_kvc
from llm_inference_engine_tpu.parallel import pipeline as JPP
from llm_inference_engine_tpu.utils import cpu_devices
from llm_inference_engine_tpu_torch.config import EngineConfig, ModelConfig
from llm_inference_engine_tpu_torch.models import llama as M
from llm_inference_engine_tpu_torch.models.weights import (
    params_from_numpy, quantize_params)
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.parallel import make_mesh, sharding
from llm_inference_engine_tpu_torch.parallel import pipeline as PP

SHAPE = dict(name="pp-test", vocab_size=128, hidden_size=64,
             intermediate_size=128, num_layers=4, num_heads=8,
             num_kv_heads=4, head_dim=8, dtype_name="float32")
CFG_J, CFG = JModelConfig(**SHAPE), ModelConfig(**SHAPE)
CPU = torch.device("cpu")
TOL = 2e-4
S = 32


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jp():
    return j_init_dummy_params(CFG_J, seed=0, scale=0.3)


def _inputs(B):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG.vocab_size, size=(B, 6)).astype(np.int32)
    return ids, np.zeros((B,), np.int32), np.full((B,), 6, np.int32)


def _new_cache(B):
    return kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads, S,
                            CFG.head_dim, dtype=torch.float32)


def _stage_rows(caches, name="k"):
    """The stages' caches joined back into [L, B, S, K, D]."""
    stages = []
    for c in caches:
        rows = [torch.cat([getattr(sh, name) for sh in row], dim=3)
                for row in c.shards]
        stages.append(torch.cat(rows, dim=1))
    return torch.cat(stages, dim=0)


def _run_pp(params, pp, dp, tp, B, ids, q0, lens):
    mesh = PP.make_pp_mesh(pp, dp, tp, devices=[CPU] * (pp * dp * tp))
    assert mesh.shape == {"pipe": pp, "data": dp, "model": tp}
    eng = EngineConfig(max_batch_size=B, max_seq_len=S)
    fwd = PP.make_pp_forward(CFG, eng, mesh)
    sp = PP.shard_params_pp(params, mesh)
    caches = PP.shard_cache_pp(_new_cache(B), mesh)
    got1, caches = fwd(sp, caches, ids, q0, lens)
    tok = got1.argmax(-1).to(torch.int32)[:, None]
    got2, caches = fwd(sp, caches, tok, lens.clone(), lens + 1)
    return got1, got2, tok, caches


def _run_flat(params, dp, tp, B, ids, q0, lens, tok):
    """The port's forward without the pipe axis: one device at tp = 1
    (dp = 1), make_sharded_forward otherwise."""
    eng = EngineConfig(max_batch_size=B, max_seq_len=S)
    if dp * tp == 1:
        cache = _new_cache(B)
        out1, cache = M.forward_hidden(CFG, eng, params, ids, cache, q0,
                                       lens)
        out2, cache = M.forward_hidden(CFG, eng, params, tok, cache,
                                       lens.clone(), lens + 1)
        return out1, out2, cache.k, cache.v
    mesh = make_mesh(dp, tp, devices=[CPU] * (dp * tp))
    fwd = sharding.make_sharded_forward(CFG, eng, mesh)
    sp = sharding.shard_params(params, mesh)
    mc = sharding.shard_cache(_new_cache(B), mesh)
    out1, mc = fwd(sp, mc, ids, q0, lens)
    out2, mc = fwd(sp, mc, tok, lens.clone(), lens + 1)
    return out1, out2, _stage_rows([mc], "k"), _stage_rows([mc], "v")


@pytest.mark.parametrize("pp,dp,tp", [(2, 2, 2), (4, 1, 2), (2, 1, 1)])
def test_pp_forward_matches_jax_and_the_flat_forward(jp, pp, dp, tp):
    B = max(2, dp)
    ids, q0, lens = _inputs(B)
    eng_j = JEngineConfig(max_batch_size=B, max_seq_len=S, kernels="xla")
    cache0 = j_kvc.new_kv_cache(CFG_J.num_layers, B, CFG_J.num_kv_heads, S,
                                CFG_J.head_dim, dtype=CFG_J.dtype)
    want1, jcache = JM.forward_hidden(CFG_J, eng_j, jp, jnp.asarray(ids),
                                      cache0, jnp.asarray(q0),
                                      jnp.asarray(lens))

    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    t = [torch.from_numpy(a) for a in (ids, q0, lens)]
    got1, got2, tok, caches = _run_pp(params, pp, dp, tp, B, *t)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=TOL,
                               rtol=TOL)
    want2, jcache = JM.forward_hidden(CFG_J, eng_j, jp,
                                      jnp.asarray(tok.numpy()), jcache,
                                      jnp.asarray(lens),
                                      jnp.asarray(lens + 1))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(_stage_rows(caches).numpy(),
                               np.asarray(jcache.k), atol=TOL, rtol=TOL)

    flat1, flat2, k, v = _run_flat(params, dp, tp, B, *t, tok)
    assert torch.equal(got1, flat1) and torch.equal(got2, flat2)
    assert torch.equal(_stage_rows(caches, "k"), k)
    assert torch.equal(_stage_rows(caches, "v"), v)
    for c in caches:
        assert c.lengths.tolist() == (lens + 1).tolist()


def test_pp_forward_matches_a_jax_pp_forward(jp):
    """One JAX pp = 2 forward (its SPMD ticks and gated writes) against
    the port's real ticks."""
    B = 2
    ids, q0, lens = _inputs(B)
    jmesh = JPP.make_pp_mesh(pp=2, dp=1, tp=1, devices=cpu_devices(2))
    eng_j = JEngineConfig(max_batch_size=B, max_seq_len=S, kernels="xla")
    sparams = JPP.shard_params_pp(jp, jmesh)
    scache = JPP.shard_cache_pp(j_kvc.new_kv_cache(
        CFG_J.num_layers, B, CFG_J.num_kv_heads, S, CFG_J.head_dim,
        dtype=CFG_J.dtype), jmesh)
    fwd = jax.jit(JPP.make_pp_forward(CFG_J, eng_j, jmesh, sparams))
    want, jcache = fwd(sparams, scache, jnp.asarray(ids), jnp.asarray(q0),
                       jnp.asarray(lens))
    tok = jnp.argmax(want, axis=-1).astype(jnp.int32)[:, None]
    want2, jcache = fwd(sparams, jcache, tok, jnp.asarray(lens),
                        jnp.asarray(lens + 1))
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    got, got2, ttok, caches = _run_pp(params, 2, 1, 1, B,
                                      *(torch.from_numpy(a) for a in
                                        (ids, q0, lens)))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))
    for g, w in ((got, want), (got2, want2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_allclose(_stage_rows(caches, "v").numpy(),
                               np.asarray(jcache.v), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_pp_quantized_stages_are_views_and_bit_exact(jp, mode):
    """Quantized stacked weights split over the stages as views of the
    one-device leaves (no copy at tp = 1); logits and cache rows bit for
    bit against the one-device forward."""
    B = 2
    params = quantize_params(params_from_numpy(jax.tree.map(np.asarray, jp)),
                             mode, 32)
    mesh = PP.make_pp_mesh(2, 1, 1, devices=[CPU] * 2)
    sp = PP.shard_params_pp(params, mesh)
    wo = params["layers"]["wo"]
    stage1 = sp[1].shards[0][0]["layers"]["wo"]
    assert stage1.q.data_ptr() == wo.q[2].data_ptr()
    assert stage1.q.shape[0] == CFG.num_layers // 2
    t = [torch.from_numpy(a) for a in _inputs(B)]
    got1, got2, tok, caches = _run_pp(params, 2, 1, 1, B, *t)
    flat1, flat2, k, _ = _run_flat(params, 1, 1, B, *t, tok)
    assert torch.equal(got1, flat1) and torch.equal(got2, flat2)
    assert torch.equal(_stage_rows(caches), k)


def test_pp_mesh_and_layer_split_checks():
    with pytest.raises(ValueError, match="need 8 devices for pp=2 dp=2 "
                       "tp=2, have 4"):
        PP.make_pp_mesh(2, 2, 2, devices=[CPU] * 4)
    mesh = PP.make_pp_mesh(3, 1, 1, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="num_layers 4 % pp 3"):
        PP.make_pp_forward(CFG, EngineConfig(max_batch_size=2,
                                             max_seq_len=S), mesh)
    specs = PP.pp_param_pspecs({"layers": {"wo": None, "wqkv": None}})
    assert specs["layers"] == {"wo": ("pipe", "rows"),
                               "wqkv": ("pipe", "columns")}
    assert PP.pp_cache_pspecs(True)["k_scale"] == ("pipe", "data", None,
                                                   "model")

"""The model families under tensor parallelism on the CPU: a Qwen2-like
model (the packed qkv bias, 14 heads over 2 kv heads: G = 7 and one kv
head a rank at tp = 2), a Mistral-like one (a sliding window of 6) and a
Llama-3.1-like one (its RoPE scaling past an original context of 16),
each split over a mesh and held against the JAX package's mesh on the
same weights.

The JAX meshes run on the conftest's virtual CPU devices, the port's on
``[cpu] * n``. Held for each family at (dp, tp) = (1, 2), and for the
Qwen2-like model also at (2, 2): ``make_sharded_forward`` over a ragged
history and a decode step, logits within 1e-5 at f32; and a control, the
family's feature switched off, whose sharded logits must miss JAX's by
far (the check could see the feature). For the Qwen2-like model also a
fault control: its ``bqkv`` shards taken in another order than the
group-major one of ``wqkv`` must miss JAX's by far. And the full presets
split over meshes as the JAX package splits them (``validate_mesh``).
The mesh engines' greedy ids (slot and paged layouts, INT4 weights at tp = 2) are
``tests/test_torch_model_families_tp_engines.py``'s: each file's JAX
compiles stay small in its test worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import RopeScaling as JRopeScaling
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.ops import kv_cache as j_kvc
from llm_inference_engine_tpu.parallel import make_mesh as j_make_mesh
from llm_inference_engine_tpu.parallel import sharding as j_sharding

from llm_inference_engine_tpu_torch.config import EngineConfig
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.parallel import make_mesh, sharding
from llm_inference_engine_tpu_torch.parallel.mesh import local_config
from test_torch_model_families import (  # noqa: F401 (a fixture)
    _port_cfg, _torch_threads)

# each family's feature on the debug preset; its switch-off for the
# control. The Qwen2-like model has 2 kv heads so that tp = 2 splits them
FAMILIES = {
    "qwen2": (dict(attention_bias=True, num_heads=14, num_kv_heads=2,
                   head_dim=32), dict(attention_bias=False)),
    "mistral": (dict(sliding_window=6), dict(sliding_window=None)),
    "llama3.1": (dict(rope_scaling=JRopeScaling(8.0, 1.0, 4.0, 16)),
                 dict(rope_scaling=None)),
}
FORWARD_MESHES = [("qwen2", 1, 2), ("qwen2", 2, 2), ("mistral", 1, 2),
                  ("llama3.1", 1, 2)]
CPU = torch.device("cpu")
TOL = 1e-5
# a control must miss JAX's logits by this much (100x the tolerance)
FAR = 100 * TOL
B, T, S = 4, 8, 48
# the histories pass the window of 6 and the original context of 16
HIST = np.array([3, 0, 20, 30], np.int32)
NEW = np.array([8, 5, 8, 3], np.int32)


def j_cfg(family: str):
    return j_get_config("debug").replace(name=f"debug-{family}",
                                         **FAMILIES[family][0])


def meshes(dp: int, tp: int):
    return (j_make_mesh(dp=dp, tp=tp, devices=jax.devices("cpu")),
            make_mesh(dp, tp, devices=[CPU] * (dp * tp)))


def crossed(jp) -> dict:
    return params_from_numpy(jax.tree.map(np.asarray, jp))


def feature_off(cfg, params: dict, family: str):
    """The control's config and params: the family's feature switched off
    (no bias tensor for the Qwen2-like model's)."""
    cfg = cfg.replace(**FAMILIES[family][1])
    if family == "qwen2":
        params = {**params, "layers": {k: v for k, v in
                                       params["layers"].items()
                                       if k != "bqkv"}}
    return cfg, params


def strided_bias(sp: sharding.ShardedParams, bqkv: torch.Tensor,
                 head_dim: int) -> None:
    """The fault: every rank's ``bqkv`` replaced by every tp-th head_dim
    block of the whole bias (rank r: blocks r, r + tp, ...). ``wqkv``'s
    columns, and the contiguous half that ``shard_params`` takes, are
    group-major ([K, G + 2, D]: each rank's kv groups whole); this split
    hands each rank half of every group's q, k and v biases instead."""
    tp = sp.mesh.tp
    blocks = bqkv.reshape(bqkv.shape[0], -1, head_dim)
    for row in sp.shards:
        for r, shard in enumerate(row):
            shard["layers"]["bqkv"] = blocks[:, r::tp].reshape(
                bqkv.shape[0], -1).contiguous()


def port_logits(cfg, sp, mesh, k0, v0, steps):
    """The port's sharded forward over a sharded copy of (k0, v0): each of
    ``steps`` (ids, q_start, kv_len) in turn; the logits of each."""
    fwd = sharding.make_sharded_forward(
        cfg, EngineConfig(max_batch_size=B, max_seq_len=S), mesh)
    mc = sharding.shard_cache(kvc.KVCache(
        torch.from_numpy(k0), torch.from_numpy(v0),
        torch.from_numpy(HIST)), mesh)
    out = []
    for ids, qs, kl in steps:
        got, mc = fwd(sp, mc, torch.from_numpy(ids), torch.from_numpy(qs),
                      torch.from_numpy(kl))
        out.append(got.numpy())
    return out, mc


@pytest.mark.parametrize("family,dp,tp", FORWARD_MESHES)
def test_sharded_forward_matches_jax_mesh(rng, family, dp, tp):
    """A slot cache holding a ragged history (random rows, a row of none)
    is sharded, a ragged prefill appends to it, then a decode step: the
    port's sharded logits within 1e-5 of the JAX mesh's, the shards'
    lengths written; then the control: the same steps with the family's
    feature off miss JAX's logits by more than FAR."""
    cfg_j = j_cfg(family)
    cfg = _port_cfg(cfg_j)
    jp = j_init_dummy_params(cfg_j, seed=1)
    L, K, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    lens = HIST + NEW
    steps = [(rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32),
              HIST, lens),
             (rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32),
              lens, lens + 1)]
    k0, v0 = (rng.standard_normal((L, B, S, K, D)).astype(np.float32)
              for _ in "kv")
    jmesh, mesh = meshes(dp, tp)

    jeng = JEngineConfig(max_batch_size=B, max_seq_len=S, kernels="xla")
    jfwd = jax.jit(j_sharding.make_sharded_forward(cfg_j, jeng, jmesh, jp))
    jc = j_sharding.shard_cache(j_kvc.KVCache(
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(HIST)), jmesh)
    jsp = j_sharding.shard_params(jp, jmesh)
    want = []
    for ids, qs, kl in steps:
        w, jc = jfwd(jsp, jc, jnp.asarray(ids), jnp.asarray(qs),
                     jnp.asarray(kl))
        want.append(np.asarray(w))

    params = crossed(jp)
    got, mc = port_logits(cfg, sharding.shard_params(params, mesh), mesh,
                          k0, v0, steps)
    for g, w in zip(got, want):
        assert g.shape == (B, cfg.vocab_size)
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(mc.lengths.numpy(), lens + 1)
    loc = local_config(cfg, mesh)
    assert loc.num_kv_heads == K // tp
    for d, row in enumerate(mc.shards):
        for shard in row:
            assert shard.k.shape == (L, B // dp, S, K // tp, D)
            np.testing.assert_array_equal(shard.lengths.numpy(),
                                          (lens + 1)[mc.rows(d)])

    cfg_off, params_off = feature_off(cfg, params, family)
    off, _ = port_logits(cfg_off, sharding.shard_params(params_off, mesh),
                         mesh, k0, v0, steps)
    moved = max(np.abs(o - w).max() for o, w in zip(off, want))
    assert moved > FAR, (family, moved)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_bias_split_out_of_group_order_misses_jax(rng, dp, tp):
    """The Qwen2-like bias must be split as ``wqkv`` is: each rank's
    ``bqkv`` shard is its kv groups' [G + 2, D] rows, the JAX package's
    column split (``parallel/sharding.py``). The same forward over shards
    whose bias blocks are dealt out one head_dim block at a time
    (``strided_bias``) misses the JAX mesh's logits by more than FAR,
    while the group-major shards agree within 1e-5: the parity check can
    see a bias split in the wrong order."""
    cfg_j = j_cfg("qwen2")
    cfg = _port_cfg(cfg_j)
    jp = j_init_dummy_params(cfg_j, seed=2)
    L, K, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    steps = [(rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32),
              HIST, HIST + NEW)]
    k0, v0 = (rng.standard_normal((L, B, S, K, D)).astype(np.float32)
              for _ in "kv")
    jmesh, mesh = meshes(dp, tp)
    jeng = JEngineConfig(max_batch_size=B, max_seq_len=S, kernels="xla")
    jfwd = jax.jit(j_sharding.make_sharded_forward(cfg_j, jeng, jmesh, jp))
    jc = j_sharding.shard_cache(j_kvc.KVCache(
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(HIST)), jmesh)
    ids, qs, kl = steps[0]
    want, _ = jfwd(j_sharding.shard_params(jp, jmesh), jc, jnp.asarray(ids),
                   jnp.asarray(qs), jnp.asarray(kl))
    want = np.asarray(want)

    params = crossed(jp)
    sp = sharding.shard_params(params, mesh)
    G = cfg.num_heads // K
    for r, shard in enumerate(sp.shards[0]):
        # the rank's bias is its kv group's [G + 2, D] rows, as its wqkv
        # columns are
        bias = shard["layers"]["bqkv"]
        assert bias.shape == (L, (K // tp) * (G + 2) * D)
        assert torch.equal(bias, params["layers"]["bqkv"].reshape(
            L, K, G + 2, D)[:, r * K // tp:(r + 1) * K // tp].reshape(L, -1))
    (good,), _ = port_logits(cfg, sp, mesh, k0, v0, steps)
    np.testing.assert_allclose(good, want, atol=TOL, rtol=TOL)
    strided_bias(sp, params["layers"]["bqkv"], D)
    (bad,), _ = port_logits(cfg, sp, mesh, k0, v0, steps)
    assert np.abs(bad - want).max() > FAR


@pytest.mark.parametrize("name", ["qwen2-7b", "llama3.1-8b", "mistral-7b"])
def test_family_presets_split_over_meshes_as_in_jax(name):
    """The families' full presets over (dp, tp) = (1, 2), (2, 2), (1, 4)
    and (1, 8): ``validate_mesh`` passes where the JAX package's passes
    and refuses with its message where it refuses (Qwen2-7B's 4 kv heads
    and Llama-3.1-8B's and Mistral-7B's 8 over tp = 8); INT4 at group 128
    at tp = 2, which chip_smoke 4w runs, passes in both."""
    from llm_inference_engine_tpu.parallel.mesh import (
        validate_mesh as j_validate_mesh)
    from llm_inference_engine_tpu_torch.config import get_config
    from llm_inference_engine_tpu_torch.parallel.mesh import validate_mesh
    cfg, cfg_j = get_config(name), j_get_config(name)
    for dp, tp in ((1, 2), (2, 2), (1, 4), (1, 8)):
        jmesh, mesh = meshes(dp, tp)
        want = got = None
        try:
            j_validate_mesh(cfg_j, JEngineConfig(max_batch_size=8), jmesh)
        except ValueError as e:
            want = str(e)
        try:
            validate_mesh(cfg, EngineConfig(max_batch_size=8), mesh)
        except ValueError as e:
            got = str(e)
        assert got == want, (name, dp, tp)
        assert (want is None) == (cfg.num_kv_heads % tp == 0)
    jmesh, mesh = meshes(1, 2)
    j_validate_mesh(cfg_j, JEngineConfig(quant_mode="int4",
                                         quant_group_size=128), jmesh)
    validate_mesh(cfg, EngineConfig(quant_mode="int4", quant_group_size=128),
                  mesh)

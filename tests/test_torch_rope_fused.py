"""Kernel J's wrapper (``ops.rope.split_qkv_rope_fused``, the QKV split
with RoPE) on the CPU, where it runs its plain version, against the JAX
package's ``split_qkv_rope_xla`` and a float64 numpy golden; and the
decoder's taps around it against the JAX engine's dumps.

Inputs are drawn with numpy and handed to both packages. Tolerances: in
float32 both packages compute the Cody-Waite angles and the rotation in
f32 and differ by an ulp of their libraries' cos/sin (2e-5); bf16 and
f16 outputs round once, so such an ulp may move a value by one step of
the output type (2^-7 / 2^-10 relative). Against ``np_rope`` (float64
angles) the bound is 1e-5 at the first positions, where the f32 angles
carry no error above that (``tests/test_torch_ops.py`` holds the long
positions to the Cody-Waite limit)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import RopeScaling as JRopeScaling
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.ops import rope as j_rope
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)
from llm_inference_engine_tpu.utils import debug as j_debug

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, RopeScaling, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models import llama
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops import counted_wrappers, rope
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.utils import debug

from test_ops_rope import np_rope

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.float16: dict(atol=1e-4, rtol=2.0 ** -10),
       torch.bfloat16: dict(atol=1e-3, rtol=2.0 ** -7)}
JNP = {torch.float32: jnp.float32, torch.float16: jnp.float16,
       torch.bfloat16: jnp.bfloat16}
SCALING = {"none": (None, None), "linear": (4.0, 4.0),
           "llama3": (RopeScaling(), JRopeScaling())}


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _fused(qkv, pos, H, K, D, theta=10000.0, scaling=None, **kw):
    """The decoder's call: cos/sin once (``rope_tables``' [B, T, 1, D/2]),
    then J's wrapper."""
    cos, sin = rope.rope_cos_sin(pos, D, theta, scaling)
    return rope.split_qkv_rope_fused(qkv, cos[..., None, :],
                                     sin[..., None, :], H, K, D, **kw)


def _positions(rng, B, T, kind):
    if kind == "long":        # up to 2^20
        return rng.integers(0, 1 << 20, size=(B, T)).astype(np.int32)
    if kind == "negative":
        return rng.integers(-5000, 5000, size=(B, T)).astype(np.int32)
    return (np.arange(T, dtype=np.int32)[None, :] + 100 * np.arange(B)[:, None]
            ).astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16], ids=str)
@pytest.mark.parametrize("G,D", [(1, 16), (4, 64), (8, 128), (1, 128),
                                 (8, 16)])
@pytest.mark.parametrize("kind", ["short", "long", "negative"])
def test_fused_split_rope_matches_jax(rng, dtype, G, D, kind):
    """q, k, v of the port's wrapper against JAX ``split_qkv_rope_xla``
    over groups, head dims, positions (up to 2^20, negative) and dtypes."""
    B, T, K = 2, 5, 2
    H = K * G
    x = rng.normal(size=(B, T, K * (G + 2) * D)).astype(np.float32)
    pos = _positions(rng, B, T, kind)
    qkv = torch.from_numpy(x).to(dtype)
    got = _fused(qkv, torch.from_numpy(pos), H, K, D)
    want = j_rope.split_qkv_rope_xla(jnp.asarray(x).astype(JNP[dtype]),
                                     jnp.asarray(pos), H, K, D)
    for g, w, shape in zip(got, want, ((B, T, H, D), (B, T, K, D),
                                       (B, T, K, D))):
        assert tuple(g.shape) == shape and g.dtype == dtype
        assert g.is_contiguous()
        np.testing.assert_allclose(
            _as_np(g), np.asarray(w.astype(jnp.float32)), **TOL[dtype])


@pytest.mark.parametrize("scaling", ["linear", "llama3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_fused_split_rope_scaling_matches_jax(rng, scaling, dtype):
    B, T, K, G, D = 2, 9, 2, 4, 128
    H = K * G
    tsc, jsc = SCALING[scaling]
    x = rng.normal(size=(B, T, K * (G + 2) * D)).astype(np.float32)
    pos = rng.integers(0, 20000, size=(B, T)).astype(np.int32)
    got = _fused(torch.from_numpy(x).to(dtype), torch.from_numpy(pos), H, K,
                 D, 500000.0, tsc)
    want = j_rope.split_qkv_rope_xla(jnp.asarray(x).astype(JNP[dtype]),
                                     jnp.asarray(pos), H, K, D, 500000.0,
                                     jsc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            _as_np(g), np.asarray(w.astype(jnp.float32)), **TOL[dtype])


@pytest.mark.parametrize("G,D", [(1, 16), (4, 64), (8, 128)])
def test_fused_split_rope_matches_numpy_golden(rng, G, D):
    """float32, positions 0-3: within 1e-5 of the float64 rotation."""
    T, K = 4, 2
    H = K * G
    x = rng.normal(size=(T, K * (G + 2) * D)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32)
    q, k, v = _fused(torch.from_numpy(x), torch.from_numpy(pos), H, K, D)
    z = x.reshape(T, K, G + 2, D)
    np.testing.assert_allclose(q.numpy(), np_rope(
        z[:, :, :G].reshape(T, H, D), pos, 10000.0), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(k.numpy(), np_rope(z[:, :, G], pos, 10000.0),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(v.numpy(), z[:, :, G + 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16], ids=str)
@pytest.mark.parametrize("G,D", [(1, 16), (4, 64), (8, 128)])
def test_fused_split_rope_is_the_glue_bit_for_bit(rng, dtype, G, D):
    """On the CPU the wrapper is the split, two rotations and v's copy that
    the decoder ran before kernel J, step for step."""
    B, T, K = 3, 7, 2
    H = K * G
    qkv = torch.from_numpy(rng.normal(
        size=(B, T, K * (G + 2) * D)).astype(np.float32)).to(dtype)
    pos = torch.from_numpy(rng.integers(0, 70000, size=(B, T)).astype(
        np.int32))
    cos, sin = llama.rope_tables(get_config("debug").replace(
        head_dim=D, num_heads=H, num_kv_heads=K), pos)
    q0, k0, v0 = rope.split_qkv(qkv, H, K, D)
    want = (rope.rotate(q0, cos, sin), rope.rotate(k0, cos, sin),
            v0.contiguous())
    for kernels in ("auto", "torch"):
        got = rope.split_qkv_rope_fused(qkv, cos, sin, H, K, D,
                                        kernels=kernels)
        for g, w in zip(got, want):
            assert torch.equal(g, w) and g.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16], ids=str)
@pytest.mark.parametrize("G,D", [(1, 16), (4, 64), (7, 128), (8, 128)])
def test_fused_split_rope_with_bias_matches_jax(rng, dtype, G, D):
    """Qwen2's packed qkv bias: the plain route adds ``bias`` first, as the
    JAX decoder's ``qkv + bqkv.astype(qkv.dtype)`` before
    ``split_qkv_rope_xla``; bit for bit the plain add then the plain J."""
    B, T, K = 2, 5, 2 if G < 7 else 1
    H = K * G
    x = rng.normal(size=(B, T, K * (G + 2) * D)).astype(np.float32)
    b = rng.normal(size=(K * (G + 2) * D,)).astype(np.float32)
    pos = _positions(rng, B, T, "long")
    qkv, bias = torch.from_numpy(x).to(dtype), torch.from_numpy(b).to(dtype)
    got = _fused(qkv, torch.from_numpy(pos), H, K, D, bias=bias)
    jx = jnp.asarray(x).astype(JNP[dtype])
    want = j_rope.split_qkv_rope_xla(
        jx + jnp.asarray(b).astype(JNP[dtype]).astype(jx.dtype),
        jnp.asarray(pos), H, K, D)
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            _as_np(g), np.asarray(w.astype(jnp.float32)), **TOL[dtype])
    cos, sin = rope.rope_cos_sin(torch.from_numpy(pos), D, 10000.0)
    plain = rope.split_qkv_rope_fused_torch(qkv + bias, cos[..., None, :],
                                            sin[..., None, :], H, K, D)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)


def test_fused_split_rope_is_a_counted_wrapper():
    assert rope.split_qkv_rope_fused in counted_wrappers()
    assert rope.split_qkv_rope_fused.launches == 0   # CPU: no launch
    with pytest.raises(ValueError, match="CUDA tensor"):
        rope.split_qkv_rope_fused(torch.zeros(1, 64), torch.zeros(1, 8),
                                  torch.zeros(1, 8), 2, 1, 16,
                                  kernels="cuda")


# ---------------------------------------------------------------------------
# the decoder's taps around J against the JAX engine's
# ---------------------------------------------------------------------------

CFG = get_config("debug")
J_CFG = j_get_config("debug")
PROMPT = [1, 5, 9]
NEW = 8
ROPE_TAPS = ("qkv_proj", "q_rope", "k_rope")


def _port_generate(params, eos, dump_dir=None):
    if dump_dir is not None:
        debug.set_dump_dir(str(dump_dir))
    try:
        eng = InferenceEngine(CFG, EngineConfig(max_batch_size=2,
                                                max_seq_len=64), params)
        return eng.generate([PROMPT], SamplingParams(
            greedy=True, max_new_tokens=NEW), eos_token_id=eos).token_ids
    finally:
        debug.set_dump_dir(None)


@pytest.fixture(scope="module")
def jax_dumps(tmp_path_factory):
    """The JAX engine's dumps of one greedy generate (its engine built
    once for the module), the port's weights and the stop id. The stop id
    is a token the port's greedy run emits at step NEW - 2, so both runs
    end on a decode step and the newest dump of each name pairs up (the
    JAX package writes its dumps once per compiled program)."""
    path = tmp_path_factory.mktemp("jax_dumps")
    jp = j_init_dummy_params(J_CFG, seed=0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    eos = _port_generate(tp, None)[0][NEW - 2]
    j_debug.set_dump_dir(str(path))
    try:
        eng = JInferenceEngine(J_CFG, JEngineConfig(
            max_batch_size=2, max_seq_len=64, kernels="xla"), jp)
        ids = eng.generate([PROMPT], JSamplingParams(
            greedy=True, max_new_tokens=NEW), eos_token_id=eos).token_ids
    finally:
        j_debug.set_dump_dir(None)
    return path, tp, eos, ids


def test_forward_rope_taps_equal_the_jax_engines(jax_dumps, tmp_path):
    """The same generate in both packages: the ids are equal, and every
    layer's qkv_proj, q_rope and k_rope dumps (J's input and outputs, at
    the JAX package's names and shapes) agree within 1e-4, as
    tests/test_torch_debug.py holds the whole set with compare_dumps."""
    jdir, tp, eos, jids = jax_dumps
    assert _port_generate(tp, eos, tmp_path) == jids
    for f in os.listdir(tmp_path):          # keep J's taps only
        if f.split("_", 2)[-1][:-4] not in ROPE_TAPS:
            os.remove(tmp_path / f)
    names = {f.split("_", 1)[1][:-4] for f in os.listdir(tmp_path)}
    assert names == {f"L{i}_{t}" for i in range(CFG.num_layers)
                     for t in ROPE_TAPS}
    bad = debug.compare_dumps(str(jdir), str(tmp_path), atol=1e-4, rtol=1e-4)
    assert [b for b in bad if not b.startswith("missing:")] == []
    assert {b[8:-4] for b in bad if b.startswith("missing:")} <= {
        "embedding", "final_norm"} | {
        f"L{i}_{t}" for i in range(CFG.num_layers)
        for t in ("attn_norm", "attn_ctx", "attn_out", "ffn_in", "ffn_act",
                  "layer_out")}

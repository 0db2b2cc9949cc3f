"""Op parity: the PyTorch port's plain versions against the JAX package.

Inputs are drawn with numpy from the per-test seeded ``rng`` fixture and
fed to both packages. The JAX side runs as its own tests run it on the
CPU: Pallas kernels in interpret mode (``kernels="pallas"``; conftest
sets interpret mode), or its XLA path where the Pallas kernel has no
interpret mode. The port side runs its plain versions (CPU tensors).
Tolerances: f32 1e-5 where both sides do the same f32 math; 2e-2 where
one side rounds through bf16 (bf16 has 8 mantissa bits, ~4e-3 relative
per rounding) or runs bf16 dots, as in tests/test_mxu_decode.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.ops import activations as j_act
from llm_inference_engine_tpu.ops import attention as j_attn
from llm_inference_engine_tpu.ops import kv_cache as j_kvc
from llm_inference_engine_tpu.ops import rmsnorm as j_norm
from llm_inference_engine_tpu.ops import rope as j_rope
from llm_inference_engine_tpu.ops import sampling as j_samp
from llm_inference_engine_tpu.config import RopeScaling as JRopeScaling

from llm_inference_engine_tpu_torch.config import RopeScaling
from llm_inference_engine_tpu_torch.ops import activations, attention
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops import rmsnorm, rope, sampling
from llm_inference_engine_tpu_torch.utils import use_kernel

from test_ops_rope import np_rope

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


def both(x, jdtype, tdtype):
    """The same numpy values as a JAX array and a torch tensor."""
    return jnp.asarray(x, jdtype), torch.from_numpy(np.array(x)).to(tdtype)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# kernel A: rmsnorm / add_residual_rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 64), (3, 5, 256)])
def test_rmsnorm_matches_jax(rng, dtype, shape):
    jd, td, tol = DTYPES[dtype]
    x = rng.normal(size=shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    (jx, tx), (jw, tw) = both(x, jd, td), both(w, jd, td)
    want = j_norm.rmsnorm(jx, jw, 1e-5, kernels="pallas")
    got = rmsnorm.rmsnorm(tx, tw, 1e-5)
    assert got.dtype == td and got.shape == shape
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_residual_rmsnorm_matches_jax(rng, dtype):
    jd, td, tol = DTYPES[dtype]
    x = rng.normal(size=(2, 7, 128)).astype(np.float32)
    r = rng.normal(size=(2, 7, 128)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=128)).astype(np.float32)
    (jx, tx), (jr, tr), (jw, tw) = (both(a, jd, td) for a in (x, r, w))
    wy, wh = j_norm.add_residual_rmsnorm(jx, jr, jw, 1e-5, kernels="pallas")
    gy, gh = rmsnorm.add_residual_rmsnorm(tx, tr, tw, 1e-5)
    np.testing.assert_allclose(as_np(gh), as_np(wh), **tol)
    np.testing.assert_allclose(as_np(gy), as_np(wy), **tol)


# ---------------------------------------------------------------------------
# kernel B: silu_and_mul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_and_mul_matches_jax(rng, dtype):
    # 128 rows: inside the JAX package's 64 < tokens < 2048 Pallas range,
    # so its TPU kernel (interpreted) is what the port is held against
    jd, td, tol = DTYPES[dtype]
    x = rng.normal(size=(2, 64, 2 * 96)).astype(np.float32)
    jx, tx = both(x, jd, td)
    want = j_act.silu_and_mul(jx, kernels="pallas")
    got = activations.silu_and_mul(tx)
    assert got.shape == (2, 64, 96)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)
    np.testing.assert_allclose(
        as_np(activations.add_residual(tx[..., :96], tx[..., 96:])),
        as_np(j_act.add_residual(jx[..., :96], jx[..., 96:])), **tol)


# ---------------------------------------------------------------------------
# RoPE and the group-major QKV split (plain torch in both packages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 1000, 29990])
def test_rope_matches_numpy_golden(rng, offset):
    # float64 golden; the Cody-Waite angles keep f32 error ~2e-4 rad at
    # position ~30k, hence 1e-3 on unit-variance inputs
    T, H, D = 10, 3, 64
    x = rng.normal(size=(T, H, D)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32) + offset
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np_rope(x, pos, 10000.0),
                               atol=1e-3, rtol=1e-3)


def test_split_qkv_rope_matches_numpy_golden(rng):
    T, H, K, D = 6, 8, 2, 32
    G = H // K
    qkv = rng.normal(size=(T, K * (G + 2) * D)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32) + 30000 - T
    q, k, v = rope.split_qkv_rope(torch.from_numpy(qkv),
                                  torch.from_numpy(pos), H, K, D)
    z = qkv.reshape(T, K, G + 2, D)
    np.testing.assert_allclose(q.numpy(), np_rope(
        z[:, :, :G].reshape(T, H, D), pos, 10000.0), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(k.numpy(), np_rope(z[:, :, G], pos, 10000.0),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(v.numpy(), z[:, :, G + 1])


@pytest.mark.parametrize("scaling", ["none", "linear", "llama3"])
def test_rope_scaling_matches_jax(rng, scaling):
    tsc, jsc = {"none": (None, None), "linear": (4.0, 4.0),
                "llama3": (RopeScaling(), JRopeScaling())}[scaling]
    x = rng.normal(size=(2, 9, 2, 128)).astype(np.float32)
    pos = rng.integers(0, 20000, size=(2, 9)).astype(np.int32)
    want = j_rope.apply_rope_xla(jnp.asarray(x), jnp.asarray(pos), 500000.0,
                                 jsc)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          500000.0, tsc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# kernel C: the cache write
# ---------------------------------------------------------------------------

def test_kv_write_matches_jax(rng):
    """JAX side: update_cache_at_layer on CPU (its DUS path; the Pallas
    write kernel has no interpret mode). The JAX package writes the whole
    padded T-window; the port writes only real rows, so the valid rows are
    compared exactly and every other row must be untouched by the port."""
    L, B, S, K, D, T, layer = 3, 4, 24, 2, 8, 6, 1
    base = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    new_k = rng.normal(size=(B, T, K, D)).astype(np.float32)
    new_v = rng.normal(size=(B, T, K, D)).astype(np.float32)
    starts = np.array([0, 5, 17, 9], np.int32)
    new_len = np.array([6, 3, 1, 0], np.int32)      # last row: no-op

    jc = j_kvc.KVCache(jnp.asarray(base), jnp.asarray(base),
                       jnp.zeros((B,), jnp.int32))
    jc = j_kvc.update_cache_at_layer(
        jc, jnp.int32(layer), jnp.asarray(new_k), jnp.asarray(new_v),
        jnp.asarray(starts), new_len=jnp.asarray(new_len), kernels="xla")
    tc = kvc.KVCache(torch.from_numpy(base.copy()),
                     torch.from_numpy(base.copy()),
                     torch.zeros((B,), dtype=torch.int32))
    out = kvc.update_cache_at_layer(
        tc, layer, torch.from_numpy(new_k), torch.from_numpy(new_v),
        torch.from_numpy(starts), torch.from_numpy(new_len))
    assert out is tc                                   # updated in place
    jk, jv = np.asarray(jc.k), np.asarray(jc.v)
    written = np.zeros((L, B, S), bool)
    for b in range(B):
        rows = slice(starts[b], starts[b] + new_len[b])
        written[layer, b, rows] = True
        np.testing.assert_array_equal(tc.k.numpy()[layer, b, rows],
                                      jk[layer, b, rows])
        np.testing.assert_array_equal(tc.v.numpy()[layer, b, rows],
                                      jv[layer, b, rows])
    np.testing.assert_array_equal(tc.k.numpy()[~written], base[~written])
    np.testing.assert_array_equal(tc.v.numpy()[~written], base[~written])


# ---------------------------------------------------------------------------
# kernel D: prefill attention and fused decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,G,window", [(2, 1, None), (2, 4, None),
                                        (1, 2, 5)])
def test_prefill_attention_matches_jax(rng, K, G, window):
    """JAX side: the flash kernel (_attn_kernel) interpreted, on a stacked
    cache at a layer, with ragged q_start/kv_len and an empty row."""
    L, B, S, D, T, layer = 2, 4, 48, 32, 16, 1
    H = K * G
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    kc = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    vc = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    q_start = np.array([0, 7, 30, 0], np.int32)
    kv_len = np.array([16, 17, 46, 0], np.int32)   # last row sees nothing
    want = j_attn.attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(q_start), jnp.asarray(kv_len), kernels="pallas",
        layer=jnp.int32(layer), window=window, block_q=16, block_kv=16)
    got = attention.attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(q_start), torch.from_numpy(kv_len), layer=layer,
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16)
    assert not got[3].any()                     # empty row gives 0, not NaN


def test_fused_decode_matches_jax(rng):
    """JAX side: attention_decode_fused_mxu called directly (its gate is
    false on the CPU), interpreted, with one inactive row. Outputs and the
    written cache rows are compared."""
    L, B, K, G, D, S, layer = 2, 2, 8, 2, 128, 32, 1
    H = K * G
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kc = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    vc = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    kn = rng.normal(size=(B, 1, K, D)).astype(np.float32)
    vn = rng.normal(size=(B, 1, K, D)).astype(np.float32)
    hist = np.array([6, 17], np.int32)
    kv_len = hist + np.array([1, 0], np.int32)       # row 1 inactive
    jout, jk, jv = j_attn.attention_decode_fused_mxu(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(hist), jnp.asarray(kv_len),
        jnp.int32(layer), block_kv=16)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tout, tk2, tv2 = attention.attention_decode_fused(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tk, tv, torch.from_numpy(hist), torch.from_numpy(kv_len), layer)
    assert tk2 is tk and tv2 is tv                   # updated in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **BF16)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[layer, 1], kc[layer, 1])


def test_decode_gate():
    c = kvc.new_kv_cache(1, 2, 2, 8, 16, dtype=torch.bfloat16)
    assert attention.can_fuse_decode((2, 1, 4, 16), c)
    assert not attention.can_fuse_decode((2, 3, 4, 16), c)
    c32 = kvc.new_kv_cache(1, 2, 2, 8, 16, dtype=torch.float32)
    assert not attention.can_fuse_decode((2, 1, 4, 16), c32)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _sampling_inputs(rng, B=4, V=300):
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.3], np.float32)
    top_k = np.array([5, 64, 1, 20], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5], np.float32)
    min_p = np.array([0.0, 0.05, 0.0, 0.1], np.float32)
    return logits, temp, top_k, top_p, min_p


def test_processed_probs_and_greedy_match_jax(rng):
    arrs = _sampling_inputs(rng)
    want = j_samp.processed_probs(*(jnp.asarray(a) for a in arrs))
    got = sampling.processed_probs(*(torch.from_numpy(a) for a in arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(
        sampling.greedy_sample(torch.from_numpy(arrs[0])).numpy(),
        np.asarray(j_samp.greedy_sample(jnp.asarray(arrs[0]))))


def test_penalties_and_logprobs_match_jax(rng):
    B, V = 3, 50
    logits = rng.normal(size=(B, V)).astype(np.float32)
    cc = rng.integers(0, 3, size=(B, V)).astype(np.int32)
    cg = rng.integers(0, 2, size=(B, V)).astype(np.int32)
    rep = np.array([1.0, 1.3, 0.8], np.float32)
    pres = np.array([0.0, 0.5, 1.0], np.float32)
    freq = np.array([0.0, 0.2, 0.1], np.float32)
    args = (logits, cc, cg, rep, pres, freq)
    want = np.asarray(j_samp.apply_penalties(*(jnp.asarray(a) for a in args)))
    got = sampling.apply_penalties(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    ids = rng.integers(0, V, size=B).astype(np.int32)
    np.testing.assert_allclose(
        sampling.token_logprobs(got, torch.from_numpy(ids)).numpy(),
        np.asarray(j_samp.token_logprobs(jnp.asarray(want),
                                         jnp.asarray(ids))), **F32)


def test_sample_tokens_draws_inside_processed_support(rng):
    """Sampled ids cannot match threefry; they must fall where the
    processed distribution is positive, be reproducible from the
    generator's seed, and be the argmax on greedy rows."""
    arrs = _sampling_inputs(rng)
    t = [torch.from_numpy(a) for a in arrs]
    probs = sampling.processed_probs(*t)
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        draws.append(torch.stack([sampling.sample_tokens(t[0], g, *t[1:])
                                  for _ in range(20)]))
    assert torch.equal(draws[0], draws[1])
    picked = torch.gather(probs.expand(20, -1, -1), -1,
                          draws[0].long()[..., None])[..., 0]
    assert (picked > 0).all()
    assert (draws[0][:, 0] == t[0][0].argmax()).all()      # greedy row
    assert (draws[0][:, 2] == t[0][2].argmax()).all()      # top_k = 1


# ---------------------------------------------------------------------------
# dispatch rule
# ---------------------------------------------------------------------------

def test_use_kernel_rule():
    cpu = torch.zeros(2)
    assert not use_kernel("auto", cpu)
    assert not use_kernel("torch", cpu)
    with pytest.raises(ValueError):
        use_kernel("cuda", cpu)
    with pytest.raises(ValueError):
        use_kernel("pallas", cpu)


def test_cpu_dispatch_runs_plain_versions_only():
    """On CPU tensors every wrapper takes its plain version: no launch
    counter moves, and kernels='cuda' raises instead of falling back."""
    counters = (rmsnorm.rmsnorm, rmsnorm.add_residual_rmsnorm,
                activations.silu_and_mul, kvc.update_cache_at_layer,
                attention.attention, attention.attention_decode_fused)
    before = [f.launches for f in counters]
    x = torch.ones(2, 8)
    rmsnorm.rmsnorm(x, torch.ones(8))
    rmsnorm.add_residual_rmsnorm(x, x, torch.ones(8))
    activations.silu_and_mul(x)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(x, torch.ones(8), kernels="cuda")
    with pytest.raises(ValueError):
        activations.silu_and_mul(x, kernels="cuda")

"""INT8 KV cache parity: the PyTorch port's int8 slot cache and pool, its
quantizers, writes and int8 attention modes, and its int8 engines against
the JAX package, on the CPU.

The port keeps one layout for both of the JAX package's int8 numerics:
int8 values plus f32 scale planes [.., K]. The JAX package's
separate-scale cache (absmax / 127 scales) is compared plane for plane;
its embedded-scale cache and pool (log2-snapped codes in 8 pad rows per
token) cross over through ``kv_scales_from_numpy``. Its Pallas kernels
run in interpret mode (conftest), its engines on the XLA path; the port
runs its plain versions (CPU tensors). Inputs come from a numpy seed.

Tolerances. The absmax quantizer is the same f32 arithmetic on both sides
(IEEE divide, round half to even): values and scales must be equal. The
snapped quantizer goes through log2 and exp2, where XLA's CPU versions and
torch's may differ by an ulp; a code can then cross a .5 boundary, so
snapped scales may differ by 2^-20 relative and int8 values by 1 in at
most 0.1% of elements. Attention in f32 sums in another order: 1e-5. The
JAX decode kernels run their int8 dots in bf16: 1.5e-2, as the JAX
package's own int8 tests hold them.
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
from llm_inference_engine_tpu.ops import kv_cache as j_kvc
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops import attention
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

SNAP_REL = 2.0 ** -20       # snapped scales, relative
SNAP_SHARE = 1e-3           # int8 values off by one, share of elements
F32 = dict(atol=1e-5, rtol=1e-5)
BF16_DOTS = dict(atol=1.5e-2, rtol=1.5e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _kv(rng, *shape):
    """K/V-like rows: normal values with one all-zero row (both floors
    give q = 0 there), one small and one large row."""
    x = rng.normal(size=shape).astype(np.float32) * 2.0
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[1] *= 0.05
    flat[2] *= 1e4
    return x


def _assert_snapped_close(q, scale, q_ref, scale_ref):
    """int8 values within 1 in at most SNAP_SHARE of elements, scales
    within SNAP_REL relative. An all-zero row's scale (the 1e-30 floor,
    2^-106.6, where XLA's CPU exp2 is off by up to 4e-6 relative) weighs
    only zeros, so there the scale is held to be finite and positive."""
    q, q_ref = np.asarray(q, np.int32), np.asarray(q_ref, np.int32)
    diff = np.abs(q - q_ref)
    assert diff.max() <= 1 and (diff > 0).mean() <= SNAP_SHARE, diff.mean()
    live = q_ref.any(axis=-1)
    scale, scale_ref = np.asarray(scale), np.asarray(scale_ref)
    np.testing.assert_allclose(scale[live], scale_ref[live], rtol=SNAP_REL,
                               atol=0)
    assert np.isfinite(scale).all() and (scale > 0).all()


def _embedded(x: np.ndarray, K: int):
    """The JAX package's embedded-scale quantization of x [.., T, K, D]
    and the same cache in the port's layout (values, scale planes)."""
    lead, (T, _, D) = x.shape[:-3], x.shape[-3:]
    packed = np.asarray(j_kvc.quantize_kv_embedded(
        jnp.asarray(x.reshape(-1, T, K, D)))).reshape(
            *lead, T, K + j_kvc.EMBED_PAD, D)
    vals, scales = kvc.kv_scales_from_numpy(packed, K)
    return packed, vals, scales


# ---------------------------------------------------------------------------
# the two quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [8, 2])
def test_absmax_quantizer_matches_jax(rng, dtype, K):
    jd, td = DTYPES[dtype]
    x = _kv(rng, 2, 5, K, 128)
    jq, js = j_kvc._quantize_kv(jnp.asarray(x, jd))
    tq, ts = kvc.quantize_kv(torch.from_numpy(x).to(td))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not tq.reshape(-1, 128)[0].any()           # the zero row: q = 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [8, 2])
def test_snapped_quantizer_matches_jax_embedded(rng, dtype, K):
    """quantize_kv_snapped against quantize_kv_embedded, the JAX codes
    decoded both by the port's kv_scales_from_numpy and by the JAX
    package's decode_embedded_scales."""
    jd, td = DTYPES[dtype]
    x = _kv(rng, 2, 5, K, 128)
    xj = np.array(jnp.asarray(x, jd).astype(jnp.float32))
    packed, jvals, jscales = _embedded(xj, K)
    _assert_snapped_close(jvals.numpy(), jscales.numpy(), jvals.numpy(),
                          np.asarray(j_kvc.decode_embedded_scales(
                              jnp.asarray(packed[..., K, :]), K)))
    tq, ts = kvc.quantize_kv_snapped(torch.from_numpy(x).to(td))
    _assert_snapped_close(tq.numpy(), ts.numpy(), jvals.numpy(),
                          jscales.numpy())
    assert not tq.reshape(-1, 128)[0].any()           # the zero row: q = 0
    assert torch.isfinite(ts).all() and (ts > 0).all()
    # dequantization is exact against the snapped scale: |x - q s| <= s/2
    deq = tq.float() * ts[..., None]
    err = (deq - torch.from_numpy(xj)).abs()
    assert (err <= ts[..., None] * 0.5 + 1e-30).all()


# ---------------------------------------------------------------------------
# the int8 slot write (the plain version of kernel I)
# ---------------------------------------------------------------------------

# (starts, new_len, T) per call, B = 3: a prefill chunk with a new_len == 0
# row, a ragged chunk, decode rows
_WRITES = [([0, 0, 4], [8, 5, 0], 8),
           ([8, 5, 4], [3, 0, 4], 4),
           ([11, 5, 8], [1, 1, 0], 1)]


@pytest.mark.parametrize("K", [8, 2])
def test_int8_write_matches_jax_separate_scale_cache(rng, K):
    """The port's int8 update_cache_at_layer against the JAX package's on
    a separate-scale cache (its XLA route computes the same write as
    ``_write_kernel_quant``): every real row equal in values and scales,
    every other row of the port untouched. The JAX route also writes its
    T-window's padding rows past each sequence's new rows."""
    L, B, S, D = 2, 3, 24, 128
    jc = j_kvc.new_kv_cache(L, B, K, S, D, quantized=True, embedded=False)
    tc = kvc.new_kv_cache(L, B, K, S, D, quantized=True, snapped=False)
    assert tc.quantized and not tc.snapped
    real = np.zeros((L, B, S), bool)
    for starts, new_len, T in _WRITES:
        starts, new_len = np.array(starts, np.int32), np.array(new_len,
                                                                np.int32)
        for layer in (1, 0):
            nk, nv = _kv(rng, B, T, K, D), _kv(rng, B, T, K, D)
            jc = j_kvc.update_cache_at_layer(
                jc, jnp.int32(layer), jnp.asarray(nk), jnp.asarray(nv),
                jnp.asarray(starts), jnp.asarray(new_len), kernels="xla")
            out = kvc.update_cache_at_layer(
                tc, layer, torch.from_numpy(nk), torch.from_numpy(nv),
                torch.from_numpy(starts), torch.from_numpy(new_len))
            assert out is tc                                # in place
            for b in range(B):
                real[layer, b, starts[b]:starts[b] + new_len[b]] = True
    for got, want, init in ((tc.k, jc.k, 0), (tc.v, jc.v, 0),
                            (tc.k_scale, jc.k_scale, 1),
                            (tc.v_scale, jc.v_scale, 1)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(got[real], want[real])
        assert (got[~real] == init).all()


# ---------------------------------------------------------------------------
# attention with scale planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,G,T,window", [(8, 1, 6, None), (2, 4, 6, 5),
                                          (2, 4, 1, None)])
def test_attention_torch_with_planes_matches_attention_xla(rng, K, G, T,
                                                           window):
    """The plain version with scale planes (stacked cache, read at a
    layer) against ``attention_xla`` with k_scale/v_scale, in f32."""
    L, B, S, D = 2, 3, 20, 128
    kq, ks = kvc.quantize_kv(torch.from_numpy(_kv(rng, L, B, S, K, D)))
    vq, vs = kvc.quantize_kv(torch.from_numpy(_kv(rng, L, B, S, K, D)))
    q = rng.normal(size=(B, T, K * G, D)).astype(np.float32)
    kv_len = np.array([T, 13, 20], np.int32)
    q_start = kv_len - T
    want = j_attn.attention_xla(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(q_start), jnp.asarray(kv_len),
        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()),
        layer=jnp.int32(1), window=window)
    got = attention.attention(
        torch.from_numpy(q), kq, vq, torch.from_numpy(q_start),
        torch.from_numpy(kv_len), layer=1, window=window, k_scale=ks,
        v_scale=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("G,window", [(1, None), (4, None), (4, 9)])
def test_slot_prefill_int8_matches_jax_kernel(rng, G, window):
    """Kernel D's int8 slot prefill mode (plain version) against the JAX
    ``_attn_kernel`` with embedded scales, interpreted; the cache crosses
    over through kv_scales_from_numpy."""
    B, S, K, D, T = 2, 40, 8, 128, 12
    pk, kvals, kscale = _embedded(_kv(rng, B, S, K, D), K)
    pv, vvals, vscale = _embedded(_kv(rng, B, S, K, D), K)
    q = rng.normal(size=(B, T, K * G, D)).astype(np.float32)
    kv_len = np.array([T, 37], np.int32)
    q_start = kv_len - T
    want = j_attn.attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(q_start), jnp.asarray(kv_len), kernels="pallas",
        block_q=16, block_kv=16, embedded_kv=True, window=window)
    n0 = attention.attention_int8.launches
    got = attention.attention(
        torch.from_numpy(q), kvals, vvals, torch.from_numpy(q_start),
        torch.from_numpy(kv_len), window=window, k_scale=kscale,
        v_scale=vscale)
    assert attention.attention_int8.launches == n0      # plain on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _int8_pool(rng, L, P, page, K, D):
    """A JAX embedded-scale pool [L, P, page, K + 8, D] and the same pool in
    the port's layout (values, scale planes)."""
    return _embedded(_kv(rng, L, P, page, K, D), K)


@pytest.mark.parametrize("T,G,window", [(8, 1, None), (8, 4, 20),
                                        (1, 1, None), (1, 4, 20)])
def test_paged_int8_attention_matches_jax_kernel(rng, T, G, window):
    """Kernel D's int8 paged modes (plain versions) against the JAX kernels
    over its embedded-scale pool (page 16, shuffled table): T > 1 the
    ``_attn_kernel`` under the paged index map, T == 1
    ``_decode_mxu_kernel`` (its int8 dots run in bf16), both
    interpreted."""
    L, B, K, D, page, maxp = 2, 3, 8, 128, 16, 4
    P = 1 + B * maxp
    table = rng.permutation(np.arange(1, P)).reshape(B, maxp).astype(
        np.int32)
    jk, kvals, kscale = _int8_pool(rng, L, P, page, K, D)
    jv, vvals, vscale = _int8_pool(rng, L, P, page, K, D)
    q = rng.normal(size=(B, T, K * G, D)).astype(np.float32)
    kv_len = np.array([32, 45, 9 if T > 1 else 1], np.int32)
    q_start = kv_len - T
    tol = F32 if T > 1 else BF16_DOTS
    for layer in range(L):
        want = j_attn.attention(
            jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv),
            jnp.asarray(q_start), jnp.asarray(kv_len), kernels="pallas",
            block_q=16, block_kv=16, layer=jnp.int32(layer),
            table=jnp.asarray(table), embedded_kv=True, window=window)
        args = (torch.from_numpy(q), kvals, vvals, torch.from_numpy(q_start),
                torch.from_numpy(kv_len))
        planes = dict(k_scale=kscale, v_scale=vscale, window=window)
        if T == 1:
            got = attention.attention_decode(
                *args, layer, table=torch.from_numpy(table), **planes)
        else:
            got = attention.attention(*args, layer=layer,
                                      table=torch.from_numpy(table), **planes)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("G,window", [(1, None), (4, None), (4, 30)])
def test_fused_int8_decode_matches_jax_kernel(rng, G, window):
    """Kernel D's fused int8 decode (plain version, snapped numerics)
    against ``attention_decode_fused_mxu(embedded=True)`` interpreted: the
    output of the active rows (the JAX dots run in bf16), and the written
    rows, values and scales, against the JAX package's packed rows. Row 2
    is inactive."""
    L, B, S, K, D = 2, 4, 64, 8, 128
    jk, kvals, kscale = _embedded(_kv(rng, L, B, S, K, D), K)
    jv, vvals, vscale = _embedded(_kv(rng, L, B, S, K, D), K)
    q = rng.normal(size=(B, 1, K * G, D)).astype(np.float32)
    kn, vn = _kv(rng, B, 1, K, D), _kv(rng, B, 1, K, D)
    q_start = np.array([0, 17, 40, 63], np.int32)
    kv_len = q_start + np.array([1, 1, 0, 1], np.int32)
    want, jkc, jvc = j_attn.attention_decode_fused_mxu(
        jnp.asarray(q), j_kvc.quantize_kv_embedded(jnp.asarray(kn)),
        j_kvc.quantize_kv_embedded(jnp.asarray(vn)), jnp.asarray(jk),
        jnp.asarray(jv), jnp.asarray(q_start), jnp.asarray(kv_len), 1,
        block_kv=16, embedded=True, window=window)
    got, _, _ = attention.attention_decode_fused(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        kvals, vvals, torch.from_numpy(q_start), torch.from_numpy(kv_len), 1,
        window=window, k_scale=kscale, v_scale=vscale, snapped=True)
    # active rows (an inactive row's output is unused; the JAX kernel's
    # window mask places its query at kv_len - 1, the port's at q_start)
    active = kv_len > q_start
    np.testing.assert_allclose(got.numpy()[active],
                               np.asarray(want)[active], **BF16_DOTS)
    for vals, scales, jc in ((kvals, kscale, jkc), (vvals, vscale, jvc)):
        jvals, jscales = kvc.kv_scales_from_numpy(np.asarray(jc), K)
        _assert_snapped_close(vals.numpy(), scales.numpy(), jvals.numpy(),
                              jscales.numpy())
        # the inactive row wrote nothing
        assert torch.equal(vals[1, 2, 40], jvals[1, 2, 40])


def test_fusible_and_quantized_caches():
    slot = kvc.new_kv_cache(1, 2, 2, 16, 128, quantized=True)
    pool = pkv.new_paged_kv_cache(1, 2, 2, 5, 16, 128, 2, quantized=True)
    assert attention.can_fuse_decode((2, 1, 4, 128), slot)
    assert not attention.can_fuse_decode((2, 1, 4, 128), pool)
    # a CPU cache takes the JAX package's CPU numerics; the pool is snapped
    assert slot.quantized and not slot.snapped and pool.snapped
    assert kvc.new_kv_cache(1, 2, 8, 16, 128, quantized=True,
                            snapped=True).snapped
    assert kvc.embedded_supported(32, 128) and not kvc.embedded_supported(
        2, 16)


def test_int8_kernel_routes_refuse_cpu_tensors():
    c = kvc.new_kv_cache(1, 2, 2, 16, 128, quantized=True)
    new = torch.zeros((2, 1, 2, 128), dtype=torch.bfloat16)
    zero = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kvc.update_cache_at_layer(c, 0, new, new, zero, kernels="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention.attention(new, c.k, c.v, zero, zero, layer=0,
                            k_scale=c.k_scale, v_scale=c.v_scale,
                            kernels="cuda")


# ---------------------------------------------------------------------------
# engines: greedy ids over two generate rounds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jp = j_init_dummy_params(j_get_config("debug"), seed=4)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("case", ["slot-absmax", "slot-snapped", "paged"])
def test_int8_engine_greedy_ids_match_jax_over_two_rounds(weights, case):
    """The debug preset (f32) with an int8 KV cache. slot-absmax: the JAX
    package's CPU cache (separate scales); slot-snapped: a JAX engine whose
    cache is replaced by an embedded-scale cache, beside a port engine with
    a snapped cache; paged: both int8 pools (chunks of 8, pages of 16)."""
    kw = dict(max_batch_size=3, max_seq_len=96, max_prefill_len=16,
              kv_cache_dtype_name="int8")
    lens = [(5, 30, 17), (3, 9, 20)]
    if case == "paged":
        kw.update(kv_layout="paged", page_size=16, max_prefill_len=8)
        # a paged append must start page-aligned: round 1 ends at 8k
        lens[0] = (4, 28, 20)
    cfg_j, cfg = j_get_config("debug"), get_config("debug")
    je = JInferenceEngine(cfg_j, JEngineConfig(kernels="xla", **kw),
                          weights[0])
    te = InferenceEngine(cfg, EngineConfig(**kw), weights[1])
    assert te.cache.quantized and te.cache.snapped == (case == "paged")
    if case == "slot-snapped":
        shape = (cfg.num_layers, 3, cfg.num_kv_heads, 96, cfg.head_dim)
        je.cache = j_kvc.new_kv_cache(*shape, quantized=True, embedded=True)
        te.cache = kvc.new_kv_cache(*shape, quantized=True, snapped=True)
    rng = np.random.default_rng(11)
    for round_lens in lens:
        prompts = [rng.integers(3, 256, n).tolist() for n in round_lens]
        sp = dict(greedy=True, max_new_tokens=12)
        rj = je.generate(prompts, JSamplingParams(**sp), eos_token_id=None)
        rt = te.generate(prompts, SamplingParams(**sp), eos_token_id=None)
        assert rt.token_ids == rj.token_ids
        np.testing.assert_array_equal(te.cache.lengths.numpy(),
                                      np.asarray(je.cache.lengths))

"""INT8/INT4 weight-only quantization: the PyTorch port against the JAX
package, on the CPU.

Inputs are drawn with numpy from the per-test seeded ``rng`` fixture and
fed to both packages. The JAX side runs as its own tests run it: its
Pallas kernels in interpret mode (``kernels="pallas"``; conftest sets
interpret mode). The port runs its plain versions, as it does on every
CPU tensor. Tolerances:

- storage (packing, quantize, clip search, dequantize, kernel G's plain
  version, the ``.npz`` format): bit for bit;
- f32 matmuls: 1e-5 relative to the output's largest magnitude; both
  sides take the same f32 products and only sum them in another order;
- bf16 outputs: 2e-2 (one bf16 rounding of the output, ~4e-3 relative,
  plus the order of the f32 sums);
- generated ids equal; logprobs within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models import weights as j_weights
from llm_inference_engine_tpu.ops import quant as j_quant
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models import weights
from llm_inference_engine_tpu_torch.models.registry import create_engine
from llm_inference_engine_tpu_torch.ops import quant
from llm_inference_engine_tpu_torch.ops.linear import linear
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

MODES = ["int8", "int4"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def t_(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def crossed(jt) -> quant.QuantizedTensor:
    """A JAX QuantizedTensor as the port's (same arrays)."""
    return quant.QuantizedTensor(t_(jt.q), t_(jt.scale), jt.mode,
                                 jt.group_size)


def assert_rel(got, want, tol):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# ---------------------------------------------------------------------------
# storage: bit for bit
# ---------------------------------------------------------------------------

def test_pack_unpack_int4_match_jax(rng):
    q = rng.integers(-8, 8, size=(32, 6)).astype(np.int8)
    packed = quant._pack_int4(t_(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(j_quant._pack_int4(q)))
    np.testing.assert_array_equal(quant._unpack_int4(packed).numpy(), q)
    # byte r: row 2r in the low nibble, row 2r+1 in the high nibble
    b = packed.numpy().astype(np.int32)
    np.testing.assert_array_equal(b[3] & 0xF, q[6] & 0xF)
    np.testing.assert_array_equal((b[3] >> 4) & 0xF, q[7] & 0xF)
    every = np.arange(256, dtype=np.uint8).view(np.int8).reshape(128, 2)
    np.testing.assert_array_equal(
        quant._unpack_int4(t_(every)).numpy(),
        np.asarray(j_quant._unpack_int4(jnp.asarray(every))))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("with_clip", [False, True])
def test_quantize_and_dequantize_match_jax(rng, mode, with_clip):
    k, n, g = 256, 96, 64
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    clip = None
    if with_clip:
        shape = (k // g, n) if mode == "int4" else (1, n)
        clip = rng.uniform(0.5, 1.0, size=shape).astype(np.float32)
    jt = j_quant.quantize_tensor(jnp.asarray(w), mode, g,
                                 clip=None if clip is None else
                                 jnp.asarray(clip))
    pt = quant.quantize_tensor(t_(w), mode, g,
                               clip=None if clip is None else t_(clip))
    assert (pt.mode, pt.group_size, pt.shape) == (jt.mode, jt.group_size,
                                                  tuple(jt.shape))
    np.testing.assert_array_equal(pt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(jt.scale))
    np.testing.assert_array_equal(quant.dequantize_tensor(pt).numpy(),
                                  np.asarray(j_quant.dequantize_tensor(jt)))
    assert pt.nbytes == jt.nbytes


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("weighted", [False, True])
def test_search_clip_matches_jax(rng, mode, weighted):
    k, n, g = 256, 64, 128
    w = rng.standard_t(3, size=(k, n)).astype(np.float32)   # outliers
    act_sq = (rng.uniform(0.1, 3.0, size=(k,)).astype(np.float32)
              if weighted else None)
    want = np.asarray(j_quant.search_clip(
        jnp.asarray(w), mode, g,
        act_sq=None if act_sq is None else jnp.asarray(act_sq)))
    got = quant.search_clip(t_(w), mode, g,
                            act_sq=None if act_sq is None else t_(act_sq))
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "int4":
        assert (want < 1.0).any()      # the search did clip somewhere


@pytest.mark.parametrize("k,n", [(512, 256), (1280, 384)])
def test_dequant_int4_plain_matches_jax_kernel(rng, k, n):
    """Kernel G's plain version against the JAX package's Pallas kernel
    (interpret mode): bf16(f32(nibble) * scale), bit for bit."""
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    jt = j_quant.quantize_tensor(jnp.asarray(w), "int4", 128)
    plan = j_quant._plan_dequant_blocks(k, n, 128)
    assert plan is not None
    want = np.asarray(j_quant._dequant_int4_pallas(jt.q, jt.scale, 128,
                                                   *plan, True))
    got = quant.dequant_int4(t_(jt.q), t_(jt.scale), 128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


# ---------------------------------------------------------------------------
# quantized_linear against the JAX package's Pallas path
# ---------------------------------------------------------------------------

def _linear_case(rng, mode, m, k, n, dtype, group=128):
    jdt, tdt, tol = DTYPES[dtype]
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jt = j_quant.quantize_tensor(jnp.asarray(w), mode, group)
    want = j_quant.quantized_linear(jnp.asarray(x, jdt), jt,
                                    kernels="pallas")
    got = quant.quantized_linear(t_(x, tdt), crossed(jt))
    assert got.dtype == tdt
    assert_rel(got, want, tol)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", [(5, 256, 128), (64, 512, 384),
                                   (1, 128, 256)])
def test_quantized_linear_matches_jax(rng, mode, dtype, m, k, n):
    _linear_case(rng, mode, m, k, n, dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [1280, 1408])
def test_quantized_linear_ragged_k_matches_jax(rng, mode, k):
    """K that 1024 does not divide (Llama's 11008 is the production
    case)."""
    _linear_case(rng, mode, 8, k, 256, "float32")


def _stacked(rng, mode, L, k, n, structured, group=128):
    """A stacked JAX QuantizedTensor [L, (2,) k', n] and its layers'
    per-half JAX tensors."""
    halves = 2 if structured else 1
    ts = [[j_quant.quantize_tensor(
        jnp.asarray((rng.normal(size=(k, n)) * 0.02).astype(np.float32)),
        mode, group) for _ in range(halves)] for _ in range(L)]
    q = np.stack([np.stack([np.asarray(t.q) for t in row]) for row in ts])
    s = np.stack([np.stack([np.asarray(t.scale) for t in row]) for row in ts])
    if not structured:
        q, s = q[:, 0], s[:, 0]
    return j_quant.QuantizedTensor(jnp.asarray(q), jnp.asarray(s), mode,
                                   group), ts


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("structured", [False, True])
def test_stacked_and_gate_up_match_jax(rng, mode, structured):
    """Layer 1 of a stacked weight, and of the [L, 2, k', I] gate|up stack
    (flat [m, gate | up] out): the port's layer view against the JAX
    package's layer-indexed kernel."""
    m, k, n, L = 6, 256, 128, 3
    jt, _ = _stacked(rng, mode, L, k, n, structured)
    x = rng.normal(size=(m, k)).astype(np.float32)
    want = j_quant.quantized_linear(jnp.asarray(x), jt, kernels="pallas",
                                    layer=jnp.int32(1))
    full = crossed(jt)
    pt = full[1]                                  # views, no copy
    for a, b in ((pt.q, full.q), (pt.scale, full.scale)):
        assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    got = quant.quantized_linear(t_(x), pt)
    assert got.shape == (m, (2 if structured else 1) * n)
    assert_rel(got, want, 1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("structured", [False, True])
def test_large_m_path_matches_jax(rng, mode, structured):
    """m = 1024 takes the dequantize-once + bf16 matmul path on both
    sides (x rounded to bf16, int4 scales baked into the bf16 weight):
    the same rounding points, so f32 agreement."""
    m, k, n, L = quant._PREFILL_M, 256, 128, 2
    jt, ts = _stacked(rng, mode, L, k, n, structured)
    x = rng.normal(size=(m, k)).astype(np.float32)
    want = j_quant.quantized_linear(jnp.asarray(x), jt, kernels="pallas",
                                    layer=jnp.int32(1))
    got = quant.quantized_linear(t_(x), crossed(jt)[1])
    assert_rel(got, want, 1e-5)
    # and it is the quantized product, to the int4 path's extra rounding
    gold = np.concatenate([np.asarray(j_quant.quantized_linear_xla(
        jnp.asarray(x), t)) for t in ts[1]], axis=-1)
    assert_rel(got, gold, 2e-2)


@pytest.mark.parametrize("mode", MODES)
def test_f32_output_is_never_rounded_to_bf16(rng, mode):
    """The lm_head: bf16 x, f32 out."""
    m, k, n = 4, 256, 200
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jt = j_quant.quantize_tensor(jnp.asarray(w), mode, 128)
    want = j_quant.quantized_linear(jnp.asarray(x, jnp.bfloat16), jt,
                                    out_dtype=jnp.float32, kernels="pallas")
    got = linear(t_(x, torch.bfloat16), crossed(jt), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert_rel(got, want, 1e-5)
    rounded = got.to(torch.bfloat16).float()
    assert not torch.equal(rounded, got)


def test_cpu_dispatch_runs_plain_versions_only(rng):
    """On CPU tensors kernels E, F and G take their plain versions (no
    launch counter moves), and kernels='cuda' raises."""
    counters = (quant.int4_matmul, quant.int8_matmul, quant.dequant_int4)
    before = [f.launches for f in counters]
    x = t_(rng.normal(size=(3, 128)).astype(np.float32))
    for mode in MODES:
        t = quant.quantize_tensor(t_(rng.normal(size=(128, 32))), mode, 64)
        torch.testing.assert_close(quant.quantized_linear(x, t),
                                   quant.quantized_linear_torch(x, t))
        with pytest.raises(ValueError):
            quant.quantized_linear(x, t, kernels="cuda")
    quant.dequant_int4(t.q, t.scale, 64)
    assert [f.launches for f in counters] == before


def test_fused_kernel_checks(rng):
    """The Python side of kernels E and F (shapes, strides, alignment),
    which the CPU reaches: a layer view of the gate|up stack and an f32
    lm_head pass; what the CUDA code does not take raises."""
    bf16 = torch.bfloat16
    x = torch.zeros(8, 512, dtype=bf16)
    stack = quant.QuantizedTensor(torch.zeros(3, 2, 256, 1040,
                                              dtype=torch.int8),
                                  torch.ones(3, 2, 4, 1040), "int4", 128)
    layer = stack[2]
    assert quant._check_fused("e", x, layer.q, layer.scale, bf16, True,
                              128) == (2, 512, 1040)
    q8, s8 = torch.zeros(11008, 384, dtype=torch.int8), torch.ones(1, 384)
    assert quant._check_fused("f", torch.zeros(5, 11008, dtype=bf16), q8,
                              s8, torch.float32, False, 0) == (1, 11008, 384)
    bad = [
        (TypeError, (x.float(), layer.q, layer.scale, bf16, True, 128)),
        (TypeError, (x, layer.q, layer.scale, torch.float16, True, 128)),
        (ValueError, (x, layer.q[:, :, :1000], layer.scale[:, :, :1000],
                      bf16, True, 128)),                  # not contiguous
        (ValueError, (x, layer.q, layer.scale, bf16, True, 32)),   # group
        (ValueError, (x[:, :256].contiguous(), layer.q, layer.scale, bf16,
                      True, 128)),                        # k mismatch
        (ValueError, (torch.zeros(8, 1000, dtype=bf16),
                      torch.zeros(500, 1000, dtype=torch.int8),
                      torch.ones(1, 1000), bf16, False, 0)),   # n % 16
    ]
    for err, args in bad:
        with pytest.raises(err):
            quant._check_fused("e", *args)


# ---------------------------------------------------------------------------
# parameter trees, the .npz format and the engine
# ---------------------------------------------------------------------------

def _cmp_trees(pp, jp):
    assert pp.keys() == jp.keys()
    for key, jv in jp.items():
        pv = pp[key]
        if isinstance(jv, dict):
            _cmp_trees(pv, jv)
        elif isinstance(jv, j_quant.QuantizedTensor):
            assert isinstance(pv, quant.QuantizedTensor), key
            assert (pv.mode, pv.group_size) == (jv.mode, jv.group_size)
            np.testing.assert_array_equal(pv.q.numpy(), np.asarray(jv.q))
            np.testing.assert_array_equal(pv.scale.numpy(),
                                          np.asarray(jv.scale))
        else:
            np.testing.assert_array_equal(as_np(pv), as_np(jv))


@pytest.mark.parametrize("mode", MODES)
def test_params_cross_from_jax_and_quantize_alike(mode):
    """params_from_numpy carries the JAX package's quantized trees across
    (born-quantized dummies and quantize_params output), and the port's
    quantize_params of the same dense weights equals the JAX package's."""
    cfg_j = j_get_config("debug").replace(dtype_name="bfloat16")
    born = j_weights.init_dummy_quantized_params(cfg_j, mode, 64, seed=2)
    _cmp_trees(weights.params_from_numpy(jax.tree.map(np.asarray, born)),
               born)
    dense = j_weights.init_dummy_params(cfg_j, seed=4)
    jq = j_weights.quantize_params(dense, mode, 64)
    _cmp_trees(weights.params_from_numpy(jax.tree.map(np.asarray, jq)), jq)
    pq = weights.quantize_params(
        weights.params_from_numpy(jax.tree.map(np.asarray, dense)), mode, 64)
    _cmp_trees(pq, jq)
    n_j = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jq))
    b_j = sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(jq))
    assert weights.param_count(pq) == n_j
    assert weights.param_bytes(pq) == b_j


def _engines(mode, seed, kw):
    """A JAX and a port engine over the same born-quantized debug model
    (f32, group 64, which divides every contraction dim)."""
    cfg_j = j_get_config("debug")
    jp = j_weights.init_dummy_quantized_params(cfg_j, mode, 64, seed=seed)
    tp = weights.params_from_numpy(jax.tree.map(np.asarray, jp))
    je = JInferenceEngine(cfg_j, JEngineConfig(quant_mode=mode,
                                               quant_group_size=64, **kw), jp)
    te = InferenceEngine(get_config("debug"),
                         EngineConfig(quant_mode=mode, quant_group_size=64,
                                      **kw), tp)
    return jp, je, te


@pytest.mark.parametrize("mode", MODES)
def test_quantized_generate_matches_jax_over_two_rounds(rng, mode):
    kw = dict(max_batch_size=3, max_seq_len=128, max_prefill_len=32)
    _, je, te = _engines(mode, 7, kw)
    for lens in [(5, 40, 17), (3, 9, 20)]:
        prompts = [rng.integers(3, 256, n).tolist() for n in lens]
        sp = dict(greedy=True, max_new_tokens=12)
        rj = je.generate(prompts, JSamplingParams(**sp), eos_token_id=None)
        rt = te.generate(prompts, SamplingParams(**sp), eos_token_id=None)
        assert rt.token_ids == rj.token_ids
        np.testing.assert_allclose(np.array(rt.logprobs),
                                   np.array(rj.logprobs), atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_npz_checkpoint_crosses_both_ways(rng, tmp_path, mode):
    """A JAX save_params file serves the port's create_engine(model, path)
    with the same ids, and the port's save_params file loads in JAX
    unchanged."""
    kw = dict(max_batch_size=2, max_seq_len=64, max_prefill_len=32)
    jp, je, _ = _engines(mode, 9, kw)
    path_j = str(tmp_path / "jax.npz")
    j_weights.save_params(jp, path_j)
    te = create_engine("debug", path_j,
                       EngineConfig(quant_mode=mode, quant_group_size=64,
                                    **kw))
    prompts = [rng.integers(3, 256, n).tolist() for n in (6, 21)]
    sp = dict(greedy=True, max_new_tokens=8)
    rj = je.generate(prompts, JSamplingParams(**sp), eos_token_id=None)
    rt = te.generate(prompts, SamplingParams(**sp), eos_token_id=None)
    assert rt.token_ids == rj.token_ids

    path_t = str(tmp_path / "torch.npz")
    weights.save_params(te.params, path_t)
    _cmp_trees(te.params, j_weights.load_saved_params(path_t, device=False))
    back = weights.load_saved_params(path_t)
    _cmp_trees(back, j_weights.load_saved_params(path_j, device=False))


def test_unported_quantization_paths_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        weights.quantize_params_calibrated({}, {}, "int4")
    (tmp_path / "model.safetensors").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_engine("debug", str(tmp_path),
                      EngineConfig(quant_mode="int4", quant_group_size=64))

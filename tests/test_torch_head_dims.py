"""Head dims 80, 96 and 256: the PyTorch port's attention and int8 row
quantizer against the JAX package on the CPU, and the head-dim set that
every kernel source is built for.

The port runs its plain versions (CPU tensors), the JAX package its golden
``attention_xla`` and its decode route (``attention`` with one query row,
Pallas interpreted, as conftest sets it): at these widths the JAX package
leaves its fused MXU decode (``D % 128 != 0``) for the general Pallas
kernel. Inputs come from a numpy seed.

Tolerances. Attention in f32 on both sides sums in another order: 1e-5.
The absmax quantizer is the same f32 arithmetic (IEEE divide, round half
to even): values and scales equal. The JAX package's other int8 numerics,
its embedded log2-snapped scales, is defined only where ``D % 128 == 0``
(``embedded_supported``), so at 80 and 96 there is one numerics to hold.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.ops import attention as j_attn
from llm_inference_engine_tpu.ops import kv_cache as j_kvc
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingParams)
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops import _native, attention
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

NEW_DIMS = (80, 96, 256)
F32 = dict(atol=1e-5, rtol=1e-5)
L, B, K, G = 2, 3, 2, 2


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("window", [None, 5])
def test_prefill_attention_matches_attention_xla(rng, D, window):
    """The plain prefill (a stacked cache read at a layer) against
    ``attention_xla``: ragged chunks, one row with no new token."""
    S, T = 20, 6
    q = _normal(rng, B, T, K * G, D)
    kc, vc = _normal(rng, L, B, S, K, D), _normal(rng, L, B, S, K, D)
    q_start = np.array([0, 4, 11], np.int32)
    kv_len = q_start + np.array([6, 3, 0], np.int32)
    want = j_attn.attention_xla(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(q_start), jnp.asarray(kv_len), layer=jnp.int32(1),
        window=window)
    got = attention.attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(q_start), torch.from_numpy(kv_len), layer=1,
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("window", [None, 7])
def test_fused_decode_matches_jax_decode_route(rng, D, window):
    """The port's fused decode (write, then attend) against the JAX decode
    route at this width: the slot write, then ``attention`` with one query
    row through its Pallas kernel (interpreted). Row 2 is inactive; the
    caches must come out equal (S a multiple of the JAX kernel's 16-key
    blocks, whose tail it does not mask)."""
    S = 32
    q = _normal(rng, B, 1, K * G, D)
    kn, vn = _normal(rng, B, 1, K, D), _normal(rng, B, 1, K, D)
    kc, vc = _normal(rng, L, B, S, K, D), _normal(rng, L, B, S, K, D)
    q_start = np.array([0, 9, 17], np.int32)
    active = np.array([1, 1, 0], np.int32)
    kv_len = q_start + active
    jc = j_kvc.KVCache(k=jnp.asarray(kc), v=jnp.asarray(vc),
                       lengths=jnp.asarray(q_start))
    jc = j_kvc.update_cache_at_layer(
        jc, jnp.int32(1), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(q_start), jnp.asarray(active), kernels="xla")
    want = j_attn.attention(
        jnp.asarray(q), jc.k, jc.v, jnp.asarray(q_start), jnp.asarray(kv_len),
        kernels="pallas", block_q=16, block_kv=16, layer=jnp.int32(1),
        window=window)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, tk, tv = attention.attention_decode_fused(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk,
        tv, torch.from_numpy(q_start), torch.from_numpy(kv_len), 1,
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jc.v))


@pytest.mark.parametrize("D", NEW_DIMS)
def test_paged_decode_matches_jax_decode_route(rng, D):
    """The port's attend-only paged decode against the JAX decode route
    through a shuffled block table (pages of 8), kv_len 1, 8 and 13."""
    page, maxp = 8, 3
    P = 1 + B * maxp
    table = (rng.permutation(P - 1)[:B * maxp] + 1).astype(
        np.int32).reshape(B, maxp)
    kp, vp = _normal(rng, L, P, page, K, D), _normal(rng, L, P, page, K, D)
    q = _normal(rng, B, 1, K * G, D)
    kv_len = np.array([1, 8, 13], np.int32)
    want = j_attn.attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(kv_len - 1), jnp.asarray(kv_len), kernels="pallas",
        block_q=8, block_kv=8, layer=jnp.int32(1),
        table=jnp.asarray(table))
    got = attention.attention_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(kv_len - 1), torch.from_numpy(kv_len), 1,
        table=torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absmax_quantizer_matches_jax_at_head_dims(rng, D, dtype):
    """The int8 row quantizer of kernel I's plain version against
    ``_quantize_kv``, bit for bit, with an all-zero row."""
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    x = _normal(rng, 2, 5, K, D) * 2.0
    x.reshape(-1, D)[0] = 0.0
    jq, js = j_kvc._quantize_kv(jnp.asarray(x, jd))
    tq, ts = kvc.quantize_kv(torch.from_numpy(x).to(td))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not tq.reshape(-1, D)[0].any()


@pytest.mark.parametrize("D", [80, 96])
def test_generate_greedy_ids_match_jax_at_head_dims(rng, D):
    """The slice as a whole: the debug model at head_dim D in f32 (the JAX
    engine on its XLA path), 8 greedy tokens over three ragged prompts,
    one of them chunked."""
    import jax
    from llm_inference_engine_tpu.models.weights import (
        init_dummy_params as j_init_dummy_params)
    cfg_j = j_get_config("debug").replace(head_dim=D)
    jp = j_init_dummy_params(cfg_j, 5)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    cfg = ModelConfig(**{f: getattr(cfg_j, f)
                         for f in ModelConfig.__dataclass_fields__})
    kw = dict(max_batch_size=3, max_seq_len=64, max_prefill_len=16)
    je = JInferenceEngine(cfg_j, JEngineConfig(kernels="xla", **kw), jp)
    te = InferenceEngine(cfg, EngineConfig(**kw), tp, device="cpu")
    prompts = [rng.integers(3, 256, n).tolist() for n in (4, 21, 9)]
    sp = dict(greedy=True, max_new_tokens=8)
    rj = je.generate(prompts, JSamplingParams(**sp), eos_token_id=None)
    rt = te.generate(prompts, SamplingParams(**sp), eos_token_id=None)
    assert rt.token_ids == rj.token_ids


# every source with a ``switch (D)``, by the head dims its instances take:
# the bf16 attention sources ``_native.HEAD_DIMS``, the float16 and
# float32 attention sources ``_native.FLOAT_HEAD_DIMS``; the int8 write's
# source has one switch for each, in that order (bf16 rows, then float16
# and float32 rows)
_SOURCES = {
    "attention_prefill.cu": _native.HEAD_DIMS,
    "attention_decode.cu": _native.HEAD_DIMS,
    "kv_write_quant.cu": (_native.HEAD_DIMS, _native.FLOAT_HEAD_DIMS),
    "attention_prefill_f16.cu": _native.FLOAT_HEAD_DIMS,
    "attention_prefill_f32.cu": _native.FLOAT_HEAD_DIMS,
    "attention_decode_f16.cu": _native.FLOAT_HEAD_DIMS,
    "attention_decode_f32.cu": _native.FLOAT_HEAD_DIMS,
}
_SWITCH = re.compile(r"switch \(D\) \{(.*?)\n\s*\}", re.S)


@pytest.mark.parametrize("name", list(_SOURCES))
def test_kernel_switches_match_the_python_head_dims(name):
    """Each ``switch (D)`` of the source instantiates exactly the head dims
    that the Python wrappers accept for the dtype it serves
    (``_native.HEAD_DIMS`` for bf16, ``_native.FLOAT_HEAD_DIMS`` for
    float16 and float32)."""
    text = (_native.CSRC / name).read_text()
    blocks = _SWITCH.findall(text)
    assert blocks, f"{name} has no switch (D)"
    want = _SOURCES[name]
    if isinstance(want[0], tuple):        # one switch a set, in order
        assert len(blocks) == len(want)
    else:
        want = (want,) * len(blocks)
    for block, dims in zip(blocks, want):
        cases = tuple(sorted(int(c) for c in re.findall(r"case (\d+):",
                                                        block)))
        assert cases == dims


def test_every_head_dim_switch_is_held():
    """No source or header has a ``switch (D)`` that the test above does not
    hold to a head-dim set."""
    found = {src.name for src in (*_native.CSRC.glob("*.cu"),
                                  *_native.CSRC.glob("*.cuh"))
             if _SWITCH.search(src.read_text())}
    assert found == set(_SOURCES)


def test_quantizer_header_matches_the_python_head_dims():
    text = (_native.CSRC / "kv_quant.cuh").read_text()
    assert_line = re.search(r"static_assert\(([^;]*)\);", text, re.S).group(1)
    dims = tuple(sorted(int(d) for d in re.findall(r"D == (\d+)",
                                                   assert_line)))
    assert dims == _native.HEAD_DIMS


def _int8_write_check(D):
    cache = kvc.new_kv_cache(1, 2, 2, 8, D, quantized=True)
    new = torch.zeros(2, 1, 2, D, dtype=torch.bfloat16)
    lens = torch.ones(2, dtype=torch.int32)
    kvc._check_write(cache, 0, new, new, lens, lens)


def _paged_int8_write_check(D):
    cache = pkv.new_paged_kv_cache(1, 2, 2, 3, 4, D, 2, quantized=True)
    new = torch.zeros(2, 1, 2, D, dtype=torch.bfloat16)
    lens = torch.ones(2, dtype=torch.int32)
    pkv._check_write(cache, 0, new, new, lens, lens)


def _attention_check(D):
    q = torch.zeros(2, 1, 4, D, dtype=torch.bfloat16)
    c = torch.zeros(1, 2, 8, 2, D, dtype=torch.bfloat16)
    lens = torch.ones(2, dtype=torch.int32)
    attention._check(q, c, c, lens, lens, 0)


@pytest.mark.parametrize("check", [_attention_check, _int8_write_check,
                                   _paged_int8_write_check],
                         ids=["attention", "kv_write_quant",
                              "paged_kv_write_quant"])
def test_kernel_checks_read_one_head_dim_set(check):
    """The wrappers' checks take every head dim of ``_native.HEAD_DIMS``
    and raise NotImplementedError naming the set for any other."""
    for D in _native.HEAD_DIMS:
        check(D)
    with pytest.raises(NotImplementedError, match=re.escape(
            str(_native.HEAD_DIMS))):
        check(48)

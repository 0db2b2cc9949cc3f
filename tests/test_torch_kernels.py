"""Hand-written Hopper kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip where there is no CUDA device (the
``cuda`` fixture decides at run time, so every pytest worker collects the
same tests). Run them on the H100 with
``python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_kernels.py`` (``--noconftest``: tests/conftest.py
imports JAX, which the GPU machine need not have; this file imports none).

Shapes are ragged on purpose: hardware reads past a tensor's end return
garbage rather than zeros, so the kernels must mask their tails
themselves. Tolerance 2e-2 on bf16 outputs: the kernels and the plain
versions both compute in f32 and round once, but sum in another order,
so an output can land one bf16 ulp (~4e-3 relative) apart.
"""

import pytest
import torch

from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
from llm_inference_engine_tpu_torch.models.weights import init_dummy_params
from llm_inference_engine_tpu_torch.ops import activations, attention
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops import quant, rmsnorm
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100)")
    torch.manual_seed(0)
    return torch.device("cuda")


@pytest.mark.parametrize("n,h", [(7, 4096), (300, 1000)])
def test_rmsnorm_kernels(cuda, n, h):
    x = torch.randn(n, h, device=cuda, dtype=torch.bfloat16)
    r = torch.randn(n, h, device=cuda, dtype=torch.bfloat16)
    w = torch.rand(h, device=cuda, dtype=torch.bfloat16) + 0.5
    torch.testing.assert_close(rmsnorm.rmsnorm(x, w, kernels="cuda"),
                               rmsnorm.rmsnorm_torch(x, w), **TOL)
    y, hh = rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda")
    y0, h0 = rmsnorm.add_residual_rmsnorm_torch(x, r, w)
    torch.testing.assert_close(hh, h0, atol=0, rtol=0)
    torch.testing.assert_close(y, y0, **TOL)


@pytest.mark.parametrize("n,inter", [(5, 11008), (129, 1000)])
def test_silu_and_mul_kernel(cuda, n, inter):
    x = torch.randn(n, 2 * inter, device=cuda, dtype=torch.bfloat16)
    torch.testing.assert_close(activations.silu_and_mul(x, kernels="cuda"),
                               activations.silu_and_mul_torch(x), **TOL)


def test_kv_write_kernel(cuda):
    L, B, S, K, D, T = 3, 4, 600, 8, 128, 512
    new_k = torch.randn(B, T, K, D, device=cuda, dtype=torch.bfloat16)
    new_v = torch.randn_like(new_k)
    starts = torch.tensor([0, 37, 599, 88], device=cuda, dtype=torch.int32)
    new_len = torch.tensor([512, 300, 1, 0], device=cuda, dtype=torch.int32)
    base = torch.randn(L, B, S, K, D, device=cuda, dtype=torch.bfloat16)
    lengths = torch.zeros(B, device=cuda, dtype=torch.int32)
    caches = [kvc.KVCache(base.clone(), base.clone(), lengths)
              for _ in range(2)]
    kvc.update_cache_at_layer(caches[0], 2, new_k, new_v, starts, new_len,
                              kernels="cuda")
    kvc.update_cache_at_layer_torch(caches[1], 2, new_k, new_v, starts,
                                    new_len)
    torch.cuda.synchronize()
    assert torch.equal(caches[0].k, caches[1].k)
    assert torch.equal(caches[0].v, caches[1].v)


def _qkv(cuda, L, B, T, H, K, S, D):
    q = torch.randn(B, T, H, D, device=cuda, dtype=torch.bfloat16)
    kc = torch.randn(L, B, S, K, D, device=cuda, dtype=torch.bfloat16)
    vc = torch.randn_like(kc)
    return q, kc, vc


@pytest.mark.parametrize("K,G,D,window", [(4, 1, 128, None), (2, 4, 128, None),
                                          (2, 4, 128, 70), (3, 2, 64, None)])
def test_prefill_attention_kernel(cuda, K, G, D, window):
    L, B, T, S = 2, 4, 77, 300
    q, kc, vc = _qkv(cuda, L, B, T, K * G, K, S, D)
    q_start = torch.tensor([0, 5, 150, 223], device=cuda, dtype=torch.int32)
    kv_len = q_start + torch.tensor([77, 40, 1, 0], device=cuda,
                                    dtype=torch.int32)
    got = attention.attention(q, kc, vc, q_start, kv_len, layer=1,
                              window=window, kernels="cuda")
    want = attention.attention_torch(q, kc, vc, q_start, kv_len, layer=1,
                                     window=window)
    torch.testing.assert_close(got, want, **TOL)


def test_prefill_attention_empty_rows_are_zero(cuda):
    q, kc, vc = _qkv(cuda, 1, 2, 9, 4, 4, 64, 128)
    zero = torch.zeros(2, device=cuda, dtype=torch.int32)
    out = attention.attention(q, kc, vc, zero, zero, layer=0, kernels="cuda")
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("K,G,window", [(8, 1, None), (4, 4, None),
                                        (4, 4, 100)])
def test_fused_decode_kernel(cuda, K, G, window):
    L, B, S, D = 2, 4, 1000, 128
    q, kc, vc = _qkv(cuda, L, B, 1, K * G, K, S, D)
    k_new = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    v_new = torch.randn_like(k_new)
    q_start = torch.tensor([0, 17, 500, 999], device=cuda, dtype=torch.int32)
    kv_len = q_start + torch.tensor([1, 1, 0, 1], device=cuda,
                                    dtype=torch.int32)    # row 2 inactive
    kc2, vc2 = kc.clone(), vc.clone()
    got, _, _ = attention.attention_decode_fused(
        q, k_new, v_new, kc, vc, q_start, kv_len, 1, window=window,
        kernels="cuda")
    want, _, _ = attention.attention_decode_fused_torch(
        q, k_new, v_new, kc2, vc2, q_start, kv_len, 1, window=window)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    torch.testing.assert_close(got, want, **TOL)


def test_bf16_engine_kernels_match_plain(cuda):
    """A small bf16 model: the prefill logits of the kernel path and the
    plain path agree (the ~1-ulp differences of each kernel compound over
    the layers, hence 5e-2 on logits of magnitude ~1)."""
    cfg = get_config("debug").replace(dtype_name="bfloat16", head_dim=128,
                                      num_layers=3)
    eng = EngineConfig(max_batch_size=3, max_seq_len=256, max_prefill_len=64)
    params = init_dummy_params(cfg, device=cuda)
    e_k = InferenceEngine(cfg, eng, params, device=cuda)
    e_t = InferenceEngine(cfg, eng.replace(kernels="torch"), params,
                          device=cuda)
    prompts = [[1, 2, 3], list(range(5, 100)), [7] * 30]
    lk, lt = e_k.prefill(prompts), e_t.prefill(prompts)
    assert torch.isfinite(lk).all()
    torch.testing.assert_close(lk, lt, atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------------------------
# kernels E, F (fused dequant-matmul) and G (int4 dequantize)
# ---------------------------------------------------------------------------

def _qweight(dev, mode, k, n, halves=1, group=128):
    """Random quantized weight [k, n] (or the [2, k', n] gate|up stack)."""
    lead = (2,) if halves == 2 else ()
    int4 = mode == "int4"
    q = torch.randint(-128 if int4 else -127, 128,
                      (*lead, k // 2 if int4 else k, n), dtype=torch.int8,
                      device=dev)
    s = torch.rand((*lead, k // group if int4 else 1, n), device=dev)
    return quant.QuantizedTensor(q, s * 1e-2 + 1e-3, mode, group)


def _fused(mode):
    return quant.int4_matmul if mode == "int4" else quant.int8_matmul


def _run_fused(t, x, out_dtype, kernels):
    if t.mode == "int4":
        return quant.int4_matmul(x, t.q, t.scale, t.group_size, out_dtype,
                                 kernels=kernels)
    return quant.int8_matmul(x, t.q, t.scale, out_dtype, kernels=kernels)


@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("m", [1, 5, 33, 300, 1023])
def test_fused_quant_matmul_kernels(cuda, mode, m):
    """K = 11008 (no power of two divides it past 256), n = 384 (ragged
    against the 64-column tiles), bf16 out."""
    t = _qweight(cuda, mode, 11008, 384)
    x = torch.randn(m, 11008, device=cuda, dtype=torch.bfloat16)
    before = _fused(mode).launches
    got = _run_fused(t, x, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    assert _fused(mode).launches == before + 1
    torch.testing.assert_close(got, _run_fused(t, x, torch.bfloat16, "torch"),
                               **TOL)


@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("m", [5, 300])
def test_fused_quant_matmul_gate_up_stack(cuda, mode, m):
    """One launch over both halves of a layer of the [L, 2, k', I] stack
    (a view with an offset), flat [m, gate | up] out."""
    stack = _qweight(cuda, mode, 512, 1040, halves=2)
    full = quant.QuantizedTensor(stack.q[None].repeat(3, 1, 1, 1),
                                 stack.scale[None].repeat(3, 1, 1, 1),
                                 mode, 128)
    layer = full[2]
    x = torch.randn(m, 512, device=cuda, dtype=torch.bfloat16)
    got = _run_fused(layer, x, torch.bfloat16, "cuda")
    want = torch.cat([_run_fused(quant.QuantizedTensor(
        stack.q[h], stack.scale[h], mode, 128), x, torch.bfloat16, "torch")
        for h in range(2)], dim=-1)
    assert got.shape == (m, 2080)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_fused_quant_matmul_f32_out(cuda, mode):
    """The lm_head: bf16 x, f32 out, vocab 32000 (not a power of two).
    Only the order of the f32 sums differs from the plain version."""
    t = _qweight(cuda, mode, 4096, 32000)
    x = torch.randn(8, 4096, device=cuda, dtype=torch.bfloat16)
    got = _run_fused(t, x, torch.float32, "cuda")
    want = _run_fused(t, x, torch.float32, "torch")
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("k,n,halves", [(11008, 384, 1), (512, 1040, 2)])
def test_dequant_int4_kernel_bit_identical(cuda, k, n, halves):
    t = _qweight(cuda, "int4", k, n, halves=halves)
    got = quant.dequant_int4(t.q, t.scale, 128, kernels="cuda")
    want = quant.dequant_int4(t.q, t.scale, 128, kernels="torch")
    torch.cuda.synchronize()
    assert got.shape == (k, halves * n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_quantized_linear_large_m_routes_through_kernels(cuda, mode):
    """m >= 1024: int4 dequantizes through kernel G, then a bf16 matmul."""
    t = _qweight(cuda, mode, 1024, 384)
    x = torch.randn(2, 600, 1024, device=cuda, dtype=torch.bfloat16)
    before = quant.dequant_int4.launches
    got = quant.quantized_linear(x, t)
    want = quant.quantized_linear_torch(x, t)
    assert got.shape == (2, 600, 384)
    assert quant.dequant_int4.launches == before + (mode == "int4")
    torch.testing.assert_close(got, want, **TOL)


def test_quant_kernels_refuse_instead_of_falling_back(cuda):
    t = _qweight(cuda, "int4", 256, 128)
    with pytest.raises(TypeError):
        quant.quantized_linear(torch.randn(4, 256, device=cuda), t)
    with pytest.raises(ValueError):
        quant.quantized_linear(
            torch.randn(4, 256, device=cuda, dtype=torch.bfloat16),
            quant.QuantizedTensor(t.q, t.scale, "int4", 32))


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_quantized_engine_kernels_match_plain(cuda, mode):
    """A small born-quantized bf16 model: prefill logits of the kernel path
    against the plain path (5e-2 as for the bf16 engine above)."""
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_quantized_params)
    cfg = get_config("debug").replace(dtype_name="bfloat16", head_dim=128,
                                      num_layers=3)
    eng = EngineConfig(max_batch_size=3, max_seq_len=256, max_prefill_len=64,
                       quant_mode=mode, quant_group_size=64)
    params = init_dummy_quantized_params(cfg, mode, 64, device=cuda)
    e_k = InferenceEngine(cfg, eng, params, device=cuda)
    e_t = InferenceEngine(cfg, eng.replace(kernels="torch"), params,
                          device=cuda)
    prompts = [[1, 2, 3], list(range(5, 100)), [7] * 30]
    before = _fused(mode).launches
    lk, lt = e_k.prefill(prompts), e_t.prefill(prompts)
    assert _fused(mode).launches > before
    assert torch.isfinite(lk).all()
    torch.testing.assert_close(lk, lt, atol=5e-2, rtol=5e-2)

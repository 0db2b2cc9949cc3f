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

import contextlib
import dataclasses
import re

import numpy as np
import pytest
import torch

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models.weights import init_dummy_params
from llm_inference_engine_tpu_torch.ops import activations, attention
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops import quant, rmsnorm, rope
from llm_inference_engine_tpu_torch.ops import counted_wrappers
from llm_inference_engine_tpu_torch.ops._native import FLOAT_HEAD_DIMS
from llm_inference_engine_tpu_torch.runtime.decode_graph import (
    HostReadError, run_eagerly)
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100)")
    torch.manual_seed(0)
    return torch.device("cuda")


# Kernels A and B (csrc/norm_act.cu): the decode step's rows (1, 8, 16),
# ragged row counts, a prefill's 2048; widths of 16-byte loads (4096,
# 1000, 11008) and of one value a load (1001: no row is 16-byte aligned).
NORM_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=str)
@pytest.mark.parametrize("n,h", [(1, 4096), (7, 4096), (8, 4096),
                                 (16, 4096), (2048, 4096), (300, 1000),
                                 (8, 1000), (5, 1001), (16, 1001)])
def test_rmsnorm_kernels(cuda, n, h, dtype):
    """A in both modes against the plain versions; the residual sum h is
    bit-identical (the same f32 add, rounded once)."""
    x = torch.randn(n, h, device=cuda, dtype=dtype)
    r = torch.randn(n, h, device=cuda, dtype=dtype)
    w = torch.rand(h, device=cuda, dtype=dtype) + 0.5
    torch.testing.assert_close(rmsnorm.rmsnorm(x, w, kernels="cuda"),
                               rmsnorm.rmsnorm_torch(x, w), **TOL)
    y, hh = rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda")
    y0, h0 = rmsnorm.add_residual_rmsnorm_torch(x, r, w)
    torch.testing.assert_close(hh, h0, atol=0, rtol=0)
    torch.testing.assert_close(y, y0, **TOL)


@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=str)
@pytest.mark.parametrize("n,inter", [(1, 11008), (5, 11008), (8, 11008),
                                     (16, 11008), (2048, 11008),
                                     (129, 1000), (8, 1001)])
def test_silu_and_mul_kernel(cuda, n, inter, dtype):
    x = torch.randn(n, 2 * inter, device=cuda, dtype=dtype)
    torch.testing.assert_close(activations.silu_and_mul(x, kernels="cuda"),
                               activations.silu_and_mul_torch(x), **TOL)


def test_norm_act_kernels_refuse_instead_of_falling_back(cuda):
    """Rows wider than kernel A holds, a weight of another dtype and an
    odd packed width raise on the card."""
    x = torch.zeros(2, 16385, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wider"):
        rmsnorm.rmsnorm(x, torch.ones(16385, device=cuda,
                                      dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="weight dtype"):
        rmsnorm.rmsnorm(x[:, :4096].contiguous(),
                        torch.ones(4096, device=cuda))
    with pytest.raises(ValueError):
        activations.silu_and_mul(torch.zeros(2, 7, device=cuda))


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_pdl_chain_replays_equal_eager(cuda, mode):
    """The decode step's chain at 7B widths, m = 8: E(wqkv) -> J (the QKV
    split with RoPE) -> E(wo) on J's q -> A with residual -> E(gate|up)
    -> B -> E(down), every kernel a programmatic dependent of the one
    before, captured in one CUDA graph and replayed 200 times: every
    replay's outputs are bit-identical to the eager chain's."""
    wqkv = _qweight(cuda, mode, 4096, 12288)
    wo = _qweight(cuda, mode, 4096, 4096)
    gate_up = _qweight(cuda, mode, 4096, 11008, halves=2)
    down = _qweight(cuda, mode, 11008, 4096)
    attn = torch.randn(8, 4096, device=cuda, dtype=torch.bfloat16)
    resid = torch.randn(8, 4096, device=cuda, dtype=torch.bfloat16)
    w = torch.rand(4096, device=cuda, dtype=torch.bfloat16) + 0.5
    cos, sin = (t[:, None, :].contiguous() for t in rope.rope_cos_sin(
        torch.arange(300, 308, device=cuda), 128, 10000.0))

    def chain():
        qkv = _run_fused(wqkv, attn, torch.bfloat16, "cuda")
        q, k, v = rope.split_qkv_rope_fused(qkv, cos, sin, 32, 32, 128)
        o = _run_fused(wo, q.reshape(8, 4096), torch.bfloat16, "cuda")
        y, h = rmsnorm.add_residual_rmsnorm(o, resid, w)
        act = activations.silu_and_mul(_run_fused(gate_up, y, torch.bfloat16,
                                                  "cuda"))
        return k, v, h, _run_fused(down, act, torch.bfloat16, "cuda")
    want = chain()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = chain()
    for _ in range(200):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(g, v) for g, v in zip(got, want))


# Kernel J (csrc/norm_act.cu): the QKV split with RoPE, every dtype and
# head dim of the float instances, groups 1 / 4 / 8 at 16 and 32 kv heads,
# the decode step's token counts (1, 7, 8), the verify's 40 and a prefill
# chunk's 4096; bit for bit the plain version (the same f32 products, sum
# and difference, one rounding), every input at the head of a buffer
# whose tail holds NaN.
ROPE_HEADS = [(32, 1), (16, 1), (32, 4), (16, 8)]


def _nan_tail(t, pad: int = 1 << 12, shift: int = 0):
    """``t``'s values ``shift`` elements into a buffer of NaN (127 for an
    integer dtype) that runs ``pad`` elements past them."""
    fill = float("nan") if t.is_floating_point() else 127
    buf = torch.full((t.numel() + pad + shift,), fill, dtype=t.dtype,
                     device=t.device)
    buf[shift:shift + t.numel()].copy_(t.flatten())
    return buf[shift:shift + t.numel()].view(t.shape)


def _rope_inputs(dev, n, K, G, D, dtype):
    qkv = torch.randn(n, K * (G + 2) * D, device=dev, dtype=dtype)
    pos = torch.randint(-70000, 1 << 20, (n,), device=dev)
    cos, sin = (t[:, None, :].contiguous()
                for t in rope.rope_cos_sin(pos, D, 10000.0))
    return qkv, cos, sin


def _rope_held(qkv, cos, sin, K, G, D, shift=0):
    """J on poisoned copies of its inputs (qkv ``shift`` elements into its
    buffer) against the plain version on the inputs: q, k, v bit for bit,
    one launch."""
    before = rope.split_qkv_rope_fused.launches
    got = rope.split_qkv_rope_fused(_nan_tail(qkv, shift=shift),
                                    _nan_tail(cos), _nan_tail(sin),
                                    K * G, K, D)
    want = rope.split_qkv_rope_fused_torch(qkv, cos, sin, K * G, K, D)
    torch.cuda.synchronize()
    assert rope.split_qkv_rope_fused.launches == before + 1
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=str)
@pytest.mark.parametrize("D", FLOAT_HEAD_DIMS)
@pytest.mark.parametrize("K,G", ROPE_HEADS)
def test_split_qkv_rope_kernel_bit_for_bit(cuda, dtype, D, K, G):
    for n in (1, 7, 8, 40, 4096):
        _rope_held(*_rope_inputs(cuda, n, K, G, D, dtype), K, G, D)


@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=str)
def test_split_qkv_rope_kernel_one_value_a_load(cuda, dtype):
    """A half row the 16-byte vector does not fill (head_dim 18) and a
    qkv that is not 16-byte aligned take J's one-value loads."""
    _rope_held(*_rope_inputs(cuda, 9, 4, 2, 18, dtype), 4, 2, 18)
    _rope_held(*_rope_inputs(cuda, 9, 4, 2, 64, dtype), 4, 2, 64, shift=1)


def test_split_qkv_rope_kernel_refuses_instead_of_falling_back(cuda):
    """float64, a non-contiguous qkv and an odd head_dim raise on the
    card."""
    qkv, cos, sin = _rope_inputs(cuda, 8, 4, 1, 64, torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        rope.split_qkv_rope_fused(qkv.double(), cos, sin, 4, 4, 64)
    wide = torch.randn(8, 2 * qkv.shape[1], device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        rope.split_qkv_rope_fused(wide, cos, sin, 4, 4, 64)
    odd = torch.randn(8, 4 * 3 * 63, device=cuda)
    with pytest.raises(ValueError, match="even"):
        rope.split_qkv_rope_fused(odd, cos[..., :31].contiguous(),
                                  sin[..., :31].contiguous(), 4, 4, 63)


# Kernel G8 (ops/_triton_kernels.py): the INT8 weight cast exactly to bf16,
# each half of the gate|up stack into its columns, bit for bit
# ``.to(torch.bfloat16)`` + ``_cat``, q at the head of a buffer whose tail
# holds 127
@pytest.mark.parametrize("k,n,halves", [(4096, 11008, 2), (11008, 4096, 1),
                                        (1000, 1040, 2), (37, 100, 1)])
def test_dequant_int8_kernel_bit_for_bit(cuda, k, n, halves):
    t = _qweight(cuda, "int8", k, n, halves=halves)
    before = quant.dequant_int8.launches
    got = quant.dequant_int8(_nan_tail(t.q), kernels="cuda")
    want = quant.dequant_int8_torch(t.q)
    torch.cuda.synchronize()
    assert quant.dequant_int8.launches == before + halves
    assert got.shape == (k, halves * n)
    assert torch.equal(got, want)


# G8's epilogue: the f32 product times the per-column scale, rounded once
# to the output dtype, bit for bit ``(y * scale).to(dtype)``; ragged m and
# n, y and the scale with NaN past their tails
@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=str)
@pytest.mark.parametrize("m,n", [(1024, 12288), (4096, 22016), (1030, 1040),
                                 (1, 7)])
def test_int8_scale_cast_kernel_bit_for_bit(cuda, dtype, m, n):
    y = torch.randn(m, n, device=cuda) * 40.0
    scale = torch.rand(1, n, device=cuda) * 1e-2 + 1e-4
    before = quant.int8_scale_cast.launches
    got = quant.int8_scale_cast(_nan_tail(y), _nan_tail(scale), dtype,
                                kernels="cuda")
    want = quant.int8_scale_cast_torch(y, scale, dtype)
    torch.cuda.synchronize()
    assert quant.int8_scale_cast.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, want)


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


# Prefill cases of kernel D2: (T, S, q_start, new rows per sequence). The
# first is a ragged 77-row chunk (a row of 1 and one of 0 new rows); the
# others reach kv_len 2048 (32 tiles of 64 keys, so the copy ring wraps
# many times) from 130 rows and from 1 row.
CHUNK = (77, 300, [0, 5, 150, 223], [77, 40, 1, 0])
LONG = (130, 2048, [0, 5, 1024, 1918], [130, 70, 1, 130])
ONE_ROW = (1, 2048, [0, 5, 1024, 2047], [1, 0, 1, 1])


def _case(*args, D=None, lens=CHUNK, tag=""):
    """A parametrize case: ``args``, then ``D`` where given, then ``lens``.
    Its id is ``args`` joined, then ``tag``, so the original cases keep
    their ids."""
    values = args + (() if D is None else (D,)) + (lens,)
    return pytest.param(*values, id="-".join(map(str, args)) + tag)


def _lens(cuda, lens):
    T, S, starts, new = lens
    q_start = torch.tensor(starts, device=cuda, dtype=torch.int32)
    return T, S, q_start, q_start + torch.tensor(new, device=cuda,
                                                 dtype=torch.int32)


@pytest.mark.parametrize("K,G,D,window,lens", [
    _case(4, 1, 128, None), _case(2, 4, 128, None), _case(2, 4, 128, 70),
    _case(3, 2, 64, None),
    _case(4, 8, 128, None, lens=LONG, tag="-long"),
    _case(2, 8, 64, 100, lens=LONG, tag="-long"),   # window starts mid-tile
    _case(8, 1, 128, 300, lens=LONG, tag="-long"),
    _case(4, 8, 128, None, lens=ONE_ROW, tag="-one-row"),
    _case(2, 4, 64, 70, lens=ONE_ROW, tag="-one-row")])
def test_prefill_attention_kernel(cuda, K, G, D, window, lens):
    T, S, q_start, kv_len = _lens(cuda, lens)
    q, kc, vc = _qkv(cuda, 2, 4, T, K * G, K, S, D)
    got = attention.attention(q, kc, vc, q_start, kv_len, layer=1,
                              window=window, kernels="cuda")
    want = attention.attention_torch(q, kc, vc, q_start, kv_len, layer=1,
                                     window=window)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("mode", ["slot", "paged", "int8", "paged-int8"])
def test_prefill_attention_empty_rows_are_zero(cuda, mode):
    """kv_len 0 (no visible key) gives exact zeros in every D2 mode."""
    q = torch.randn(2, 9, 4, 128, device=cuda, dtype=torch.bfloat16)
    zero = torch.zeros(2, device=cuda, dtype=torch.int32)
    if mode.startswith("paged"):
        c = (_int8_pool if mode == "paged-int8" else _paged_pool)(
            cuda, 1, 2, 4, 16, 4, 128)
        kw = dict(table=c.block_table)
    elif mode == "int8":
        c = _int8_slot(cuda, 1, 2, 64, 4, 128, False)
        kw = {}
    else:
        c = kvc.KVCache(*_qkv(cuda, 1, 2, 9, 4, 4, 64, 128)[1:], zero)
        kw = {}
    if mode.endswith("int8"):
        kw.update(_planes(c))
    out = attention.attention(q, c.k, c.v, zero, zero, layer=0,
                              kernels="cuda", **kw)
    assert torch.equal(out, torch.zeros_like(out))


def _poison_slot(c, kv_len):
    """NaN into every row at or past kv_len of each sequence: the values of
    a bf16 cache, the scales of an int8 one."""
    names = ("k_scale", "v_scale") if c.k_scale is not None else ("k", "v")
    for name in names:
        t = getattr(c, name)
        for b, n in enumerate(kv_len.tolist()):
            t[:, b, n:] = float("nan")


def _poison_pool(c, kv_len, page):
    """NaN into every pool row that no key below kv_len maps to: the pages
    not in the table (page 0 included) and the tails of the last used
    pages; table entries past the used pages point at page 0."""
    used = (kv_len.long() + page - 1) // page
    cols = torch.arange(c.block_table.shape[1], device=kv_len.device)
    c.block_table[cols[None, :] >= used[:, None]] = 0
    keep = torch.zeros(c.k.shape[1], page, dtype=torch.bool,
                       device=kv_len.device)
    for b, n in enumerate(kv_len.tolist()):
        j = torch.arange(n, device=kv_len.device)
        keep[c.block_table[b, j // page].long(), j % page] = True
    names = ("k_scale", "v_scale") if c.k_scale is not None else ("k", "v")
    for name in names:
        getattr(c, name)[:, ~keep] = float("nan")


@pytest.mark.parametrize("mode", ["slot", "paged", "int8", "paged-int8"])
@pytest.mark.parametrize("lens", [CHUNK, LONG], ids=["chunk", "long"])
def test_prefill_attention_ignores_poisoned_tail(cuda, mode, lens):
    """Every cache row at or past kv_len, and every pool page outside the
    table, holds NaN (values, or an int8 cache's scales): D2 must read
    none of it, and its zero-filled tail rows must stay zero, so it agrees
    with the plain version on a clean copy."""
    T, S, q_start, kv_len = _lens(cuda, lens)
    K, G, D, page = 2, 4, 128, 16
    q = torch.randn(4, T, K * G, D, device=cuda, dtype=torch.bfloat16)
    if mode.startswith("paged"):
        c = (_int8_pool if mode == "paged-int8" else _paged_pool)(
            cuda, 2, 4, S // page + 1, page, K, D)
    elif mode == "int8":
        c = _int8_slot(cuda, 2, 4, S, K, D, True)
    else:
        c = kvc.KVCache(*_qkv(cuda, 2, 4, 1, 1, K, S, D)[1:], q_start)
    clean = [None if t is None else t.clone()
             for t in (c.k, c.v, c.k_scale, c.v_scale)]
    kw = {}
    if mode.startswith("paged"):
        _poison_pool(c, kv_len, page)
        kw = dict(table=c.block_table)
    else:
        _poison_slot(c, kv_len)
    got = attention.attention(q, c.k, c.v, q_start, kv_len, layer=1,
                              kernels="cuda", **kw,
                              **(_planes(c) if c.k_scale is not None else {}))
    want = attention.attention(q, clean[0], clean[1], q_start, kv_len,
                               layer=1, kernels="torch", **kw,
                               **({} if clean[2] is None else dict(
                                   k_scale=clean[2], v_scale=clean[3])))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


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
    # INT4 with groups of 64 or 128: its fragment order too, which kernel
    # E reads at m <= 16 (engines build theirs)
    return quant.add_decode_layout(
        quant.QuantizedTensor(q, s * 1e-2 + 1e-3, mode, group))


def _fused(mode):
    return quant.int4_matmul if mode == "int4" else quant.int8_matmul


def _run_fused(t, x, out_dtype, kernels):
    if t.mode == "int4":
        return quant.int4_matmul(x, t.q, t.scale, t.group_size, out_dtype,
                                 qd=t.qd, kernels=kernels)
    return quant.int8_matmul(x, t.q, t.scale, out_dtype, kernels=kernels)


def _held_against_plain(t, x, out_dtype, **tol):
    before = _fused(t.mode).launches
    got = _run_fused(t, x, out_dtype, "cuda")
    torch.cuda.synchronize()
    assert _fused(t.mode).launches == before + 1
    assert got.dtype == out_dtype
    torch.testing.assert_close(got, _run_fused(t, x, out_dtype, "torch"),
                               **(tol or TOL))
    return got


# m of both modes: decode 8-row (1, 5, 8) and 16-row (9, 16) tiles,
# prefill 64-row (17, 33, 64) and 128-row (300, 512, 1023) tiles
@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("m", [1, 5, 8, 9, 16, 17, 33, 64, 300, 512, 1023])
def test_fused_quant_matmul_kernels(cuda, mode, m):
    """K = 11008 (86 scale groups: no power of two divides it past 256,
    uneven over a cluster of 8), n = 384, bf16 out."""
    t = _qweight(cuda, mode, 11008, 384)
    x = torch.randn(m, 11008, device=cuda, dtype=torch.bfloat16)
    _held_against_plain(t, x, torch.bfloat16)


@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 64, 512, 1023])
def test_fused_quant_matmul_k4096_ragged_n(cuda, mode, m):
    """K = 4096, n = 1040: ragged against the 64- and 128-column tiles."""
    t = _qweight(cuda, mode, 4096, 1040)
    x = torch.randn(m, 4096, device=cuda, dtype=torch.bfloat16)
    _held_against_plain(t, x, torch.bfloat16)


@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("m", [5, 16, 300, 512])
def test_fused_quant_matmul_gate_up_stack(cuda, mode, m):
    """One launch over both halves of a layer of the [L, 2, k', I] stack
    (a view with an offset), flat [m, gate | up] out."""
    stack = _qweight(cuda, mode, 512, 1040, halves=2)
    full = quant.add_decode_layout(quant.QuantizedTensor(
        stack.q[None].repeat(3, 1, 1, 1),
        stack.scale[None].repeat(3, 1, 1, 1), mode, 128))
    layer = full[2]
    x = torch.randn(m, 512, device=cuda, dtype=torch.bfloat16)
    got = _run_fused(layer, x, torch.bfloat16, "cuda")
    want = torch.cat([_run_fused(quant.QuantizedTensor(
        stack.q[h], stack.scale[h], mode, 128), x, torch.bfloat16, "torch")
        for h in range(2)], dim=-1)
    assert got.shape == (m, 2080)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("m", [8, 16])
def test_fused_quant_matmul_f32_out(cuda, mode, m):
    """The lm_head: bf16 x, f32 out, vocab 32000 (not a power of two).
    Only the order of the f32 sums differs from the plain version."""
    t = _qweight(cuda, mode, 4096, 32000)
    x = torch.randn(m, 4096, device=cuda, dtype=torch.bfloat16)
    _held_against_plain(t, x, torch.float32, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("m,k,n", [(8, 11008, 4096), (16, 4096, 4096),
                                   (512, 4096, 1040)])
def test_fused_quant_matmul_is_deterministic(cuda, mode, m, k, n):
    """Two launches on the same inputs are bit-identical: the decode
    mode's cluster merge sums the ranks in order, with no atomics."""
    t = _qweight(cuda, mode, k, n)
    x = torch.randn(m, k, device=cuda, dtype=torch.bfloat16)
    first = _run_fused(t, x, torch.bfloat16, "cuda")
    second = _run_fused(t, x, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("m", [8, 16, 512])
def test_quant_matmul_plan_mirror_equals_library(cuda, m, dtype):
    """ops.quant.quant_matmul_plan (Python, what the CPU tests check)
    equals the library's quant_matmul_plan of x's dtype (E/F, and the
    float16 / float32 instances Ef/Ff) on every 7B projection."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = get_config("llama2-7b")
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    for k, n, halves in ((H, 3 * H, 1), (H, H, 1), (H, I, 2), (I, H, 1),
                         (H, V, 1)):
        for int4 in (True, False):
            native = quant.quant_matmul_plan_native(m, k, n, halves,
                                                    int4=int4, dtype=dtype)
            assert native.pop("blocks_per_sm") >= 1
            assert native == quant.quant_matmul_plan(
                m, k, n, halves, int4=int4, sms=sms, dtype=dtype), (
                    k, n, halves, int4)


def _params_to(tree, device):
    """A params tree (dense or quantized leaves) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("dtype_name", ["float32", "float16"])
def test_debug_preset_generates_on_the_card(cuda, dtype_name):
    """The debug preset (float32, head_dim 16, as shipped; and in float16)
    builds on the card through create_engine and generates through the
    float kernels; on the same weights its float32 greedy ids equal the
    CPU plain route's."""
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    eng = EngineConfig(max_batch_size=3, max_seq_len=64)
    prompts = [[1, 17, 93, 5], [7] * 11, [200, 3]]
    sp = SamplingParams(greedy=True, max_new_tokens=12)
    counters = (attention.attention_prefill_float,
                attention.attention_decode_float)
    before = [f.launches for f in counters]
    if dtype_name == "float32":
        card = create_engine("debug", None, eng)
    else:
        cfg = get_config("debug").replace(dtype_name=dtype_name)
        card = InferenceEngine(cfg, eng, init_dummy_params(
            cfg, seed=0, device=cuda), device=cuda)
    got = card.generate(prompts, sp, eos_token_id=None).token_ids
    assert [f.launches for f in counters] > before
    assert all(len(ids) == 12 for ids in got)
    if dtype_name == "float32":
        cpu = InferenceEngine(card.config, eng,
                              _params_to(card.params, "cpu"), device="cpu")
        assert got == cpu.generate(prompts, sp, eos_token_id=None).token_ids


@pytest.mark.parametrize("dtype_name", ["float32", "float16"])
def test_float_params_on_the_card(cuda, tmp_path, dtype_name):
    """init_dummy_params on the card, params_from_numpy and the .npz
    loader give float16 / float32 leaves on the card, and the three serve
    an engine the same greedy ids."""
    from llm_inference_engine_tpu_torch.models import weights as W
    cfg = get_config("debug").replace(dtype_name=dtype_name)
    drawn = init_dummy_params(cfg, seed=0, device=cuda)

    def numpy_tree(tree):
        return {k: numpy_tree(v) if isinstance(v, dict) else v.cpu().numpy()
                for k, v in tree.items()}
    path = str(tmp_path / "params.npz")
    W.save_params(drawn, path)
    trees = [drawn, W.params_from_numpy(numpy_tree(drawn), cuda),
             W.load_saved_params(path, cuda)]
    ids = []
    for tree in trees:
        leaves = [tree[k] for k in ("embed", "final_norm", "lm_head")] + \
            list(tree["layers"].values())
        assert all(t.dtype == cfg.dtype and t.is_cuda for t in leaves)
        engine = InferenceEngine(cfg, EngineConfig(max_batch_size=2,
                                                   max_seq_len=32), tree,
                                 device=cuda)
        ids.append(engine.generate([[3, 9, 27], [1] * 7], SamplingParams(
            greedy=True, max_new_tokens=6), eos_token_id=None).token_ids)
    assert ids[0] == ids[1] == ids[2]


@pytest.mark.parametrize("k,n,halves", [(11008, 384, 1), (512, 1040, 2)])
def test_dequant_int4_kernel_bit_identical(cuda, k, n, halves):
    t = _qweight(cuda, "int4", k, n, halves=halves)
    got = quant.dequant_int4(t.q, t.scale, 128, kernels="cuda")
    want = quant.dequant_int4(t.q, t.scale, 128, kernels="torch")
    torch.cuda.synchronize()
    assert got.shape == (k, halves * n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["int8", "int4", "int4cal"])
def test_quantizer_on_the_card_equals_the_cpu(cuda, mode):
    """quantize_tensor (and the clip search of int4cal) on the card gives
    the CPU's q and scales bit for bit: every divide is an IEEE divide."""
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(1024, 3000, generator=gen) * torch.rand(3000,
                                                             generator=gen)
    act = torch.rand(1024, generator=gen)
    base = "int4" if mode == "int4cal" else mode

    def build(device):
        wd = w.to(device)
        clip = (quant.search_clip(wd, base, 128, act_sq=act.to(device))
                if mode == "int4cal" else None)
        return quant.quantize_tensor(wd, base, 128, clip=clip)
    got, want = build(cuda), build(torch.device("cpu"))
    assert torch.equal(got.q.cpu(), want.q)
    assert torch.equal(got.scale.cpu(), want.scale)


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_quantized_linear_large_m_routes_through_kernels(cuda, mode):
    """m >= 1024: int4 dequantizes through kernel G, int8 casts through
    kernel G8, then a bf16 matmul (int8: its scale and rounding in G8's
    epilogue, bit for bit the plain route's)."""
    t = _qweight(cuda, mode, 1024, 384)
    x = torch.randn(2, 600, 1024, device=cuda, dtype=torch.bfloat16)
    before = (quant.dequant_int4.launches, quant.dequant_int8.launches,
              quant.int8_scale_cast.launches)
    got = quant.quantized_linear(x, t)
    want = quant.quantized_linear_torch(x, t)
    assert got.shape == (2, 600, 384)
    assert quant.dequant_int4.launches == before[0] + (mode == "int4")
    assert quant.dequant_int8.launches == before[1] + (mode == "int8")
    assert quant.int8_scale_cast.launches == before[2] + (mode == "int8")
    torch.testing.assert_close(got, want, **TOL)


def test_quant_kernels_refuse_instead_of_falling_back(cuda):
    t = _qweight(cuda, "int4", 256, 128)
    with pytest.raises(TypeError):     # no instance takes a float64 x
        quant.quantized_linear(
            torch.randn(4, 256, device=cuda, dtype=torch.float64), t)
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


# ---------------------------------------------------------------------------
# kernel H (paged write) and kernel D's paged modes
# ---------------------------------------------------------------------------

def _paged_pool(cuda, L, B, maxp, page, K, D, spare=3):
    """Random pool with a shuffled table over pages 1.. (page 0 is the
    scratch page; ``spare`` pages stay unreferenced)."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    P = 1 + B * maxp + spare
    k = torch.randn(L, P, page, K, D, device=cuda, dtype=torch.bfloat16)
    table = (torch.randperm(P - 1, device=cuda)[:B * maxp] + 1).to(
        torch.int32).reshape(B, maxp).contiguous()
    return pkv.PagedKVCache(k, torch.randn_like(k), table,
                            torch.zeros(B, device=cuda, dtype=torch.int32))


def _cut_table(cache, kv_len, page):
    """Point every entry at or past ceil(kv_len / page) at page 0 and fill
    page 0 with NaN: a kernel that reads such an entry shows it."""
    used = (kv_len.long() + page - 1) // page
    cols = torch.arange(cache.block_table.shape[1], device=kv_len.device)
    cache.block_table[cols[None, :] >= used[:, None]] = 0
    cache.k[:, 0] = float("nan")
    cache.v[:, 0] = float("nan")


@pytest.mark.parametrize("page", [16, 64])
def test_paged_write_kernel(cuda, page):
    """Chunk rows (one spanning pages at page 16), decode rows at odd
    offsets and new_len == 0 rows in one launch; bit-identical to the plain
    scatter, and page 0 and the unreferenced pages keep their bytes."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B, maxp, K, D, T = 3, 5, 6, 8, 128, 64
    cache = _paged_pool(cuda, L, B, maxp, page, K, D)
    ref = pkv.PagedKVCache(cache.k.clone(), cache.v.clone(),
                           cache.block_table, cache.lengths)
    before = cache.k.clone()
    new_k = torch.randn(B, T, K, D, device=cuda, dtype=torch.bfloat16)
    new_v = torch.randn_like(new_k)
    starts = torch.tensor([0, page, 2 * page + 7, 5, 3 * page], device=cuda,
                          dtype=torch.int32)
    new_len = torch.tensor([T, 37, 1, 1, 0], device=cuda, dtype=torch.int32)
    n0 = pkv.paged_update_at_layer.launches
    pkv.paged_update_at_layer(cache, 2, new_k, new_v, starts, new_len,
                              kernels="cuda")
    pkv.paged_update_at_layer_torch(ref, 2, new_k, new_v, starts, new_len)
    torch.cuda.synchronize()
    assert pkv.paged_update_at_layer.launches == n0 + 1
    assert torch.equal(cache.k, ref.k) and torch.equal(cache.v, ref.v)
    used = torch.zeros(cache.k.shape[1], dtype=torch.bool, device=cuda)
    used[cache.block_table.long().flatten()] = True
    assert torch.equal(cache.k[:, ~used], before[:, ~used])
    assert not used[0]


@pytest.mark.parametrize("page,K,G,window,D,lens", [
    _case(16, 2, 4, None, D=128), _case(64, 4, 1, None, D=128),
    _case(16, 2, 4, 70, D=128),
    _case(16, 4, 8, None, D=64, lens=LONG, tag="-d64-long"),
    _case(16, 2, 8, 100, D=128, lens=LONG, tag="-long"),
    _case(64, 4, 2, None, D=64, lens=ONE_ROW, tag="-d64-one-row")])
def test_paged_prefill_attention_kernel(cuda, page, K, G, window, D, lens):
    """D2's paged mode; lens CHUNK keeps the original q_start [0, 5, 150,
    2 * page]."""
    T, S, q_start, kv_len = _lens(cuda, lens)
    if lens is CHUNK:
        q_start[3] = 2 * page
        kv_len = q_start + torch.tensor(CHUNK[3], device=cuda,
                                        dtype=torch.int32)
    L, B, maxp = 2, 4, S // page + 2
    cache = _paged_pool(cuda, L, B, maxp, page, K, D)
    q = torch.randn(B, T, K * G, D, device=cuda, dtype=torch.bfloat16)
    _cut_table(cache, kv_len, page)
    want = attention.attention_paged_torch(
        q, cache.k.nan_to_num(), cache.v.nan_to_num(), q_start, kv_len, 1,
        cache.block_table, window=window)
    got = attention.attention(q, cache.k, cache.v, q_start, kv_len, layer=1,
                              window=window, table=cache.block_table,
                              kernels="cuda")
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("page,K,G,window", [(16, 4, 4, None),
                                             (64, 8, 1, None),
                                             (64, 4, 4, 100)])
def test_paged_decode_attention_kernel(cuda, page, K, G, window):
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B, D, maxp = 2, 6, 128, 1000 // page + 1
    cache = _paged_pool(cuda, L, B, maxp, page, K, D)
    q = torch.randn(B, 1, K * G, D, device=cuda, dtype=torch.bfloat16)
    kv_len = torch.tensor([1, 17, page, page + 1, 999, 500], device=cuda,
                          dtype=torch.int32)
    q_start = kv_len - 1
    _cut_table(cache, kv_len, page)
    n0 = attention.attention_decode.launches
    got = attention.attention_decode(q, cache.k, cache.v, q_start, kv_len, 1,
                                     table=cache.block_table, window=window,
                                     kernels="cuda")
    want = attention.attention_paged_torch(
        q, cache.k.nan_to_num(), cache.v.nan_to_num(), q_start, kv_len, 1,
        cache.block_table, window=window)
    torch.cuda.synchronize()
    assert attention.attention_decode.launches == n0 + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("page", [16, 64])
def test_paged_modes_are_bit_identical_to_slot_modes(cuda, page):
    """The paged modes change addressing only: H then the attend-only
    decode gives the fused slot decode's bytes, and the paged prefill the
    slot prefill's, on the same keys."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B, K, G, D, maxp = 2, 4, 4, 4, 128, 512 // page
    cache = _paged_pool(cuda, L, B, maxp, page, K, D)
    S = maxp * page
    slot_k, slot_v = (torch.empty(L, B, S, K, D, device=cuda,
                                  dtype=torch.bfloat16) for _ in range(2))
    for layer in range(L):
        slot_k[layer], slot_v[layer] = pkv.gather_layer_pages(cache, layer)
    hist = torch.tensor([0, 63, 64, 400], device=cuda, dtype=torch.int32)
    kv_len = hist + 1
    q = torch.randn(B, 1, K * G, D, device=cuda, dtype=torch.bfloat16)
    kn = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    want, _, _ = attention.attention_decode_fused(
        q, kn, vn, slot_k, slot_v, hist, kv_len, 1, kernels="cuda")
    pkv.paged_update_at_layer(cache, 1, kn, vn, hist, kv_len - hist,
                              kernels="cuda")
    got = attention.attention_decode(q, cache.k, cache.v, hist, kv_len, 1,
                                     table=cache.block_table, kernels="cuda")
    assert torch.equal(got, want)
    qp = torch.randn(B, 40, K * G, D, device=cuda, dtype=torch.bfloat16)
    kv_len = hist + 40
    assert torch.equal(
        attention.attention(qp, cache.k, cache.v, hist, kv_len, layer=1,
                            table=cache.block_table, kernels="cuda"),
        attention.attention(qp, slot_k, slot_v, hist, kv_len, layer=1,
                            kernels="cuda"))


def test_paged_kernels_refuse_instead_of_falling_back(cuda):
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    cache = _paged_pool(cuda, 1, 2, 2, 16, 2, 128)
    q = torch.randn(2, 1, 4, 128, device=cuda)                 # f32
    lens = torch.ones(2, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):
        attention.attention_decode(q, cache.k, cache.v, lens - 1, lens, 0,
                                   table=cache.block_table)
    with pytest.raises(ValueError):
        attention.attention_decode(q.bfloat16(), cache.k, cache.v, lens - 1,
                                   lens, 0, table=cache.block_table.long())
    with pytest.raises(TypeError):
        pkv.paged_update_at_layer(cache, 0, q[:, :, :2], q[:, :, :2],
                                  lens, lens)
    new = torch.randn(2, 1, 2, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        attention.attention_decode_paged_fused(
            q, new, new, cache.k, cache.v, lens - 1, lens, 0,
            table=cache.block_table)
    with pytest.raises(ValueError):
        attention.attention_decode_paged_fused(
            q.bfloat16(), new.float(), new, cache.k, cache.v, lens - 1,
            lens, 0, table=cache.block_table)


def test_paged_engine_matches_slot_engine_and_plain(cuda):
    """A small bf16 model, pages of 16: the paged engine's prefill logits
    are bit-identical to the slot engine's under the same kernels (equal
    chunk size), its greedy ids equal, and its logits agree with the plain
    path within the bf16 engine tolerance."""
    cfg = get_config("debug").replace(dtype_name="bfloat16", head_dim=128,
                                      num_layers=3)
    eng = EngineConfig(max_batch_size=3, max_seq_len=256, max_prefill_len=16)
    params = init_dummy_params(cfg, device=cuda)
    paged = InferenceEngine(cfg, eng.replace(kv_layout="paged",
                                             page_size=16), params,
                            device=cuda)
    slot = InferenceEngine(cfg, eng, params, device=cuda)
    plain = InferenceEngine(cfg, eng.replace(kv_layout="paged", page_size=16,
                                             kernels="torch"), params,
                            device=cuda)
    prompts = [[1, 2, 3], list(range(5, 100)), [7] * 30]
    lp, ls, lt = (e.prefill(prompts) for e in (paged, slot, plain))
    assert torch.equal(lp, ls)
    torch.testing.assert_close(lp, lt, atol=5e-2, rtol=5e-2)
    from llm_inference_engine_tpu_torch.config import SamplingParams
    sp = SamplingParams(greedy=True, max_new_tokens=12)
    paged.reset()
    slot.reset()
    assert (paged.generate(prompts, sp, eos_token_id=None).token_ids
            == slot.generate(prompts, sp, eos_token_id=None).token_ids)


# ---------------------------------------------------------------------------
# the int8 KV cache: kernel I, kernel H's int8 mode, kernel D's int8 modes
# ---------------------------------------------------------------------------

def _quantized(x, snapped):
    return (kvc.quantize_kv_snapped if snapped else kvc.quantize_kv)(x)


def _int8_slot(cuda, L, B, S, K, D, snapped):
    """An int8 slot cache filled with quantized random rows."""
    c = kvc.new_kv_cache(L, B, K, S, D, device=cuda, quantized=True,
                         snapped=snapped)
    for vals, scales in ((c.k, c.k_scale), (c.v, c.v_scale)):
        q, s = _quantized(torch.randn(L, B, S, K, D, device=cuda,
                                      dtype=torch.bfloat16), snapped)
        vals.copy_(q)
        scales.copy_(s)
    return c


def _int8_pool(cuda, L, B, maxp, page, K, D, spare=3):
    """An int8 pool of quantized random rows with a shuffled table; page 0
    (the scratch page) gets NaN scales, so a kernel that reads a table
    entry past kv_len's pages shows it."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    P = 1 + B * maxp + spare
    c = pkv.new_paged_kv_cache(L, B, K, P, page, D, maxp, device=cuda,
                               quantized=True)
    for vals, scales in ((c.k, c.k_scale), (c.v, c.v_scale)):
        q, s = kvc.quantize_kv_snapped(torch.randn(
            L, P, page, K, D, device=cuda, dtype=torch.bfloat16))
        vals.copy_(q)
        scales.copy_(s)
    c.block_table.copy_((torch.randperm(P - 1, device=cuda)[:B * maxp] + 1)
                        .to(torch.int32).reshape(B, maxp))
    return c


def _cut_int8_table(cache, kv_len, page):
    used = (kv_len.long() + page - 1) // page
    cols = torch.arange(cache.block_table.shape[1], device=kv_len.device)
    cache.block_table[cols[None, :] >= used[:, None]] = 0
    cache.k_scale[:, 0] = float("nan")
    cache.v_scale[:, 0] = float("nan")


def _planes(c):
    return dict(k_scale=c.k_scale, v_scale=c.v_scale)


@pytest.mark.parametrize("K,D,snapped", [(8, 128, False), (8, 128, True),
                                         (32, 128, True), (2, 64, False)])
def test_kv_write_quant_kernel(cuda, K, D, snapped):
    """Kernel I at ragged T with a new_len == 0 row and an all-zero input
    row: values and scales bit-identical to the plain quantize + write, and
    every other row untouched."""
    L, B, S, T = 3, 4, 600, 77
    c = _int8_slot(cuda, L, B, S, K, D, snapped)
    caches = [c, kvc.KVCache(c.k.clone(), c.v.clone(), c.lengths,
                             c.k_scale.clone(), c.v_scale.clone(),
                             snapped=snapped)]
    new_k = torch.randn(B, T, K, D, device=cuda, dtype=torch.bfloat16)
    new_v = torch.randn_like(new_k)
    new_k[0, 0, 0] = 0.0
    starts = torch.tensor([0, 37, 599, 88], device=cuda, dtype=torch.int32)
    new_len = torch.tensor([77, 40, 1, 0], device=cuda, dtype=torch.int32)
    before = caches[0].k.clone()
    n0 = kvc.kv_write_quant.launches
    kvc.update_cache_at_layer(caches[0], 2, new_k, new_v, starts, new_len,
                              kernels="cuda")
    kvc.update_cache_at_layer_torch(caches[1], 2, new_k, new_v, starts,
                                    new_len)
    torch.cuda.synchronize()
    assert kvc.kv_write_quant.launches == n0 + 1
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(caches[0], name), getattr(caches[1], name))
    assert not caches[0].k[2, 0, 0, 0].any()
    assert torch.equal(caches[0].k[:2], before[:2])
    assert torch.equal(caches[0].k[2, 3], before[2, 3])


@pytest.mark.parametrize("K,G,window,D,lens", [
    _case(4, 1, None, D=128), _case(2, 4, None, D=128),
    _case(2, 4, 70, D=128),
    _case(4, 8, None, D=64, lens=LONG, tag="-d64-long"),
    _case(2, 8, 100, D=128, lens=LONG, tag="-long"),
    _case(8, 1, None, D=64, lens=ONE_ROW, tag="-d64-one-row")])
def test_int8_prefill_attention_kernel(cuda, K, G, window, D, lens):
    T, S, q_start, kv_len = _lens(cuda, lens)
    L, B = 2, 4
    c = _int8_slot(cuda, L, B, S, K, D, False)
    q = torch.randn(B, T, K * G, D, device=cuda, dtype=torch.bfloat16)
    n0 = attention.attention_int8.launches
    got = attention.attention(q, c.k, c.v, q_start, kv_len, layer=1,
                              window=window, kernels="cuda", **_planes(c))
    want = attention.attention_torch(q, c.k, c.v, q_start, kv_len, layer=1,
                                     window=window, **_planes(c))
    assert attention.attention_int8.launches == n0 + 1
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("K,G,window,snapped", [(8, 1, None, True),
                                                (4, 4, None, False),
                                                (4, 4, 100, True)])
def test_fused_int8_decode_kernel(cuda, K, G, window, snapped):
    """The in-kernel quantize writes the same bytes as the plain version;
    the output agrees within TOL. Row 2 is inactive."""
    L, B, S, D = 2, 4, 1000, 128
    c = _int8_slot(cuda, L, B, S, K, D, snapped)
    ref = [t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale)]
    q = torch.randn(B, 1, K * G, D, device=cuda, dtype=torch.bfloat16)
    k_new = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    v_new = torch.randn_like(k_new)
    q_start = torch.tensor([0, 17, 500, 999], device=cuda, dtype=torch.int32)
    kv_len = q_start + torch.tensor([1, 1, 0, 1], device=cuda,
                                    dtype=torch.int32)
    n0 = attention.attention_decode_fused_int8.launches
    got, _, _ = attention.attention_decode_fused(
        q, k_new, v_new, c.k, c.v, q_start, kv_len, 1, window=window,
        kernels="cuda", snapped=snapped, **_planes(c))
    want, _, _ = attention.attention_decode_fused_torch(
        q, k_new, v_new, ref[0], ref[1], q_start, kv_len, 1, window=window,
        k_scale=ref[2], v_scale=ref[3], snapped=snapped)
    torch.cuda.synchronize()
    assert attention.attention_decode_fused_int8.launches == n0 + 1
    for got_t, want_t in zip((c.k, c.v, c.k_scale, c.v_scale), ref):
        assert torch.equal(got_t, want_t)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("page", [16, 64])
def test_paged_int8_write_kernel(cuda, page):
    """Kernel H's int8 mode: chunk rows (one spanning pages at page 16),
    decode rows and a new_len == 0 row in one launch; bit-identical to the
    plain quantize + scatter, unreferenced pages untouched."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B, maxp, K, D, T = 3, 5, 6, 8, 128, 64
    cache = _int8_pool(cuda, L, B, maxp, page, K, D)
    ref = pkv.PagedKVCache(cache.k.clone(), cache.v.clone(),
                           cache.block_table, cache.lengths,
                           cache.k_scale.clone(), cache.v_scale.clone())
    before = cache.k.clone()
    new_k = torch.randn(B, T, K, D, device=cuda, dtype=torch.bfloat16)
    new_v = torch.randn_like(new_k)
    starts = torch.tensor([0, page, 2 * page + 7, 5, 3 * page], device=cuda,
                          dtype=torch.int32)
    new_len = torch.tensor([T, 37, 1, 1, 0], device=cuda, dtype=torch.int32)
    n0 = pkv.paged_kv_write_quant.launches
    pkv.paged_update_at_layer(cache, 2, new_k, new_v, starts, new_len,
                              kernels="cuda")
    pkv.paged_update_at_layer_torch(ref, 2, new_k, new_v, starts, new_len)
    torch.cuda.synchronize()
    assert pkv.paged_kv_write_quant.launches == n0 + 1
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(cache, name), getattr(ref, name))
    used = torch.zeros(cache.k.shape[1], dtype=torch.bool, device=cuda)
    used[cache.block_table.long().flatten()] = True
    assert torch.equal(cache.k[:, ~used], before[:, ~used])


@pytest.mark.parametrize("page,K,G,window,D,lens", [
    _case(16, 2, 4, None, D=128), _case(64, 4, 1, None, D=128),
    _case(16, 2, 4, 70, D=128),
    _case(16, 4, 8, None, D=64, lens=LONG, tag="-d64-long"),
    _case(16, 2, 8, 100, D=64, lens=LONG, tag="-d64-long"),
    _case(64, 8, 1, None, D=128, lens=ONE_ROW, tag="-one-row")])
def test_paged_int8_attention_kernels(cuda, page, K, G, window, D, lens):
    """D2's int8 paged prefill and kernel D's attend-only int8 decode
    against the plain paged versions; no table entry past kv_len's pages is
    read (page 0's scales are NaN). Lens CHUNK keeps the original q_start
    [0, 5, 150, 2 * page]."""
    T, S, q_start, kv_len = _lens(cuda, lens)
    if lens is CHUNK:
        q_start[3] = 2 * page
        kv_len = q_start + torch.tensor(CHUNK[3], device=cuda,
                                        dtype=torch.int32)
    L, B, maxp = 2, 4, max(1000, S) // page + 1
    cache = _int8_pool(cuda, L, B, maxp, page, K, D)
    q = torch.randn(B, T, K * G, D, device=cuda, dtype=torch.bfloat16)
    dec_len = torch.tensor([1, page, page + 1, 999], device=cuda,
                           dtype=torch.int32)
    _cut_int8_table(cache, torch.maximum(kv_len, dec_len), page)
    clean = dict(k_scale=cache.k_scale.nan_to_num(),
                 v_scale=cache.v_scale.nan_to_num())
    got = attention.attention(q, cache.k, cache.v, q_start, kv_len, layer=1,
                              window=window, table=cache.block_table,
                              kernels="cuda", **_planes(cache))
    want = attention.attention_paged_torch(
        q, cache.k, cache.v, q_start, kv_len, 1, cache.block_table,
        window=window, **clean)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)
    q1 = q[:, :1].contiguous()
    n0 = attention.attention_decode_int8.launches
    got = attention.attention_decode(q1, cache.k, cache.v, dec_len - 1,
                                     dec_len, 1, table=cache.block_table,
                                     window=window, kernels="cuda",
                                     **_planes(cache))
    want = attention.attention_paged_torch(
        q1, cache.k, cache.v, dec_len - 1, dec_len, 1, cache.block_table,
        window=window, **clean)
    torch.cuda.synchronize()
    assert attention.attention_decode_int8.launches == n0 + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("page", [16, 64])
def test_paged_int8_modes_are_bit_identical_to_slot_int8(cuda, page):
    """As for bf16: H's int8 mode then the int8 attend-only decode gives
    the fused int8 slot decode's bytes (snapped numerics, as the pool),
    and the int8 paged prefill the int8 slot prefill's."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B, K, G, D, maxp = 2, 4, 4, 4, 128, 512 // page
    cache = _int8_pool(cuda, L, B, maxp, page, K, D)
    S = maxp * page
    slot = kvc.new_kv_cache(L, B, K, S, D, device=cuda, quantized=True,
                            snapped=True)
    for layer in range(L):
        for src, dst in ((cache.k, slot.k), (cache.v, slot.v),
                         (cache.k_scale, slot.k_scale),
                         (cache.v_scale, slot.v_scale)):
            dst[layer] = pkv.gather_pages(src, layer, cache.block_table)
    hist = torch.tensor([0, 63, 64, 400], device=cuda, dtype=torch.int32)
    kv_len = hist + 1
    q = torch.randn(B, 1, K * G, D, device=cuda, dtype=torch.bfloat16)
    kn = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    want, _, _ = attention.attention_decode_fused(
        q, kn, vn, slot.k, slot.v, hist, kv_len, 1, kernels="cuda",
        snapped=True, **_planes(slot))
    pkv.paged_update_at_layer(cache, 1, kn, vn, hist, kv_len - hist,
                              kernels="cuda")
    got = attention.attention_decode(q, cache.k, cache.v, hist, kv_len, 1,
                                     table=cache.block_table, kernels="cuda",
                                     **_planes(cache))
    assert torch.equal(got, want)
    qp = torch.randn(B, 40, K * G, D, device=cuda, dtype=torch.bfloat16)
    kv_len = hist + 40
    assert torch.equal(
        attention.attention(qp, cache.k, cache.v, hist, kv_len, layer=1,
                            table=cache.block_table, kernels="cuda",
                            **_planes(cache)),
        attention.attention(qp, slot.k, slot.v, hist, kv_len, layer=1,
                            kernels="cuda", **_planes(slot)))


def test_int8_kernels_refuse_instead_of_falling_back(cuda):
    c = _int8_slot(cuda, 1, 2, 32, 2, 128, True)
    q = torch.randn(2, 3, 4, 128, device=cuda, dtype=torch.bfloat16)
    lens = torch.full((2,), 3, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):            # an f64 row into an int8 cache
        kvc.update_cache_at_layer(c, 0, q[:, :, :2].double(),
                                  q[:, :, :2].double(), lens - 3, lens)
    with pytest.raises(ValueError):           # a scale plane of the wrong type
        attention.attention(q, c.k, c.v, lens - 3, lens, layer=0,
                            k_scale=c.k_scale.double(), v_scale=c.v_scale)


def test_int8_kv_engines_match_plain_and_paged_matches_slot(cuda):
    """A small bf16 model (K = 8, D = 128: the slot cache is snapped on the
    card, as the pool is) with an int8 KV cache: the kernel path's prefill
    logits agree with the plain path's, the paged engine's are
    bit-identical to the slot engine's, and their greedy ids are equal."""
    from llm_inference_engine_tpu_torch.config import SamplingParams
    cfg = get_config("debug").replace(dtype_name="bfloat16", head_dim=128,
                                      num_heads=8, num_kv_heads=8,
                                      num_layers=3)
    eng = EngineConfig(max_batch_size=3, max_seq_len=256, max_prefill_len=16,
                       kv_cache_dtype_name="int8")
    params = init_dummy_params(cfg, device=cuda)
    slot = InferenceEngine(cfg, eng, params, device=cuda)
    paged = InferenceEngine(cfg, eng.replace(kv_layout="paged",
                                             page_size=16), params,
                            device=cuda)
    plain = InferenceEngine(cfg, eng.replace(kernels="torch"), params,
                            device=cuda)
    assert slot.cache.snapped and paged.cache.snapped
    prompts = [[1, 2, 3], list(range(5, 100)), [7] * 30]
    ls, lp, lt = (e.prefill(prompts) for e in (slot, paged, plain))
    assert torch.isfinite(ls).all()
    assert torch.equal(lp, ls)
    torch.testing.assert_close(ls, lt, atol=5e-2, rtol=5e-2)
    sp = SamplingParams(greedy=True, max_new_tokens=12)
    slot.reset()
    paged.reset()
    assert (paged.generate(prompts, sp, eos_token_id=None).token_ids
            == slot.generate(prompts, sp, eos_token_id=None).token_ids)


# ---------------------------------------------------------------------------
# kernel D's decode (split-KV over a cluster) in all four modes, and every
# kernel at the head dims 80, 96 and 256
# ---------------------------------------------------------------------------

HEAD_DIMS = (64, 80, 96, 128, 256)
DECODE_MODES = ("fused", "paged", "fused-int8", "paged-int8",
                "paged-fused")
# kv_len per sequence: 1, one 32-key tile, one tile + 1, a slice ending
# mid-page, an inactive row (kv_len == q_start), and S itself
DEC_S = 600
DEC_LENS = [1, 32, 33, 217, 301, DEC_S]
DEC_INACTIVE = 4


def _decode_inputs(cuda, mode, K, G, D, page=16, snapped=True):
    """A cache of random rows for one decode mode (L = 2, B = 6): slot or a
    pool with a shuffled table over S = DEC_S tokens, bf16 or int8 (pools
    snapped), q, k_new/v_new, q_start and kv_len (DEC_LENS; the inactive
    row's kv_len equals its q_start)."""
    B = len(DEC_LENS)
    kv_len = torch.tensor(DEC_LENS, device=cuda, dtype=torch.int32)
    q_start = kv_len - 1
    q_start[DEC_INACTIVE] = kv_len[DEC_INACTIVE]
    if mode.startswith("paged"):
        maxp = -(-DEC_S // page)
        c = (_int8_pool if mode.endswith("int8") else _paged_pool)(
            cuda, 2, B, maxp, page, K, D)
    elif mode == "fused-int8":
        c = _int8_slot(cuda, 2, B, DEC_S, K, D, snapped)
    else:
        c = kvc.KVCache(*_qkv(cuda, 2, B, 1, 1, K, DEC_S, D)[1:], kv_len)
    q = torch.randn(B, 1, K * G, D, device=cuda, dtype=torch.bfloat16)
    kn = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    return c, q, kn, torch.randn_like(kn), q_start, kv_len


def _run_decode(mode, c, q, kn, vn, q_start, kv_len, window, kernels,
                snapped=True):
    """One decode step of ``mode`` at layer 1: the fused modes write the
    token and attend (paged-fused through the table); the paged modes
    attend (the pool holds the token)."""
    planes = _planes(c) if c.k_scale is not None else {}
    if mode == "paged-fused":
        return attention.attention_decode_paged_fused(
            q, kn, vn, c.k, c.v, q_start, kv_len, 1, table=c.block_table,
            window=window, kernels=kernels)[0]
    if mode.startswith("paged"):
        if kernels == "torch":
            return attention.attention_paged_torch(
                q, c.k, c.v, q_start, kv_len, 1, c.block_table,
                window=window, **planes)
        return attention.attention_decode(
            q, c.k, c.v, q_start, kv_len, 1, table=c.block_table,
            window=window, kernels="cuda", **planes)
    if kernels == "torch":
        return attention.attention_decode_fused_torch(
            q, kn, vn, c.k, c.v, q_start, kv_len, 1, window=window,
            snapped=snapped, **planes)[0]
    return attention.attention_decode_fused(
        q, kn, vn, c.k, c.v, q_start, kv_len, 1, window=window,
        kernels="cuda", snapped=snapped, **planes)[0]


def _clone_cache(c):
    return dataclasses.replace(c, **{
        n: getattr(c, n).clone() for n in ("k", "v", "k_scale", "v_scale")
        if getattr(c, n) is not None})


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G,window", [(1, None), (4, None), (7, 45),
                                      (8, 100), (1, 200), (3, 30)])
def test_decode_kernel_modes(cuda, mode, D, G, window):
    """Kernel D's four decode modes at every head dim against the plain
    versions: kv_len 1, one tile, one tile + 1, slices ending mid-page, S,
    an inactive row; G 1, 3 and 4 (blocks of 4 query heads, one idle at
    3), 7 (a group that is no power of two) and 8, windows starting inside
    a tile. The fused writes (slot and paged) are bit-identical to the
    plain write; page 0 and the pages past each sequence's pages hold NaN,
    so a read outside the table shows."""
    K = 2
    page = 16 if D != 96 else 24
    c, q, kn, vn, q_start, kv_len = _decode_inputs(cuda, mode, K, G, D, page)
    if mode.startswith("paged"):
        (_cut_int8_table if mode.endswith("int8") else _cut_table)(
            c, kv_len, page)
    ref = _clone_cache(c)
    if mode.startswith("paged"):
        for name in ("k", "v", "k_scale", "v_scale"):
            if getattr(ref, name) is not None:
                setattr(ref, name, getattr(ref, name).nan_to_num())
    counter = {"fused": attention.attention_decode_fused,
               "paged": attention.attention_decode,
               "fused-int8": attention.attention_decode_fused_int8,
               "paged-int8": attention.attention_decode_int8,
               "paged-fused": attention.attention_decode_paged_fused}[mode]
    n0 = counter.launches
    got = _run_decode(mode, c, q, kn, vn, q_start, kv_len, window, "cuda")
    want = _run_decode(mode, ref, q, kn, vn, q_start, kv_len, window,
                       "torch")
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    if "fused" in mode:
        for name in ("k", "v", "k_scale", "v_scale"):
            t = getattr(c, name)
            if t is not None:
                # the paged pool's NaN page 0 is zero in ref
                t = t.nan_to_num() if t.is_floating_point() else t
                assert torch.equal(t, getattr(ref, name)), name
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("D", [128, 80])
def test_decode_ignores_poisoned_tail(cuda, mode, D):
    """Every cache row at or past kv_len, and every pool page outside the
    table, holds NaN (values, or an int8 cache's scales): the decode must
    read none of it, and its zero-filled tail keys must stay zero, so it
    agrees with the plain version on a clean copy."""
    K, G, page = 2, 4, 16
    c, q, kn, vn, q_start, kv_len = _decode_inputs(cuda, mode, K, G, D, page)
    clean = _clone_cache(c)
    if mode.startswith("paged"):
        _poison_pool(c, kv_len, page)
        clean.block_table = c.block_table
    else:
        # rows past each fused write's row; the write fills kv_len - 1
        _poison_slot(c, kv_len)
    got = _run_decode(mode, c, q, kn, vn, q_start, kv_len, None, "cuda")
    want = _run_decode(mode, clean, q, kn, vn, q_start, kv_len, None,
                       "torch")
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D", [80, 96, 256])
def test_paged_decode_bit_identical_to_slot_at_head_dims(cuda, int8, D):
    """The paged write then the attend-only decode gives the fused slot
    decode's bytes at the new head dims (int8: snapped, as the pool)."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B, K, G, page, maxp = 2, 4, 2, 4, 16, 24
    cache = (_int8_pool if int8 else _paged_pool)(cuda, L, B, maxp, page, K,
                                                 D)
    S = maxp * page
    slot = kvc.new_kv_cache(L, B, K, S, D, device=cuda, quantized=int8,
                            snapped=True)
    names = ("k", "v", "k_scale", "v_scale") if int8 else ("k", "v")
    for layer in range(L):
        for n in names:
            getattr(slot, n)[layer] = pkv.gather_pages(
                getattr(cache, n), layer, cache.block_table)
    hist = torch.tensor([0, 31, 32, 300], device=cuda, dtype=torch.int32)
    kv_len = hist + 1
    q = torch.randn(B, 1, K * G, D, device=cuda, dtype=torch.bfloat16)
    kn = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    sp = _planes(slot) if int8 else {}
    pp = _planes(cache) if int8 else {}
    want, _, _ = attention.attention_decode_fused(
        q, kn, vn, slot.k, slot.v, hist, kv_len, 1, kernels="cuda",
        snapped=True, **sp)
    pkv.paged_update_at_layer(cache, 1, kn, vn, hist, kv_len - hist,
                              kernels="cuda")
    got = attention.attention_decode(q, cache.k, cache.v, hist, kv_len, 1,
                                     table=cache.block_table, kernels="cuda",
                                     **pp)
    assert torch.equal(got, want)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("page", [16, 64])
def test_fused_paged_decode_bit_identical_to_slot(cuda, D, page):
    """The fused paged decode gives the fused slot decode's output bytes
    on the same keys (its pages gathered into a slot cache), and its pool
    equals kernel H's plain write on a copy bit for bit: a check that goes
    through neither kernel H nor the paged decode without new rows. Rows:
    a first token, q_start at in-page offsets page - 1 and 0, and one
    deep in the sequence."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B, K, G, maxp = 2, 4, 2, 4, 512 // page
    cache = _paged_pool(cuda, L, B, maxp, page, K, D)
    slot = kvc.new_kv_cache(L, B, K, maxp * page, D, device=cuda)
    for layer in range(L):
        for n in ("k", "v"):
            getattr(slot, n)[layer] = pkv.gather_pages(
                getattr(cache, n), layer, cache.block_table)
    ref = pkv.PagedKVCache(cache.k.clone(), cache.v.clone(),
                           cache.block_table, cache.lengths)
    hist = torch.tensor([0, page - 1, page, 400], device=cuda,
                        dtype=torch.int32)
    kv_len = hist + 1
    q = torch.randn(B, 1, K * G, D, device=cuda, dtype=torch.bfloat16)
    kn = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    want, _, _ = attention.attention_decode_fused(
        q, kn, vn, slot.k, slot.v, hist, kv_len, 1, kernels="cuda")
    got, _, _ = attention.attention_decode_paged_fused(
        q, kn, vn, cache.k, cache.v, hist, kv_len, 1,
        table=cache.block_table, kernels="cuda")
    pkv.paged_update_at_layer_torch(ref, 1, kn, vn, hist, kv_len - hist)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(cache.k, ref.k) and torch.equal(cache.v, ref.v)


@pytest.mark.parametrize("K,G,D,window,lens", [
    _case(2, 4, 80, None), _case(2, 7, 96, 70),
    _case(4, 1, 256, None), _case(2, 8, 80, 100, lens=LONG, tag="-long"),
    _case(2, 4, 256, None, lens=LONG, tag="-long"),
    _case(2, 4, 96, None, lens=ONE_ROW, tag="-one-row")])
def test_prefill_attention_kernel_at_head_dims(cuda, K, G, D, window, lens):
    """D2's four prefill modes at head dims 80, 96 and 256 against the
    plain versions (the pools' table entries past kv_len's pages point at
    a NaN page 0)."""
    T, S, q_start, kv_len = _lens(cuda, lens)
    L, B, page = 2, 4, 16
    q = torch.randn(B, T, K * G, D, device=cuda, dtype=torch.bfloat16)
    _, kc, vc = _qkv(cuda, L, B, 1, 1, K, S, D)
    torch.testing.assert_close(
        attention.attention(q, kc, vc, q_start, kv_len, layer=1,
                            window=window, kernels="cuda"),
        attention.attention_torch(q, kc, vc, q_start, kv_len, layer=1,
                                  window=window), **TOL)
    c8 = _int8_slot(cuda, L, B, S, K, D, False)
    torch.testing.assert_close(
        attention.attention(q, c8.k, c8.v, q_start, kv_len, layer=1,
                            window=window, kernels="cuda", **_planes(c8)),
        attention.attention_torch(q, c8.k, c8.v, q_start, kv_len, layer=1,
                                  window=window, **_planes(c8)), **TOL)
    maxp = S // page + 1
    for pool, cut in ((_paged_pool(cuda, L, B, maxp, page, K, D), _cut_table),
                      (_int8_pool(cuda, L, B, maxp, page, K, D),
                       _cut_int8_table)):
        cut(pool, kv_len, page)
        planes = _planes(pool) if pool.k_scale is not None else {}
        clean = {n: t.nan_to_num() for n, t in planes.items()}
        got = attention.attention(q, pool.k, pool.v, q_start, kv_len,
                                  layer=1, window=window,
                                  table=pool.block_table, kernels="cuda",
                                  **planes)
        want = attention.attention_paged_torch(
            q, pool.k.nan_to_num(), pool.v.nan_to_num(), q_start, kv_len, 1,
            pool.block_table, window=window, **clean)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("K,D,snapped", [(4, 80, True), (4, 96, False),
                                         (2, 256, True), (8, 80, False)])
def test_kv_write_quant_kernel_at_head_dims(cuda, K, D, snapped):
    """Kernel I at head dims 80, 96 and 256, slot (both numerics) and
    paged: values and scales bit-identical to the plain quantize + write."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B, S, T = 2, 4, 300, 40
    c = _int8_slot(cuda, L, B, S, K, D, snapped)
    ref = _clone_cache(c)
    new_k = torch.randn(B, T, K, D, device=cuda, dtype=torch.bfloat16)
    new_v = torch.randn_like(new_k)
    new_k[0, 0, 0] = 0.0
    starts = torch.tensor([0, 37, 299, 88], device=cuda, dtype=torch.int32)
    new_len = torch.tensor([40, 17, 1, 0], device=cuda, dtype=torch.int32)
    kvc.update_cache_at_layer(c, 1, new_k, new_v, starts, new_len,
                              kernels="cuda")
    kvc.update_cache_at_layer_torch(ref, 1, new_k, new_v, starts, new_len)
    pool = _int8_pool(cuda, L, B, 20, 16, K, D)
    pref = _clone_cache(pool)
    pkv.paged_update_at_layer(pool, 1, new_k, new_v, starts, new_len,
                              kernels="cuda")
    pkv.paged_update_at_layer_torch(pref, 1, new_k, new_v, starts, new_len)
    torch.cuda.synchronize()
    for got, want in ((c, ref), (pool, pref)):
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_unsupported_head_dim_raises(cuda):
    """A head_dim outside the built set raises on a CUDA tensor; it never
    falls back to the plain version."""
    q = torch.randn(2, 1, 4, 48, device=cuda, dtype=torch.bfloat16)
    c = torch.randn(1, 2, 32, 2, 48, device=cuda, dtype=torch.bfloat16)
    new = torch.randn(2, 1, 2, 48, device=cuda, dtype=torch.bfloat16)
    lens = torch.ones(2, device=cuda, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="head_dim 48"):
        attention.attention_decode_fused(q, new, new, c, c.clone(), lens - 1,
                                         lens, 0)
    with pytest.raises(NotImplementedError, match="head_dim 48"):
        attention.attention(q, c, c, lens - 1, lens, layer=0)


@pytest.mark.parametrize("B,H,K,D", [(4, 32, 32, 128), (8, 32, 32, 128),
                                     (16, 32, 32, 128), (2, 28, 4, 96),
                                     (8, 32, 8, 128)])
def test_decode_plan_ignores_page_and_length(cuda, B, H, K, D):
    """The split plan depends on B, K, G and D only: slot and paged (any
    page size) launches split alike, so they sum alike."""
    slot = attention.decode_plan(B, H, K, D)
    for page, maxp in ((16, 128), (64, 32)):
        plan = attention.decode_plan(B, H, K, D, page=page, max_pages=maxp)
        assert plan["nsplit"] == slot["nsplit"]
    assert 1 <= slot["nsplit"] <= 8 and slot["blocks_per_sm"] >= 1
    assert slot["max_active_clusters"] >= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
def test_decode_plan_mirror_equals_library(cuda, dtype):
    """ops.attention.decode_plan_mirror (Python, what the CPU tests check),
    given the residency the library reads (decode_residency), equals the
    library's decode_plan at every head dim, cache kind, B 1-16 and the
    presets' (H, K) and their tp = 2 shards; on an H100 80GB HBM3 that
    residency is H100_DECODE_CLUSTERS."""
    from llm_inference_engine_tpu_torch.ops import _native
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = str(dtype).split(".")[-1]
    dims = _native.HEAD_DIMS if dtype == torch.bfloat16 else \
        _native.FLOAT_HEAD_DIMS
    h100 = torch.cuda.get_device_name(0) == "NVIDIA H100 80GB HBM3"
    for D in dims:
        for int8 in (False, True):
            res = attention.decode_residency(D, int8=int8, dtype=dtype)
            if h100:
                assert res == attention.H100_DECODE_CLUSTERS[
                    (name, D, int8)], (D, int8)
            for B in (1, 4, 8, 16):
                for H, K in ((32, 32), (16, 16), (40, 40), (32, 8),
                             (16, 4), (32, 4), (16, 2), (28, 4), (14, 2),
                             (4, 2), (2, 1)):
                    plan = attention.decode_plan(B, H, K, D, int8=int8,
                                                 dtype=dtype)
                    want = attention.decode_plan_mirror(
                        B, K, H // K, clusters=res, esize=dtype.itemsize,
                        sms=sms)
                    assert (plan["nsplit"], plan["heads_per_block"]) == (
                        want["nsplit"], want["heads_per_block"]), (
                            B, H, K, D, int8)


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_plan_reports_every_head_dim(cuda, int8):
    """D2's tiling, as the source reports it, at every head dim: 64-key
    tiles up to D = 128, 32 at 256, and dynamic shared memory that fits an
    SM (227 KB) twice."""
    for D in HEAD_DIMS:
        plan = attention.prefill_plan(D, int8=int8)
        assert plan["tile_keys"] == (32 if D > 128 else 64)
        assert plan["stages"] >= 2
        assert 0 < 2 * plan["smem_bytes"] <= 227 * 1024


# ---------------------------------------------------------------------------
# the K/V row writes: C (bf16 slot), I (int8 slot), H (bf16 pool) and H's
# int8 mode, at every head dim, bit for bit against the plain writes
# ---------------------------------------------------------------------------

WRITE_MODES = ("slot", "slot-int8-snapped", "slot-int8-absmax", "paged",
               "paged-int8")
WRITE_PAGE = 16
# int8 values the quantizers never produce (they clamp to +-127)
INT8_POISON = -128


def _bits(t):
    """``t`` as integers of its width, so that NaN bytes compare equal."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _poisoned_write_target(cuda, mode, L, B, S, K, D):
    """A slot cache or a pool whose every value is poison (NaN, or -128 in
    an int8 cache, with NaN scales), for ``mode``; pools get a shuffled
    table over pages 1.. of S tokens a sequence."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    int8 = "int8" in mode
    if mode.startswith("paged"):
        maxp = -(-S // WRITE_PAGE)
        P = 1 + B * maxp + 3
        c = pkv.new_paged_kv_cache(L, B, K, P, WRITE_PAGE, D, maxp,
                                   device=cuda, quantized=int8)
        c.block_table.copy_((torch.randperm(P - 1, device=cuda)[:B * maxp]
                             + 1).to(torch.int32).reshape(B, maxp))
    else:
        c = kvc.new_kv_cache(L, B, K, S, D, device=cuda, quantized=int8,
                             snapped=mode.endswith("snapped"))
    for t in (c.k, c.v):
        t.fill_(INT8_POISON if int8 else float("nan"))
    for t in (c.k_scale, c.v_scale):
        if t is not None:
            t.fill_(float("nan"))
    return c


def _write_plain_through_trash(c, layer, kn, vn, starts, new_len):
    """The plain write of ``c`` on a copy with one more page (the trash
    page P), table entries outside [0, P) pointed at it: the plain scatter
    would index with them, the kernel skips their rows. Returns the copy's
    first P pages."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    P = c.k.shape[1]
    grow = {n: torch.cat([getattr(c, n), getattr(c, n)[:, :1]], 1)
            for n in ("k", "v", "k_scale", "v_scale")
            if getattr(c, n) is not None}
    table = c.block_table.clone()
    table[(table < 0) | (table >= P)] = P
    ref = dataclasses.replace(c, block_table=table, **grow)
    pkv.paged_update_at_layer_torch(ref, layer, kn, vn, starts, new_len)
    return {n: t[:, :P] for n, t in grow.items()}


@pytest.mark.parametrize("mode", WRITE_MODES)
@pytest.mark.parametrize("T", [1, 7, 64, 512])
@pytest.mark.parametrize("K,D", [(k, d) for k in (1, 8, 32)
                                 for d in HEAD_DIMS])
def test_kv_write_kernels_bit_identical(cuda, mode, T, K, D):
    """One launch writes, at layer 1 of a poisoned cache: a full row from
    0 (one token row of zeros); a row from an odd offset (at T > 1 it
    straddles page boundaries, at T = 1 it is a decode row); a new_len ==
    0 row; a row that runs past S (slot) or past the table's reach (paged;
    wholly past at T = 1); and two rows from odd offsets whose first table
    entry is -1 and P + 5 (paged: their rows on those pages are skipped).
    Launched twice, the cache equals the plain write bit for bit, poison
    outside the written rows included."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B = 2, 6
    S = T + 2 * WRITE_PAGE
    c = _poisoned_write_target(cuda, mode, L, B, S, K, D)
    kn = torch.randn(B, T, K, D, device=cuda, dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    kn[0, 0, 0] = 0.0
    reach = S
    if mode.startswith("paged"):
        reach = c.block_table.shape[1] * WRITE_PAGE
        c.block_table[4, 1] = -1
        c.block_table[5, 1] = c.k.shape[1] + 5
    starts = [0, WRITE_PAGE - 3, 3, reach - T // 2, 2 * WRITE_PAGE - 1,
              WRITE_PAGE + 5]
    new_len = [T, T, 0, T, T, T]
    starts_t = torch.tensor(starts, device=cuda, dtype=torch.int32)
    new_len_t = torch.tensor(new_len, device=cuda, dtype=torch.int32)
    if mode.startswith("paged"):
        want = _write_plain_through_trash(c, 1, kn, vn, starts_t, new_len_t)
        write, counter = pkv.paged_update_at_layer, (
            pkv.paged_kv_write_quant if "int8" in mode
            else pkv.paged_update_at_layer)
    else:
        ref = _clone_cache(c)
        kvc.update_cache_at_layer_torch(ref, 1, kn, vn, starts_t, new_len_t)
        want = {n: getattr(ref, n) for n in ("k", "v", "k_scale", "v_scale")
                if getattr(ref, n) is not None}
        write, counter = kvc.update_cache_at_layer, (
            kvc.kv_write_quant if "int8" in mode
            else kvc.update_cache_at_layer)
    n0 = counter.launches
    for _ in range(2):
        write(c, 1, kn, vn, starts_t, new_len_t, kernels="cuda")
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    for name, w in want.items():
        assert torch.equal(_bits(getattr(c, name)), _bits(w)), name


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("snapped", [True, False])
def test_fused_decode_write_equals_kernel_i_write(cuda, D, snapped):
    """Kernel D's fused int8 decode write (a warp a row) and kernel I's
    write (a sub-warp a row) of the same new token rows give the same
    values and scales, bit for bit."""
    L, B, S, K = 2, 4, 300, 8
    c = _int8_slot(cuda, L, B, S, K, D, snapped)
    other = _clone_cache(c)
    q = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    kn = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    kn[1, 0, 3] = 0.0                                  # a row of zeros
    q_start = torch.tensor([0, 17, 150, 299], device=cuda, dtype=torch.int32)
    attention.attention_decode_fused(q, kn, vn, c.k, c.v, q_start,
                                     q_start + 1, 1, kernels="cuda",
                                     snapped=snapped, **_planes(c))
    kvc.kv_write_quant(other, 1, kn, vn, q_start,
                       torch.ones_like(q_start), kernels="cuda")
    torch.cuda.synchronize()
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(c, name), getattr(other, name)), name


@pytest.mark.parametrize("B,T", [(1, 1), (8, 1), (16, 1), (8, 7), (8, 64),
                                 (16, 64), (8, 512), (1, 2048)])
def test_write_quant_plan_mirror_equals_library(cuda, B, T):
    """ops.kv_cache.write_quant_plan (Python, what the CPU tests check)
    equals the library's plan."""
    for K in (1, 4, 8, 32, 40):
        for D in HEAD_DIMS:
            assert kvc.write_quant_plan_native(B, T, K, D) == \
                kvc.write_quant_plan(B, T, K, D)


@pytest.mark.parametrize("B,T", [(1, 1), (8, 1), (16, 1), (8, 64),
                                 (16, 64), (8, 512), (1, 2048)])
def test_write_plan_mirror_equals_library(cuda, B, T):
    """ops.kv_cache.write_plan (Python, what the CPU tests check) equals
    the library's plan of kernels C and H."""
    for K in (1, 2, 4, 8, 16, 32, 40):
        for D in HEAD_DIMS:
            for elem in (2, 4):
                row_bytes = K * D * elem
                assert kvc.write_plan_native(B, T, row_bytes) == \
                    kvc.write_plan(B, T, row_bytes)


@pytest.mark.parametrize("snapped", [True, False])
def test_int8_write_every_bf16_pair(cuda, snapped):
    """Kernel I's quantize (the IEEE divide's fast path without its range
    check, the rounding by 1.5 * 2^23) against the plain version on every
    pair of finite bf16 values x and absmax with |x| <= absmax, zero and
    subnormals included: rows of 128 values, the absmax and 127 others,
    values and scales bit for bit."""
    mags = torch.arange(0x7F80, device=cuda, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)           # +0 .. max finite
    n = mags.numel()
    per = 2 * torch.arange(1, n + 1, device=cuda)  # +-mags[:i + 1]
    rows_of = (per + 126) // 127
    first = torch.cumsum(rows_of, 0) - rows_of
    step = 1 << 20                                 # rows a launch
    i0 = 0
    while i0 < n:
        i1 = int(torch.searchsorted(first, first[i0] + step))
        i1 = max(i1, i0 + 1)
        which = torch.repeat_interleave(
            torch.arange(i0, i1, device=cuda), rows_of[i0:i1])
        chunk = torch.arange(which.numel(), device=cuda) - (
            first[which] - first[i0])
        idx = chunk[:, None] * 127 + torch.arange(127, device=cuda)[None]
        ok = idx < per[which][:, None]
        vals = mags[(idx // 2).clamp_max(n - 1)].float()
        vals = torch.where(idx % 2 == 1, -vals, vals)
        vals = torch.where(ok, vals, torch.zeros_like(vals))
        rows = torch.cat([mags[which].float()[:, None], vals], 1).to(
            torch.bfloat16)
        T = rows.shape[0]
        new = rows.reshape(1, T, 1, 128).contiguous()
        c = kvc.new_kv_cache(1, 1, 1, T, 128, device=cuda, quantized=True,
                             snapped=snapped)
        zero = torch.zeros(1, device=cuda, dtype=torch.int32)
        kvc.kv_write_quant(c, 0, new, new, zero, zero + T, kernels="cuda")
        q, sc = _quantized(rows, snapped)
        torch.cuda.synchronize()
        assert torch.equal(c.k[0, 0, :, 0], q), (i0, i1)
        assert torch.equal(c.k_scale[0, 0, :, 0], sc), (i0, i1)
        i0 = i1


# ---------------------------------------------------------------------------
# the decode programs as CUDA-graph replays (runtime/decode_graph.py)
# ---------------------------------------------------------------------------

GRAPH_LAYOUTS = {"slot": {}, "paged": dict(kv_layout="paged", page_size=16),
                 "int8": dict(kv_cache_dtype_name="int8")}
GRAPH_PROMPTS = [[1, 2, 3], list(range(5, 100)), [7] * 30]


def _graph_engine(cuda, layout, **kw):
    cfg = get_config("debug").replace(dtype_name="bfloat16", head_dim=128,
                                      num_layers=3)
    eng = EngineConfig(max_batch_size=3, max_seq_len=256, max_prefill_len=16,
                       **GRAPH_LAYOUTS[layout], **kw)
    return InferenceEngine(cfg, eng, init_dummy_params(cfg, seed=1,
                                                       device=cuda),
                           device=cuda)


def _decode_all(e, eager: bool):
    """From a fresh prefill, the generator seeded: 6 sampled decode steps
    with a repetition penalty (one row inactive), an 11-step greedy
    rollout; then from fresh slots, two generate rounds: greedy with a
    stop id, row 0 reaching capacity, and sampled with top-p. Returns
    every output with the lengths after each part."""
    e.reset()
    e._gen.manual_seed(3)
    outs = []
    with run_eagerly(e) if eager else contextlib.nullcontext():
        toks = e.prefill(GRAPH_PROMPTS).argmax(-1).to(torch.int32)
        active = np.array([True, True, False])
        for _ in range(6):
            toks, lp = e.decode_step(toks, active, SamplingParams(
                temperature=0.8, repetition_penalty=1.3),
                return_logprobs=True)
            outs.append((toks.tolist(), lp.tolist()))
        rolled = e.decode_rollout(toks, 11).tolist()
        outs.append((rolled, e.cache.lengths.tolist()))
        prompts = [list(range(3, 3 + 240)), [5, 9], [11] * 17]
        for sp in (SamplingParams(greedy=True, max_new_tokens=24,
                                  stop_token_ids=(rolled[4][1],)),
                   SamplingParams(temperature=0.9, top_p=0.8,
                                  max_new_tokens=20)):
            e.reset()
            r = e.generate(prompts, sp, eos_token_id=None)
            outs.append((r.token_ids, r.logprobs, e.cache.lengths.tolist()))
    return outs


@pytest.mark.parametrize("layout", list(GRAPH_LAYOUTS))
def test_replays_equal_eager_bodies(cuda, layout):
    """decode_step, decode_rollout and generate replayed equal the same
    bodies run eagerly (the same kernels), bit for bit: ids, logprobs
    (sampled rows drawn from the same generator state) and lengths. Row
    0 of the generate rounds (240 + 1 tokens in 256) stops at capacity
    on the card, after at most 16 tokens."""
    e = _graph_engine(cuda, layout)
    eager = _decode_all(e, eager=True)
    assert e._programs == {}
    replayed = _decode_all(e, eager=False)
    assert set(e._programs) == {"step", "greedy", "sampled"}
    assert replayed == eager
    assert all(len(ids[0]) <= 16 for ids, _, _ in replayed[-2:])


def test_capture_raises_on_a_host_read(cuda):
    """A body that reads a device value on the host raises at capture,
    naming the op, instead of decoding eagerly."""
    e = _graph_engine(cuda, "slot")
    body = e._step_body

    def reads():
        body()
        e.cache.lengths.max().item()
    e._step_body = reads
    with pytest.raises(HostReadError, match="_local_scalar_dense"):
        e.decode_step(torch.zeros(3, device=cuda, dtype=torch.int32),
                      np.ones(3, bool), SamplingParams(greedy=True))
    assert "step" not in e._programs


@pytest.mark.parametrize("layout", list(GRAPH_LAYOUTS))
def test_replay_launch_counts_equal_eager(cuda, layout):
    """The launch counters after 5 replayed steps equal those after 5
    eager steps (the capture itself counts nothing)."""
    e = _graph_engine(cuda, layout)
    e.prefill(GRAPH_PROMPTS)
    toks, active = torch.zeros(3, device=cuda, dtype=torch.int32), \
        np.ones(3, bool)
    sp = SamplingParams(greedy=True)
    e.decode_step(toks, active, sp)                # captures the step

    def counts(eager):
        for f in counted_wrappers():
            f.launches = 0
        with run_eagerly(e) if eager else contextlib.nullcontext():
            for _ in range(5):
                e.decode_step(toks, active, sp)
        return {f.__name__: f.launches for f in counted_wrappers()}
    replayed, eager = counts(False), counts(True)
    # one forward of 3 layers a step: A once plain, 2 x 3 times with a
    # residual (the layers' final residual adds folded in), B 3 times
    assert replayed == eager and replayed["rmsnorm"] == 5
    assert replayed["add_residual_rmsnorm"] == 5 * 6
    assert replayed["silu_and_mul"] == 5 * 3


def _spec_pair(cuda, draft_seed):
    """A target and a draft engine (bf16 debug widths, 3 layers; the draft
    from another seed, or the target's own weights), B = 3."""
    target = _graph_engine(cuda, "slot")
    if draft_seed is None:
        draft = InferenceEngine(target.config, target.engine_config,
                                target.params, device=cuda)
    else:
        cfg = target.config
        draft = InferenceEngine(cfg, target.engine_config,
                                init_dummy_params(cfg, seed=draft_seed,
                                                  device=cuda), device=cuda)
    return target, draft


@pytest.mark.parametrize("draft_seed", [None, 5])
def test_speculative_replays_equal_eager_rounds(cuda, draft_seed):
    """SpeculativeDecoder.generate, greedy and then sampled from one seed,
    with its rounds replayed (CUDA graphs, the ingest program among them
    when the draft is the target) equals the same rounds run eagerly: ids
    and drafted/accepted counts."""
    from llm_inference_engine_tpu_torch.runtime.speculative import (
        SpeculativeDecoder)
    spec = SpeculativeDecoder(*_spec_pair(cuda, draft_seed), num_draft=3)
    prompts = [list(range(3, 40)), [5, 9], [11] * 17]
    sampled = SamplingParams(temperature=0.8, top_p=0.95)

    def run():
        out = []
        for sp in (None, sampled):
            spec._gen.manual_seed(3)
            r = spec.generate(prompts, max_new_tokens=20, eos_token_id=None,
                              sampling=sp)
            out.append((r.token_ids, r.num_drafted, r.num_accepted))
        return out
    with run_eagerly(spec):
        eager = run()
    assert spec._programs == {}
    replayed = run()
    assert {"greedy", "sampled"} <= set(spec._programs)
    assert replayed == eager
    if draft_seed is None:
        assert "ingest" in spec._programs
        assert eager[0][2] == eager[0][1]      # greedy: all accepted


def test_beam_step_replays_equal_eager_steps(cuda):
    """A 3-beam search with its step replayed equals the eager steps:
    sequences and scores; a second search with other rows to reorder is
    captured again and equals its eager run."""
    from llm_inference_engine_tpu_torch.runtime.beam_search import BeamSearch
    e = _graph_engine(cuda, "slot")
    bs = BeamSearch(e.config, e.engine_config, e.params, num_beams=3)
    for prompt, n in (([1, 2, 3] * 10, 12), (list(range(5, 60)), 7)):
        with run_eagerly(bs):
            want = bs.search(prompt, n, eos_token_id=None)
        assert bs.search(prompt, n, eos_token_id=None) == want
        assert set(bs._programs) == {"step"}


# ---------------------------------------------------------------------------
# the kernels at a model rank's local shapes of llama2-7b under tp = 2
# (parallel/sharding.py): every input a view at the head of a buffer whose
# tail past it holds NaN (int8 weights: 127), so a read past any ragged
# tail shows
# ---------------------------------------------------------------------------

# (k, n, halves) of E/F: the column-sharded wqkv, gate|up and vocab, the
# row-sharded wo (k 2048) and down (k 5504: 43 groups, 21.5 decode stages)
TP2_PROJECTIONS = {"wqkv": (4096, 6144, 1), "wo": (2048, 4096, 1),
                   "gate_up": (4096, 5504, 2), "down": (5504, 4096, 1),
                   "lm_head": (4096, 16000, 1)}
TP2_HEADS = 16


def _tail_poisoned(t: torch.Tensor, pad: int = 1 << 16) -> torch.Tensor:
    """``t``'s values at the head of a larger buffer whose tail is NaN (or
    127 for an integer dtype)."""
    fill = float("nan") if t.is_floating_point() else 127
    buf = torch.full((t.numel() + pad,), fill, dtype=t.dtype,
                     device=t.device)
    buf[:t.numel()].copy_(t.flatten())
    return buf[:t.numel()].view(t.shape)


def _poisoned_weight(t, poison):
    """``t`` with q, its scales and (INT4) its fragment order each at the
    head of a buffer whose tail ``poison`` fills (``_tail_poisoned``,
    ``_nan_tailed``)."""
    out = quant.QuantizedTensor(poison(t.q), poison(t.scale), t.mode,
                                t.group_size)
    if t.qd is not None:
        out.qd = poison(quant.repack_int4_decode(out.q))
    return out


@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("m", [8, 512])
@pytest.mark.parametrize("proj", list(TP2_PROJECTIONS))
def test_quant_matmul_at_tp2_local_shapes(cuda, mode, m, proj):
    k, n, halves = TP2_PROJECTIONS[proj]
    t = _qweight(cuda, mode, k, n, halves)
    t = _poisoned_weight(t, _tail_poisoned)
    x = _tail_poisoned(torch.randn(m, k, device=cuda, dtype=torch.bfloat16))
    if proj == "lm_head":
        got = _held_against_plain(t, x, torch.float32, atol=1e-3, rtol=1e-4)
    else:
        got = _held_against_plain(t, x, torch.bfloat16)
    assert got.shape == (m, n * halves) and torch.isfinite(got).all()


# the projections of llama2-7b, tinyllama-1.1b and their tp = 2 shards (k,
# n, halves): a speculative verify (B 8 x k + 1 = 5 rows) or a decode batch
# of 17-48 rows runs E/F's decode mode at 32- and 48-row x tiles
ROWS_17_48_PROJECTIONS = {
    "7b wqkv": (4096, 12288, 1), "7b wo": (4096, 4096, 1),
    "7b gate_up": (4096, 11008, 2), "7b down": (11008, 4096, 1),
    "tiny wqkv": (2048, 2560, 1), "tiny wo": (2048, 2048, 1),
    "tiny gate_up": (2048, 5632, 2), "tiny down": (5632, 2048, 1),
    **{f"7b tp2 {p}": v for p, v in TP2_PROJECTIONS.items()
       if p != "lm_head"},
    "tiny tp2 wqkv": (2048, 1280, 1), "tiny tp2 wo": (1024, 2048, 1),
    "tiny tp2 gate_up": (2048, 2816, 2), "tiny tp2 down": (2816, 2048, 1)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("m", [17, 24, 32, 40, 48])
def test_quant_matmul_rows_17_to_48(cuda, dtype, mode, m):
    """E / F (bf16) and Ef / Ff (f16) at m 17-48 on every projection of
    llama2-7b, tinyllama-1.1b and their tp = 2 shards (the decode mode's
    32- and 48-row tiles where n is narrow, the prefill mode elsewhere),
    x, q and the scales at the head of buffers whose tails hold NaN (127
    for q): one launch, in the mode the plan and its mirror name, against
    the plain version."""
    counter = (getattr(quant, f"{mode}_matmul_float")
               if dtype == torch.float16 else _fused(mode))
    for proj, (k, n, halves) in ROWS_17_48_PROJECTIONS.items():
        t = _qweight(cuda, mode, k, n, halves)
        t = _poisoned_weight(t, _tail_poisoned)
        x = _tail_poisoned(torch.randn(m, k, device=cuda, dtype=dtype))
        before = counter.launches
        got = _run_fused(t, x, dtype, "cuda")
        want = _run_fused(t, x, dtype, "torch")
        torch.cuda.synchronize()
        assert counter.launches == before + 1, proj
        assert got.shape == (m, halves * n) and torch.isfinite(got).all()
        if dtype == torch.float16:
            _held_float(got, want, dtype)
        else:
            torch.testing.assert_close(got, want, **TOL)
        plan = quant.quant_matmul_plan_native(m, k, n, halves,
                                              int4=mode == "int4",
                                              dtype=dtype)
        assert plan.pop("blocks_per_sm") >= 1
        assert plan == quant.quant_matmul_plan(
            m, k, n, halves, int4=mode == "int4", dtype=dtype), proj
        if plan["mode"] == "decode":
            assert plan["rows"] == (32 if m <= 32 else 48), (proj, plan)


def test_silu_and_mul_at_tp2_local_shape(cuda):
    x = _tail_poisoned(torch.randn(8, 2 * 5504, device=cuda,
                                   dtype=torch.bfloat16))
    got = activations.silu_and_mul(x, kernels="cuda")
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, activations.silu_and_mul_torch(x), **TOL)


@pytest.mark.parametrize("proj", list(TP2_PROJECTIONS))
def test_dequant_int4_at_tp2_local_shapes(cuda, proj):
    """G on a model rank's shard (the m >= 1024 prefill route), q and
    scale tail-poisoned: bit-identical to the plain dequant."""
    k, n, halves = TP2_PROJECTIONS[proj]
    t = _qweight(cuda, "int4", k, n, halves)
    q, scale = _tail_poisoned(t.q), _tail_poisoned(t.scale)
    got = quant.dequant_int4(q, scale, 128, kernels="cuda")
    want = quant.dequant_int4(q, scale, 128, kernels="torch")
    torch.cuda.synchronize()
    assert got.shape == (k, halves * n)
    assert torch.equal(got, want)


def test_paged_kv_write_at_tp2_local_heads(cuda):
    """H at 16 heads, pages of 64: a chunk of four prompts (5, 17, 40 and
    64 tokens) beside four empty rows, then one decode row each of the
    four, the new rows tail-poisoned: bit-identical to the plain write."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    B, K, D, page = 8, TP2_HEADS, 128, 64
    cache = _paged_pool(cuda, 2, B, 4, page, K, D)
    ref = pkv.PagedKVCache(cache.k.clone(), cache.v.clone(),
                           cache.block_table, cache.lengths)
    chunk = [5, 17, 40, 64, 0, 0, 0, 0]
    for T, starts, new_len in (
            (64, [0] * B, chunk),
            (1, [n + 15 if n else 0 for n in chunk],
             [1 if n else 0 for n in chunk])):
        new_k, new_v = (_tail_poisoned(torch.randn(
            B, T, K, D, device=cuda, dtype=torch.bfloat16)) for _ in "kv")
        starts = torch.tensor(starts, device=cuda, dtype=torch.int32)
        new_len = torch.tensor(new_len, device=cuda, dtype=torch.int32)
        pkv.paged_update_at_layer(cache, 1, new_k, new_v, starts, new_len,
                                  kernels="cuda")
        pkv.paged_update_at_layer_torch(ref, 1, new_k, new_v, starts,
                                        new_len)
        torch.cuda.synchronize()
        assert torch.equal(cache.k, ref.k) and torch.equal(cache.v, ref.v)


@pytest.mark.parametrize("int8", [False, True])
def test_kv_writes_at_tp2_local_heads(cuda, int8):
    """C (bf16) and I (int8, snapped as the 16-head shard of the engine)
    writing a ragged chunk at 16 heads: bit-identical to the plain write."""
    L, B, S, K, D, T = 2, 4, 600, TP2_HEADS, 128, 77
    if int8:
        c = _int8_slot(cuda, L, B, S, K, D, True)
        ref = kvc.KVCache(c.k.clone(), c.v.clone(), c.lengths,
                          c.k_scale.clone(), c.v_scale.clone(), snapped=True)
    else:
        base = torch.randn(L, B, S, K, D, device=cuda, dtype=torch.bfloat16)
        c = kvc.KVCache(base.clone(), base.clone(),
                        torch.zeros(B, device=cuda, dtype=torch.int32))
        ref = kvc.KVCache(base.clone(), base.clone(), c.lengths)
    new_k = _tail_poisoned(torch.randn(B, T, K, D, device=cuda,
                                       dtype=torch.bfloat16))
    new_v = _tail_poisoned(torch.randn(B, T, K, D, device=cuda,
                                       dtype=torch.bfloat16))
    starts = torch.tensor([0, 37, 599, 88], device=cuda, dtype=torch.int32)
    new_len = torch.tensor([77, 40, 1, 0], device=cuda, dtype=torch.int32)
    kvc.update_cache_at_layer(c, 1, new_k, new_v, starts, new_len,
                              kernels="cuda")
    kvc.update_cache_at_layer_torch(ref, 1, new_k, new_v, starts, new_len)
    torch.cuda.synchronize()
    for name in ("k", "v") + (("k_scale", "v_scale") if int8 else ()):
        assert torch.equal(getattr(c, name), getattr(ref, name))


@pytest.mark.parametrize("mode", ["slot", "int8", "paged"])
def test_attention_at_tp2_local_heads(cuda, mode):
    """D2 (a ragged prefill chunk) and D (the fused slot decode, or the
    paged decode) at a model rank's 16 heads of llama2-7b, every cache row
    past kv_len NaN (values; an int8 cache's scales; pool pages outside
    the table), held against the plain versions on clean copies."""
    T, S, q_start, kv_len = _lens(cuda, CHUNK)
    K, D, L, B, page = TP2_HEADS, 128, 2, 4, 64
    q = _tail_poisoned(torch.randn(B, T, K, D, device=cuda,
                                   dtype=torch.bfloat16))
    if mode == "paged":
        c = _paged_pool(cuda, L, B, S // page + 2, page, K, D)
    elif mode == "int8":
        c = _int8_slot(cuda, L, B, S, K, D, True)
    else:
        c = kvc.KVCache(*_qkv(cuda, L, B, 1, 1, K, S, D)[1:], q_start)
    clean = [None if t is None else t.clone()
             for t in (c.k, c.v, c.k_scale, c.v_scale)]
    kw = dict(table=c.block_table) if mode == "paged" else {}
    if mode == "paged":
        _poison_pool(c, kv_len, page)
    else:
        _poison_slot(c, kv_len)
    planes = _planes(c) if c.k_scale is not None else {}
    got = attention.attention(q, c.k, c.v, q_start, kv_len, layer=1,
                              kernels="cuda", **kw, **planes)
    want = attention.attention(q, clean[0], clean[1], q_start, kv_len,
                               layer=1, kernels="torch", **kw,
                               **({} if clean[2] is None else dict(
                                   k_scale=clean[2], v_scale=clean[3])))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)

    # decode, one token a sequence, row 2 inactive: the paged mode attends
    # up to each row's last valid key; the fused slot mode writes the new
    # key at kv_len (row 3 at 0: a first token) and attends up to it
    qd = _tail_poisoned(torch.randn(B, 1, K, D, device=cuda,
                                    dtype=torch.bfloat16))
    step = torch.tensor([1, 1, 0, 1], device=cuda, dtype=torch.int32)
    if mode == "paged":
        start = kv_len - 1
    else:
        start = kv_len.clone()
        start[3] = 0
    end = start + step
    if mode == "paged":
        got = attention.attention_decode(qd, c.k, c.v, start, end, 1,
                                         table=c.block_table, kernels="cuda")
        want = attention.attention_paged_torch(
            qd, c.k.nan_to_num(), c.v.nan_to_num(), start, end, 1,
            c.block_table)
    else:
        k_new = _tail_poisoned(torch.randn(B, 1, K, D, device=cuda,
                                           dtype=torch.bfloat16))
        v_new = torch.randn_like(k_new)
        ref = [None if t is None else t.clone()
               for t in (c.k, c.v, c.k_scale, c.v_scale)]
        for t in ref[2:] if mode == "int8" else ref[:2]:
            t.nan_to_num_(1.0 if mode == "int8" else 0.0)
        got, _, _ = attention.attention_decode_fused(
            qd, k_new, v_new, c.k, c.v, start, end, 1, kernels="cuda",
            snapped=mode == "int8", **planes)
        want, _, _ = attention.attention_decode_fused_torch(
            qd, k_new, v_new, ref[0], ref[1], start, end, 1,
            snapped=mode == "int8",
            **({} if ref[2] is None else dict(k_scale=ref[2],
                                              v_scale=ref[3])))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# kernel D's fused paged decode against kernel H then the attend-only decode,
# and the bf16 row writes C and H at the model's row widths
# ---------------------------------------------------------------------------

def _bits_equal(a, b):
    return torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("B,page,window", [(8, 64, None), (16, 16, 40),
                                           (16, 64, 300)])
def test_fused_paged_decode_equals_write_then_attend(cuda, D, G, B, page,
                                                     window):
    """The fused paged decode against H then the attend-only paged decode
    on a copy of the pool: pools and outputs bit for bit; against its
    plain version on a clean copy: the pool (page 0 aside) bit for bit,
    the output within TOL. Rows: a first token (q_start 0), q_start at
    in-page offsets 0 and page - 1, an inactive row, an active row whose
    table entry at q_start's page is -1 (neither writes; it attends layer
    0's last page, the same bytes for both, and is left out of the plain
    comparison), the rest random up to S = 1024. NaN in every pool row
    past kv_len and every page outside the table, and past the ends of q
    and the new rows."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    K, S, neg = 2, 1024, 4
    c = _paged_pool(cuda, 2, B, S // page, page, K, D)
    g = torch.Generator(device=cuda).manual_seed(B * D + G)
    kv_len = torch.randint(2, S + 1, (B,), generator=g, device=cuda,
                           dtype=torch.int32)
    kv_len[:3] = torch.tensor([1, page + 1, 2 * page], device=cuda)
    q_start = kv_len - 1
    q_start[3] = kv_len[3]
    _poison_pool(c, kv_len, page)
    entry = int(c.block_table[neg, q_start[neg] // page])
    c.block_table[neg, q_start[neg] // page] = -1
    split = pkv.PagedKVCache(c.k.clone(), c.v.clone(), c.block_table,
                             c.lengths)
    table = c.block_table.clone()
    table[neg, q_start[neg] // page] = 0
    clean = pkv.PagedKVCache(c.k.nan_to_num(), c.v.nan_to_num(), table,
                             c.lengths)
    q, kn, vn = (_tail_poisoned(torch.randn(
        B, 1, n, D, device=cuda, dtype=torch.bfloat16))
        for n in (K * G, K, K))
    n0 = attention.attention_decode_paged_fused.launches
    h0 = pkv.paged_update_at_layer.launches
    got, _, _ = attention.attention_decode_paged_fused(
        q, kn, vn, c.k, c.v, q_start, kv_len, 1, table=c.block_table,
        window=window, kernels="cuda")
    assert attention.attention_decode_paged_fused.launches == n0 + 1
    assert pkv.paged_update_at_layer.launches == h0
    pkv.paged_update_at_layer(split, 1, kn, vn, q_start, kv_len - q_start,
                              kernels="cuda")
    want = attention.attention_decode(q, split.k, split.v, q_start, kv_len,
                                      1, table=c.block_table, window=window,
                                      kernels="cuda")
    plain, _, _ = attention.attention_decode_paged_fused_torch(
        q, kn, vn, clean.k, clean.v, q_start, kv_len, 1, table=table,
        window=window)
    torch.cuda.synchronize()
    assert _bits_equal(c.k, split.k) and _bits_equal(c.v, split.v)
    assert _bits_equal(got, want)
    assert entry > 0
    for mine, ref in ((c.k, clean.k), (c.v, clean.v)):
        assert torch.equal(mine[:, 1:].nan_to_num(), ref[:, 1:])
    rows = [b for b in range(B) if b != neg]
    assert torch.isfinite(got[rows]).all()
    torch.testing.assert_close(got[rows], plain[rows], **TOL)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("T", [1, 64, 512])
@pytest.mark.parametrize("K,D", [(32, 128), (16, 128), (2, 64)])
def test_copy_writes_at_model_rows(cuda, paged, T, K, D):
    """C (slot) and H (pool, pages of 64) at llama2-7b's 8 KB rows, a tp =
    2 rank's 4 KB rows and the tinyllama draft rank's 256-byte rows: a
    ragged launch (a full row, one from an odd offset, a new_len == 0 row,
    one of new_len 1), the new rows with NaN past their ends, twice;
    the cache or pool equals the plain write bit for bit."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    B, L, page = 4, 2, 64
    S = T + 2 * page
    if paged:
        c = _paged_pool(cuda, L, B, S // page + 1, page, K, D)
        ref = pkv.PagedKVCache(c.k.clone(), c.v.clone(), c.block_table,
                               c.lengths)
        write, plain = pkv.paged_update_at_layer, \
            pkv.paged_update_at_layer_torch
    else:
        _, kc, vc = _qkv(cuda, L, B, 1, 1, K, S, D)
        c = kvc.KVCache(kc, vc, torch.zeros(B, device=cuda,
                                            dtype=torch.int32))
        ref = kvc.KVCache(kc.clone(), vc.clone(), c.lengths)
        write, plain = kvc.update_cache_at_layer, \
            kvc.update_cache_at_layer_torch
    kn, vn = (_tail_poisoned(torch.randn(B, T, K, D, device=cuda,
                                         dtype=torch.bfloat16))
              for _ in "kv")
    starts = torch.tensor([0, page - 3, 5, 2 * page + 1], device=cuda,
                          dtype=torch.int32)
    new_len = torch.tensor([T, max(T - 9, 1), 0, 1], device=cuda,
                           dtype=torch.int32)
    for _ in range(2):
        write(c, 1, kn, vn, starts, new_len, kernels="cuda")
    plain(ref, 1, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    assert torch.equal(c.k, ref.k) and torch.equal(c.v, ref.v)


# ---------------------------------------------------------------------------
# the float instances: D2f and Df (csrc/attention_*_f16.cu, _f32.cu), Ef
# and Ff (csrc/quant_matmul_f16.cu, _f32.cu), If (csrc/kv_write_quant.cu)
# ---------------------------------------------------------------------------

FLOAT_DTYPES = [torch.float32, torch.float16]
# head dims of the float16 / float32 instances: 16 and HEAD_DIMS
FLOAT_HEAD_DIMS = (16,) + HEAD_DIMS
# max |kernel - plain| over max |plain|: both sum in f32 in another order;
# float16 outputs also round once (2^-11 relative)
FLOAT_TOL = {torch.float32: 1e-5, torch.float16: 2e-3}
FLOAT_MODES = ["slot", "paged", "int8", "paged-int8"]


def _held_float(got, want, dtype):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    rel = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
    assert rel <= FLOAT_TOL[dtype], rel


def _float_cache(cuda, dtype, mode, L, B, S, K, D, page=16):
    """A cache of random rows for ``mode``: a float slot cache or pool of
    ``dtype`` (a shuffled table over pages 1..), or an int8 one."""
    if mode == "int8":
        return _int8_slot(cuda, L, B, S, K, D, True)
    if mode == "paged-int8":
        return _int8_pool(cuda, L, B, -(-S // page), page, K, D)
    if mode == "paged":
        c = _paged_pool(cuda, L, B, -(-S // page), page, K, D)
        return dataclasses.replace(c, k=c.k.to(dtype), v=c.v.to(dtype))
    k = torch.randn(L, B, S, K, D, device=cuda, dtype=dtype)
    return kvc.KVCache(k, torch.randn_like(k),
                       torch.zeros(B, device=cuda, dtype=torch.int32))


def _float_counter(kind, mode):
    return getattr(attention, {"slot": f"attention_{kind}_float",
                               "paged": f"attention_{kind}_paged_float",
                               "int8": f"attention_{kind}_float_int8",
                               "paged-int8":
                                   f"attention_{kind}_paged_float_int8"}[mode])


def _poisoned(c, mode, kv_len, page=16):
    """A clean copy of ``c`` for the plain version, then NaN into every
    row of ``c`` at or past kv_len and every pool page outside the table
    (values, or an int8 cache's scales); returns (clean, table kwargs)."""
    clean = _clone_cache(c)
    if mode.startswith("paged"):
        _poison_pool(c, kv_len, page)
        return clean, dict(table=c.block_table)
    _poison_slot(c, kv_len)
    return clean, {}


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("mode", FLOAT_MODES)
@pytest.mark.parametrize("D,G,window,lens", [
    (16, 2, None, CHUNK), (64, 4, 70, CHUNK), (128, 1, None, CHUNK),
    (128, 4, None, LONG), (80, 2, 100, CHUNK), (256, 1, None, CHUNK)])
def test_float_prefill_attention(cuda, dtype, mode, D, G, window, lens):
    """D2f in each mode against the plain version on a clean copy, with NaN
    past kv_len and outside the table: prefill, chunk and ragged rows."""
    T, S, q_start, kv_len = _lens(cuda, lens)
    K = 2
    q = torch.randn(4, T, K * G, D, device=cuda, dtype=dtype)
    c = _float_cache(cuda, dtype, mode, 2, 4, S, K, D)
    clean, kw = _poisoned(c, mode, kv_len)
    counter = _float_counter("prefill", mode)
    before = counter.launches
    got = attention.attention(q, c.k, c.v, q_start, kv_len, layer=1,
                              window=window, kernels="cuda", **kw,
                              **(_planes(c) if c.k_scale is not None else {}))
    want = attention.attention(q, clean.k, clean.v, q_start, kv_len, layer=1,
                               window=window, kernels="torch", **kw,
                               **(_planes(clean) if clean.k_scale is not None
                                  else {}))
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.dtype == dtype
    _held_float(got, want, dtype)


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("mode", FLOAT_MODES)
def test_float_prefill_attention_empty_rows_are_zero(cuda, dtype, mode):
    q = torch.randn(2, 9, 4, 16, device=cuda, dtype=dtype)
    zero = torch.zeros(2, device=cuda, dtype=torch.int32)
    c = _float_cache(cuda, dtype, mode, 1, 2, 64, 2, 16)
    kw = dict(table=c.block_table) if mode.startswith("paged") else {}
    if c.k_scale is not None:
        kw.update(_planes(c))
    out = attention.attention(q, c.k, c.v, zero, zero, layer=0,
                              kernels="cuda", **kw)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("int8,snapped", [(False, False), (True, False),
                                          (True, True)])
@pytest.mark.parametrize("D,G,window", [(16, 2, None), (64, 4, 45),
                                        (128, 1, None), (128, 8, None)])
def test_float_fused_decode(cuda, dtype, int8, snapped, D, G, window):
    """Df's slot decode: the token's row written (an int8 cache's values
    and scales bit for bit as the plain quantizer writes them), then
    attended; NaN in every row from q_start on, which the write must
    replace before the attention reads it."""
    L, B, S, K = 2, 5, 300, 2
    kv_len = torch.tensor([1, 40, 299, 300, 77], device=cuda,
                          dtype=torch.int32)
    q_start = kv_len - 1
    q_start[3] = kv_len[3]                  # inactive: writes nothing
    c = (_int8_slot(cuda, L, B, S, K, D, snapped) if int8
         else _float_cache(cuda, dtype, "slot", L, B, S, K, D))
    clean = _clone_cache(c)
    _poison_slot(c, q_start)
    q = torch.randn(B, 1, K * G, D, device=cuda, dtype=dtype)
    kn = torch.randn(B, 1, K, D, device=cuda, dtype=dtype)
    vn = torch.randn_like(kn)
    planes = (lambda x: _planes(x)) if int8 else (lambda x: {})
    counter = (attention.attention_decode_float_int8 if int8
               else attention.attention_decode_float)
    before = counter.launches
    got = attention.attention_decode_fused(
        q, kn, vn, c.k, c.v, q_start, kv_len, 1, window=window,
        kernels="cuda", snapped=snapped, **planes(c))[0]
    want = attention.attention_decode_fused_torch(
        q, kn, vn, clean.k, clean.v, q_start, kv_len, 1, window=window,
        snapped=snapped, **planes(clean))[0]
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    _held_float(got, want, dtype)
    names = ("k", "v", "k_scale", "v_scale") if int8 else ("k", "v")
    for b, n in enumerate(kv_len.tolist()):      # layer 1 was written
        for name in names:
            assert torch.equal(getattr(c, name)[1, b, :n],
                               getattr(clean, name)[1, b, :n]), (b, name)


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("mode", ["paged", "paged-int8"])
@pytest.mark.parametrize("D,G,window,page", [(16, 2, None, 16),
                                             (64, 4, 45, 16),
                                             (128, 1, None, 64),
                                             (128, 8, None, 16)])
def test_float_paged_decode(cuda, dtype, mode, D, G, window, page):
    """Df's attend-only decode through the table (the pool already holds
    the token), NaN past kv_len and outside the table."""
    B, S, K = 5, 300, 2
    kv_len = torch.tensor([1, 40, 299, 300, 77], device=cuda,
                          dtype=torch.int32)
    q_start = kv_len - 1
    c = _float_cache(cuda, dtype, mode, 2, B, S, K, D, page)
    clean, kw = _poisoned(c, mode, kv_len, page)
    q = torch.randn(B, 1, K * G, D, device=cuda, dtype=dtype)
    planes = _planes if mode.endswith("int8") else (lambda x: {})
    counter = _float_counter("decode", mode)
    before = counter.launches
    got = attention.attention_decode(q, c.k, c.v, q_start, kv_len, 1,
                                     window=window, kernels="cuda", **kw,
                                     **planes(c))
    want = attention.attention_paged_torch(q, clean.k, clean.v, q_start,
                                           kv_len, 1, kw["table"],
                                           window=window, **planes(clean))
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    _held_float(got, want, dtype)


def _float_rows(cuda, dtype, B, T, K, D, new_len):
    """New rows [B, T, K, D] with a zero row, a tiny and a large one, and
    NaN in every row at or past new_len (never read)."""
    x = torch.randn(B, T, K, D, device=cuda, dtype=torch.float32) * 2
    x[0, 0, 0] = 0.0
    x[0, 0, 1] *= 1e-3
    x[0, 1, 0] *= 3e3
    for b, n in enumerate(new_len.tolist()):
        x[b, n:] = float("nan")
    return x.to(dtype)


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("paged,snapped", [(False, False), (False, True),
                                           (True, True)])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_float_int8_write_bit_for_bit(cuda, dtype, paged, snapped, D):
    """If: float rows quantized into the int8 slot cache or pool, values
    and scales bit for bit as the plain quantizer writes them; rows past
    new_len hold NaN, rows past S (or the table) are not written."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B, T, K, page = 2, 4, 37, 4, 16
    starts = torch.tensor([0, 5, 250, 290], device=cuda, dtype=torch.int32)
    new_len = torch.tensor([37, 1, 0, 37], device=cuda, dtype=torch.int32)
    kn = _float_rows(cuda, dtype, B, T, K, D, new_len)
    vn = _float_rows(cuda, dtype, B, T, K, D, new_len)
    if paged:
        c = _int8_pool(cuda, L, B, -(-300 // page), page, K, D)
        ref = _clone_cache(c)
        counter = pkv.paged_kv_write_quant_float
        before = counter.launches
        pkv.paged_update_at_layer(c, 1, kn, vn, starts, new_len,
                                  kernels="cuda")
        pkv.paged_update_at_layer_torch(ref, 1, kn, vn, starts, new_len)
    else:
        c = _int8_slot(cuda, L, B, 300, K, D, snapped)
        ref = _clone_cache(c)
        counter = kvc.kv_write_quant_float
        before = counter.launches
        kvc.update_cache_at_layer(c, 1, kn, vn, starts, new_len,
                                  kernels="cuda")
        kvc.update_cache_at_layer_torch(ref, 1, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(c, name), getattr(ref, name)), name


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("paged,snapped", [(False, False), (False, True),
                                           (True, True)])
@pytest.mark.parametrize("D", FLOAT_HEAD_DIMS)
def test_float_int8_write_every_head_dim(cuda, dtype, paged, snapped, D):
    """If, kernel I's template over float16 and float32 rows, at every
    head dim of its instances: values and scales bit for bit as the plain
    quantizer writes them, at 8 x 512 rows (the slot prefill chunk) with
    ragged new_len. NaN in every row past new_len and past the end of the
    new rows' buffer (never read); over a pool, NaN scales in every page
    outside the table and in the rows past each sequence's last written
    position, -128 values in the scratch page 0,
    which stay as they were."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B, T, K, page = 2, 8, 512, 4, 64
    starts = torch.tensor([0, 512, 1000, 1535, 7, 1536, 100, 1200],
                          device=cuda, dtype=torch.int32)
    new_len = torch.tensor([512, 300, 1, 0, 512, 512, 77, 512],
                           device=cuda, dtype=torch.int32)
    kn, vn = (_tail_poisoned(_float_rows(cuda, dtype, B, T, K, D, new_len))
              for _ in range(2))
    if paged:
        c = _int8_pool(cuda, L, B, 2048 // page, page, K, D)
        _poison_pool(c, torch.clamp(starts + new_len, max=2048), page)
        c.k[:, 0] = c.v[:, 0] = INT8_POISON
        ref = _clone_cache(c)
        counter = pkv.paged_kv_write_quant_float
        before = counter.launches
        pkv.paged_update_at_layer(c, 1, kn, vn, starts, new_len,
                                  kernels="cuda")
        pkv.paged_update_at_layer_torch(ref, 1, kn, vn, starts, new_len)
    else:
        c = _int8_slot(cuda, L, B, 2048, K, D, snapped)
        ref = _clone_cache(c)
        counter = kvc.kv_write_quant_float
        before = counter.launches
        kvc.update_cache_at_layer(c, 1, kn, vn, starts, new_len,
                                  kernels="cuda")
        kvc.update_cache_at_layer_torch(ref, 1, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for name in ("k", "v", "k_scale", "v_scale"):
        got, want = getattr(c, name), getattr(ref, name)
        if paged:                      # the plain write may touch page 0
            got, want = got[:, 1:], want[:, 1:]
        assert _bits_equal(got, want), name


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("snapped", [True, False])
@pytest.mark.parametrize("D", FLOAT_HEAD_DIMS)
def test_float_int8_write_equals_fused_decode_write(cuda, dtype, snapped, D):
    """If (a sub-warp a row, 32-byte pieces) and the row quantizer it
    replaced (kvq::quantize_row_strided, a warp a row, which Df's fused
    int8 slot decode still runs) write the same new token rows alike:
    values and scales bit for bit, a row of zeros and a row of tiny values
    among them."""
    L, B, S, K = 2, 4, 300, 8
    c = _int8_slot(cuda, L, B, S, K, D, snapped)
    other = _clone_cache(c)
    q = torch.randn(B, 1, K, D, device=cuda, dtype=dtype)
    kn = torch.randn(B, 1, K, D, device=cuda, dtype=dtype)
    vn = torch.randn_like(kn)
    kn[1, 0, 3] = 0.0                                  # a row of zeros
    vn[2, 0, 1] *= 1e-4
    q_start = torch.tensor([0, 17, 150, 299], device=cuda, dtype=torch.int32)
    attention.attention_decode_fused(q, kn, vn, c.k, c.v, q_start,
                                     q_start + 1, 1, kernels="cuda",
                                     snapped=snapped, **_planes(c))
    kvc.kv_write_quant(other, 1, kn, vn, q_start,
                       torch.ones_like(q_start), kernels="cuda")
    torch.cuda.synchronize()
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(c, name), getattr(other, name)), name


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("B,T", [(1, 1), (8, 1), (16, 1), (8, 7), (8, 64),
                                 (8, 512)])
def test_float_write_quant_plan_mirror_equals_library(cuda, dtype, B, T):
    """ops.kv_cache.write_quant_plan of float16 and float32 rows equals
    If's plan in the built library at every head dim and preset K."""
    from llm_inference_engine_tpu_torch.config import PRESETS
    for K in sorted({c.num_kv_heads for c in PRESETS.values()}):
        for D in FLOAT_HEAD_DIMS:
            assert kvc.write_quant_plan_native(B, T, K, D, dtype) == \
                kvc.write_quant_plan(B, T, K, D, dtype)


# kernel D's fused decode over an int8 pool: bf16 q at every head dim and
# group size, float16 / float32 q (Df) at the float tests' shapes
INT8_FUSED_CASES = (
    [(torch.bfloat16, d, g) for d in HEAD_DIMS for g in (1, 4, 8)]
    + [(dt, d, g) for dt in FLOAT_DTYPES
       for d, g in ((16, 2), (64, 4), (128, 1), (128, 8), (256, 1))])


@pytest.mark.parametrize("dtype,D,G", INT8_FUSED_CASES,
                         ids=lambda v: str(v).split(".")[-1])
@pytest.mark.parametrize("B,page,window", [(8, 64, None), (16, 16, 40),
                                           (16, 64, 300)])
def test_int8_fused_paged_decode_equals_write_then_attend(
        cuda, dtype, D, G, B, page, window):
    """The fused decode over an int8 pool (the token's row quantized with
    snapped scales inside kernel D / Df and written through the table)
    against the route it replaced on a copy: kernel H's int8 mode (If for
    float rows) then the attend-only int8 paged decode; pool values,
    scales and outputs bit for bit, no H launched by the fused one.
    Against the plain version on a clean copy: the pool (page 0 aside) bit
    for bit, the output within TOL (bf16) or FLOAT_TOL. The rows of the
    tests above: a first token, q_start at in-page offsets 0 and page - 1,
    an inactive row, an active row whose table entry at q_start's page is
    -1 (it writes nothing and is left out of the plain comparison); NaN
    scales in every pool row past kv_len and every page outside the table,
    and NaN past the ends of q and the new rows."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    K, S, neg = 2, 1024, 4
    c = _int8_pool(cuda, 2, B, S // page, page, K, D)
    g = torch.Generator(device=cuda).manual_seed(B * D + G)
    kv_len = torch.randint(2, S + 1, (B,), generator=g, device=cuda,
                           dtype=torch.int32)
    kv_len[:3] = torch.tensor([1, page + 1, 2 * page], device=cuda)
    q_start = kv_len - 1
    q_start[3] = kv_len[3]
    _poison_pool(c, kv_len, page)
    c.block_table[neg, q_start[neg] // page] = -1
    split = _clone_cache(c)
    table = c.block_table.clone()
    table[neg, q_start[neg] // page] = 0
    clean = dataclasses.replace(_clone_cache(c), block_table=table,
                                k_scale=c.k_scale.nan_to_num(),
                                v_scale=c.v_scale.nan_to_num())
    q, kn, vn = (_tail_poisoned(torch.randn(
        B, 1, n, D, device=cuda, dtype=dtype)) for n in (K * G, K, K))
    bf16 = dtype == torch.bfloat16
    fused = (attention.attention_decode_paged_fused_int8 if bf16
             else attention.attention_decode_paged_fused_float_int8)
    writes = (pkv.paged_kv_write_quant, pkv.paged_kv_write_quant_float,
              pkv.paged_update_at_layer)
    n0, h0 = fused.launches, [w.launches for w in writes]
    got, _, _ = attention.attention_decode_paged_fused(
        q, kn, vn, c.k, c.v, q_start, kv_len, 1, table=c.block_table,
        window=window, kernels="cuda", **_planes(c))
    assert fused.launches == n0 + 1
    assert [w.launches for w in writes] == h0
    pkv.paged_update_at_layer(split, 1, kn, vn, q_start, kv_len - q_start,
                              kernels="cuda")
    want = attention.attention_decode(q, split.k, split.v, q_start, kv_len,
                                      1, table=c.block_table, window=window,
                                      kernels="cuda", **_planes(split))
    plain, _, _ = attention.attention_decode_paged_fused_torch(
        q, kn, vn, clean.k, clean.v, q_start, kv_len, 1, table=table,
        window=window, **_planes(clean))
    torch.cuda.synchronize()
    for name in ("k", "v", "k_scale", "v_scale"):
        assert _bits_equal(getattr(c, name), getattr(split, name)), name
        mine, ref = getattr(c, name)[:, 1:], getattr(clean, name)[:, 1:]
        assert torch.equal(mine.nan_to_num(), ref), name
    assert _bits_equal(got, want)
    rows = [b for b in range(B) if b != neg]
    if bf16:
        assert torch.isfinite(got[rows]).all()
        torch.testing.assert_close(got[rows], plain[rows], **TOL)
    else:
        _held_float(got[rows], plain[rows], dtype)


def _nan_tailed(t):
    """``t`` copied into the front of a larger buffer whose tail holds NaN
    (or -128 for int8): a kernel that reads past its end shows it."""
    flat = torch.empty(t.numel() + 4096, device=t.device, dtype=t.dtype)
    flat.fill_(-128 if t.dtype == torch.int8 else float("nan"))
    flat[:t.numel()] = t.reshape(-1)
    return flat[:t.numel()].view(t.shape)


# Ef / Ff: every plan boundary of m (decode 8- and 16-row tiles, the
# prefill mode's 64- and 128-row tiles, the last m below the bf16
# route), scale groups 64 and 128 and 192 (which takes the prefill mode
# at any m), the gate|up stack, f32 out, ragged n and k
FLOAT_MATMUL_CASES = (
    [(m, 4096, 1040, 1, False, 128) for m in (1, 8, 9, 16, 17, 64, 65, 512,
                                              1023)]
    + [(1, 4096, 1040, 1, False, 64), (8, 4096, 1040, 1, True, 64),
       (5, 1024, 688, 2, False, 64), (300, 1024, 1040, 1, False, 64),
       (64, 64, 128, 2, False, 64), (512, 128, 64, 1, True, 64),
       (9, 4096, 1040, 2, True, 128), (16, 1536, 688, 2, False, 192),
       (8, 1536, 1040, 1, True, 192), (65, 1152, 688, 2, False, 192),
       (512, 1536, 1040, 1, False, 192)])


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("m,k,n,halves,out_f32,group", FLOAT_MATMUL_CASES)
def test_float_quant_matmul(cuda, dtype, mode, m, k, n, halves, out_f32,
                            group):
    """Ef / Ff against the plain versions, with NaN past the ends of x and
    of the scales and garbage past the weights'; one launch, in the mode
    the plan names."""
    t = _qweight(cuda, mode, k, n, halves=halves, group=group)
    t = _poisoned_weight(t, _nan_tailed)
    x = _nan_tailed(torch.randn(m, k, device=cuda, dtype=dtype))
    out_dtype = torch.float32 if out_f32 else dtype
    counter = getattr(quant, f"{mode}_matmul_float")
    before = counter.launches
    got = _run_fused(t, x, out_dtype, "cuda")
    want = _run_fused(t, x, out_dtype, "torch")
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, halves * n)
    _held_float(got, want, dtype)
    plan = quant.quant_matmul_plan_native(m, k, n, halves,
                                          int4=mode == "int4", group=group,
                                          dtype=dtype)
    assert plan["mode"] == quant.quant_matmul_plan(
        m, k, n, halves, int4=mode == "int4", group=group,
        dtype=dtype)["mode"]
    if m <= 16 or m > 48 or dtype == torch.float32:
        fragment = (mode == "int4" and dtype == torch.float16
                    and group in (64, 128))
        assert plan["mode"] == (
            ("fragment" if fragment else "decode") if m <= 16 and (
                mode == "int8" or group in (64, 128)) else "prefill")


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("m", [8, 16])
def test_float_quant_matmul_graph_replays_equal_eager(cuda, dtype, mode, m):
    """The decode mode of Ef / Ff (a cluster merge and a programmatic
    dependent, no workspace) captured in a CUDA graph behind kernel A
    replays bit for bit what it computes eagerly, on new x each replay."""
    t = _qweight(cuda, mode, 4096, 11008, halves=2)
    w = torch.rand(4096, device=cuda, dtype=dtype) + 0.5
    x = torch.randn(m, 4096, device=cuda, dtype=dtype)
    out = torch.empty(m, 2 * 11008, device=cuda, dtype=dtype)

    def body():
        out.copy_(_run_fused(t, rmsnorm.rmsnorm(x, w, kernels="cuda"), dtype,
                             "cuda"))
    body()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for _ in range(3):
        x.copy_(torch.randn_like(x))
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone()
        body()
        torch.cuda.synchronize()
        assert torch.equal(replayed, out)
        _held_float(out, _run_fused(t, rmsnorm.rmsnorm(x, w, kernels="cuda"),
                                    dtype, "torch"), dtype)


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("D,G", [(16, 2), (64, 4), (128, 1), (128, 8),
                                 (256, 1)])
@pytest.mark.parametrize("B,page,window", [(8, 64, None), (16, 16, 40),
                                           (16, 64, 300)])
def test_float_fused_paged_decode_equals_write_then_attend(
        cuda, dtype, D, G, B, page, window):
    """Df's fused paged decode over a float pool against kernel H then
    Df's attend-only paged decode on a copy: pools and outputs bit for
    bit, no H launched by the fused one; against the plain version on a
    clean copy within FLOAT_TOL. The rows of the bf16 test above: a first
    token, q_start at in-page offsets 0 and page - 1, an inactive row, an
    active row whose table entry at q_start's page is -1 (it writes
    nothing and is left out of the plain comparison); NaN in every pool row
    past kv_len, every page outside the table and past the ends of q and
    the new rows."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    K, S, neg = 2, 1024, 4
    c = _float_cache(cuda, dtype, "paged", 2, B, S, K, D, page)
    g = torch.Generator(device=cuda).manual_seed(B * D + G)
    kv_len = torch.randint(2, S + 1, (B,), generator=g, device=cuda,
                           dtype=torch.int32)
    kv_len[:3] = torch.tensor([1, page + 1, 2 * page], device=cuda)
    q_start = kv_len - 1
    q_start[3] = kv_len[3]
    _poison_pool(c, kv_len, page)
    c.block_table[neg, q_start[neg] // page] = -1
    split = dataclasses.replace(c, k=c.k.clone(), v=c.v.clone())
    table = c.block_table.clone()
    table[neg, q_start[neg] // page] = 0
    clean = dataclasses.replace(c, k=c.k.nan_to_num(), v=c.v.nan_to_num(),
                                block_table=table)
    q, kn, vn = (_tail_poisoned(torch.randn(
        B, 1, n, D, device=cuda, dtype=dtype)) for n in (K * G, K, K))
    n0 = attention.attention_decode_paged_fused_float.launches
    h0 = pkv.paged_update_at_layer.launches
    got, _, _ = attention.attention_decode_paged_fused(
        q, kn, vn, c.k, c.v, q_start, kv_len, 1, table=c.block_table,
        window=window, kernels="cuda")
    assert attention.attention_decode_paged_fused_float.launches == n0 + 1
    assert pkv.paged_update_at_layer.launches == h0
    pkv.paged_update_at_layer(split, 1, kn, vn, q_start, kv_len - q_start,
                              kernels="cuda")
    want = attention.attention_decode(q, split.k, split.v, q_start, kv_len,
                                      1, table=c.block_table, window=window,
                                      kernels="cuda")
    plain, _, _ = attention.attention_decode_paged_fused_torch(
        q, kn, vn, clean.k, clean.v, q_start, kv_len, 1, table=table,
        window=window)
    torch.cuda.synchronize()
    assert _bits_equal(c.k, split.k) and _bits_equal(c.v, split.v)
    assert _bits_equal(got, want)
    for mine, ref in ((c.k, clean.k), (c.v, clean.v)):
        assert torch.equal(mine[:, 1:].nan_to_num(), ref[:, 1:])
    rows = [b for b in range(B) if b != neg]
    _held_float(got[rows], plain[rows], dtype)


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
def test_float_paged_engine_equals_slot_engine(cuda, dtype):
    """A small float16 or float32 model, pages of 16: the paged engine
    (D2f through the table, Df's fused paged decode: no H in a decode step)
    gives prefill logits bit for bit the slot engine's under the same
    kernels and chunk size, and the same greedy ids and decode logits."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    cfg = get_config("debug").replace(dtype_name=str(dtype).split(".")[-1],
                                      head_dim=128, num_layers=3)
    eng = EngineConfig(max_batch_size=3, max_seq_len=256, max_prefill_len=16)
    params = init_dummy_params(cfg, device=cuda)
    paged = InferenceEngine(cfg, eng.replace(kv_layout="paged",
                                             page_size=16), params,
                            device=cuda)
    slot = InferenceEngine(cfg, eng, params, device=cuda)
    prompts = [[1, 2, 3], list(range(5, 100)), [7] * 30]
    lp, ls = paged.prefill(prompts), slot.prefill(prompts)
    assert torch.equal(lp, ls)
    toks = lp.argmax(-1).to(torch.int32)
    active = np.ones(3, bool)
    sp = SamplingParams(greedy=True)
    with run_eagerly(paged), run_eagerly(slot):
        for _ in range(6):
            h0 = pkv.paged_update_at_layer.launches
            tp = paged.decode_step(toks, active, sp)
            assert pkv.paged_update_at_layer.launches == h0
            ts = slot.decode_step(toks, active, sp)
            assert torch.equal(tp, ts)
            toks = tp
    paged.reset()
    slot.reset()
    sp = SamplingParams(greedy=True, max_new_tokens=12)
    assert (paged.generate(prompts, sp, eos_token_id=None).token_ids
            == slot.generate(prompts, sp, eos_token_id=None).token_ids)


@pytest.mark.parametrize("mode", FLOAT_MODES)
@pytest.mark.parametrize("D,G,window", [(16, 4, None), (16, 1, 50),
                                        (256, 4, None), (256, 2, 90)])
def test_float16_prefill_tensor_core_head_dims(cuda, mode, D, G, window):
    """D2's float16 instance at the head dims of its edge tiles: 16 (one
    k-step, a 24-element row pitch) and 256 (32-key tiles, Q fragments read
    from shared memory each tile), long ragged rows (LONG) with NaN past
    kv_len and outside the table; its tiling is D2's."""
    T, S, q_start, kv_len = _lens(cuda, LONG)
    K = 2
    q = torch.randn(4, T, K * G, D, device=cuda, dtype=torch.float16)
    c = _float_cache(cuda, torch.float16, mode, 2, 4, S, K, D)
    clean, kw = _poisoned(c, mode, kv_len)
    planes = _planes if c.k_scale is not None else (lambda x: {})
    got = attention.attention(q, c.k, c.v, q_start, kv_len, layer=1,
                              window=window, kernels="cuda", **kw,
                              **planes(c))
    want = attention.attention(q, clean.k, clean.v, q_start, kv_len, layer=1,
                               window=window, kernels="torch", **kw,
                               **planes(clean))
    torch.cuda.synchronize()
    _held_float(got, want, torch.float16)
    plan = attention.prefill_plan(D, int8=c.k_scale is not None,
                                  dtype=torch.float16)
    assert plan["tile_keys"] == (32 if D > 128 else 64)


def test_float_kernels_refuse_instead_of_falling_back(cuda):
    """No instance, no fallback: a float64 q on the fused paged decode
    (which has float16 and float32 instances now) or on the prefill, a
    float16 q against a float32 pool, a head_dim outside FLOAT_HEAD_DIMS,
    a float cache of another dtype than q's."""
    from llm_inference_engine_tpu_torch.ops import _native
    c = _float_cache(cuda, torch.float32, "paged", 1, 2, 32, 2, 64)
    q = torch.randn(2, 1, 4, 64, device=cuda, dtype=torch.float16)
    new = torch.randn(2, 1, 2, 64, device=cuda, dtype=torch.float16)
    lens = torch.ones(2, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError, match="need torch.float16 q"):
        attention.attention_decode_paged_fused(
            q, new, new, c.k, c.v, lens - 1, lens, 0, table=c.block_table)
    with pytest.raises(TypeError, match="no torch.float64 instance"):
        attention.attention_decode_paged_fused(
            q.double(), new.double(), new.double(), c.k.double(),
            c.v.double(), lens - 1, lens, 0, table=c.block_table)
    q48 = torch.randn(2, 1, 4, 48, device=cuda, dtype=torch.float32)
    c48 = torch.randn(1, 2, 32, 2, 48, device=cuda, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match=re.escape(
            str(_native.FLOAT_HEAD_DIMS))):
        attention.attention(q48, c48, c48, lens - 1, lens, layer=0)
    with pytest.raises(TypeError, match="no torch.float64 instance"):
        attention.attention(q48.double(), c48.double(), c48.double(),
                            lens - 1, lens, layer=0)
    c32 = torch.randn(1, 2, 32, 2, 64, device=cuda, dtype=torch.float32)
    with pytest.raises(TypeError, match="need torch.float16 q"):
        attention.attention(q, c32, c32, lens - 1, lens, layer=0)


# The model families beside Llama-2 (config.py's presets): the kernels at
# the shapes llama3.1-8b, mistral-7b and qwen2-7b give them. E's (k, n,
# halves) per family, the rows of a decode step (B 4 / 8) and of a prefill
# chunk's tail (4 x 64, 8 x 64)
FAMILY_PROJECTIONS = {
    "llama3 wqkv": (4096, 6144, 1), "llama3 wo": (4096, 4096, 1),
    "llama3 gate_up": (4096, 14336, 2), "llama3 down": (14336, 4096, 1),
    "llama3 lm_head": (4096, 128256, 1), "mistral lm_head": (4096, 32000, 1),
    "qwen2 wqkv": (3584, 4608, 1), "qwen2 wo": (3584, 3584, 1),
    "qwen2 gate_up": (3584, 18944, 2), "qwen2 down": (18944, 3584, 1),
    "qwen2 lm_head": (3584, 152064, 1)}


@pytest.mark.parametrize("m", [4, 8, 256, 512])
@pytest.mark.parametrize("proj", list(FAMILY_PROJECTIONS))
def test_int4_matmul_at_family_shapes(cuda, proj, m):
    """E (INT4, group 128) at each family's projections, every input at
    the head of a buffer whose tail is NaN: the decode mode's cluster split
    at k 3584, 14336 and 18944 and the prefill mode's tiles at n 4608,
    28672, 37888 and the wide vocabularies."""
    k, n, halves = FAMILY_PROJECTIONS[proj]
    t = _qweight(cuda, "int4", k, n, halves)
    t = _poisoned_weight(t, _tail_poisoned)
    x = _tail_poisoned(torch.randn(m, k, device=cuda, dtype=torch.bfloat16))
    if proj.endswith("lm_head"):
        got = _held_against_plain(t, x, torch.float32, atol=1e-3, rtol=1e-4)
    else:
        got = _held_against_plain(t, x, torch.bfloat16)
    assert got.shape == (m, n * halves) and torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=str)
@pytest.mark.parametrize("n", [1, 8, 2048])
def test_norm_act_at_family_widths(cuda, n, dtype):
    """A at Qwen2's hidden 3584 (both modes; the residual sum bit for bit)
    and B at intermediate 14336 and 18944."""
    x = torch.randn(n, 3584, device=cuda, dtype=dtype)
    r = torch.randn(n, 3584, device=cuda, dtype=dtype)
    w = torch.rand(3584, device=cuda, dtype=dtype) + 0.5
    torch.testing.assert_close(rmsnorm.rmsnorm(x, w, kernels="cuda"),
                               rmsnorm.rmsnorm_torch(x, w), **TOL)
    y, hh = rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda")
    y0, h0 = rmsnorm.add_residual_rmsnorm_torch(x, r, w)
    assert torch.equal(hh, h0)
    torch.testing.assert_close(y, y0, **TOL)
    for inter in (14336, 18944):
        gu = torch.randn(n, 2 * inter, device=cuda, dtype=dtype)
        torch.testing.assert_close(
            activations.silu_and_mul(gu, kernels="cuda"),
            activations.silu_and_mul_torch(gu), **TOL)


def _rope_bias_held(dev, n, K, G, D, dtype, shift=0):
    """J's bias mode on poisoned copies of its inputs against the plain
    add then the plain J (``qkv + bias``): q, k, v bit for bit, one
    launch."""
    qkv, cos, sin = _rope_inputs(dev, n, K, G, D, dtype)
    bias = torch.randn(qkv.shape[-1], device=dev, dtype=dtype)
    before = rope.split_qkv_rope_fused.launches
    got = rope.split_qkv_rope_fused(
        _nan_tail(qkv, shift=shift), _nan_tail(cos), _nan_tail(sin), K * G,
        K, D, bias=_nan_tail(bias, shift=shift))
    want = rope.split_qkv_rope_fused_torch(qkv + bias, cos, sin, K * G, K,
                                           D)
    torch.cuda.synchronize()
    assert rope.split_qkv_rope_fused.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=str)
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("K,G", [(8, 1), (8, 4), (4, 7), (4, 8)])
def test_split_qkv_rope_kernel_bias_bit_for_bit(cuda, dtype, D, K, G):
    """J's bias mode (Qwen2's packed qkv bias) is bit for bit the add
    (rounded once to the dtype, as torch rounds ``qkv + bqkv``) then J, at
    G 1, 4, 7 and 8, and without a bias J at the families' 32 / 8 and
    28 / 4 heads."""
    for n in (1, 7, 8, 40, 4096):
        _rope_bias_held(cuda, n, K, G, D, dtype)
        _rope_held(*_rope_inputs(cuda, n, K, G, D, dtype), K, G, D)
    # one value a load: a qkv and a bias one element off 16 bytes
    _rope_bias_held(cuda, 9, K, G, D, dtype, shift=1)


# D and D2 at the families' groups with Mistral's window of 4096, at
# contexts past it (4000-6150 of a cache of 8192): kv_len per sequence
WINDOW = 4096
WIDE_LENS = [4000, 4097, 5200, 6150]


@pytest.mark.parametrize("mode", ["fused", "paged-fused"])
@pytest.mark.parametrize("H,K", [(32, 8), (28, 4)])
def test_decode_at_family_groups_with_window(cuda, mode, H, K):
    """D's fused decode (slot) and fused paged decode (pages of 64, a
    shuffled table) at G 4 and 7 under a window of 4096: every row at or
    past kv_len and every pool row outside the table is NaN; the write is
    bit for bit the plain write, the output within the tolerance of the
    plain version on a clean copy, and the paged output bit for bit the
    slot output on the same rows."""
    D, S, page = 128, 8192, 64
    B = len(WIDE_LENS)
    kv_len = torch.tensor(WIDE_LENS, device=cuda, dtype=torch.int32)
    q_start = kv_len - 1
    k = torch.randn(2, B, S, K, D, device=cuda, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    q = torch.randn(B, 1, H, D, device=cuda, dtype=torch.bfloat16)
    kn = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    slot = kvc.KVCache(k.clone(), v.clone(), kv_len)
    _poison_slot(slot, q_start)
    want, _, _ = attention.attention_decode_fused_torch(
        q, kn, vn, k.clone(), v.clone(), q_start, kv_len, 1, window=WINDOW)
    got_slot = attention.attention_decode_fused(
        q, kn, vn, slot.k, slot.v, q_start, kv_len, 1, window=WINDOW,
        kernels="cuda")[0]
    if mode == "fused":
        got = got_slot
        torch.cuda.synchronize()
        for b, n in enumerate(WIDE_LENS):
            assert torch.equal(slot.k[1, b, n - 1], kn[b, 0].to(k.dtype))
            assert torch.equal(slot.v[1, b, n - 1], vn[b, 0].to(k.dtype))
    else:
        from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
        maxp = S // page
        P = 1 + B * maxp + 3
        table = (torch.randperm(P - 1, device=cuda)[:B * maxp] + 1).to(
            torch.int32).reshape(B, maxp).contiguous()
        kp = torch.randn(2, P, page, K, D, device=cuda, dtype=torch.bfloat16)
        vp = torch.randn_like(kp)
        kp[1][table.long()] = k[1].view(B, maxp, page, K, D)
        vp[1][table.long()] = v[1].view(B, maxp, page, K, D)
        pool = pkv.PagedKVCache(kp, vp, table, kv_len)
        _poison_pool(pool, q_start, page)
        before = attention.attention_decode_paged_fused.launches
        got = attention.attention_decode_paged_fused(
            q, kn, vn, pool.k, pool.v, q_start, kv_len, 1,
            table=pool.block_table, window=WINDOW, kernels="cuda")[0]
        torch.cuda.synchronize()
        assert attention.attention_decode_paged_fused.launches == before + 1
        assert torch.equal(got, got_slot)
        for b, n in enumerate(WIDE_LENS):
            p = pool.block_table[b, (n - 1) // page].long()
            assert torch.equal(pool.k[1, p, (n - 1) % page],
                               kn[b, 0].to(k.dtype))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("mode", ["slot", "paged"])
@pytest.mark.parametrize("H,K", [(32, 8), (28, 4)])
def test_prefill_at_family_groups_with_window(cuda, mode, H, K):
    """D2 at G 4 and 7 under a window of 4096: a 4 x 512 chunk at
    histories 3584-5632 of a cache of 8192 (kv_len to 6144), the window
    cutting every row's keys; NaN at or past kv_len and outside the
    table (pages of 64), held against the plain version on a clean
    copy."""
    D, S, T, page = 128, 8192, 512, 64
    q_start = torch.tensor([3584, 4096, 5120, 5632], device=cuda,
                           dtype=torch.int32)
    kv_len = q_start + torch.tensor([512, 512, 300, 512], device=cuda,
                                    dtype=torch.int32)
    B = 4
    q = torch.randn(B, T, H, D, device=cuda, dtype=torch.bfloat16)
    if mode == "slot":
        c = kvc.KVCache(*(torch.randn(2, B, S, K, D, device=cuda,
                                      dtype=torch.bfloat16)
                          for _ in "kv"), kv_len)
    else:
        c = _paged_pool(cuda, 2, B, S // page, page, K, D)
    clean, kw = _poisoned(c, mode, kv_len, page)
    got = attention.attention(q, c.k, c.v, q_start, kv_len, layer=1,
                              window=WINDOW, kernels="cuda", **kw)
    want = attention.attention(q, clean.k, clean.v, q_start, kv_len,
                               layer=1, window=WINDOW, kernels="torch", **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


# Llama-2-13B (config.py's llama2-13b: hidden 5120, 40 heads of 128, no
# GQA, intermediate 13824): E at its projections, A / B at its widths, J
# at K 40, D and D2 over 40 heads
LLAMA_13B_PROJECTIONS = {
    "wqkv": (5120, 15360, 1), "wo": (5120, 5120, 1),
    "gate_up": (5120, 13824, 2), "down": (13824, 5120, 1),
    "lm_head": (5120, 32000, 1)}


@pytest.mark.parametrize("m", [8, 512])
@pytest.mark.parametrize("proj", list(LLAMA_13B_PROJECTIONS))
def test_int4_matmul_at_13b_shapes(cuda, proj, m):
    """E (INT4, group 128) at 13B's projections, the decode step's m 8 and
    the prefill tail's m 512, every input at the head of a buffer whose
    tail is NaN; the library's plan equals its mirror."""
    k, n, halves = LLAMA_13B_PROJECTIONS[proj]
    t = _qweight(cuda, "int4", k, n, halves)
    t = _poisoned_weight(t, _tail_poisoned)
    x = _tail_poisoned(torch.randn(m, k, device=cuda, dtype=torch.bfloat16))
    if proj == "lm_head":
        got = _held_against_plain(t, x, torch.float32, atol=1e-3, rtol=1e-4)
    else:
        got = _held_against_plain(t, x, torch.bfloat16)
    assert got.shape == (m, n * halves) and torch.isfinite(got).all()
    plan = quant.quant_matmul_plan_native(m, k, n, halves)
    assert plan.pop("blocks_per_sm") >= 1
    assert plan == quant.quant_matmul_plan(m, k, n, halves), proj


@pytest.mark.parametrize("n", [1, 8, 2048])
def test_norm_act_at_13b_widths(cuda, n):
    """A at hidden 5120 (both modes; the residual sum bit for bit) and B
    at intermediate 13824, NaN past the tails."""
    bf16 = torch.bfloat16
    x, r = (torch.randn(n, 5120, device=cuda, dtype=bf16) for _ in "xr")
    w = torch.rand(5120, device=cuda, dtype=bf16) + 0.5
    torch.testing.assert_close(
        rmsnorm.rmsnorm(_tail_poisoned(x), _tail_poisoned(w),
                        kernels="cuda"), rmsnorm.rmsnorm_torch(x, w), **TOL)
    y, hh = rmsnorm.add_residual_rmsnorm(_tail_poisoned(x),
                                         _tail_poisoned(r), w,
                                         kernels="cuda")
    y0, h0 = rmsnorm.add_residual_rmsnorm_torch(x, r, w)
    assert torch.equal(hh, h0)
    torch.testing.assert_close(y, y0, **TOL)
    gu = torch.randn(n, 2 * 13824, device=cuda, dtype=bf16)
    torch.testing.assert_close(
        activations.silu_and_mul(_tail_poisoned(gu), kernels="cuda"),
        activations.silu_and_mul_torch(gu), **TOL)


@pytest.mark.parametrize("n", [1, 8, 2048])
def test_split_qkv_rope_at_13b_heads(cuda, n):
    """J at 40 heads over 40 kv heads (G 1), bit for bit, NaN past the
    tails."""
    _rope_held(*_rope_inputs(cuda, n, 40, 1, 128, torch.bfloat16), 40, 1,
               128)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_attention_at_13b_heads(cuda, mode):
    """D2 (a 4 x 512 chunk at 4a's prompts) and D's fused decode (B 8 at
    4b's contexts) over 40 heads, every cache row at or past kv_len NaN,
    held against the plain version on a clean copy; D's write bit for
    bit."""
    H = K = 40
    D, S, L = 128, 2048, 2
    if mode == "prefill":
        B, T = 4, 512
        q_start = torch.zeros(B, device=cuda, dtype=torch.int32)
        kv_len = torch.tensor([7, 129, 384, 512], device=cuda,
                              dtype=torch.int32)
    else:
        B, T = 8, 1
        q_start = torch.tensor([40, 65, 163, 249, 354, 500, 540, 632],
                               device=cuda, dtype=torch.int32)
        kv_len = q_start + 1
    k = torch.randn(L, B, S, K, D, device=cuda, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    clean = kvc.KVCache(k.clone(), v.clone(), kv_len)
    c = kvc.KVCache(k, v, kv_len)
    _poison_slot(c, kv_len if mode == "prefill" else q_start)
    q = torch.randn(B, T, H, D, device=cuda, dtype=torch.bfloat16)
    if mode == "prefill":
        got = attention.attention(q, c.k, c.v, q_start, kv_len, layer=1,
                                  kernels="cuda")
        want = attention.attention_torch(q, clean.k, clean.v, q_start,
                                         kv_len, layer=1)
    else:
        kn = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
        vn = torch.randn_like(kn)
        got = attention.attention_decode_fused(
            q, kn, vn, c.k, c.v, q_start, kv_len, 1, kernels="cuda")[0]
        want = attention.attention_decode_fused_torch(
            q, kn, vn, clean.k, clean.v, q_start, kv_len, 1)[0]
        rows = (torch.arange(B, device=cuda), q_start.long())
        assert torch.equal(c.k[1][rows], clean.k[1][rows])
        assert torch.equal(c.v[1][rows], clean.v[1][rows])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


# Mistral-7B with INT8 weights over an int8 slot cache: F at its decode
# step's m 4, G8 and its epilogue at its first chunk's 2048 rows, I at K
# 8, D2's and D's int8 modes under its window of 4096 (and D's at Qwen2's
# G 7 without one); every scale at or past kv_len and left of each row's
# window NaN
MISTRAL_INT8_PROJECTIONS = {
    "wqkv": (4096, 6144, 1), "wo": (4096, 4096, 1),
    "gate_up": (4096, 14336, 2), "down": (14336, 4096, 1),
    "lm_head": (4096, 32000, 1)}


@pytest.mark.parametrize("proj", list(MISTRAL_INT8_PROJECTIONS))
def test_int8_matmul_at_mistral_decode_step(cuda, proj):
    k, n, halves = MISTRAL_INT8_PROJECTIONS[proj]
    t = _qweight(cuda, "int8", k, n, halves)
    t = _poisoned_weight(t, _tail_poisoned)
    x = _tail_poisoned(torch.randn(4, k, device=cuda, dtype=torch.bfloat16))
    out = torch.float32 if proj == "lm_head" else torch.bfloat16
    got = _held_against_plain(t, x, out, **(
        dict(atol=1e-3, rtol=1e-4) if proj == "lm_head" else TOL))
    assert got.shape == (4, n * halves) and torch.isfinite(got).all()
    plan = quant.quant_matmul_plan_native(4, k, n, halves, int4=False)
    assert plan.pop("blocks_per_sm") >= 1
    assert plan == quant.quant_matmul_plan(4, k, n, halves, int4=False)


@pytest.mark.parametrize("proj", ["wqkv", "wo", "gate_up", "down"])
def test_g8_and_epilogue_at_mistral_chunk(cuda, proj):
    """G8 bit for bit ``.to(bfloat16)`` + ``_cat`` (127 past q's tail), its
    epilogue on the 2048-row product bit for bit ``(y * scale).to``."""
    k, n, halves = MISTRAL_INT8_PROJECTIONS[proj]
    t = _qweight(cuda, "int8", k, n, halves)
    got = quant.dequant_int8(_tail_poisoned(t.q), kernels="cuda")
    assert torch.equal(got, quant.dequant_int8_torch(t.q))
    y = torch.randn(2048, halves * n, device=cuda) * 40.0
    scale = torch.rand(1, halves * n, device=cuda) * 1e-2 + 1e-4
    out = quant.int8_scale_cast(_tail_poisoned(y), _tail_poisoned(scale),
                                torch.bfloat16, kernels="cuda")
    torch.cuda.synchronize()
    assert torch.equal(out, quant.int8_scale_cast_torch(y, scale,
                                                        torch.bfloat16))


MISTRAL_CHUNK = ([3584, 4096, 5120, 5632], [512, 512, 300, 512])


def _poison_scales_outside(c, lo, hi):
    """NaN scales of layer 1 below ``lo[b]`` (left of every row's window)
    and from ``hi[b]`` (past kv_len)."""
    for b, (a, z) in enumerate(zip(lo, hi)):
        for t in (c.k_scale, c.v_scale):
            t[1, b, :max(a, 0)] = float("nan")
            t[1, b, z:] = float("nan")


def test_int8_write_and_prefill_at_mistral_window(cuda):
    """I writes a 4 x 512 chunk at histories 3584-5632 of 8192 (K 8,
    snapped) bit for bit the plain write, NaN past the new rows' tails;
    then D2's int8 mode attends it under the window (kv_len to 6144),
    scales NaN outside what any row sees, against the plain version on a
    clean copy."""
    H, K, D, S, T, W = 32, 8, 128, 8192, 512, WINDOW
    starts_l, new_len_l = MISTRAL_CHUNK
    starts = torch.tensor(starts_l, device=cuda, dtype=torch.int32)
    new_len = torch.tensor(new_len_l, device=cuda, dtype=torch.int32)
    c = _int8_slot(cuda, 2, 4, S, K, D, True)
    ref = dataclasses.replace(c, **{n: getattr(c, n).clone() for n in
                                    ("k", "v", "k_scale", "v_scale")})
    kn = torch.randn(4, T, K, D, device=cuda, dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    n0 = kvc.kv_write_quant.launches
    kvc.update_cache_at_layer(c, 1, _tail_poisoned(kn), _tail_poisoned(vn),
                              starts, new_len, kernels="cuda")
    kvc.update_cache_at_layer_torch(ref, 1, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    assert kvc.kv_write_quant.launches == n0 + 1
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(c, name), getattr(ref, name)), name
    kv_len_l = [s + n for s, n in zip(starts_l, new_len_l)]
    kv_len = torch.tensor(kv_len_l, device=cuda, dtype=torch.int32)
    _poison_scales_outside(c, [s - W + 1 for s in starts_l], kv_len_l)
    q = torch.randn(4, T, H, D, device=cuda, dtype=torch.bfloat16)
    n0 = attention.attention_int8.launches
    got = attention.attention(q, c.k, c.v, starts, kv_len, layer=1,
                              window=W, kernels="cuda", **_planes(c))
    want = attention.attention_torch(q, ref.k, ref.v, starts, kv_len,
                                     layer=1, window=W, **_planes(ref))
    torch.cuda.synchronize()
    assert attention.attention_int8.launches == n0 + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("H,K,window,hist", [
    (32, 8, WINDOW, [3600, 4095, 5200, 6150]),
    (28, 4, None, [40, 65, 163, 249, 354, 500, 540, 632])])
def test_fused_int8_decode_at_family_groups(cuda, H, K, window, hist):
    """D's fused int8 decode (snapped) at Mistral's G 4 under its window
    and at Qwen2's G 7 without one: scales NaN past kv_len and left of the
    window; the write bit for bit, the output within TOL of the plain
    version on a clean copy."""
    D = 128
    B, S = len(hist), 8192 if window else 2048
    c = _int8_slot(cuda, 2, B, S, K, D, True)
    ref = [t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale)]
    _poison_scales_outside(c, [n - window + 1 if window else 0
                               for n in hist], [n + 1 for n in hist])
    q = torch.randn(B, 1, H, D, device=cuda, dtype=torch.bfloat16)
    kn = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    q_start = torch.tensor(hist, device=cuda, dtype=torch.int32)
    kv_len = q_start + 1
    n0 = attention.attention_decode_fused_int8.launches
    got = attention.attention_decode_fused(
        q, kn, vn, c.k, c.v, q_start, kv_len, 1, window=window,
        kernels="cuda", snapped=True, **_planes(c))[0]
    want = attention.attention_decode_fused_torch(
        q, kn, vn, ref[0], ref[1], q_start, kv_len, 1, window=window,
        k_scale=ref[2], v_scale=ref[3], snapped=True)[0]
    torch.cuda.synchronize()
    assert attention.attention_decode_fused_int8.launches == n0 + 1
    rows = (torch.arange(B, device=cuda), q_start.long())
    for got_t, want_t in zip((c.k, c.v, c.k_scale, c.v_scale), ref):
        assert torch.equal(got_t[1][rows], want_t[1][rows])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


def _projections(model: str) -> dict:
    cfg = get_config(model)
    return {"wqkv": (cfg.hidden_size, cfg.qkv_size, 1),
            "wo": (cfg.q_size, cfg.hidden_size, 1),
            "gate_up": (cfg.hidden_size, cfg.intermediate_size, 2),
            "down": (cfg.intermediate_size, cfg.hidden_size, 1)}


# the INT4 prefill's m >= 1024 projections: each preset the port runs on
# the card, and Llama-2-7B's tp = 2 local shapes
LARGE_M_PROJECTIONS = {
    f"{model} {proj}": shape
    for model in ("llama2-7b", "llama3.1-8b", "mistral-7b", "qwen2-7b",
                  "llama2-13b", "tinyllama-1.1b")
    for proj, shape in _projections(model).items()}
LARGE_M_PROJECTIONS.update({f"llama2-7b tp2 {proj}": shape
                            for proj, shape in TP2_PROJECTIONS.items()
                            if proj != "lm_head"})


@pytest.mark.parametrize("proj", list(LARGE_M_PROJECTIONS))
def test_int4_large_m_route_bit_for_bit_plain(cuda, proj):
    """m >= 1024 (whole chunks and rows a chunk leaves live): the kernel
    route's bf16-output product (G, one launch a half of the gate|up
    stack, then cuBLAS rounding once) is bit for bit the plain route's f32
    product cast to bf16."""
    k, n, halves = LARGE_M_PROJECTIONS[proj]
    t = _qweight(cuda, "int4", k, n, halves)
    x = torch.randn(4096, k, device=cuda, dtype=torch.bfloat16)
    for m in (1024, 1100, 1536, 3000, 4096):
        before = quant.dequant_int4.launches
        got = quant.quantized_linear(x[:m], t)
        assert quant.dequant_int4.launches == before + halves
        want = quant.quantized_linear_torch(x[:m], t)
        assert got.dtype == want.dtype == torch.bfloat16
        assert got.shape == (m, halves * n)
        assert torch.equal(got, want), (proj, m)


# The families' rank shapes at tp = 2: Qwen2-7B's rank holds 14 query
# heads over 2 kv heads (G 7), Llama-3.1-8B's and Mistral-7B's 16 over 4;
# the rank's projections are the presets' split by columns (wqkv, gate|up,
# lm_head) or by rows (wo, down)
def _rank_projections(model: str, tp: int = 2) -> dict:
    shapes = _projections(model)
    cfg = get_config(model)
    shapes["lm_head"] = (cfg.hidden_size, cfg.vocab_size, 1)
    return {p: ((k // tp, n, h) if p in ("wo", "down") else (k, n // tp, h))
            for p, (k, n, h) in shapes.items()}


QWEN2_CONTEXTS = [40, 65, 163, 249, 354, 500, 540, 632]


def test_split_qkv_rope_kernel_bias_at_qwen2_rank(cuda):
    """J's bias mode at Qwen2-7B's rank (K 2, G 7, head_dim 128): a decode
    step's 8 rows, a 4 x 512 chunk and ragged counts, every input (the
    bias too) at the head of a buffer of NaN, bit for bit the add then J;
    and one value a load, qkv and bias one element off 16 bytes."""
    for n in (1, 7, 8, 40, 2048):
        _rope_bias_held(cuda, n, 2, 7, 128, torch.bfloat16)
    _rope_bias_held(cuda, 9, 2, 7, 128, torch.bfloat16, shift=1)


@pytest.mark.parametrize("H,K,window,hist", [
    (14, 2, None, QWEN2_CONTEXTS),
    (16, 4, WINDOW, [3600, 4095, 5200, 6150])], ids=["qwen2", "mistral"])
def test_fused_decode_at_family_rank(cuda, H, K, window, hist):
    """D's fused slot decode at a family's rank: Qwen2-7B's G 7 over 2 kv
    heads (B 8, 4b's contexts), Mistral-7B's G 4 over 4 kv heads under
    its window (B 4, contexts past 4096). Every cache row past kv_len and
    the tails of q and the new rows NaN; the write bit for bit, the
    output within TOL of the plain version on clean copies."""
    D, B = 128, len(hist)
    S = 8192 if window else 2048
    q, kc, vc = _qkv(cuda, 2, B, 1, H, K, S, D)
    kn = torch.randn(B, 1, K, D, device=cuda, dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    q_start = torch.tensor(hist, device=cuda, dtype=torch.int32)
    kv_len = q_start + 1
    c = kvc.KVCache(kc, vc, kv_len)
    ref = _clone_cache(c)
    _poison_slot(c, kv_len)
    n0 = attention.attention_decode_fused.launches
    got = attention.attention_decode_fused(
        _nan_tail(q), _nan_tail(kn), _nan_tail(vn), c.k, c.v, q_start,
        kv_len, 1, window=window, kernels="cuda")[0]
    want = attention.attention_decode_fused_torch(
        q, kn, vn, ref.k, ref.v, q_start, kv_len, 1, window=window)[0]
    torch.cuda.synchronize()
    assert attention.attention_decode_fused.launches == n0 + 1
    rows = (torch.arange(B, device=cuda), q_start.long())
    for got_t, want_t in ((c.k, ref.k), (c.v, ref.v)):
        assert torch.equal(got_t[1][rows], want_t[1][rows])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("model", ["qwen2-7b", "llama3.1-8b", "mistral-7b"])
@pytest.mark.parametrize("m", [4, 8, 512])
def test_quant_plan_at_family_rank_shapes(cuda, model, m):
    """E's plan from the built library equals its mirror
    (``quant_matmul_plan``) at every rank projection of the family at
    tp = 2, the lm_head shard included (Qwen2-7B's n 76032, Llama-3.1-8B's
    64128), and so do the decode mode's cluster K ranges."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for proj, (k, n, halves) in _rank_projections(model).items():
        native = quant.quant_matmul_plan_native(m, k, n, halves)
        assert native.pop("blocks_per_sm") >= 1
        assert native == quant.quant_matmul_plan(m, k, n, halves,
                                                 sms=sms), (proj, m)
        if native["mode"] == "decode":
            ranges = quant.cluster_k_ranges(m, k, n, halves, sms=sms)
            assert len(ranges) == native["cluster"]
            assert ranges[0][0] == 0 and ranges[-1][1] == k


@pytest.mark.parametrize("proj", ["wo", "wqkv", "down"])
def test_int4_decode_at_uneven_cluster_ranges(cuda, proj):
    """E's fragment mode (its decode rows since PR 28) at m 8 on
    Qwen2-7B's rank projections, whose K splits over the warps of a
    cluster in slices of unequal length (wo: k 1792 = 14 groups over 8
    slices of 128 and 256 rows), x, q, its fragment order and the scales
    at the head of buffers of NaN: within TOL of the plain version."""
    k, n, halves = _rank_projections("qwen2-7b")[proj]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert quant.quant_matmul_plan(8, k, n, halves, sms=sms)["mode"] == \
        "fragment"
    ranges = quant.fragment_k_slices(8, k, n, halves, sms=sms)
    assert len({hi - lo for lo, hi in ranges}) > 1, ranges
    if proj == "wo":
        assert sorted({hi - lo for lo, hi in ranges}) == [128, 256]
    t = _qweight(cuda, "int4", k, n, halves)
    t = _poisoned_weight(t, _tail_poisoned)
    x = _tail_poisoned(torch.randn(8, k, device=cuda, dtype=torch.bfloat16))
    got = _held_against_plain(t, x, torch.bfloat16)
    assert torch.isfinite(got).all()


# ---------------------------------------------------------------------------
# kernel E's fragment mode (INT4 at m <= 16, a bf16 or float16 x)
# ---------------------------------------------------------------------------

def _fragment_held(cuda, m, k, n, halves, group, dtype, out_dtype,
                   poison=_tail_poisoned):
    """One fragment-mode launch against its plain version (the fragment
    order unpacked, then kernel E's plain version), x, q, qd and the
    scales each at the head of a buffer whose tail ``poison`` fills; the
    library's plan equals its mirror."""
    t = _poisoned_weight(_qweight(cuda, "int4", k, n, halves, group), poison)
    x = poison(torch.randn(m, k, device=cuda, dtype=dtype))
    plan = quant.quant_matmul_plan_native(m, k, n, halves, group=group,
                                          dtype=dtype)
    assert plan.pop("blocks_per_sm") >= 1
    assert plan == quant.quant_matmul_plan(
        m, k, n, halves, group=group, dtype=dtype,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan["mode"] == "fragment", plan
    counter = quant.int4_matmul if dtype == torch.bfloat16 else \
        quant.int4_matmul_float
    before = counter.launches
    got = quant.int4_matmul(x, t.q, t.scale, group, out_dtype, qd=t.qd)
    want = quant.int4_matmul_decode_torch(x, t.qd, t.scale, group, out_dtype)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, halves * n)
    assert torch.isfinite(got).all()
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    elif dtype == torch.float16:
        _held_float(got, want, dtype)
    else:
        torch.testing.assert_close(got, want, **TOL)
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("m", list(range(1, 17)))
def test_int4_fragment_mode_every_m(cuda, m, dtype):
    """Every m of the fragment mode (8-row x tiles to 8, 16-row ones to
    16; rows past m feed zeros): K of 86 groups over uneven warp slices,
    a ragged n (1040: a column group of one tile), the gate|up stack,
    groups of 64, and the lm_head's f32 output."""
    for k, n, halves, group, out in ((11008, 384, 1, 128, dtype),
                                     (4096, 1040, 1, 128, dtype),
                                     (512, 1040, 2, 128, dtype),
                                     (4096, 4096, 1, 64, dtype),
                                     (4096, 32000, 1, 128, torch.float32)):
        _fragment_held(cuda, m, k, n, halves, group, dtype, out)


def _fragment_shapes() -> dict:
    """Every INT4 projection of the models that run INT4 on the card, one
    rank of tp 1 and 2: llama2-7b (4b, 4n), the families (4u, 4w d),
    llama2-13b (4v) and tinyllama-1.1b (4l, 4q), shapes shared listed
    once."""
    out, seen = {}, set()
    for model in ("llama2-7b", "llama3.1-8b", "mistral-7b", "qwen2-7b",
                  "llama2-13b", "tinyllama-1.1b"):
        for tp in (1, 2):
            for proj, shape in _rank_projections(model, tp).items():
                if shape not in seen:
                    seen.add(shape)
                    out[f"{model} tp{tp} {proj}"] = (proj, shape)
    return out


FRAGMENT_SHAPES = _fragment_shapes()


@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("case", list(FRAGMENT_SHAPES))
def test_int4_fragment_mode_at_model_shapes(cuda, case, m):
    """The decode step's m (Mistral's 4, the B 8 paths, the server's 16)
    at every listed shape, bf16 x (f32 out on the lm_head), every input
    NaN- (127-) tailed; llama2-7b's in float16 too (4t's f16 INT4 path)."""
    proj, (k, n, halves) = FRAGMENT_SHAPES[case]
    out = torch.float32 if proj == "lm_head" else torch.bfloat16
    _fragment_held(cuda, m, k, n, halves, 128, torch.bfloat16, out)
    if case.startswith("llama2-7b tp1"):
        _fragment_held(cuda, m, k, n, halves, 128, torch.float16,
                       torch.float32 if proj == "lm_head" else torch.float16,
                       poison=_nan_tailed)


def test_int4_fragment_mode_refuses_without_its_layout(cuda):
    """On the card an INT4 call at m <= 16 without the fragment order
    raises, naming the function that builds it; nothing falls back to the
    plain version or to another mode. m 17, a float32 x and the plain
    route run without it."""
    t = _qweight(cuda, "int4", 4096, 4096)
    bare = quant.QuantizedTensor(t.q, t.scale, "int4", 128)
    before = quant.int4_matmul.launches
    for m in (1, 8, 16):
        x = torch.randn(m, 4096, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="add_decode_layout"):
            quant.quantized_linear(x, bare)
        with pytest.raises(ValueError, match="add_decode_layout"):
            quant.int4_matmul_float(x.half(), t.q, t.scale, 128,
                                    torch.float16)
        torch.testing.assert_close(
            quant.quantized_linear(x, bare, kernels="torch"),
            quant.quantized_linear(x, t), **TOL)
    assert quant.int4_matmul.launches == before + 3
    quant.quantized_linear(torch.randn(17, 4096, device=cuda,
                                       dtype=torch.bfloat16), bare)
    quant.quantized_linear(torch.randn(8, 4096, device=cuda), bare)


def _int4_leaves(tree) -> list:
    if isinstance(tree, quant.QuantizedTensor):
        return [tree] if tree.mode == "int4" else []
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _int4_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _int4_leaves(v)]
    return []


def test_engines_build_the_fragment_order(cuda):
    """Every path that runs INT4 on the card holds each weight's fragment
    order (q's bytes, permuted) before its first forward: a slot engine,
    a tp = 2 mesh engine (each rank's shard), a beam search and pipeline
    stages over fresh weights, a float16 model; a float32 model and
    kernels="torch" build none. The slot engine's greedy ids equal the
    plain route's."""
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_quantized_params)
    from llm_inference_engine_tpu_torch.parallel import pipeline
    from llm_inference_engine_tpu_torch.parallel.mesh import make_mesh
    from llm_inference_engine_tpu_torch.runtime.beam_search import BeamSearch
    cfg = get_config("debug").replace(
        hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
        head_dim=64, dtype_name="bfloat16")
    eng = EngineConfig(max_batch_size=2, max_seq_len=64, quant_mode="int4",
                       quant_group_size=64)

    def fresh(c=cfg):
        return init_dummy_quantized_params(c, "int4", 64, seed=0,
                                           device=cuda)

    def built(tree):
        leaves = _int4_leaves(tree)
        assert leaves
        return all(t.qd is not None and t.qd.shape == t.q.shape
                   and torch.equal(quant.unpack_int4_decode(t.qd), t.q)
                   for t in leaves)

    params = fresh()
    engine = InferenceEngine(cfg, eng, params, device=cuda)
    assert built(engine.params)
    plain = InferenceEngine(cfg, eng.replace(kernels="torch"), fresh(),
                            device=cuda)
    assert not any(t.qd is not None for t in _int4_leaves(plain.params))
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    prompts = [[1, 2, 3], [7] * 9]
    assert engine.generate(prompts, sp, eos_token_id=None).token_ids == \
        plain.generate(prompts, sp, eos_token_id=None).token_ids
    mesh = InferenceEngine(cfg, eng, fresh(), mesh=make_mesh(
        1, 2, devices=[cuda] * 2))
    assert built(mesh.params.grid)
    beams = BeamSearch(cfg, eng, fresh(), num_beams=2)
    assert built(beams.params)
    stages = pipeline.shard_params_pp(fresh(), pipeline.make_pp_mesh(
        2, devices=[cuda] * 2))
    assert built([s.grid for s in stages])
    f16 = cfg.replace(dtype_name="float16")
    assert built(InferenceEngine(f16, eng, fresh(f16), device=cuda).params)
    f32 = cfg.replace(dtype_name="float32")
    assert not any(t.qd is not None for t in _int4_leaves(
        InferenceEngine(f32, eng, fresh(f32), device=cuda).params))

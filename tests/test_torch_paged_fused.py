"""The fused paged decode (kernel D writing the token's K/V through the
block table, then attending), on the CPU.

The fused decode's plain route is held against the JAX package's two
steps, ``paged_update_at_layer`` then the paged ``attention`` at T = 1,
both as Pallas kernels in interpret mode (``kernels="pallas"``; conftest
sets interpret mode), at the ``debug`` preset's widths (H 4, K 2, D 16,
pages of 16, L 2), inputs from a numpy seed, in float32, float16 and
bfloat16. The engine cases hold the bf16, float16 and float32 paged
engines, whose decode steps take the fused route, against the port's
slot engine of the same dtype, and show that no paged write runs in a
pure decode step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.ops import attention as j_attn
from llm_inference_engine_tpu.ops import paged_kv as j_pkv

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models.weights import init_dummy_params
from llm_inference_engine_tpu_torch.ops import attention
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

_DEBUG = get_config("debug")
L, PAGE = _DEBUG.num_layers, 16
H, K, D = _DEBUG.num_heads, _DEBUG.num_kv_heads, _DEBUG.head_dim
MAXP = 4
# tolerances of the paged attention tests against the JAX kernels
# (f32: the sums' order; f16: the JAX kernel rounds p to f16 and its
# output once, 2^-11 relative, the port's plain route only the output;
# bf16: 2^-8)
F32 = dict(atol=1e-5, rtol=1e-5)
F16 = dict(atol=2e-3, rtol=2e-3)
BF16 = dict(atol=2e-2, rtol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "float16": (jnp.float16, torch.float16, F16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}

# one decode token a sequence: q_start at in-page offset 0 (the first
# token of a page), at offset page - 1, an inactive row (kv_len ==
# q_start), the first token of a sequence (q_start 0), and a row whose
# table entry at q_start's page is -1 (NEG_ROW: its write is skipped)
Q_START = [PAGE, 2 * PAGE - 1, 40, 0, PAGE + 5]
ACTIVE = [1, 1, 0, 1, 1]
NEG_ROW = 4


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("window", [None, 20])
def test_fused_paged_decode_matches_jax_write_then_decode(rng, dtype,
                                                         window):
    """Two decode steps at each layer: the pool equals the JAX pool bit
    for bit on every page but the scratch page 0, which the port never
    writes (a JAX DMA through a -1 entry is clamped into the pool); the
    outputs agree within the paged attention tests' tolerances on every
    row whose keys lie in the table (NEG_ROW's newest key sits on page
    -1)."""
    jd, td, tol = DTYPES[dtype]
    B = len(Q_START)
    P = 1 + B * MAXP
    table = rng.permutation(np.arange(1, P)).reshape(B, MAXP).astype(
        np.int32)
    table[NEG_ROW, Q_START[NEG_ROW] // PAGE] = -1
    base = rng.normal(size=(L, P, PAGE, K, D)).astype(np.float32)
    jk, jv = jnp.asarray(base, jd), jnp.asarray(-base, jd)
    tk = torch.from_numpy(base.copy()).to(td)
    tv = torch.from_numpy(-base).to(td)
    ttable = torch.from_numpy(table.copy())
    q_start = np.array(Q_START, np.int32)
    for step in range(2):
        qs = q_start + step
        kv_len = qs + np.array(ACTIVE, np.int32)
        for layer in (1, 0):
            q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
            kn = rng.normal(size=(B, 1, K, D)).astype(np.float32)
            vn = rng.normal(size=(B, 1, K, D)).astype(np.float32)
            jcache = j_pkv.paged_update_at_layer(
                j_pkv.PagedKVCache(k=jk, v=jv,
                                   block_table=jnp.asarray(table),
                                   lengths=jnp.zeros((B,), jnp.int32)),
                jnp.int32(layer), jnp.asarray(kn, jd), jnp.asarray(vn, jd),
                jnp.asarray(qs), jnp.asarray(kv_len - qs), kernels="pallas")
            jk, jv = jcache.k, jcache.v
            want = j_attn.attention(
                jnp.asarray(q, jd), jk, jv, jnp.asarray(qs),
                jnp.asarray(kv_len), kernels="pallas", block_q=16,
                block_kv=16, layer=jnp.int32(layer),
                table=jnp.asarray(table), window=window)
            got, k_out, v_out = attention.attention_decode_paged_fused(
                torch.from_numpy(q).to(td), torch.from_numpy(kn).to(td),
                torch.from_numpy(vn).to(td), tk, tv, torch.from_numpy(qs),
                torch.from_numpy(kv_len), layer, table=ttable,
                window=window)
            assert k_out is tk and v_out is tv                # in place
            assert got.dtype == td and got.shape == (B, 1, H, D)
            rows = [b for b in range(B) if b != NEG_ROW]
            np.testing.assert_allclose(_as_np(got)[rows],
                                       _as_np(want)[rows], **tol)
    start = _as_np(torch.from_numpy(base).to(td))
    for got, want, sign in ((tk, jk, 1), (tv, jv, -1)):
        got, want = _as_np(got), _as_np(want)
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
        np.testing.assert_array_equal(got[:, 0], sign * start[:, 0])
    # the skipped rows: NEG_ROW's and the inactive row's positions
    for b in (NEG_ROW, 2):
        for step in range(2):
            pos = Q_START[b] + step
            page = table[b, pos // PAGE]
            if page > 0:
                np.testing.assert_array_equal(
                    _as_np(tk)[:, page, pos % PAGE],
                    start[:, page, pos % PAGE])


@pytest.mark.parametrize("window", [None, 20])
def test_fused_paged_decode_equals_write_then_attend(rng, window):
    """The plain route is bit for bit the port's two plain steps: kernel
    H's plain write with new_len = kv_len - q_start, then the paged
    attention (the JAX package's order)."""
    B = len(Q_START)
    P = 1 + B * MAXP
    table = torch.from_numpy(rng.permutation(np.arange(1, P)).reshape(
        B, MAXP).astype(np.int32))
    base = torch.from_numpy(rng.normal(size=(L, P, PAGE, K, D)).astype(
        np.float32)).to(torch.bfloat16)
    fused = pkv.PagedKVCache(base.clone(), -base, table,
                             torch.zeros(B, dtype=torch.int32))
    split = pkv.PagedKVCache(base.clone(), -base, table, fused.lengths)
    q_start = torch.tensor(Q_START, dtype=torch.int32)
    kv_len = q_start + torch.tensor(ACTIVE, dtype=torch.int32)
    q, kn, vn = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        torch.bfloat16) for s in ((B, 1, H, D), (B, 1, K, D), (B, 1, K, D)))
    got, _, _ = attention.attention_decode_paged_fused(
        q, kn, vn, fused.k, fused.v, q_start, kv_len, 1, table=table,
        window=window)
    pkv.paged_update_at_layer(split, 1, kn, vn, q_start, kv_len - q_start)
    want = attention.attention_decode(q, split.k, split.v, q_start, kv_len,
                                      1, table=table, window=window)
    assert torch.equal(fused.k, split.k) and torch.equal(fused.v, split.v)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("window", [None, 20])
def test_fused_int8_paged_decode_equals_write_then_attend(rng, dtype,
                                                          window):
    """Over an int8 pool the plain route is bit for bit the port's two
    plain steps: kernel H's int8 write (snapped scales; If's numerics for
    float rows) with new_len = kv_len - q_start, then the int8 paged
    attention; rows whose entry is -1 or that are inactive write nothing,
    values or scales."""
    td = DTYPES[dtype][1]
    B = len(Q_START)
    P = 1 + B * MAXP
    table = rng.permutation(np.arange(1, P)).reshape(B, MAXP).astype(
        np.int32)
    table[NEG_ROW, Q_START[NEG_ROW] // PAGE] = -1
    table = torch.from_numpy(table)
    vals = torch.from_numpy(rng.integers(-127, 128, (L, P, PAGE, K, D),
                                         dtype=np.int8))
    sc = torch.from_numpy(rng.uniform(0.01, 0.1, (L, P, PAGE, K)).astype(
        np.float32))
    lens = torch.zeros(B, dtype=torch.int32)
    fused = pkv.PagedKVCache(vals.clone(), -vals, table, lens, sc.clone(),
                             2 * sc)
    split = pkv.PagedKVCache(vals.clone(), -vals, table, lens, sc.clone(),
                             2 * sc)
    q_start = torch.tensor(Q_START, dtype=torch.int32)
    kv_len = q_start + torch.tensor(ACTIVE, dtype=torch.int32)
    q, kn, vn = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        td) for s in ((B, 1, H, D), (B, 1, K, D), (B, 1, K, D)))
    got, k_out, _ = attention.attention_decode_paged_fused(
        q, kn, vn, fused.k, fused.v, q_start, kv_len, 1, table=table,
        window=window, k_scale=fused.k_scale, v_scale=fused.v_scale)
    assert k_out is fused.k and got.dtype == td
    pkv.paged_update_at_layer(split, 1, kn, vn, q_start, kv_len - q_start)
    want = attention.attention_decode(
        q, split.k, split.v, q_start, kv_len, 1, table=table, window=window,
        k_scale=split.k_scale, v_scale=split.v_scale)
    for a, b in ((fused.k, split.k), (fused.v, split.v),
                 (fused.k_scale, split.k_scale),
                 (fused.v_scale, split.v_scale)):
        assert torch.equal(a, b)
    assert not torch.equal(fused.k_scale, sc)        # the token was written
    assert torch.equal(got, want)


def test_fused_paged_decode_refuses_bad_input_on_the_kernel_route():
    c = pkv.new_paged_kv_cache(1, 2, K, 5, PAGE, D, 2, dtype=torch.bfloat16)
    q = torch.zeros((2, 1, H, D), dtype=torch.bfloat16)
    new = torch.zeros((2, 1, K, D), dtype=torch.bfloat16)
    lens = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention.attention_decode_paged_fused(
            q, new, new, c.k, c.v, lens - 1, lens, 0, table=c.block_table,
            kernels="cuda")


def test_fused_paged_decode_gate():
    """bf16, float16, float32 and int8 pools at T == 1 only: a float64
    pool has no instance, and the slot gate stays slot-only."""
    pools = {dt: pkv.new_paged_kv_cache(1, 2, K, 5, PAGE, D, 2, dtype=dt)
             for dt in (torch.bfloat16, torch.float16, torch.float32,
                        torch.float64)}
    int8 = pkv.new_paged_kv_cache(1, 2, K, 5, PAGE, D, 2, quantized=True)
    slot = kvc.new_kv_cache(1, 2, K, 32, D, dtype=torch.bfloat16)
    for pool in (pools[torch.bfloat16], pools[torch.float16],
                 pools[torch.float32], int8):
        assert attention.can_fuse_paged_decode((2, 1, H, D), pool)
        assert not attention.can_fuse_paged_decode((2, 3, H, D), pool)
        assert not attention.can_fuse_decode((2, 1, H, D), pool)
    for other in (pools[torch.float64], slot):
        assert not attention.can_fuse_paged_decode((2, 1, H, D), other)


def _counting(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_engine_decode_route(monkeypatch, int8):
    """A paged engine's prefill writes through H and its decode steps
    through the fused paged decode alone: L a step, no H. So for bf16,
    float16 and float32 models (kernel D, or Df), over a pool of the
    model's dtype or an int8 pool. Its greedy ids equal the slot engine's
    of the same dtype, or, over an int8 pool (snapped scales, where the
    CPU's slot cache quantizes absmax), those of the same pool decoding
    in the JAX package's order: H's int8 write, then the attend-only
    decode."""
    from llm_inference_engine_tpu_torch.models import llama
    for dtype in ("bfloat16", "float16", "float32"):
        cfg = _DEBUG.replace(dtype_name=dtype)
        params = init_dummy_params(cfg, seed=0)
        eng = EngineConfig(max_batch_size=2, max_seq_len=64,
                           max_prefill_len=8, kv_layout="paged",
                           page_size=PAGE,
                           kv_cache_dtype_name="int8" if int8 else "")
        paged = InferenceEngine(cfg, eng, params)
        prompts = [list(range(1, 20)), [9, 8, 7]]
        sp = SamplingParams(greedy=True)
        counts = {}
        with monkeypatch.context() as mp:
            for name in ("attention_decode_paged_fused_torch",
                         "attention_paged_torch"):
                _counting(mp, attention, name, counts)
            _counting(mp, pkv, "paged_update_at_layer", counts)
            toks = paged.prefill(prompts).argmax(-1).to(torch.int32)
            assert counts == {"paged_update_at_layer": L * 3,
                              "attention_paged_torch": L * 3}, dtype
            counts.clear()
            active = np.ones(2, bool)
            ids = [toks.tolist()]
            for _ in range(4):
                toks = paged.decode_step(toks, active, sp)
                ids.append(toks.tolist())
        # the fused route's plain version calls the plain attention itself
        assert counts == {"attention_decode_paged_fused_torch": 4 * L,
                          "attention_paged_torch": 4 * L}, dtype
        if int8:
            with monkeypatch.context() as mp:
                mp.setattr(llama, "can_fuse_paged_decode",
                           lambda *args: False)
                split = InferenceEngine(cfg, eng, params)
                toks = split.prefill(prompts).argmax(-1).to(torch.int32)
                want = [toks.tolist()]
                for _ in range(4):
                    toks = split.decode_step(toks, active, sp)
                    want.append(toks.tolist())
            assert ids == want, dtype
            continue
        slot = InferenceEngine(cfg, eng.replace(kv_layout="slot"), params)
        toks = slot.prefill(prompts).argmax(-1).to(torch.int32)
        want = [toks.tolist()]
        for _ in range(4):
            toks = slot.decode_step(toks, active, sp)
            want.append(toks.tolist())
        assert ids == want, dtype

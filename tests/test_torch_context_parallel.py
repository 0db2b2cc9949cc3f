"""Context-parallel attention and the append-log bookkeeping of the
PyTorch port against the JAX package.

The same numpy inputs go through the JAX functions of
``llm_inference_engine_tpu/parallel/context_parallel.py`` and
``cp_cache.py`` and their ports, at 1e-5: the chunk stats (dense and
blockwise, causal, windowed and not), the online-softmax merge (an empty
chunk is its identity), ring-attention prefill and split-KV decode over a
(seq,) mesh (the JAX mesh on the conftest's virtual CPU devices, the
port's on n copies of the CPU), an int8 chunk in both of the JAX
package's scale forms (separate planes; embedded rows, read through
``kv_scales_from_numpy``), and the write plan, the llen update, the
kv_pos append and the reset of the append logs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.ops import kv_cache as j_kvc
from llm_inference_engine_tpu.parallel import context_parallel as j_cp
from llm_inference_engine_tpu.parallel import cp_cache as j_cpc
from llm_inference_engine_tpu_torch.ops.attention import attention_torch
from llm_inference_engine_tpu_torch.ops.kv_cache import kv_scales_from_numpy
from llm_inference_engine_tpu_torch.parallel import context_parallel as cp
from llm_inference_engine_tpu_torch.parallel import cp_cache as cpc

TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _both(a):
    return torch.from_numpy(np.ascontiguousarray(a)), jnp.asarray(a)


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert not np.isnan(g).any()
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol)


def _chunk(rng, B=2, Tq=5, Tk=37, K=2, G=2, D=8, pos_hi=50):
    """q, k, v, per-batch positions and scattered invalid rows."""
    q = rng.standard_normal((B, Tq, K * G, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, K, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, K, D)).astype(np.float32)
    q_pos = rng.integers(0, pos_hi, (B, Tq)).astype(np.int32)
    kv_pos = rng.integers(0, pos_hi, (B, Tk)).astype(np.int32)
    return q, k, v, q_pos, kv_pos, kv_pos % 5 != 0


@pytest.mark.parametrize("block_kv", [None, 8])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None)])
def test_chunk_stats_match_jax(rng, block_kv, causal, window):
    """Dense and blockwise (a ragged last block), causal, windowed and
    not: acc, m and l within 1e-5 of the JAX function's."""
    arrays = _chunk(rng)
    t = [_both(a)[0] for a in arrays]
    j = [_both(a)[1] for a in arrays]
    got = cp.chunk_attention_stats(*t, causal=causal, window=window,
                                   block_kv=block_kv)
    want = j_cp.chunk_attention_stats(*j, causal=causal, window=window,
                                      block_kv=block_kv)
    _close(got, want)


def test_merge_stats_matches_jax_and_an_empty_chunk_is_neutral(rng):
    shape_acc, shape_ml = (2, 4, 3, 8), (2, 4, 3)

    def mk():
        return (rng.standard_normal(shape_acc).astype(np.float32),
                rng.standard_normal(shape_ml).astype(np.float32),
                np.abs(rng.standard_normal(shape_ml)).astype(np.float32)
                + 0.1)

    a, b = mk(), mk()
    got = cp.merge_stats(*(_both(x)[0] for x in a + b))
    want = j_cp.merge_stats(*(_both(x)[1] for x in a + b))
    _close(got, want)
    empty = (np.zeros(shape_acc, np.float32),
             np.full(shape_ml, -1e30, np.float32),
             np.zeros(shape_ml, np.float32))
    merged = cp.merge_stats(*(_both(x)[0] for x in a + empty))
    _close(merged, a, 1e-6)
    # two empty chunks merge to an empty chunk, which finalizes to 0
    both_empty = cp.merge_stats(*(_both(x)[0] for x in empty + empty))
    out = cp._finalize(both_empty[0], both_empty[2])
    assert not torch.isnan(out).any() and not out.any()


def _meshes(n):
    return (j_cp.make_cp_mesh(n, jax.devices("cpu")),
            cp.make_cp_mesh(n, [CPU] * n))


def _ring_inputs(rng, B=2, T=32, S=32, K=2, G=2, D=16, ragged=False):
    q = rng.standard_normal((B, T, K * G, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32)
            for _ in "kv")
    q_start = np.full((B,), S - T, np.int32)
    kv_len = np.array([S, S - 13] if ragged else [S, S], np.int32)
    return q, k, v, q_start, kv_len


def test_ring_prefill_matches_jax(rng):
    """Ring attention over 2 seq ranks against the JAX ring: 16 tokens
    of history before the chunk, GQA 4, a ragged row, a window."""
    arrays = _ring_inputs(rng, T=32, S=48, G=4, ragged=True)
    jmesh, mesh = _meshes(2)
    got = cp.ring_prefill_sharded(mesh, *(_both(a)[0] for a in arrays),
                                  window=19)
    want = j_cp.ring_prefill_sharded(
        jmesh, *(jnp.asarray(a) for a in arrays), window=19)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("gqa,ragged,history,window", [
    (1, False, 0, None), (4, False, 0, None), (1, True, 0, None),
    (4, True, 16, None), (2, False, 0, 11), (2, True, 16, 11)])
def test_ring_prefill_matches_plain_attention(rng, n, gqa, ragged, history,
                                              window):
    """Ring attention over n seq ranks against the port's plain
    one-device attention (the JAX ring's own check), blockwise inner
    loop included (blocks of 8 < the 16-row chunks at n = 2)."""
    arrays = _ring_inputs(rng, T=32, S=32 + history, G=gqa, ragged=ragged)
    t = [_both(a)[0] for a in arrays]
    mesh = cp.make_cp_mesh(n, [CPU] * n)
    got = cp.ring_prefill_sharded(mesh, *t, window=window)
    plain = attention_torch(*t, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL,
                               rtol=TOL)
    if n == 2:
        blocked = cp.ring_prefill_sharded(mesh, *t, window=window,
                                          block_kv=8)
        np.testing.assert_allclose(blocked.numpy(), plain.numpy(),
                                   atol=TOL, rtol=TOL)


def _decode_inputs(rng, gqa, B=3, S=128, K=2, D=16):
    q = rng.standard_normal((B, 1, K * gqa, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32)
            for _ in "kv")
    return q, k, v, np.array([S, 77, 1], np.int32)


def test_split_decode_matches_jax(rng):
    """Split-KV decode over 2 seq ranks against the JAX combine: GQA 2,
    a window, ragged lengths down to 1 (rank 1 holds nothing valid for
    that row)."""
    arrays = _decode_inputs(rng, 2)
    jmesh, mesh = _meshes(2)
    got = cp.split_decode_sharded(mesh, *(_both(a)[0] for a in arrays),
                                  window=40)
    want = j_cp.split_decode_sharded(
        jmesh, *(jnp.asarray(a) for a in arrays), window=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("gqa,window", [(1, None), (4, None), (2, 40)])
def test_split_decode_matches_plain_attention(rng, gqa, window):
    """Split-KV decode over 4 seq ranks against the port's plain
    attention of the newest token."""
    q, k, v, kv_len = (_both(a)[0] for a in _decode_inputs(rng, gqa))
    got = cp.split_decode_sharded(cp.make_cp_mesh(4, [CPU] * 4), q, k, v,
                                  kv_len, window=window)
    plain = attention_torch(q, k, v, kv_len - 1, kv_len, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("block_kv", [None, 8])
@pytest.mark.parametrize("form", ["separate", "embedded"])
def test_int8_chunk_stats_match_jax(rng, block_kv, form):
    """An int8 chunk with the port's scale planes against the JAX
    package's two forms: its separate [B, Tk, K] scales, and its embedded
    scale rows, which ``kv_scales_from_numpy`` turns into planes (the
    bytes and codes carried over exactly)."""
    B, Tq, Tk, K, G, D = 2, 3, 20, 8, 1, 128
    q = rng.standard_normal((B, Tq, K * G, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Tk, K, D)).astype(np.float32)
            for _ in "kv")
    q_pos = np.broadcast_to(np.arange(Tq)[None] + 6, (B, Tq)).astype(
        np.int32)
    kv_pos = np.broadcast_to(np.arange(Tk)[None], (B, Tk)).astype(np.int32)
    kv_valid = kv_pos < 13
    common = [_both(a) for a in (q_pos, kv_pos, kv_valid)]
    if form == "separate":
        (jk, jks), (jv, jvs) = (j_kvc._quantize_kv(jnp.asarray(x))
                                for x in (k, v))
        want = j_cp.chunk_attention_stats(
            jnp.asarray(q), jk, jv, *(c[1] for c in common), k_scale=jks,
            v_scale=jvs, block_kv=block_kv)
        tk, tks, tv, tvs = (torch.from_numpy(np.array(a))
                            for a in (jk, jks, jv, jvs))
    else:
        ek, ev = (j_kvc.quantize_kv_embedded(jnp.asarray(x))
                  for x in (k, v))
        want = j_cp.chunk_attention_stats(
            jnp.asarray(q), ek, ev, *(c[1] for c in common),
            embedded_kv=True, block_kv=block_kv)
        (tk, tks), (tv, tvs) = (kv_scales_from_numpy(np.asarray(e), K)
                                for e in (ek, ev))
    got = cp.chunk_attention_stats(torch.from_numpy(q), tk, tv,
                                   *(c[0] for c in common), k_scale=tks,
                                   v_scale=tvs, block_kv=block_kv)
    _close(got, want)


def test_int8_ring_scales_ride_with_their_chunks(rng):
    """Ring attention over 2 ranks of an int8 chunk: the scales reach
    the other rank with their rows (a mismatch would show at once)."""
    B, T, K, G, D = 2, 8, 2, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, T, K * G, D)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, K, D)).astype(
        np.float32)) for _ in "kv")
    (qk, ks), (qv, vs) = (cpc.kvc.quantize_kv(x) for x in (k, v))
    kv_len = torch.tensor([T, T - 3], dtype=torch.int32)
    mesh = cp.make_cp_mesh(2, [CPU] * 2)
    tl = T // 2
    gens = []
    for i in range(2):
        rows = slice(i * tl, (i + 1) * tl)
        kv_pos = i * tl + torch.arange(tl, dtype=torch.int32)
        gens.append(cp.ring_attention(
            q[:, rows], qk[:, rows], qv[:, rows], kv_pos[None].expand(B, tl),
            kv_pos, kv_pos[None] < kv_len[:, None], i, 2,
            k_scale=ks[:, rows], v_scale=vs[:, rows]))
    got = torch.cat(cp._drive(mesh, gens), dim=1)
    want = attention_torch(q, qk.float() * ks[..., None],
                           qv.float() * vs[..., None],
                           torch.zeros(B, dtype=torch.int32), kv_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("t_local", [1, 4])
def test_write_plan_llen_and_kv_pos_match_jax(rng, t_local):
    """cp_write_plan, cp_llen_after and append_kv_pos against the JAX
    functions on ragged logs (ties in llen for decode), every rank; and
    reset_cp_cache clearing the rows it is given."""
    n, B, sl = 4, 5, 16
    llen = rng.integers(0, 6, (B, n)).astype(np.int32)
    llen[0] = 3                                   # a tie over every rank
    q_start = llen.sum(1).astype(np.int32)
    new = (rng.integers(0, 2, B) if t_local == 1
           else rng.integers(0, n * t_local + 1, B)).astype(np.int32)
    kv_len = q_start + new
    kv_pos0 = rng.integers(-1, 40, (B, sl)).astype(np.int32)
    for me in range(n):
        got = cpc.cp_write_plan(*(_both(a)[0] for a in
                                  (llen, q_start, kv_len)), me, n, t_local)
        want = j_cpc.cp_write_plan(*(jnp.asarray(a) for a in
                                     (llen, q_start, kv_len)), me, n,
                                   t_local)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        kv_pos = torch.from_numpy(kv_pos0.copy())
        cpc.append_kv_pos(kv_pos, *got, t_local)
        want_pos = j_cpc.append_kv_pos(jnp.asarray(kv_pos0), *want, t_local)
        np.testing.assert_array_equal(kv_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(
        cpc.cp_llen_after(*(_both(a)[0] for a in (llen, q_start, kv_len)),
                          n, t_local).numpy(),
        np.asarray(j_cpc.cp_llen_after(*(jnp.asarray(a) for a in
                                         (llen, q_start, kv_len)), n,
                                       t_local)))
    mesh = cp.make_cp_mesh(2, [CPU] * 2)
    cache = cpc.new_cp_cache(1, 4, 2, 16, 8, mesh, dtype=torch.float32)
    for _, s, _, shard, kv_pos in cache.ranks():
        kv_pos.fill_(s)
        shard.lengths.fill_(3)
    cache.llen.fill_(3)
    cache.lengths.fill_(6)
    cpc.reset_cp_cache(cache, [1, 3])
    for _, s, _, shard, kv_pos in cache.ranks():
        assert (kv_pos[[1, 3]] == -1).all() and (kv_pos[[0, 2]] == s).all()
        assert shard.lengths.tolist() == [3, 0, 3, 0]
    assert cache.llen.tolist() == [[3, 3], [0, 0], [3, 3], [0, 0]]
    assert cache.lengths.tolist() == [6, 0, 6, 0]

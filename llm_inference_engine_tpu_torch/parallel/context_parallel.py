"""Context (sequence) parallelism: ring attention and split-KV decode.

Port of ``llm_inference_engine_tpu/parallel/context_parallel.py``. The
sequence is sharded over the mesh's ``seq`` axis (``parallel/mesh.py``):
each seq rank holds a slice of the KV cache (an append log,
``parallel/cp_cache.py``) and, in prefill, a slice of the query chunk.

- **Ring attention (prefill)**: each rank computes online-softmax
  partials (acc, m, l) of its query rows against its own KV chunk, then
  against every other rank's chunk in ring order (its own, then rank
  i - 1's, i - 2's, ...), merging as it goes, and finalizes. The JAX
  package rotates the chunks with ``ppermute``; here one controller drives
  every rank's layer body (``parallel/sharding.py``), and the body asks
  for the other ranks' chunks by yielding a :class:`RingPass`: the
  controller sends back every rank's chunk in rank order, on the rank's
  device (the same tensors where the devices are the same).
- **Split-KV decode** (flash-decoding): every rank attends its local KV
  in one pass and yields its partials as :class:`SeqStats`; the
  controller combines them over the seq ranks in rank order (the JAX
  ``pmax`` of the running max and ``psum`` of the rescaled accumulators
  and normalizers, :func:`combine_stats`) and sends each rank the
  result.

Causality never depends on shard order: masks are computed from ABSOLUTE
positions (``q_pos``, ``kv_pos``) carried alongside the chunks, so ragged
per-sequence lengths (``kv_valid``) and any row order in a log compose.

Numerics, as in the JAX package: scores, m, l and acc in f32; the
online-softmax merge uses the finite sentinel -1e30 (not -inf), so a fully
masked chunk merges as the identity and an empty row gives 0, never NaN;
an int8 chunk's per-(token, head) scales are applied block by block. The
KV chunk is read in blocks of ``block_kv`` rows, each converted to f32 on
its own, so the working set is O(Tq * block_kv) per head whatever a
rank's log holds. This math is plain torch: the JAX package dropped its
Pallas CP inner loop as slower than XLA's, and the port keeps the math
as the path itself (its cost on the card is in PERF.md).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from llm_inference_engine_tpu_torch.parallel.mesh import (
    SEQ_AXIS, Mesh, make_mesh)

__all__ = ["SEQ_AXIS", "BLOCK_KV", "RingPass", "SeqStats", "make_cp_mesh",
           "chunk_attention_stats", "merge_stats", "combine_stats",
           "seq_exchange", "ring_attention", "split_kv_decode_attention",
           "ring_prefill_sharded", "split_decode_sharded"]

_NEG = -1e30
BLOCK_KV = 512


class RingPass(NamedTuple):
    """What a rank yields for the ring: its KV chunk (k, v, kv_pos,
    kv_valid, k_scale, v_scale; the scales None for a bf16 chunk). It is
    sent back every seq rank's chunk, in rank order."""
    chunk: tuple


class SeqStats(NamedTuple):
    """What a rank yields for the split-KV combine: its partials over its
    local KV. It is sent back the combined attention output (f32)."""
    acc: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor


def make_cp_mesh(cp: int, devices: Optional[Sequence[torch.device]] = None
                 ) -> Mesh:
    """A (seq=cp,) mesh: dp = tp = 1."""
    return make_mesh(1, 1, cp, devices=devices)


def chunk_attention_stats(q, k, v, q_pos, kv_pos, kv_valid, *,
                          sm_scale: Optional[float] = None,
                          causal: bool = True,
                          window: Optional[int] = None,
                          block_kv: Optional[int] = BLOCK_KV,
                          k_scale=None, v_scale=None):
    """Online-softmax partials of a query chunk against ONE kv chunk.

    q [B, Tq, H, D]; q_pos [B, Tq] absolute position of each query row;
    k, v [B, Tk, K, D] (GQA: G = H // K), bf16, f32 or int8 with
    ``k_scale``/``v_scale`` [B, Tk, K] per-(token, head) scales; kv_pos
    [Tk] or [B, Tk] absolute position of each kv row; kv_valid [B, Tk]
    bool, the row holds a real token. The chunk is read in blocks of
    ``block_kv`` rows with an online-softmax merge between blocks (None,
    or Tk <= block_kv: one block).

    Returns (acc [B, Tq, H, D], m [B, Tq, H], l [B, Tq, H]), all f32:
    acc = sum_j exp(s_j - m) v_j (unnormalized), m the running max
    (sentinel -1e30), l = sum_j exp(s_j - m).
    """
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    kv_pos_b = kv_pos if kv_pos.dim() == 2 else kv_pos[None].expand(B, Tk)
    qf = q.float()
    if block_kv is None or Tk <= block_kv:
        return _chunk_stats_dense(qf, k, v, q_pos, kv_pos_b, kv_valid,
                                  sm_scale=sm_scale, causal=causal,
                                  window=window, k_scale=k_scale,
                                  v_scale=v_scale)
    # the neutral element of the merge
    acc = torch.zeros_like(qf)
    m = torch.full((B, Tq, H), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Tq, H), dtype=torch.float32, device=q.device)
    for a in range(0, Tk, block_kv):
        b = min(a + block_kv, Tk)

        def rows(t):
            return None if t is None else t[:, a:b]

        stats = _chunk_stats_dense(
            qf, k[:, a:b], v[:, a:b], q_pos, kv_pos_b[:, a:b],
            kv_valid[:, a:b], sm_scale=sm_scale, causal=causal,
            window=window, k_scale=rows(k_scale), v_scale=rows(v_scale))
        acc, m, l = merge_stats(acc, m, l, *stats)
    return acc, m, l


def _heads_major(x, scale=None):
    """[B, Tk, K, D] (bf16, f32 or int8 with [B, Tk, K] scales) -> f32
    [B, K, Tk, D], in one strided copy: the layout a batched matmul takes
    without another copy."""
    B, Tk, K, D = x.shape
    out = torch.empty((B, K, Tk, D), dtype=torch.float32, device=x.device)
    out.copy_(x.permute(0, 2, 1, 3))
    if scale is not None:
        out.mul_(scale.permute(0, 2, 1).float()[..., None])
    return out


def _chunk_stats_dense(qf, k, v, q_pos, kv_pos_b, kv_valid, *, sm_scale,
                       causal, window, k_scale=None, v_scale=None):
    """One block's stats (see :func:`chunk_attention_stats`); ``qf`` is
    f32."""
    B, Tq, H, D = qf.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    kf, vf = _heads_major(k, k_scale), _heads_major(v, v_scale)

    # s = scale * q k^T: [B*K, G*Tq, D] @ [B*K, D, Tk] -> [B, K, G, Tq, Tk]
    qk = qf.reshape(B, Tq, K, G, D).permute(0, 2, 3, 1, 4).reshape(
        B * K, G * Tq, D)
    s = torch.empty((B * K, G * Tq, Tk), dtype=torch.float32,
                    device=qf.device)
    torch.baddbmm(s, qk, kf.view(B * K, Tk, D).transpose(1, 2), beta=0,
                  alpha=scale, out=s)
    s = s.view(B, K, G, Tq, Tk)
    visible = kv_valid[:, None, :]                         # [B, 1, Tk]
    if causal:
        visible = visible & (kv_pos_b[:, None, :] <= q_pos[:, :, None])
        if window is not None:
            visible = visible & (kv_pos_b[:, None, :]
                                 > q_pos[:, :, None] - window)
    else:
        visible = visible.expand(B, Tq, Tk)
    s.masked_fill_(~visible[:, None, None], _NEG)          # [B,1,1,Tq,Tk]
    m = s.amax(dim=-1)                                     # [B, K, G, Tq]
    # a masked entry of a row that sees a key is exp(-1e30 - m) = 0; a row
    # that sees none has m = -1e30 and every entry exp(0) = 1, so its l and
    # acc are zeroed after the sums (the JAX package zeroes p instead)
    p = s.sub_(m[..., None]).exp_()
    seen = (m > _NEG).float()
    l = p.sum(dim=-1) * seen
    acc = torch.bmm(p.view(B * K, G * Tq, Tk), vf.view(B * K, Tk, D))
    acc = (acc.view(B, K, G, Tq, D) * seen[..., None]).permute(0, 3, 1, 2, 4)
    return (acc.reshape(B, Tq, H, D),
            m.permute(0, 3, 1, 2).reshape(B, Tq, H),
            l.permute(0, 3, 1, 2).reshape(B, Tq, H))


def merge_stats(acc1, m1, l1, acc2, m2, l2):
    """Online-softmax merge of two partial chunks."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return (acc1 * a1[..., None] + acc2 * a2[..., None], m,
            l1 * a1 + l2 * a2)


def _finalize(acc, l):
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / l_safe[..., None]


def combine_stats(stats: Sequence[SeqStats]) -> torch.Tensor:
    """The split-KV combine over the seq ranks' partials, in rank order
    (the JAX ``pmax`` and two ``psum``s): the attention output, f32."""
    m_g = stats[0].m
    for st in stats[1:]:
        m_g = torch.maximum(m_g, st.m)
    acc_g = l_g = None
    for st in stats:
        w = torch.exp(st.m - m_g)
        a, l = st.acc * w[..., None], st.l * w
        acc_g = a if acc_g is None else acc_g + a
        l_g = l if l_g is None else l_g + l
    return _finalize(acc_g, l_g)


def seq_exchange(requests: list, devices: list) -> list:
    """The controller's side of one seq-axis exchange: ``requests`` are
    one seq group's yields in rank order (all :class:`RingPass` or all
    :class:`SeqStats`), ``devices`` their ranks' devices. Returns what to
    send each rank: every chunk on its device, or the combined output on
    its device (combined on rank 0's)."""
    if isinstance(requests[0], RingPass):
        def to(chunk, dev):
            return tuple(None if t is None else t.to(dev) for t in chunk)
        return [[to(req.chunk, dev) for req in requests] for dev in devices]
    home = devices[0]
    out = combine_stats([SeqStats(*(t.to(home) for t in st))
                         for st in requests])
    return [out.to(dev) for dev in devices]


def ring_attention(q, k, v, q_pos, kv_pos, kv_valid, me: int,
                   num_shards: int, *, sm_scale: Optional[float] = None,
                   causal: bool = True, window: Optional[int] = None,
                   out_dtype=None, k_scale=None, v_scale=None,
                   block_kv: Optional[int] = BLOCK_KV):
    """Ring attention of seq rank ``me`` over sequence-sharded q AND kv,
    as a generator: it yields one :class:`RingPass` of its own chunk and
    is sent back every rank's chunk in rank order; it returns its query
    rows' attention [B, Tq, H, D] in ``out_dtype`` (default q's).

    q [B, Tq, H, D], q_pos [B, Tq]; k/v [B, Tk, K, D], kv_pos [Tk] or
    [B, Tk], kv_valid [B, Tk], k_scale/v_scale [B, Tk, K] or None. The
    partials of the own chunk come first, then those of rank me - 1's,
    me - 2's, ... (the chunk the JAX ring's j-th ``ppermute`` brings).
    """
    own = (k, v, kv_pos, kv_valid, k_scale, v_scale)
    kw = dict(sm_scale=sm_scale, causal=causal, window=window,
              block_kv=block_kv)
    acc, m, l = chunk_attention_stats(q, k, v, q_pos, kv_pos, kv_valid,
                                      k_scale=k_scale, v_scale=v_scale, **kw)
    chunks = yield RingPass(own)
    for j in range(1, num_shards):
        kc, vc, pc, valc, ksc, vsc = chunks[(me - j) % num_shards]
        stats = chunk_attention_stats(q, kc, vc, q_pos, pc, valc,
                                      k_scale=ksc, v_scale=vsc, **kw)
        acc, m, l = merge_stats(acc, m, l, *stats)
    return _finalize(acc, l).to(out_dtype or q.dtype)


def split_kv_decode_attention(q, k, v, q_pos, kv_pos, kv_valid, *,
                              sm_scale: Optional[float] = None,
                              window: Optional[int] = None,
                              out_dtype=None, k_scale=None, v_scale=None,
                              block_kv: Optional[int] = BLOCK_KV):
    """Flash-decoding over a sequence-sharded KV cache, as a generator:
    this rank attends its LOCAL kv (q is the same on every seq rank),
    yields its :class:`SeqStats` and is sent back the combined output;
    it returns it in ``out_dtype`` (default q's). Shapes as in
    :func:`ring_attention`."""
    acc, m, l = chunk_attention_stats(
        q, k, v, q_pos, kv_pos, kv_valid, sm_scale=sm_scale, causal=True,
        window=window, block_kv=block_kv, k_scale=k_scale, v_scale=v_scale)
    out = yield SeqStats(acc, m, l)
    return out.to(out_dtype or q.dtype)


# ---------------------------------------------------------------------------
# over a (seq,) mesh in one call (the tests' and the card's templates)
# ---------------------------------------------------------------------------

def _drive(mesh: Mesh, gens: list) -> list:
    from llm_inference_engine_tpu_torch.parallel.sharding import lockstep
    return lockstep(gens, mesh)


def ring_prefill_sharded(mesh: Mesh, q, k_cache, v_cache, q_start, kv_len,
                         *, sm_scale: Optional[float] = None,
                         window: Optional[int] = None,
                         block_kv: Optional[int] = BLOCK_KV):
    """Ring-attention prefill over a (seq,) mesh (dp = tp = 1).

    q [B, T, H, D] split on T; k/v caches [B, S, K, D] split on S;
    q_start/kv_len [B]. T and S must divide the axis size. Query row t of
    sequence b sits at absolute position q_start[b] + t; kv row s holds
    position s, valid iff s < kv_len[b]. Returns [B, T, H, D] on the
    mesh's home device."""
    n = mesh.cp
    B, T = q.shape[:2]
    S = k_cache.shape[1]
    if T % n or S % n:
        raise ValueError(f"T {T} and S {S} must divide seq={n}")
    tl, sl = T // n, S // n
    gens = []
    for i in range(n):
        dev = mesh.device(0, i, 0)
        ar_q = torch.arange(tl, dtype=torch.int32, device=dev)
        q_pos = q_start.to(dev)[:, None] + i * tl + ar_q[None]
        kv_pos = i * sl + torch.arange(sl, dtype=torch.int32, device=dev)
        kv_valid = kv_pos[None, :] < kv_len.to(dev)[:, None]
        gens.append(ring_attention(
            q[:, i * tl:(i + 1) * tl].to(dev),
            k_cache[:, i * sl:(i + 1) * sl].to(dev),
            v_cache[:, i * sl:(i + 1) * sl].to(dev), q_pos, kv_pos,
            kv_valid, i, n, sm_scale=sm_scale, window=window,
            block_kv=block_kv))
    outs = _drive(mesh, gens)
    return torch.cat([o.to(mesh.home) for o in outs], dim=1)


def split_decode_sharded(mesh: Mesh, q, k_cache, v_cache, kv_len, *,
                         sm_scale: Optional[float] = None,
                         window: Optional[int] = None):
    """Split-KV decode over a (seq,) mesh: q [B, 1, H, D] on every rank,
    caches [B, S, K, D] split on S, kv_len [B] (the newest token sits at
    kv row kv_len - 1, so q_pos = kv_len - 1). Returns [B, 1, H, D] on
    the mesh's home device."""
    n = mesh.cp
    S = k_cache.shape[1]
    if S % n:
        raise ValueError(f"S {S} must divide seq={n}")
    sl = S // n
    gens = []
    for i in range(n):
        dev = mesh.device(0, i, 0)
        lens = kv_len.to(dev)
        kv_pos = i * sl + torch.arange(sl, dtype=torch.int32, device=dev)
        gens.append(split_kv_decode_attention(
            q.to(dev), k_cache[:, i * sl:(i + 1) * sl].to(dev),
            v_cache[:, i * sl:(i + 1) * sl].to(dev), lens[:, None] - 1,
            kv_pos, kv_pos[None, :] < lens[:, None], sm_scale=sm_scale,
            window=window))
    return _drive(mesh, gens)[0].to(mesh.home)

"""Kernel D's split plan on the CPU, through its Python mirror
``ops.attention.decode_plan_mirror`` (``make_plan`` in
csrc/attention_decode.cuh; a card test in test_torch_kernels.py holds the
two equal, and ``H100_DECODE_CLUSTERS`` equal to what the library reads on
an H100): at G > 1 the grid's clusters fit the card in one wave at every
preset's shapes; the plan reads no S, page size or kv_len; at G = 1 it is
the plan kernel D has always launched, so llama2-7b's bits do not move."""

from __future__ import annotations

import inspect
import re
from pathlib import Path

import pytest

from llm_inference_engine_tpu_torch.config import PRESETS
from llm_inference_engine_tpu_torch.ops import _native, attention

SMS = 132


def _shapes():
    """(preset, K, G, D, dtype name) of every preset, whole and as a tp = 2
    rank's shard where its kv heads split."""
    out = []
    for name, cfg in sorted(PRESETS.items()):
        G = cfg.num_heads // cfg.num_kv_heads
        for tp in (1, 2):
            if cfg.num_kv_heads % tp == 0:
                out.append((f"{name} tp{tp}", cfg.num_kv_heads // tp, G,
                            cfg.head_dim, cfg.dtype_name))
    return out


def _before(B, K, esize, sms=SMS):
    """nsplit of the plan before it read the residency (every G): about 8
    blocks an SM (4 for float32)."""
    want = 8 * 2 // esize * sms
    c = B * K
    return max(1, min(8, (want + c // 2) // c))


@pytest.mark.parametrize("int8", [False, True], ids=["kv16", "int8"])
@pytest.mark.parametrize("B", [1, 4, 8, 16])
@pytest.mark.parametrize("preset,K,G,D,dtype", _shapes(),
                         ids=[s[0] for s in _shapes()])
def test_gqa_plan_fits_one_wave(preset, K, G, D, dtype, B, int8):
    """At G > 1 the grid's B * K * ceil(G / R) clusters of nsplit blocks
    fit the clusters an H100 holds at once for that instance (or nsplit
    is 1), nsplit is the largest up to the blocks-an-SM target that does,
    and R is 4 up to G = 4, else 8 or 4."""
    clusters = attention.H100_DECODE_CLUSTERS[(dtype, D, int8)]
    esize = 4 if dtype == "float32" else 2
    plan = attention.decode_plan_mirror(B, K, G, clusters=clusters,
                                        esize=esize, sms=SMS)
    R, n, rb = plan["heads_per_block"], plan["nsplit"], plan["row_blocks"]
    if G == 1:
        assert (R, rb) == (1, 1)
        return
    assert R == 4 if G <= 4 else R in (4, 8)
    assert rb == -(-G // R) and 1 <= n <= 8
    c = B * K * rb
    assert n == 1 or c <= clusters[R][n - 1], (plan, clusters[R])
    want = 8 * 2 // esize * SMS
    target = max(1, min(8, (want + c // 2) // c))
    assert n <= target
    if n < target:
        assert c > clusters[R][n], (plan, clusters[R])


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("K", [1, 8, 32, 40])
@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 32, 64])
def test_mha_plan_is_unchanged(B, K, esize):
    """G = 1 (llama2-7b, llama2-13b and their shards): one query head a
    block and the nsplit of the plan before (about 8 blocks an SM, 4 for
    float32), whatever the residency says."""
    for clusters in ({4: (0,) * 8, 8: (0,) * 8},
                     {4: (10 ** 6,) * 8, 8: (10 ** 6,) * 8}):
        plan = attention.decode_plan_mirror(B, K, 1, clusters=clusters,
                                            esize=esize)
        assert plan == dict(nsplit=_before(B, K, esize), heads_per_block=1,
                            row_blocks=1)


def test_tinyllama_draft_plan_leaves_the_second_wave():
    """The draft's shape (B 8, 4 kv heads, G 8, head_dim 64, bf16): the
    plan before (R 8, nsplit 8: 32 clusters) met 30 resident clusters of
    8 on an H100, a second wave; the plan now fits one."""
    clusters = attention.H100_DECODE_CLUSTERS[("bfloat16", 64, False)]
    assert clusters[8][7] < 32
    plan = attention.decode_plan_mirror(8, 4, 8, clusters=clusters)
    c = 8 * 4 * plan["row_blocks"]
    assert c <= clusters[plan["heads_per_block"]][plan["nsplit"] - 1]
    assert plan["nsplit"] * c > 30 * 2      # more blocks than one a cluster


def test_plan_reads_no_length_page_or_cache_size():
    """make_plan (C) and its mirror take B, K, G, the element size, the
    SM count and the residency only: no S, page size, table or kv_len, so
    a graph captures the plan and a paged launch splits as a slot one."""
    src = (_native.CSRC / "attention_decode.cuh").read_text()
    sig = re.search(r"Plan make_plan\(([^)]*)\)", src).group(1)
    params = [p.split()[-1].lstrip("&") for p in sig.split(",")]
    assert params == ["B", "K", "G", "esize", "sms", "clusters"]
    # the one call: from run<>, before the paged geometry is derived
    assert src.count("make_plan(") == 2
    assert ("make_plan(p.B, p.K, p.G, (int)sizeof(E), sm_count(), res)"
            in src)
    mirror = inspect.signature(attention.decode_plan_mirror).parameters
    assert list(mirror) == ["B", "K", "G", "clusters", "esize", "sms"]


def test_recorded_residency_covers_the_presets():
    """H100_DECODE_CLUSTERS has R = 4 and R = 8 rows of 8 cluster sizes
    for every preset's (dtype, head_dim), with and without an int8 cache,
    non-increasing in the cluster size."""
    for _, _, G, D, dtype in _shapes():
        for int8 in (False, True):
            rows = attention.H100_DECODE_CLUSTERS[(dtype, D, int8)]
            assert set(rows) == {4, 8}
            for r in rows.values():
                assert len(r) == 8 and all(x >= 1 for x in r)
                assert list(r) == sorted(r, reverse=True)

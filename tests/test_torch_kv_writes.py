"""The launch geometry of the K/V row writes, on the CPU: the plans that
``csrc/kv_write_quant.cu`` (kernel I and kernel H's int8 mode, and
their float instance If over float16 and float32 rows) and
``csrc/kv_write.cu`` (kernels C and H, bf16) make on the host, through
their Python mirrors ``ops.kv_cache.write_quant_plan`` and
``ops.kv_cache.write_plan`` (card tests hold each mirror equal to the
built library's). The tests walk each plan's blocks, thread slots and
rows a thread as the kernels do, and hold that every live row is taken
exactly once: for the int8 write at every head dim the kernel is built
for, in each row dtype, and every K of the repository's presets; for the bf16 copy at the
draft's, tp = 2's and llama2-7b's rows, every head dim at K 8 and an
f32 row of 16 KB."""

import numpy as np
import pytest
import torch

from llm_inference_engine_tpu_torch.config import PRESETS
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops._native import (
    FLOAT_HEAD_DIMS, HEAD_DIMS)

PRESET_KS = sorted({c.num_kv_heads for c in PRESETS.values()})
# T: a decode row, a ragged chunk, the paged chunk, the slot chunk
WRITE_TS = (1, 7, 64, 512)


def _new_len(B, T, seed):
    """Ragged real lengths: a full row, an empty row, the rest random."""
    n = np.random.default_rng(seed).integers(0, T + 1, B)
    n[0] = T
    if B > 1:
        n[-1] = 0
    return n


def _walk_write_quant_plan(D, K, T, dtype):
    B = 16 if T == 1 else 8
    p = kvc.write_quant_plan(B, T, K, D, dtype)
    lanes, rb = p["lanes"], p["rows_per_block"]
    # a row's pieces of 32 bytes a lane (16 values of a 2-byte dtype, 8 of
    # f32) fit one aligned group of lanes, a power of two, no larger than
    # the row needs
    per_lane = 32 // torch.empty((), dtype=dtype).element_size()
    need = -(-D // per_lane)
    assert lanes & (lanes - 1) == 0 and need <= lanes < 2 * need
    assert p["threads"] % 32 == 0 and rb * lanes == p["threads"]
    assert p["blocks_y"] == B
    assert p["blocks_x"] * rb >= 2 * T * K > (p["blocks_x"] - 1) * rb
    x = np.arange(p["blocks_x"])[:, None]
    r = x * rb + np.arange(p["threads"])[None, :] // lanes
    for b, n in enumerate(_new_len(B, T, D * K + T)):
        live = int(n) * 2 * K
        # blocks whose first row is past the live rows exit; the others
        # guard each row; a row's lanes take its pieces once
        taken = r[(x * rb < live) & (r < live)]
        assert np.array_equal(np.unique(taken), np.arange(live)), b
        assert (np.bincount(taken, minlength=live) == lanes).all(), b
    return lanes


@pytest.mark.parametrize("T", WRITE_TS)
@pytest.mark.parametrize("K", PRESET_KS)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_write_quant_plan_takes_each_live_row_once(D, K, T):
    """Kernel I's bf16 rows: 4, 8, 8, 8 or 16 lanes a row."""
    assert _walk_write_quant_plan(D, K, T, torch.bfloat16) in (4, 8, 16)


@pytest.mark.parametrize("T", WRITE_TS)
@pytest.mark.parametrize("K", PRESET_KS)
@pytest.mark.parametrize("D", FLOAT_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32], ids=str)
def test_float_write_quant_plan_takes_each_live_row_once(dtype, D, K, T):
    """Kernel If, I's instance over float16 and float32 rows: a float16
    row takes the lanes of a bf16 row of its head dim (1 at D = 16), a
    float32 row twice as many."""
    lanes = _walk_write_quant_plan(D, K, T, dtype)
    if dtype == torch.float16 and D in HEAD_DIMS:
        assert lanes == kvc.write_quant_plan(1, T, K, D)["lanes"]
    if dtype == torch.float32:
        assert lanes == 2 * kvc.write_quant_plan(1, T, K, D,
                                                 torch.float16)["lanes"]


# (K, D, bytes a value) of the bf16 copy's rows: tinyllama's rank at tp = 2
# (256-byte rows), llama2-7b's rank at tp = 2 (4 KB) and llama2-7b (8 KB),
# K 8 at the other head dims, and an f32 7B row of 16 KB (two passes)
COPY_ROWS = ([(2, 64, 2), (16, 128, 2), (32, 128, 2), (32, 128, 4)]
             + [(8, d, 2) for d in HEAD_DIMS if d != 128])


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("T", [1, 64, 512])
@pytest.mark.parametrize("K,D,elem", COPY_ROWS)
def test_write_plan_takes_each_live_row_once(B, T, K, D, elem):
    """Block (x, y) takes sequence y's flat rows r = 2 t + (k|v) from x *
    rows_per_block, up to the live rows; thread i of a pass holds vectors
    pass + j * threads + i of the block's run, j < vecs. Every 16-byte
    vector of every live row is taken once, blocks past the live rows
    exit, and a block moves more than 4 KB (about 8 KB) unless one row is
    all it takes."""
    row_bytes = K * D * elem
    row_vecs = row_bytes // 16
    p = kvc.write_plan(B, T, row_bytes)
    rb, block_vecs = p["rows_per_block"], p["threads"] * p["vecs"]
    assert p["blocks_y"] == B
    assert p["blocks_x"] * rb >= 2 * T > (p["blocks_x"] - 1) * rb
    assert p["passes"] * block_vecs >= rb * row_vecs
    assert (p["passes"] - 1) * block_vecs < rb * row_vecs
    assert rb == 1 or 4096 < rb * row_bytes <= 16 * block_vecs
    slots = (np.arange(p["passes"])[:, None, None] * block_vecs
             + np.arange(p["vecs"])[None, :, None] * p["threads"]
             + np.arange(p["threads"])[None, None, :]).ravel()
    for b, n in enumerate(_new_len(B, T, K * D * elem + T)):
        live = 2 * int(n)
        taken = []
        for x in range(p["blocks_x"]):
            r0 = x * rb
            if r0 >= live:
                continue                       # the block exits at once
            n_vecs = (min(r0 + rb, live) - r0) * row_vecs
            taken.append(r0 * row_vecs + slots[slots < n_vecs])
        taken = np.concatenate(taken) if taken else np.zeros(0, np.int64)
        assert np.array_equal(np.sort(taken), np.arange(live * row_vecs)), b

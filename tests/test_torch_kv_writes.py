"""The launch geometry of the int8 K/V row write, on the CPU: the plan
that ``csrc/kv_write_quant.cu`` (kernel I and kernel H's int8 mode) makes
on the host, through its Python mirror ``ops.kv_cache.write_quant_plan``
(a card test holds the mirror equal to the built library's). The test
walks the plan's blocks, thread slots and rows a thread as the kernel
does, and holds that every live (token, k|v, head) row is taken exactly
once, at every head dim the kernel is built for and every K of the
repository's presets."""

import numpy as np
import pytest

from llm_inference_engine_tpu_torch.config import PRESETS
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops._native import HEAD_DIMS

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


@pytest.mark.parametrize("T", WRITE_TS)
@pytest.mark.parametrize("K", PRESET_KS)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_write_quant_plan_takes_each_live_row_once(D, K, T):
    B = 16 if T == 1 else 8
    p = kvc.write_quant_plan(B, T, K, D)
    lanes, rb = p["lanes"], p["rows_per_block"]
    # a row's 16-value pieces of 32 bytes fit one aligned group of lanes
    assert lanes in (4, 8, 16) and -(-D // 16) <= lanes
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

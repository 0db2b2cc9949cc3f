"""The PyTorch port's beam search against the JAX package, on the CPU.

``beam_search`` on the ``debug`` preset in f32 with 1, 2 and 4 beams (and
an int8 KV cache, whose scale planes follow their beams too): sequences
equal to the JAX package's, scores within 1e-4 (the same f32 math summed
in another order); EOS freezing with the pad continuation; one beam equal
to greedy ``generate``; scores equal to a teacher-forced recompute. The
step body runs under ``NoHostReads``, the CPU proxy for the CUDA-graph
capture it gets on a card (held there by ``tests/test_torch_kernels.py``
and ``chip_smoke.py`` phase 4l).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.runtime.beam_search import (
    beam_search as j_beam_search)

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models import llama
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.runtime.beam_search import (
    BeamSearch, beam_search)
from llm_inference_engine_tpu_torch.runtime.decode_graph import NoHostReads
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

CFG = get_config("debug")
SCORE_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _weights(seed=3):
    jp = j_init_dummy_params(j_get_config("debug"), seed=seed, scale=0.35)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _both(prompt, num_beams, kv="", **kw):
    """The JAX package's and the port's beam search on the same weights."""
    jp, tp = _weights()
    eng = dict(max_batch_size=4, max_seq_len=64, kv_cache_dtype_name=kv)
    want = j_beam_search(j_get_config("debug"),
                         JEngineConfig(kernels="xla", **eng), jp, prompt,
                         num_beams=num_beams, **kw)
    got = beam_search(CFG, EngineConfig(**eng), tp, prompt,
                      num_beams=num_beams, **kw)
    return want, got


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("num_beams", [1, 2, 4])
def test_beam_search_matches_jax(num_beams, kv):
    """Sequences equal, in the same best-first order; scores (length
    penalty 1) within 1e-4."""
    want, got = _both([1, 13, 99, 2, 7], num_beams, kv, max_new_tokens=7,
                      eos_token_id=None)
    assert got.sequences == want.sequences
    np.testing.assert_allclose(got.scores, want.scores, atol=SCORE_ATOL)
    assert got.scores == sorted(got.scores, reverse=True)
    assert all(len(s) == 7 for s in got.sequences)


def test_beam_eos_freezing_matches_jax():
    """The greedy first token as EOS: beams that pick it freeze (EOS once,
    last; never extended), the others run on; all as in the JAX package,
    with length-normalized scores."""
    _, tp = _weights()
    eng = EngineConfig(max_batch_size=4, max_seq_len=64)
    first = InferenceEngine(CFG, eng, tp).generate(
        [[1, 2, 3]], SamplingParams(greedy=True, max_new_tokens=1),
        eos_token_id=None).token_ids[0][0]
    want, got = _both([1, 2, 3], 3, max_new_tokens=6, eos_token_id=first,
                      length_penalty=0.7)
    assert got.sequences == want.sequences
    np.testing.assert_allclose(got.scores, want.scores, atol=SCORE_ATOL)
    frozen = [s for s in got.sequences if first in s]
    assert frozen and any(first not in s for s in got.sequences)
    for s in frozen:
        assert s.count(first) == 1 and s[-1] == first
    assert all(len(s) <= 6 for s in got.sequences)


def test_one_beam_equals_greedy_generate():
    _, tp = _weights()
    eng = EngineConfig(max_batch_size=4, max_seq_len=64)
    prompt = [1, 9, 41, 7]
    greedy = InferenceEngine(CFG, eng, tp).generate(
        [prompt], SamplingParams(greedy=True, max_new_tokens=8),
        eos_token_id=None).token_ids[0]
    res = beam_search(CFG, eng, tp, prompt, num_beams=1, max_new_tokens=8,
                      eos_token_id=None)
    assert res.sequences == [greedy]


def test_scores_equal_a_teacher_forced_recompute():
    """With length penalty 0 each reported score is the sequence's summed
    log-probability, recomputed by one forward over prompt + sequence."""
    _, tp = _weights()
    prompt = [1, 23, 5]
    res = beam_search(CFG, EngineConfig(max_batch_size=4, max_seq_len=64),
                      tp, prompt, num_beams=3, max_new_tokens=6,
                      eos_token_id=None, length_penalty=0.0)
    for seq, score in zip(res.sequences, res.scores):
        full = prompt + seq
        cache = kvc.new_kv_cache(CFG.num_layers, 1, CFG.num_kv_heads,
                                 len(full), CFG.head_dim, dtype=CFG.dtype)
        logits, _ = llama.forward_all_logits(
            CFG, EngineConfig(max_batch_size=1, max_seq_len=len(full)), tp,
            torch.tensor([full], dtype=torch.int32), cache,
            torch.zeros(1, dtype=torch.int32),
            torch.tensor([len(full)], dtype=torch.int32))
        logp = torch.log_softmax(logits[0], -1)
        want = sum(logp[len(prompt) - 1 + i, t].item()
                   for i, t in enumerate(seq))
        assert score == pytest.approx(want, abs=2e-3)


def test_step_reads_nothing_on_the_host_and_reorders_bounded_rows():
    """The step body under NoHostReads (int8 cache: its scale planes are
    reordered too); the reorder moves the first prompt + max_new_tokens
    rows of each plane and leaves the rows past them alone. A second
    search on the same object (other rows to reorder) gives the result of
    a fresh one."""
    _, tp = _weights()
    eng = EngineConfig(max_batch_size=4, max_seq_len=64,
                       kv_cache_dtype_name="int8")
    bs = BeamSearch(CFG, eng, tp, num_beams=3)
    first = bs.search([1, 2, 3, 4], max_new_tokens=5, eos_token_id=None)
    rows = 4 + 5
    assert [s.shape[2] for s in bs._scratch] == [rows] * 4
    per_beam = CFG.num_layers * rows * CFG.num_kv_heads
    assert bs.gather_bytes() == 4 * 3 * per_beam * 2 * (CFG.head_dim + 4)
    tail = [p[:, :, rows:].clone() for p in bs._planes()]
    with NoHostReads("step"):
        bs._step_body()
    assert all(torch.equal(p[:, :, rows:], t)
               for p, t in zip(bs._planes(), tail))
    again = bs.search([5, 6], max_new_tokens=4, eos_token_id=None)
    fresh = beam_search(CFG, eng, tp, [5, 6], num_beams=3, max_new_tokens=4,
                        eos_token_id=None)
    assert again == fresh and first.sequences


def test_prompt_past_max_seq_len_raises():
    _, tp = _weights()
    with pytest.raises(ValueError, match="max_seq"):
        beam_search(CFG, EngineConfig(max_seq_len=16), tp, list(range(10)),
                    num_beams=2, max_new_tokens=8)

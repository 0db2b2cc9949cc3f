"""Perplexity and calibration in the PyTorch port against the JAX package,
on the CPU: ``evals/ppl.py`` (the windowed scorer, ``perplexity``,
``quant_ppl_report``, ``load_text_tokens``, the CLI) and
``models/weights.py``'s ``calibrate_act_sq`` and
``quantize_params_calibrated``.

Weights are the JAX package's dummies of the ``debug`` preset (f32),
carried across with ``params_from_numpy``; the JAX side runs with
``kernels="xla"``, as its own tests run it. Tolerances: NLL sums 1e-5
relative (both sides sum the same f32 log-probabilities in another
order), perplexities 1e-4, activation second moments 1e-5 (f32 forwards
summed in f64); quantized storage given the same statistics bit for bit.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu import evals as j_evals
from llm_inference_engine_tpu.evals import ppl as j_ppl
from llm_inference_engine_tpu.models import weights as j_weights
from llm_inference_engine_tpu.tokenizer import load_tokenizer as j_tokenizer

from llm_inference_engine_tpu_torch import evals
from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
from llm_inference_engine_tpu_torch.evals import ppl
from llm_inference_engine_tpu_torch.models import llama, weights
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
from llm_inference_engine_tpu_torch.tokenizer import load_tokenizer

CFG = get_config("debug")
J_CFG = j_get_config("debug")
J_ENG = JEngineConfig(kernels="xla")
SPM_ASSET = "tests/assets/tiny_spm_bpe.model"


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jp = j_weights.init_dummy_params(J_CFG, seed=0, scale=0.2)
    tp = weights.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(0).integers(
        0, CFG.vocab_size, size=201).tolist()
    return jp, tp, tokens


@pytest.mark.parametrize("window,batch", [(256, 2), (64, 3), (64, 1),
                                          (32, 4)])
def test_scorer_matches_the_jax_scorer(setup, window, batch):
    jp, tp, tokens = setup
    want_nll, want_n = j_ppl.Scorer(J_CFG, jp, J_ENG, window=window,
                                    batch=batch).score(tokens)
    nll, n = ppl.Scorer(CFG, tp, window=window, batch=batch).score(tokens)
    assert n == want_n == len(tokens) - 1
    assert nll == pytest.approx(want_nll, rel=1e-5)


def test_scorer_scores_an_int8_cache_as_the_jax_scorer(setup):
    jp, tp, tokens = setup
    want = j_ppl.Scorer(J_CFG, jp, J_ENG.replace(kv_cache_dtype_name="int8"),
                        window=64, batch=2).score(tokens)
    scorer = ppl.Scorer(CFG, tp, EngineConfig(kv_cache_dtype_name="int8"),
                        window=64, batch=2)
    assert scorer._cache.quantized
    nll, n = scorer.score(tokens)
    assert n == want[1]
    assert nll == pytest.approx(want[0], rel=1e-5)
    # the int8 cache moves the result: the bf16 run differs
    assert nll != ppl.Scorer(CFG, tp, window=64, batch=2).score(tokens)[0]


def _direct_nll(params, tokens):
    """Golden: one full-sequence forward, NLL of tokens[1:]."""
    eng = EngineConfig(max_batch_size=1, max_seq_len=len(tokens))
    cache = kvc.new_kv_cache(CFG.num_layers, 1, CFG.num_kv_heads,
                             len(tokens), CFG.head_dim, dtype=CFG.dtype)
    ids = torch.tensor([tokens], dtype=torch.int32)
    n = torch.tensor([len(tokens)], dtype=torch.int32)
    logits, _ = llama.forward_all_logits(CFG, eng, params, ids, cache,
                                         torch.zeros(1, dtype=torch.int32), n)
    logp = torch.log_softmax(logits[0, :-1].double(), -1)
    lp = logp.gather(-1, ids[0, 1:, None].long())[:, 0]
    return float(-lp.sum()), len(tokens) - 1


def test_scorer_matches_direct(setup):
    _, tp, tokens = setup
    want_nll, want_n = _direct_nll(tp, tokens)
    # window larger than the stream: one window
    nll, n = ppl.Scorer(CFG, tp, window=256, batch=2).score(tokens)
    assert n == want_n
    assert nll == pytest.approx(want_nll, rel=1e-4)


def test_windowing_counts_every_token_once(setup):
    _, tp, tokens = setup
    nll, n = ppl.Scorer(CFG, tp, window=64, batch=3).score(tokens)
    assert n == len(tokens) - 1
    assert math.isfinite(nll) and nll > 0
    # batch size must not change the result
    nll2, n2 = ppl.Scorer(CFG, tp, window=64, batch=1).score(tokens)
    assert n2 == n
    assert nll2 == pytest.approx(nll, rel=1e-4)
    # a stream of one window plus one token: the last window predicts one
    short = tokens[:65]
    assert ppl.Scorer(CFG, tp, window=64, batch=2).score(short)[1] == 64


def test_uniform_model_ppl_is_vocab_size(setup):
    _, _, tokens = setup
    params = weights.init_dummy_params(CFG, seed=0, scale=0.0)
    p = ppl.perplexity(CFG, params, tokens, window=128, batch=2)
    assert p == pytest.approx(CFG.vocab_size, rel=1e-5)


def test_quant_ppl_report_matches_the_jax_report(setup):
    jp, tp, tokens = setup
    kw = dict(modes=("int8", "int4"), group_size=32, window=64, batch=2)
    want = j_ppl.quant_ppl_report(J_CFG, jp, tokens[:101],
                                  engine_config=J_ENG, **kw)
    got = ppl.quant_ppl_report(CFG, tp, tokens[:101], **kw)
    assert got.keys() == want.keys()
    for k in ("fp", "int8", "int4"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert abs(got["int8_delta"]) < 0.05 * got["fp"]


def test_ppl_cli_prints_the_in_process_value(tmp_path, capsys):
    data = tmp_path / "toks.npy"
    np.save(data, np.random.default_rng(1).integers(0, CFG.vocab_size, 150))
    common = ["--model", "debug", "--dummy-weights", "--data", str(data),
              "--group-size", "32", "--window", "64", "--batch", "2"]
    args = common + ["--quant", "int8"]
    ppl.main(args + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    params = weights.quantize_params(
        weights.init_dummy_params(CFG, seed=0, device="cpu"), "int8", 32)
    want = ppl.perplexity(CFG, params, np.load(data).tolist(), window=64,
                          batch=2)
    assert out == {"model": "debug", "quant": "int8", "n_tokens": 150,
                   "ppl": want}
    ppl.main(common + ["--quant", "compare", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out)
    assert set(rep) == {"model", "n_tokens", "fp", "int8", "int8_delta",
                        "int4", "int4_delta"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ppl.main(args)


def test_load_text_tokens_matches_the_jax_package(tmp_path):
    text = tmp_path / "wiki.txt"
    text.write_text("The quick brown fox.\nJumps over the lazy dog.\n")
    assert ppl.load_text_tokens(str(text), load_tokenizer(SPM_ASSET)) == \
        j_ppl.load_text_tokens(str(text), j_tokenizer(SPM_ASSET))
    ids = np.arange(7, dtype=np.int32)
    np.save(tmp_path / "a.npy", ids)
    np.savez(tmp_path / "b.npz", tokens=ids)
    for f in ("a.npy", "b.npz"):
        assert ppl.load_text_tokens(str(tmp_path / f), None) == ids.tolist()


def test_evals_exports_match():
    assert evals.__all__ == j_evals.__all__


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calib():
    jp = j_weights.init_dummy_params(J_CFG, seed=0)
    tp = weights.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    toks = [rng.integers(0, CFG.vocab_size, size=(2, 12)).astype(np.int32),
            rng.integers(0, CFG.vocab_size, size=(1, 20)).astype(np.int32)]
    return jp, tp, toks, j_weights.calibrate_act_sq(J_CFG, jp, toks)


@pytest.mark.parametrize("matmul", ["wqkv", "wo", "w_gate_up", "w_down"])
def test_calibrate_act_sq_matches_the_jax_package(calib, matmul):
    _, tp, toks, want = calib
    got = weights.calibrate_act_sq(CFG, tp, toks)
    assert set(got) == set(want)
    g, w = got[matmul], np.asarray(want[matmul])
    assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
    for layer in range(CFG.num_layers):
        np.testing.assert_allclose(g[layer].numpy(), w[layer], rtol=1e-5)
    # the tap is restored
    from llm_inference_engine_tpu_torch.utils import debug
    assert not debug.tap.enabled


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_quantize_params_calibrated_is_the_jax_packages(calib, mode):
    """Given the same statistics, q and scales bit for bit; the format is
    quantize_params' (and at int4 the clip search moves some blocks)."""
    jp, tp, _, act_sq = calib
    want = j_weights.quantize_params_calibrated(jp, act_sq, mode, 32)
    got = weights.quantize_params_calibrated(
        tp, {k: torch.from_numpy(np.array(v)) for k, v in act_sq.items()},
        mode, 32)
    rtn = weights.quantize_params(tp, mode, 32)
    moved = 0
    for name, g in list(got["layers"].items()) + [("lm_head",
                                                   got["lm_head"])]:
        w = want["lm_head"] if name == "lm_head" else want["layers"][name]
        r = rtn["lm_head"] if name == "lm_head" else rtn["layers"][name]
        if not isinstance(g, QuantizedTensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            continue
        assert (g.mode, g.group_size) == (w.mode, w.group_size)
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
        assert (g.q.shape, g.q.dtype, g.scale.shape) == (
            r.q.shape, r.q.dtype, r.scale.shape)
        moved += int(not torch.equal(g.scale, r.scale))
    assert moved > 0 if mode == "int4" else moved >= 0


def test_calibrated_engine_generates_as_the_jax_one(calib):
    """A calibrated INT4 model serves in both engines alike."""
    from llm_inference_engine_tpu.config import (
        SamplingParams as JSamplingParams)
    from llm_inference_engine_tpu.runtime.engine import (
        InferenceEngine as JInferenceEngine)
    from llm_inference_engine_tpu_torch.config import SamplingParams
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    jp, tp, _, act_sq = calib
    jq = j_weights.quantize_params_calibrated(jp, act_sq, "int4", 32)
    tq = weights.params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    kw = dict(max_batch_size=2, max_seq_len=64, quant_mode="int4",
              quant_group_size=32)
    prompts = [[1, 5, 9, 13], [7, 3]]
    want = JInferenceEngine(J_CFG, JEngineConfig(kernels="xla", **kw),
                            jq).generate(
        prompts, JSamplingParams(greedy=True, max_new_tokens=6),
        eos_token_id=None).token_ids
    got = InferenceEngine(CFG, EngineConfig(**kw), tq).generate(
        prompts, SamplingParams(greedy=True, max_new_tokens=6),
        eos_token_id=None).token_ids
    assert got == want
    assert jnp.asarray(act_sq["wqkv"]).shape == (CFG.num_layers,
                                                 CFG.hidden_size)

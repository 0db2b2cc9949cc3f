"""The port's quantization quality proxy
(``llm_inference_engine_tpu_torch/tools/quant_divergence.py``) against the
JAX tool (``tools/quant_divergence.py``, imported here only), on the CPU
at the ``debug`` preset, group 32, B 2, T 32.

Bit for bit: the layer-streamed synthesis against ``synth_params_np``, and
the int8, int4 and int4cal storage against ``quantize_stacked_np`` /
``quantize_np`` / ``quantize_np_cal`` (int4cal given the JAX ``act_sq``).
Within tolerances: ``act_sq`` from ``calibrate_act_sq`` on the f32 weights
against the JAX function called directly (rel 1e-5 per matmul: the same
f32 forward summed in another order), and each variant's logits against
the JAX tool's ``run_variant`` on its XLA path (1e-4). ``divergence`` gives
the same dict on the same logits (1e-12), and the CLI prints the JAX
report's keys.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models.weights import (
    calibrate_act_sq as j_calibrate_act_sq)

from llm_inference_engine_tpu_torch.config import get_config
from llm_inference_engine_tpu_torch.tools import quant_divergence as qd

REPO = Path(__file__).resolve().parent.parent
CFG = get_config("debug")
G, B, T, CALIB = 32, 2, 32, 64
MATMULS = ("wqkv", "wo", "w_gate_up", "w_down")
STEP_KEYS = {"mean_abs_dlogit", "max_abs_dlogit", "fp_logit_std",
             "top1_agreement", "mean_kl_nats", "p99_kl_nats",
             "mean_abs_dlogp_top1"}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_quant_divergence", REPO / "tools" / "quant_divergence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JQD = _jax_tool()


@pytest.fixture(scope="module")
def weights():
    """(JAX host weights, the port's f32 weights, its fp variant), seed 0."""
    p32 = qd.synth_params(CFG, 0, torch.device("cpu"))
    return JQD.synth_params_np(j_get_config("debug"), 0), p32, \
        qd.fp_variant(CFG, p32)


@pytest.fixture(scope="module")
def jax_act_sq(weights):
    jp = weights[0]
    params = {"embed": jnp.asarray(jp["embed"]),
              "layers": {k: jnp.asarray(v) for k, v in jp["layers"].items()},
              "final_norm": jnp.asarray(jp["final_norm"]),
              "lm_head": jnp.asarray(jp["lm_head"])}
    act = j_calibrate_act_sq(j_get_config("debug"), params,
                             [qd.calib_tokens(CFG, 0, CALIB)])
    return {k: np.asarray(v) for k, v in act.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def test_streamed_draws_equal_one_draw():
    """A stack drawn layer by layer equals the whole draw, scales and
    outliers included."""
    whole = qd.synth_weight(np.random.default_rng(7), 13, (3, 777, 13))
    stack = qd.synth_stack(np.random.default_rng(7), 13, 3, (777, 13),
                           torch.device("cpu"))
    assert np.array_equal(stack.numpy(), whole)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthesis_equals_jax_bit_for_bit(seed):
    want = dict(_leaves(JQD.synth_params_np(j_get_config("debug"), seed)))
    got = dict(_leaves(qd.synth_params(CFG, seed, torch.device("cpu"))))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        assert np.array_equal(got[name].numpy(), w), name


@pytest.mark.parametrize("mode", ["int8", "int4", "int4cal"])
def test_storage_equals_jax_bit_for_bit(weights, jax_act_sq, mode):
    """Every quantized leaf's q and scales, layer stacks and lm_head, equal
    the JAX tool's host quantizers; the embedding and norms are the fp
    variant's."""
    jp, p32, fp = weights
    act = jax_act_sq if mode == "int4cal" else None
    got = qd.quant_variant(
        p32, fp, mode, G,
        None if act is None else {k: torch.from_numpy(np.array(v))
                                  for k, v in act.items()})
    for name in MATMULS:
        q, s = JQD.quantize_stacked_np(jp["layers"][name], mode, G,
                                       None if act is None else act[name])
        t = got["layers"][name]
        assert t.mode == ("int4" if mode == "int4cal" else mode)
        assert np.array_equal(t.q.numpy(), q), name
        assert np.array_equal(t.scale.numpy(), s), name
    if mode == "int4cal":
        q, s = JQD.quantize_np_cal(jp["lm_head"], G, None)
    else:
        q, s = JQD.quantize_np(jp["lm_head"], mode, G)
    assert np.array_equal(got["lm_head"].q.numpy(), q)
    assert np.array_equal(got["lm_head"].scale.numpy(), s)
    assert got["embed"] is fp["embed"]
    assert got["layers"]["ffn_norm"] is fp["layers"]["ffn_norm"]


def test_act_sq_matches_jax_calibration(weights, jax_act_sq):
    """``calibrate_act_sq`` on the f32 weights (the tool's int4cal_f32
    route) against the JAX function, rel L2 1e-5 per matmul."""
    got = qd.calibrate(CFG, weights[1], qd.calib_tokens(CFG, 0, CALIB),
                       kernels="torch")
    for name in MATMULS:
        want = jax_act_sq[name]
        a = got[name].numpy()
        assert a.shape == want.shape, name
        assert np.linalg.norm(a - want) / np.linalg.norm(want) < 1e-5, name


@pytest.mark.parametrize("mode", ["fp", "int8", "int4"])
def test_logits_match_jax_run_variant(weights, mode):
    jp, p32, fp = weights
    tokens = qd.eval_tokens(CFG, 0, B, T)
    want, _ = JQD.run_variant(
        j_get_config("debug"),
        JEngineConfig(max_batch_size=B, max_seq_len=T, kernels="xla"), jp,
        tokens, mode, G)
    params = fp if mode == "fp" else qd.quant_variant(p32, fp, mode, G)
    got, _ = qd.run_variant(CFG, params, tokens)
    assert got.dtype == np.float32 and got.shape == (B, T, CFG.vocab_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_divergence_equals_jax(seed):
    rng = np.random.default_rng(seed)
    fp = rng.standard_normal((2, 9, 50)).astype(np.float32) * 2
    q = fp + rng.standard_normal(fp.shape).astype(np.float32) * 0.3
    got, want = qd.divergence(fp, q), JQD.divergence(fp, q)
    assert set(got) == set(want) == STEP_KEYS
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), k


def test_cli_prints_the_jax_report():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = qd.main(["--model", "debug", "--batch", str(B), "--window",
                      str(T), "--group-size", str(G), "--device", "cpu",
                      "--modes", "int8,int4,int4cal,int4cal_f32"])
    assert rc == 0
    text = out.getvalue()
    report = json.loads(text[text.index("\n{") + 1:])
    assert {"model", "batch", "window", "group_size", "positions",
            "backend"} <= set(report)
    assert (report["model"], report["batch"], report["window"],
            report["group_size"], report["positions"]) == (
        "debug", B, T, G, B * T)
    for mode in ("int8", "int4", "int4cal", "int4cal_f32"):
        assert set(report[mode]) == STEP_KEYS, mode
        assert all(np.isfinite(v) for v in report[mode].values()), mode
    cal = report["calibration"]
    assert {"int4cal", "int4cal_f32"} <= set(cal)
    assert set(cal["act_sq_rel_l2_bf16_vs_f32"]) == set(MATMULS)
    assert report["device_peak_gib"] is None


def test_cli_refuses_a_missing_card():
    """--device cuda (the default) with no card exits, it does not fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        qd.main(["--model", "debug"])

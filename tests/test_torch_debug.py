"""The debugging utilities of the PyTorch port against the JAX package, on
the CPU: the forward's debug taps and ``compare_dumps``
(``utils/debug.py``), ``nan_guard`` and ``assert_finite``
(``utils/checks.py``), the timers and trace (``utils/profiling.py``) and
the logger (``utils/logging.py``).

Weights are the JAX package's seed-0 dummies of the ``debug`` preset,
carried across with ``params_from_numpy``; the JAX engine runs with
``kernels="xla"``, as its own tests run it. Dumps are held with
``compare_dumps(jax_dir, port_dir, atol=1e-4, rtol=1e-4)``: both sides
compute in f32 and differ only in the order of their sums.
"""

import logging
import os
import types

import jax
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)
from llm_inference_engine_tpu.utils import debug as j_debug
from llm_inference_engine_tpu.utils import logging as j_logging
from llm_inference_engine_tpu.utils import profiling as j_profiling

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models import llama
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.runtime import decode_graph
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.utils import (
    assert_finite, checks, debug, nan_guard)
from llm_inference_engine_tpu_torch.utils import logging as t_logging
from llm_inference_engine_tpu_torch.utils import profiling

CFG = get_config("debug")
J_CFG = j_get_config("debug")
PROMPT = [1, 5, 9]
NEW = 8
TAP_NAMES = ("embedding", "final_norm") + tuple(
    f"L{i}_{n}" for i in range(2)
    for n in ("attn_norm", "qkv_proj", "q_rope", "k_rope", "attn_ctx",
              "attn_out", "ffn_in", "ffn_act", "layer_out"))


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _weights(seed):
    jp = j_init_dummy_params(J_CFG, seed=seed)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _jax_run(dump_dir, params, eos, stream):
    j_debug.set_dump_dir(str(dump_dir))
    try:
        eng = JInferenceEngine(J_CFG, JEngineConfig(
            max_batch_size=2, max_seq_len=64, kernels="xla"), params)
        return eng.generate(
            [PROMPT], JSamplingParams(greedy=True, max_new_tokens=NEW),
            eos_token_id=eos,
            stream_callback=(lambda i, t: None) if stream else None)
    finally:
        j_debug.set_dump_dir(None)


def _port_run(dump_dir, params, eos, stream):
    if dump_dir is not None:
        debug.set_dump_dir(str(dump_dir))
    try:
        eng = InferenceEngine(CFG, EngineConfig(max_batch_size=2,
                                                max_seq_len=64), params)
        return eng.generate(
            [PROMPT], SamplingParams(greedy=True, max_new_tokens=NEW),
            eos_token_id=eos,
            stream_callback=(lambda i, t: None) if stream else None)
    finally:
        debug.set_dump_dir(None)


def _eos(params):
    """A stop id that ends the greedy run early: the JAX package names its
    model-level dumps (embedding, final_norm) once per compiled program,
    so each holds that program's last call, and the last call of all must
    be a decode step for the two directories' newest dumps to pair up (a
    length-terminated row ends with a one-token prefill)."""
    ids = _port_run(None, params, None, True).token_ids[0]
    return ids[NEW - 2]


@pytest.mark.parametrize("stream", [True, False],
                         ids=["decode_step", "sampled_rollout"])
def test_tap_dumps_equal_the_jax_packages(tmp_path, stream):
    """The same generate in both packages dumps the same names at the same
    shapes, and compare_dumps finds no difference; the decode steps dump
    too (through decode_step, or the rollout's eager bodies)."""
    jp, tp = _weights(0)
    eos = _eos(tp)
    rj = _jax_run(tmp_path / "j", jp, eos, stream)
    rt = _port_run(tmp_path / "t", tp, eos, stream)
    assert rt.token_ids == rj.token_ids
    assert len(rt.token_ids[0]) < NEW - 1
    names = {f.split("_", 1)[1][:-4] for f in os.listdir(tmp_path / "t")}
    assert names == {f.split("_", 1)[1][:-4]
                     for f in os.listdir(tmp_path / "j")}
    assert names == set(TAP_NAMES)
    # one dump of each layer-level name per forward: prefill + decode steps
    n_fwd = sum(f.endswith("_L0_attn_norm.npy")
                for f in os.listdir(tmp_path / "t"))
    assert n_fwd == len(rt.token_ids[0]) + 1
    assert debug.compare_dumps(str(tmp_path / "j"), str(tmp_path / "t"),
                               atol=1e-4, rtol=1e-4) == []


def test_tap_diff_catches_divergence(tmp_path):
    jp, _ = _weights(0)
    _, tp1 = _weights(1)
    _jax_run(tmp_path / "j", jp, None, True)
    _port_run(tmp_path / "t", tp1, None, True)
    bad = debug.compare_dumps(str(tmp_path / "j"), str(tmp_path / "t"),
                              atol=1e-4, rtol=1e-4)
    assert any("layer_out" in n for n in bad)


def test_tap_disabled_is_free(tmp_path, monkeypatch):
    """A disabled tap writes nothing, and the forward neither calls it nor
    computes the layer output it would dump."""
    assert not debug.tap.enabled

    def refuse(*args, **kwargs):
        raise AssertionError("called with the tap disabled")
    monkeypatch.setattr(llama, "add_residual", refuse)
    monkeypatch.setattr(debug.DebugTap, "__call__", refuse)
    _, tp = _weights(0)
    _port_run(None, tp, None, False)
    assert not os.listdir(tmp_path)


def test_tap_keeps_max_layers_and_reads_the_env(tmp_path, monkeypatch):
    _, tp = _weights(0)
    debug.set_dump_dir(str(tmp_path / "one"), max_layers=1)
    try:
        eng = InferenceEngine(CFG, EngineConfig(max_batch_size=1,
                                                max_seq_len=32), tp)
        eng.prefill([PROMPT])
    finally:
        debug.set_dump_dir(None)
    names = sorted(f.split("_", 1)[1] for f in os.listdir(tmp_path / "one"))
    assert any(n.startswith("L0_") for n in names)
    assert not any(n.startswith("L1_") for n in names)
    monkeypatch.setenv("LLM_TPU_SAVE_LAYERS", "7")
    monkeypatch.setenv("LLM_TPU_SAVE_DATA", str(tmp_path / "env"))
    tap = debug.DebugTap()
    assert tap.enabled and tap.max_layers == 7
    tap("x", torch.arange(3, dtype=torch.bfloat16), layer=2)
    (f,) = os.listdir(tmp_path / "env")
    assert f == "0001_L2_x.npy"
    np.testing.assert_array_equal(np.load(tmp_path / "env" / f),
                                  np.arange(3, dtype=np.float32))


@pytest.mark.parametrize("watch", ["tap", "guard"])
def test_decode_programs_run_eagerly_while_watched(tmp_path, watch):
    """With the tap enabled or a guard active, decode_graph.run calls the
    body instead of capturing or replaying a graph."""
    calls = []
    owner = types.SimpleNamespace(_programs={},
                                  _x_body=lambda: calls.append(1))
    if watch == "tap":
        debug.set_dump_dir(str(tmp_path))
        try:
            decode_graph.run(owner, "x")
        finally:
            debug.set_dump_dir(None)
    else:
        nan_guard(decode_graph.run)(owner, "x")
    assert calls == [1] and owner._programs == {}


def test_host_reads_refuse_capture(monkeypatch):
    """Under a CUDA graph capture the dump, peek, assert_finite and
    nan_guard raise, naming themselves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    on_card = types.SimpleNamespace(is_cuda=True)
    for what in ("TensorDumper.dump", "peek", "assert_finite"):
        with pytest.raises(RuntimeError, match=what):
            checks.refuse_capture(what, on_card)
    with pytest.raises(RuntimeError, match="nan_guard"):
        nan_guard(lambda: None)()
    # a CPU tensor is never captured
    checks.refuse_capture("peek", torch.zeros(1))


def test_peek_prints(capsys):
    debug.peek("x", torch.arange(12.0).reshape(3, 4), num=4)
    assert capsys.readouterr().out == "x: [0. 1. 2. 3.]\n"


# ---------------------------------------------------------------------------
# nan_guard / assert_finite
# ---------------------------------------------------------------------------

def _forward(params):
    cache = kvc.new_kv_cache(CFG.num_layers, 2, CFG.num_kv_heads, 32,
                             CFG.head_dim, dtype=CFG.dtype)
    toks = torch.tensor([[1, 5, 9, 13, 2, 7, 3, 11]] * 2, dtype=torch.int32)
    q = torch.zeros(2, dtype=torch.int32)
    kv = torch.tensor([8, 5], dtype=torch.int32)
    return llama.forward_all_logits(CFG, EngineConfig(max_batch_size=2,
                                                      max_seq_len=32),
                                    params, toks, cache, q, kv)[0]


def test_nan_guard_passes_a_clean_forward():
    _, tp = _weights(0)
    torch.testing.assert_close(nan_guard(_forward)(tp), _forward(tp),
                               rtol=0, atol=0)
    assert nan_guard(lambda x: (x * 2.0).sum())(torch.ones(4, 4)) == 32.0


@pytest.mark.parametrize("where,op", [
    ("wo", "aten.mm"),             # a dense projection
    ("ffn_norm", "aten.mul"),      # kernel A's plain route (rmsnorm_torch)
])
def test_nan_guard_names_the_op_of_a_planted_nan(where, op):
    _, tp = _weights(0)
    w = tp["layers"][where]
    w[1].view(-1)[3] = float("nan")
    with pytest.raises(FloatingPointError, match=f"NaN generated by {op}"):
        nan_guard(_forward)(tp)


def test_nan_guard_catches_nan_and_div():
    with pytest.raises(FloatingPointError, match="aten.log"):
        nan_guard(lambda x: torch.log(x).sum())(-torch.ones(4))
    with pytest.raises(FloatingPointError, match="NaN"):
        nan_guard(lambda x: x / x.sum())(torch.zeros(4))     # 0/0
    with pytest.raises(FloatingPointError, match="Inf generated by"):
        nan_guard(lambda x: 1.0 / x)(torch.zeros(4))
    assert torch.isinf(nan_guard(lambda x: 1.0 / x, div=False)(
        torch.zeros(4))).all()
    # a factory op's arbitrary bits are not a result
    nan_guard(lambda: torch.empty(64).fill_(1.0))()


def test_nan_guard_checks_kernel_outputs():
    """A kernel launched through ctypes is out of the dispatcher's sight:
    its wrapper hands the outputs to kernel_output, which the guard
    checks, naming the kernel (a stacked cache at its layer)."""
    bad = torch.tensor([1.0, float("nan")])
    checks.kernel_output("rmsnorm", bad)          # no guard: nothing
    with pytest.raises(FloatingPointError, match="kernel rmsnorm"):
        nan_guard(lambda: checks.kernel_output("rmsnorm", bad))()
    cache = torch.zeros(3, 4)
    cache[2, 1] = float("inf")
    nan_guard(lambda: checks.kernel_output("kv_write", cache, layer=1))()
    with pytest.raises(FloatingPointError, match="Inf generated by kernel "
                       "kv_write"):
        nan_guard(lambda: checks.kernel_output("kv_write", cache,
                                               layer=2))()
    assert not checks.guarding()


def test_assert_finite(capsys):
    assert_finite("x", torch.ones(8))
    assert "non-finite" not in capsys.readouterr().out
    x = torch.ones(8)
    x[2], x[5] = float("nan"), float("inf")
    assert_finite("x", x)
    assert capsys.readouterr().out == "[checks] x: 2 non-finite of 8\n"


# ---------------------------------------------------------------------------
# profiling and logging
# ---------------------------------------------------------------------------

def test_timer_report_equals_the_jax_packages():
    timers = [profiling.Timer(), j_profiling.Timer()]
    for t in timers:
        t.totals.update(prefill=0.0123, decode=0.25, sample=1e-5)
        t.counts.update(prefill=2, decode=64, sample=3)
    assert timers[0].report() == timers[1].report()
    with timers[0].section("s"):
        pass
    assert timers[0].counts["s"] == 1 and "s: " in timers[0].report()


def test_timeit_fence_and_trace(tmp_path):
    x = torch.ones(64, 64)
    assert 0.0 < profiling.timeit(torch.mm, x, x, repeats=2) < 60.0
    profiling.fence({"a": [None, x]})
    profiling.fence(None)
    with profiling.trace(str(tmp_path)) as prof:
        (x @ x).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


def test_get_logger_honours_the_level_variable(monkeypatch):
    root = logging.getLogger("llm_inference_engine_tpu_torch")
    handlers, level = list(root.handlers), root.level
    monkeypatch.setattr(t_logging, "_configured", False)
    monkeypatch.setenv("LLM_TPU_LOG_LEVEL", "debug")
    try:
        log = t_logging.get_logger("evals")
        assert log.name == "llm_inference_engine_tpu_torch.evals"
        assert log.isEnabledFor(logging.DEBUG)
        assert j_logging.get_logger("evals").name == (
            "llm_inference_engine_tpu.evals")
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
    monkeypatch.setattr(t_logging, "_configured", False)
    monkeypatch.setenv("LLM_TPU_LOG_LEVEL", "ERROR")
    try:
        assert not t_logging.get_logger("x").isEnabledFor(logging.WARNING)
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)

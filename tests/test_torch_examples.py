"""The port's example drivers (``examples_torch/``) on the CPU: each runs to
its end with ``--device cpu``; each refuses a missing card rather than
fall back to the CPU; a fault planted in the port function a driver holds
(its output perturbed) makes the driver exit 1; and no driver imports
JAX or the JAX package.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
DRIVERS = ("run_attention_prefill", "run_attention_decode", "run_ffn",
           "run_decoder", "run_engine_generate", "run_quantized",
           "run_sharded_tp", "run_beam_search", "run_speculative",
           "run_context_parallel", "run_serving_stack")


def _driver(name):
    return importlib.import_module(f"examples_torch.{name}")


def test_every_jax_driver_has_a_port():
    jax_side = {p.stem for p in (REPO / "examples").glob("run_*.py")}
    port = {p.stem for p in (REPO / "examples_torch").glob("run_*.py")}
    assert jax_side == port == set(DRIVERS)


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_runs_on_the_cpu(name, capsys):
    torch.set_num_threads(2)
    _driver(name).main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[OK]" in out and "[FAIL]" not in out


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_refuses_a_missing_card(name):
    """The default device is the card; without one the driver exits
    before any work, it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        _driver(name).main([])


def _shifted(fn, delta):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, tuple):
            return (out[0] + delta,) + out[1:]
        return out + delta
    return wrapped


def _plant_attention(monkeypatch, mod):
    monkeypatch.setattr(mod, "attention", _shifted(mod.attention, 1e-2))


def _plant_decode(monkeypatch, mod):
    monkeypatch.setattr(mod, "attention_decode_fused",
                        _shifted(mod.attention_decode_fused, 1e-2))


def _plant_ffn(monkeypatch, mod):
    monkeypatch.setattr(mod, "silu_and_mul", _shifted(mod.silu_and_mul, 1e-3))


def _plant_quantized(monkeypatch, mod):
    monkeypatch.setattr(mod, "quantized_linear",
                        _shifted(mod.quantized_linear, 1e-2))


def _plant_generate(monkeypatch, mod):
    real = mod.InferenceEngine.generate

    def generate(self, *args, **kwargs):
        res = real(self, *args, **kwargs)
        res.token_ids[1][3] = (res.token_ids[1][3] + 1) % 256
        return res
    monkeypatch.setattr(mod.InferenceEngine, "generate", generate)


def _plant_sharded(monkeypatch, mod):
    real = mod.sharding.make_sharded_forward

    def make(*args, **kwargs):
        return _shifted(real(*args, **kwargs), 1e-2)
    monkeypatch.setattr(mod.sharding, "make_sharded_forward", make)


def _plant_beam(monkeypatch, mod):
    real = mod.beam_search

    def search(*args, **kwargs):
        res = real(*args, **kwargs)
        res.scores[:] = [s + 0.1 for s in res.scores]
        return res
    monkeypatch.setattr(mod, "beam_search", search)


FAULTS = {"run_attention_prefill": _plant_attention,
          "run_attention_decode": _plant_decode,
          "run_ffn": _plant_ffn,
          "run_quantized": _plant_quantized,
          "run_engine_generate": _plant_generate,
          "run_sharded_tp": _plant_sharded,
          "run_beam_search": _plant_beam}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_planted_fault_exits_1(name, monkeypatch, capsys):
    torch.set_num_threads(2)
    mod = _driver(name)
    FAULTS[name](monkeypatch, mod)
    with pytest.raises(SystemExit) as e:
        mod.main(["--device", "cpu"])
    assert e.value.code == 1
    assert "[FAIL]" in capsys.readouterr().out


@pytest.mark.parametrize("path", sorted(
    (REPO / "examples_torch").glob("*.py")), ids=lambda p: p.name)
def test_driver_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "llm_inference_engine_tpu")]
    assert not bad, bad


def test_drivers_import_no_jax_at_run_time():
    """Importing every driver (and the quantization proxy) loads neither
    JAX nor the JAX package."""
    code = ("import sys\n"
            + "".join(f"import examples_torch.{n}\n" for n in DRIVERS)
            + "import llm_inference_engine_tpu_torch.tools.quant_divergence\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'llm_inference_engine_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]

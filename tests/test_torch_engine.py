"""Slice parity: the PyTorch port's forward pass and engine against the JAX
package, on the CPU.

The JAX dummy weights cross over through ``params_from_numpy``, so both
packages run the same model. The JAX side runs its CPU path (XLA ops;
its Pallas kernels are the subject of tests/test_torch_ops.py). The port
runs its plain versions, as it does on every CPU tensor.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models import llama as j_llama
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.ops import kv_cache as j_kvc
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models import llama
from llm_inference_engine_tpu_torch.models.registry import create_engine
from llm_inference_engine_tpu_torch.models.weights import (
    init_dummy_params, param_bytes, param_count, params_from_numpy)
from llm_inference_engine_tpu_torch.ops import _native
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.runtime.engine import (
    InferenceEngine, check_kernel_dtypes)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _crossed(cfg_j, seed=0):
    """JAX dummy params and the same values as port params."""
    jp = j_init_dummy_params(cfg_j, seed)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _port_cfg(cfg_j) -> ModelConfig:
    return ModelConfig(**{f: getattr(cfg_j, f)
                          for f in ModelConfig.__dataclass_fields__})


# f32: same math on both sides, only summation order differs. bf16: both
# round at the same points, but a 1-ulp flip (~4e-3 relative) in one
# activation propagates through both layers to logits of magnitude ~1.
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_forward_hidden_logits_match_jax(rng, dtype, tol):
    cfg_j = j_get_config("debug")
    if dtype == "bfloat16":
        cfg_j = cfg_j.replace(dtype_name="bfloat16", head_dim=128)
    cfg = _port_cfg(cfg_j)
    eng_j, eng = JEngineConfig(kernels="xla"), EngineConfig()
    jp, tp = _crossed(cfg_j)
    B, S, T = 3, 32, 8
    ids = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    q_start = np.array([0, 4, 20], np.int32)
    kv_len = q_start + np.array([8, 5, 1], np.int32)

    jc = j_kvc.new_kv_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                            cfg.head_dim, dtype=cfg_j.dtype)
    want, jc = j_llama.forward_hidden(cfg_j, eng_j, jp, jnp.asarray(ids), jc,
                                      jnp.asarray(q_start),
                                      jnp.asarray(kv_len))
    tc = kvc.new_kv_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                          cfg.head_dim, dtype=cfg.dtype)
    got, tc = llama.forward_hidden(cfg, eng, tp, torch.from_numpy(ids), tc,
                                   torch.from_numpy(q_start),
                                   torch.from_numpy(kv_len))
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    np.testing.assert_array_equal(tc.lengths.numpy(), kv_len)


def test_generate_greedy_ids_match_jax_over_two_rounds(rng):
    """Three ragged prompts, one longer than max_prefill_len (chunked),
    16 greedy tokens; then a second round appended to the same slots."""
    cfg_j = j_get_config("debug")
    jp, tp = _crossed(cfg_j, seed=3)
    kw = dict(max_batch_size=4, max_seq_len=128, max_prefill_len=32)
    je = JInferenceEngine(cfg_j, JEngineConfig(**kw), jp)
    te = InferenceEngine(get_config("debug"), EngineConfig(**kw), tp)
    for lens in [(5, 40, 17), (3, 9, 20)]:
        prompts = [rng.integers(3, 256, n).tolist() for n in lens]
        rj = je.generate(prompts, JSamplingParams(greedy=True,
                                                  max_new_tokens=16),
                         eos_token_id=None)
        rt = te.generate(prompts, SamplingParams(greedy=True,
                                                 max_new_tokens=16),
                         eos_token_id=None)
        assert rt.token_ids == rj.token_ids
        assert rt.num_generated == [16, 16, 16]
        np.testing.assert_allclose(np.array(rt.logprobs),
                                   np.array(rj.logprobs), atol=1e-4)
        np.testing.assert_array_equal(te.cache.lengths.numpy(),
                                      np.asarray(je.cache.lengths))


def test_sample_and_decode_rollout_match_jax(rng):
    """The low-level API: prefill, greedy sample() with logprobs and
    penalty counting, then an 8-step greedy decode_rollout."""
    cfg_j = j_get_config("debug")
    jp, tp = _crossed(cfg_j, seed=2)
    kw = dict(max_batch_size=3, max_seq_len=64, max_prefill_len=16)
    je = JInferenceEngine(cfg_j, JEngineConfig(**kw), jp)
    te = InferenceEngine(get_config("debug"), EngineConfig(**kw), tp)
    prompts = [rng.integers(3, 256, n).tolist() for n in (4, 21, 9)]
    lj, lt = je.prefill(prompts), te.prefill(prompts)
    arrays = (np.zeros(3, np.float32), np.full(3, 5, np.int32),
              np.ones(3, np.float32))
    mask = np.array([True, True, False])
    nj, lpj = je.sample(lj, *arrays, count_mask=mask, return_logprobs=True)
    nt, lpt = te.sample(lt, *arrays, count_mask=mask, return_logprobs=True)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(lpt.numpy(), np.asarray(lpj), atol=1e-5)
    np.testing.assert_array_equal(te._counts_gen.numpy(),
                                  np.asarray(je._counts_gen))
    rj = je.decode_rollout(nj, 8)
    rt = te.decode_rollout(nt, 8)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


def test_near_capacity_prefill_matches_jax(rng):
    """A near-full slot appended beside a fresh one: the batch splits, and
    the near slot runs an exact-fit 13-token chunk (no power-of-two bucket
    fits its 13 free rows)."""
    cfg_j = j_get_config("debug")
    jp, tp = _crossed(cfg_j, seed=5)
    kw = dict(max_batch_size=3, max_seq_len=64, max_prefill_len=32)
    je = JInferenceEngine(cfg_j, JEngineConfig(**kw), jp)
    te = InferenceEngine(get_config("debug"), EngineConfig(**kw), tp)
    for lens in [(51, 20), (13, 30)]:
        prompts = [rng.integers(3, 256, n).tolist() for n in lens]
        want = np.asarray(je.prefill(prompts))
        got = te.prefill(prompts).numpy()
        np.testing.assert_allclose(got[:2], want[:2], atol=1e-4, rtol=1e-4)
    assert te.cache.lengths.tolist() == [64, 50, 0]


def test_generate_stops_on_eos_and_streams():
    cfg = get_config("debug")
    te = InferenceEngine(cfg, EngineConfig(max_batch_size=2, max_seq_len=64),
                         init_dummy_params(cfg, seed=1))
    first = te.generate([[5, 6, 7]], SamplingParams(greedy=True,
                                                    max_new_tokens=6),
                        eos_token_id=None).token_ids[0]
    te.reset()
    seen = []
    res = te.generate([[5, 6, 7]], SamplingParams(greedy=True,
                                                  max_new_tokens=6),
                      eos_token_id=first[2],
                      stream_callback=lambda i, t: seen.append(t))
    assert res.token_ids[0] == first[:first.index(first[2])]
    assert seen == res.token_ids[0]


def test_sampled_generate_is_seeded():
    cfg = get_config("debug")
    sp = SamplingParams(temperature=0.8, top_k=5, max_new_tokens=8)
    outs = []
    for _ in range(2):
        te = InferenceEngine(cfg, EngineConfig(max_batch_size=2,
                                               max_seq_len=64),
                             init_dummy_params(cfg, seed=1), rng_seed=11)
        outs.append(te.generate([[1, 2, 3], [4, 5]], sp,
                                eos_token_id=None).token_ids)
    assert outs[0] == outs[1]
    assert all(len(o) == 8 for o in outs[0])


def test_prefill_refuses_chunk_past_capacity():
    cfg = get_config("debug")
    te = InferenceEngine(cfg, EngineConfig(max_batch_size=1, max_seq_len=32,
                                           max_prefill_len=16),
                         init_dummy_params(cfg))
    te.prefill([list(range(1, 30))])
    with pytest.raises(ValueError, match="remaining capacity"):
        te.prefill([list(range(1, 6))])


def test_create_engine_dummy_and_unported_paths():
    eng = create_engine("debug", None, EngineConfig(max_batch_size=2,
                                                    max_seq_len=32),
                        device="cpu")
    cfg = get_config("debug")
    assert param_count(eng.params) == (
        2 * cfg.vocab_size * cfg.hidden_size + cfg.hidden_size
        + cfg.num_layers * (2 * cfg.hidden_size
                            + cfg.hidden_size * cfg.qkv_size
                            + cfg.q_size * cfg.hidden_size
                            + 3 * cfg.hidden_size * cfg.intermediate_size))
    # checkpoint directories are ported: a missing one is not found
    with pytest.raises(FileNotFoundError):
        create_engine("debug", "/nonexistent/checkpoint", device="cpu")
    # meshes are ported (a tp = 2 CPU engine is a mesh of two CPU ranks,
    # a cp = 2 one a mesh with a seq axis); cp refuses the paged pool
    e2 = create_engine("debug", None, EngineConfig(max_batch_size=2,
                                                   max_seq_len=32, tp=2),
                       device="cpu")
    assert e2.mesh.shape == {"data": 1, "model": 2}
    e3 = create_engine("debug", None, EngineConfig(max_batch_size=2,
                                                   max_seq_len=32, cp=2),
                       device="cpu")
    assert e3.mesh.shape == {"data": 1, "seq": 2, "model": 1}
    with pytest.raises(NotImplementedError, match="paged"):
        create_engine("debug", None, EngineConfig(cp=2, kv_layout="paged"),
                      device="cpu")
    # the int8 KV cache is ported in both layouts
    for kw in (dict(), dict(kv_layout="paged", max_prefill_len=16)):
        e8 = create_engine("debug", None, EngineConfig(
            max_batch_size=2, max_seq_len=32, kv_cache_dtype_name="int8",
            **kw), device="cpu")
        assert e8.cache.quantized and e8.cache.k.dtype == torch.int8
    for bad in (dict(kernels="pallas"), dict(quant_mode="int2")):
        with pytest.raises(ValueError):
            EngineConfig(**bad)
    # quant_mode="int4" is ported: born-quantized dummy weights, q and
    # scale counted as the JAX package counts its leaves
    g = 64
    q4 = create_engine("debug", None, EngineConfig(
        max_batch_size=2, max_seq_len=32, quant_mode="int4",
        quant_group_size=g), device="cpu")
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    quant = [(H, cfg.qkv_size), (cfg.q_size, H), (H, 2 * I), (I, H)]
    packed = cfg.num_layers * sum(k * n // 2 for k, n in quant) + H * V // 2
    scales = cfg.num_layers * sum(k // g * n for k, n in quant) + H // g * V
    dense = V * H + H + cfg.num_layers * 2 * H
    assert param_count(q4.params) == dense + packed + scales
    assert param_bytes(q4.params) == 4 * dense + packed + 4 * scales
    assert q4.params["layers"]["w_gate_up"].q.shape == (
        cfg.num_layers, 2, H // 2, I)
    out = q4.generate([[1, 2, 3]], SamplingParams(greedy=True,
                                                  max_new_tokens=4),
                      eos_token_id=None)
    assert out.num_generated == [4]


@pytest.mark.parametrize("dtype,kv,device,kernels,refused", [
    ("float32", "", "cuda", "auto", None),
    # a float cache named other than the model's dtype is the model's
    # dtype, as in the JAX engine (the names kept from when it was refused)
    pytest.param("float32", "bfloat16", "cuda", "cuda", None,
                 id="float32-bfloat16-cuda-cuda-KV cache dtype "
                 "torch.bfloat16 with a torch.float32 model"),
    pytest.param("bfloat16", "float32", "cuda", "auto", None,
                 id="bfloat16-float32-cuda-auto-KV cache dtype "
                 "torch.float32 with a torch.bfloat16 model"),
    ("float16", "", "cuda", "auto", None),
    ("float32", "", "cuda", "torch", None),
    ("float32", "", "cpu", "auto", None),
    ("bfloat16", "", "cuda", "auto", None),
    ("bfloat16", "int8", "cuda", "auto", None),
    ("float64", "", "cuda", "auto", "model dtype torch.float64"),
    ("float64", "", "cuda", "torch", None)])
def test_kernel_dtype_check_refuses_before_allocating(dtype, kv, device,
                                                      kernels, refused):
    """On a CUDA device the kernels take a bf16, f16 or f32 model, with a
    cache of the model's dtype or int8 whatever float the cache's name
    gives; a model dtype no kernel takes (float64, carried by a stand-in
    config: no preset names it) is refused before the engine allocates
    (here its params lie on the CPU and no card exists, so any allocation
    on the device would fail otherwise)."""
    import types
    f64 = dtype == "float64"
    cfg = get_config("debug").replace(dtype_name="float32" if f64 else dtype)
    eng = EngineConfig(max_batch_size=2, max_seq_len=32,
                       kv_cache_dtype_name=kv, kernels=kernels)
    checked = types.SimpleNamespace(name=cfg.name, dtype=torch.float64) \
        if f64 else cfg
    if refused is None:
        check_kernel_dtypes(checked, eng, torch.device(device))
        return
    with pytest.raises(ValueError, match=refused):
        check_kernel_dtypes(checked, eng, torch.device(device))
    params = init_dummy_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match=refused):
        InferenceEngine(checked, eng, params, device=device)


@pytest.mark.parametrize("factory", ["create_engine", "create_dummy_engine",
                                     "create_real_engine"])
def test_factories_run_on_the_card_unless_asked_for_the_cpu(factory):
    """With no device argument the factories build on the card; where
    there is none they raise rather than build on the CPU."""
    from llm_inference_engine_tpu_torch.models import registry
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    args = ("debug", "w.npz") if factory == "create_real_engine" \
        else ("debug",)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(registry, factory)(*args)


@pytest.mark.parametrize("quant_mode", ["none", "int4"])
def test_create_engine_takes_a_model_config(quant_mode):
    """A ModelConfig (here the debug preset cut to one layer) builds the
    same seed's dummy engine as its preset would, at the config's depth."""
    from llm_inference_engine_tpu_torch.models import registry
    from llm_inference_engine_tpu_torch.models import weights as W
    cfg = get_config("debug").replace(num_layers=1)
    eng = EngineConfig(max_batch_size=1, max_seq_len=32,
                       quant_mode=quant_mode, quant_group_size=32)
    engine = registry.create_engine(cfg, None, eng, seed=3, device="cpu")
    assert engine.config == cfg
    want = (W.init_dummy_quantized_params(cfg, "int4", 32, seed=3,
                                          device="cpu")
            if quant_mode == "int4" else W.init_dummy_params(cfg, seed=3,
                                                   device="cpu"))
    got = engine.params
    assert torch.equal(got["embed"], want["embed"])
    layer = got["layers"]["wo"]
    ref = want["layers"]["wo"]
    if quant_mode == "int4":
        assert torch.equal(layer.q, ref.q) and torch.equal(layer.scale,
                                                           ref.scale)
    else:
        assert torch.equal(layer, ref)


def test_package_imports_no_jax():
    code = (
        "import sys\n"
        "import llm_inference_engine_tpu_torch\n"
        "import llm_inference_engine_tpu_torch.ops\n"
        "import llm_inference_engine_tpu_torch.ops._native\n"
        "import llm_inference_engine_tpu_torch.models.registry\n"
        "import llm_inference_engine_tpu_torch.runtime.engine\n"
        "import llm_inference_engine_tpu_torch.runtime.scheduler\n"
        "import llm_inference_engine_tpu_torch.runtime.prefix_cache\n"
        "import llm_inference_engine_tpu_torch.runtime.chat_template\n"
        "import llm_inference_engine_tpu_torch.ops.paged_kv\n"
        "import llm_inference_engine_tpu_torch.cli\n"
        "import llm_inference_engine_tpu_torch.server\n"
        "import llm_inference_engine_tpu_torch.native\n"
        "import llm_inference_engine_tpu_torch.runtime.native_io\n"
        "import llm_inference_engine_tpu_torch.runtime.session\n"
        "import llm_inference_engine_tpu_torch.runtime.speculative\n"
        "import llm_inference_engine_tpu_torch.runtime.speculative_scheduler\n"
        "import llm_inference_engine_tpu_torch.runtime.beam_search\n"
        "import llm_inference_engine_tpu_torch.tokenizer\n"
        "import llm_inference_engine_tpu_torch.tokenizer.bpe\n"
        "import llm_inference_engine_tpu_torch.tokenizer.bytelevel\n"
        "import llm_inference_engine_tpu_torch.tokenizer.native\n"
        "import llm_inference_engine_tpu_torch.tools.quantize\n"
        "import llm_inference_engine_tpu_torch.tools.quant_divergence\n"
        "import llm_inference_engine_tpu_torch.parallel\n"
        "import llm_inference_engine_tpu_torch.parallel.mesh\n"
        "import llm_inference_engine_tpu_torch.parallel.sharding\n"
        "import llm_inference_engine_tpu_torch.parallel.multihost\n"
        "import llm_inference_engine_tpu_torch.parallel.context_parallel\n"
        "import llm_inference_engine_tpu_torch.parallel.cp_cache\n"
        "import llm_inference_engine_tpu_torch.parallel.cp_engine\n"
        "import llm_inference_engine_tpu_torch.parallel.pipeline\n"
        "import llm_inference_engine_tpu_torch.runtime.multihost_scheduler\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('llm_inference_engine_tpu.')"
        " or m == 'llm_inference_engine_tpu'"
        # the card machine has none of these: imported lazily or never
        " or m in ('ml_dtypes', 'regex', 'tokenizers', 'safetensors')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr


_FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
text = "".join(open(p).read() for p in args[args.index("-o") + 2:])
if "-c" in args and "COMPILE_ERROR" in text:
    sys.exit("fake nvcc: compile error")
if "-shared" in args and "LINK_ERROR" in text:
    sys.exit("fake nvcc: link error")
open(out, "w").write(text)
"""


def _c_entry_points():
    """{name: [ctypes type per parameter]} of every ``extern "C" int
    name(...)`` in csrc/*.cu, and the names defined more than once."""
    import ctypes
    import re
    found, twice = {}, []
    for src in sorted(_native.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            types = [ctypes.c_void_p if "*" in p
                     else ctypes.c_longlong if p.startswith("long long")
                     else ctypes.c_float if p.startswith("float")
                     else ctypes.c_int if p.startswith("int") else p
                     for p in params]
            if m.group(1) in found:
                twice.append(m.group(1))
            found[m.group(1)] = types
    return found, twice


@pytest.mark.parametrize("name", sorted(_native._SIGNATURES))
def test_native_entry_point_matches_its_signature(name):
    """Before any build on the card: each entry point that ``_native``
    binds is defined exactly once across csrc/*.cu, with the parameter
    types its ctypes signature lists (a pointer as c_void_p, int, float,
    long long), in order."""
    found, twice = _c_entry_points()
    assert name in found, f"{name} is defined in no csrc/*.cu"
    assert name not in twice, f"{name} is defined more than once"
    assert found[name] == _native._SIGNATURES[name]


def test_chip_smoke_sources_exist_and_entry_points_are_bound():
    """Every source that chip_smoke.py names for a kernel row exists, and
    every C entry point of csrc/*.cu has a ctypes signature."""
    import importlib.util
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke_sources",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)       # standard library only at load
    assert set(smoke.SOURCES) == set(smoke.REPLACES)
    for name, (route, path) in smoke.SOURCES.items():
        assert route in ("cuda", "triton"), name
        assert (root / path).is_file(), f"{name}: {path} missing"
    found, _ = _c_entry_points()
    assert set(found) == set(_native._SIGNATURES)


@pytest.mark.parametrize("fault", [None, "COMPILE_ERROR", "LINK_ERROR"])
def test_kernel_build_raises_on_nvcc_failure_and_cleans_up(
        tmp_path, monkeypatch, fault):
    """The build compiles each source (a stand-in nvcc copies it to its
    object), links the objects, reuses a library of the same source hash,
    and raises on a failed compile or link, leaving nothing behind."""
    from llm_inference_engine_tpu_torch.ops import _native
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("int a;\n")
    (csrc / "b.cu").write_text(f"int b; // {fault}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_native, "CSRC", csrc)
    monkeypatch.setattr(_native, "BUILD_DIR", build)
    monkeypatch.setattr(_native, "nvcc_path", lambda: str(nvcc))
    if fault is None:
        lib, _ = _native.build()
        assert [p.name for p in build.iterdir()] == [lib.name]
        assert lib.read_text() == "int a;\nint b; // None\n"
        assert _native.build() == (lib, 0.0)
    else:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _native.build()
        assert list(build.iterdir()) == []

"""Checkpoint loading in the PyTorch port against the JAX package, on the
CPU: the native reader and its casts (``runtime/native_io.py``), the HF
safetensors and reference ``.bin`` loaders, ``create_engine`` from a
checkpoint directory, and the offline quantizer.

Checkpoints are tiny and written by the test (debug widths, a few
layers). The loaders must give the JAX loaders' parameters bit for bit;
engines built from the same files must give the same greedy ids.
"""

import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models import registry as j_registry
from llm_inference_engine_tpu.models import weights as j_weights
from llm_inference_engine_tpu.runtime import native_io as j_io
from llm_inference_engine_tpu.tools import quantize as j_quantize

from llm_inference_engine_tpu_torch import native
from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingParams)
from llm_inference_engine_tpu_torch.models import weights
from llm_inference_engine_tpu_torch.models.registry import create_engine
from llm_inference_engine_tpu_torch.ops import quant
from llm_inference_engine_tpu_torch.runtime import native_io
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.tools import quantize as t_quantize

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=["native", "python"])
def reader(request, monkeypatch):
    """Both packages on the native library, or both on their pure-Python
    paths."""
    if request.param == "native":
        assert native.native_available()
        assert j_io.load_native() is not None
    else:
        monkeypatch.setattr(native_io, "load_native", lambda: None)
        monkeypatch.setattr(j_io, "load_native", lambda: None)
    return request.param


def _bits(x) -> np.ndarray:
    """Bit patterns of a torch tensor or a numpy / JAX array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[x.itemsize])


def _np(t: torch.Tensor) -> np.ndarray:
    """A torch tensor as the numpy array the JAX package would hold."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _special(rng, shape) -> np.ndarray:
    """f32 values with inf, -inf, NaNs of both signs and a NaN payload,
    and ties for round-to-nearest-even."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1).view(np.uint32)
    flat[:7] = [0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                0xFF812345, 0x3F808000, 0x3F818000]
    return x


# ---------------------------------------------------------------------------
# runtime/native_io.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [torch.float32, torch.float16,
                                 torch.bfloat16])
def test_casts_match_jax_with_inf_and_nan(rng, reader, src):
    x = torch.from_numpy(_special(rng, (37, 53))).to(src)
    jx = _np(x)
    for out in (torch.float32, torch.float16, torch.bfloat16):
        jdt = _np(torch.zeros(1, dtype=out)).dtype
        np.testing.assert_array_equal(
            _bits(native_io.cast_array(x, out)),
            _bits(j_io.cast_array(jx, jdt)))
        got = native_io.transpose_cast(x, out)
        assert got.shape == (53, 37)
        np.testing.assert_array_equal(_bits(got),
                                      _bits(j_io.transpose_cast(jx, jdt)))


@pytest.mark.parametrize("src", [torch.float32, torch.float16,
                                 torch.bfloat16])
def test_safetensors_reads_match_jax(rng, tmp_path, reader, src):
    tensors = {"w": torch.from_numpy(_special(rng, (24, 40))).to(src),
               "b": torch.from_numpy(rng.standard_normal(40)
                                     .astype(np.float32)).to(src),
               "i": torch.arange(-6, 6, dtype=torch.int8)}
    path = str(tmp_path / "a.safetensors")
    written = native_io.write_safetensors(path, tensors)
    assert written == os.path.getsize(path)
    before = dict(native_io.READ_BYTES)
    mine, theirs = native_io.SafeTensorsFile(path), j_io.SafeTensorsFile(path)
    assert mine.names == theirs.names == set(tensors)
    for name, t in tensors.items():
        assert mine.info(name) == (t.dtype, tuple(t.shape))
        np.testing.assert_array_equal(_bits(mine.get(name)),
                                      _bits(theirs.get(name)))
        np.testing.assert_array_equal(_bits(mine.get(name)), _bits(t))
    for out in (torch.float32, torch.float16, torch.bfloat16):
        jdt = _np(torch.zeros(1, dtype=out)).dtype
        np.testing.assert_array_equal(
            _bits(mine.get("w", dtype=out)),
            _bits(theirs.get("w", dtype=jdt)))
        np.testing.assert_array_equal(
            _bits(mine.get("w", dtype=out, transpose=True)),
            _bits(theirs.get("w", dtype=jdt, transpose=True)))
    # a staging buffer larger than the tensor: the read lands in its head
    buf = torch.full((4096,), 7, dtype=torch.uint8)
    np.testing.assert_array_equal(_bits(mine.raw("w", buf)),
                                  _bits(tensors["w"]))
    moved = {k: native_io.READ_BYTES[k] - before[k] for k in before}
    assert moved[reader] > 0 and moved[{"native": "python",
                                        "python": "native"}[reader]] == 0
    with pytest.raises(ValueError, match="staging"):
        mine.raw("w", torch.zeros(8, dtype=torch.uint8))
    for bad in (b"", b"\x10\x00", (1 << 40).to_bytes(8, "little") + b"{}"):
        (tmp_path / "bad.safetensors").write_bytes(bad)
        with pytest.raises(ValueError, match="not a safetensors file"):
            native_io.SafeTensorsFile(str(tmp_path / "bad.safetensors"))


def test_writer_is_read_by_the_safetensors_package(rng, tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    tensors = {"a": torch.from_numpy(rng.standard_normal((3, 5))
                                     .astype(np.float32)),
               "b": torch.arange(7, dtype=torch.float16),
               "c": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    path = str(tmp_path / "w.safetensors")
    native_io.write_safetensors(path, tensors)
    back = st.load_file(path)
    for name, t in tensors.items():
        np.testing.assert_array_equal(_bits(back[name]), _bits(t))


def test_bin_reads_match_jax(rng, tmp_path, reader):
    x = _special(rng, (12, 20))
    path = str(tmp_path / "t.bin")
    x.tofile(path)
    got = native_io.read_bin_tensor(path, (12, 20))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(j_io.read_bin_tensor(path, (12, 20))))
    np.testing.assert_array_equal(
        _bits(native_io.read_bin_tensor(path, (12, 20), torch.float32,
                                        torch.bfloat16)),
        _bits(j_io.read_bin_tensor(path, (12, 20), "float32",
                                   ml_dtypes.bfloat16)))


def test_native_library_is_the_ports_own_build():
    path = Path(native.library_path() or native._build())
    assert path.parent == REPO / "build" / "native"
    assert path.name.startswith("libllm_native_") and path.suffix == ".so"
    assert path != REPO / "csrc" / "build" / "libllm_native.so"
    for src in native._SOURCES:
        assert (REPO / "llm_inference_engine_tpu_torch" / "csrc" / src
                ).exists()


def test_native_library_ignores_the_jax_packages_override(monkeypatch,
                                                          tmp_path):
    """``$LLM_NATIVE_LIB`` points the JAX package at a prebuilt library;
    the port always loads its own build."""
    other = tmp_path / "libllm_native.so"
    other.write_bytes(b"")
    monkeypatch.setenv("LLM_NATIVE_LIB", str(other))
    for name, value in (("_lib", None), ("_lib_path", None),
                        ("_load_failed", False)):
        monkeypatch.setattr(native, name, value)
    lib = native.load_native()
    if lib is None:   # no toolchain here: the pure-Python path, no .so
        assert native.library_path() is None
    else:
        assert Path(native.library_path()).parent == REPO / "build" / "native"


def test_native_build_falls_back_without_a_toolchain(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native._build() is None


# ---------------------------------------------------------------------------
# models/weights.py loaders
# ---------------------------------------------------------------------------

def _port_cfg(cfg_j) -> ModelConfig:
    return ModelConfig(**{f: getattr(cfg_j, f)
                          for f in ModelConfig.__dataclass_fields__})


def _hf_tensors(cfg, rng, src=torch.bfloat16, bias=False, tied=False):
    """A random HF-format Llama state dict ([out, in] projections)."""
    Hd, I = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_kv_heads * cfg.head_dim

    def r(*shape, scale=0.05):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(src)
    out = {"model.embed_tokens.weight": r(cfg.vocab_size, Hd),
           "model.norm.weight": r(Hd, scale=1.0)}
    if not tied:
        out["lm_head.weight"] = r(cfg.vocab_size, Hd)
    for l in range(cfg.num_layers):
        p = f"model.layers.{l}."
        out.update({
            p + "self_attn.q_proj.weight": r(cfg.num_heads * cfg.head_dim, Hd),
            p + "self_attn.k_proj.weight": r(kv, Hd),
            p + "self_attn.v_proj.weight": r(kv, Hd),
            p + "self_attn.o_proj.weight": r(Hd, cfg.num_heads * cfg.head_dim),
            p + "mlp.gate_proj.weight": r(I, Hd),
            p + "mlp.up_proj.weight": r(I, Hd),
            p + "mlp.down_proj.weight": r(Hd, I),
            p + "input_layernorm.weight": r(Hd, scale=1.0),
            p + "post_attention_layernorm.weight": r(Hd, scale=1.0)})
        if bias:
            out.update({p + "self_attn.q_proj.bias": r(cfg.num_heads
                                                       * cfg.head_dim),
                        p + "self_attn.k_proj.bias": r(kv),
                        p + "self_attn.v_proj.bias": r(kv)})
    return out


def _write_hf(path: Path, tensors: dict, shards: int = 2) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    names = list(tensors)
    for i in range(shards):
        part = {n: tensors[n] for n in names[i::shards]}
        native_io.write_safetensors(
            str(path / f"model-{i + 1:05d}-of-{shards:05d}.safetensors"), part)
    return path


def _cmp_params(pp: dict, jp: dict) -> None:
    assert pp.keys() == jp.keys()
    for key, jv in jp.items():
        pv = pp[key]
        if isinstance(jv, dict):
            _cmp_params(pv, jv)
        elif hasattr(jv, "q"):           # a JAX QuantizedTensor
            assert isinstance(pv, quant.QuantizedTensor), key
            assert (pv.mode, pv.group_size) == (jv.mode, jv.group_size)
            np.testing.assert_array_equal(pv.q.numpy(), np.asarray(jv.q))
            np.testing.assert_array_equal(pv.scale.numpy(),
                                          np.asarray(jv.scale))
        else:
            assert pv.dtype == {"bfloat16": torch.bfloat16,
                                "float32": torch.float32}[str(jv.dtype)], key
            assert tuple(pv.shape) == jv.shape, key
            assert pv.is_contiguous(), key
            np.testing.assert_array_equal(_bits(pv), _bits(jv), err_msg=key)


# GQA with a Qwen2-style qkv bias in two shards (bf16 model from F32, F16
# and BF16 files; f32 model from BF16 files), and a tied-embedding model
@pytest.mark.parametrize("model_dtype,src,bias,tied", [
    ("bfloat16", torch.float32, True, False),
    ("bfloat16", torch.float16, True, False),
    ("bfloat16", torch.bfloat16, True, False),
    ("float32", torch.bfloat16, False, True)])
def test_load_hf_safetensors_matches_jax(rng, tmp_path, reader, model_dtype,
                                         src, bias, tied):
    cfg_j = j_get_config("debug").replace(dtype_name=model_dtype,
                                          attention_bias=bias,
                                          tie_word_embeddings=tied)
    ckpt = _write_hf(tmp_path / "hf", _hf_tensors(cfg_j, rng, src, bias,
                                                  tied))
    jp = j_weights.load_hf_safetensors(cfg_j, str(ckpt))
    pp = weights.load_hf_safetensors(_port_cfg(cfg_j), str(ckpt))
    assert ("bqkv" in pp["layers"]) == bias
    _cmp_params(pp, jp)


def _write_reference_bin(cfg, rng, path: Path) -> Path:
    """The reference engine's per-tensor f32 .bin files, q|k|v and
    gate|up fused [out, in]."""
    path.mkdir(parents=True, exist_ok=True)
    Hd, I = cfg.hidden_size, cfg.intermediate_size

    def put(name, *shape, scale=0.05):
        (rng.standard_normal(shape).astype(np.float32) * scale).tofile(
            path / (name + ".bin"))
    put("model.embed_tokens.weight", cfg.vocab_size, Hd)
    put("model.norm.weight", Hd, scale=1.0)
    put("lm_head.weight", cfg.vocab_size, Hd)
    for l in range(cfg.num_layers):
        p = f"model.layers.{l}."
        put(p + "self_attn.qkv.weight", cfg.qkv_size, Hd)
        put(p + "self_attn.o_proj.weight", Hd, cfg.q_size)
        put(p + "mlp.gate_up_proj.weight", 2 * I, Hd)
        put(p + "mlp.down_proj.weight", Hd, I)
        put(p + "input_layernorm.weight", Hd, scale=1.0)
        put(p + "post_attention_layernorm.weight", Hd, scale=1.0)
    return path


@pytest.mark.parametrize("model_dtype", ["bfloat16", "float32"])
def test_load_reference_bin_matches_jax(rng, tmp_path, reader, model_dtype):
    cfg_j = j_get_config("debug").replace(dtype_name=model_dtype)
    ckpt = _write_reference_bin(cfg_j, rng, tmp_path / "bin")
    _cmp_params(weights.load_reference_bin(_port_cfg(cfg_j), str(ckpt)),
                j_weights.load_reference_bin(cfg_j, str(ckpt)))
    # a file of the wrong size is refused, as in the JAX package
    name = ckpt / "model.norm.weight.bin"
    name.write_bytes(name.read_bytes()[:-4])
    with pytest.raises(ValueError, match="expected"):
        weights.load_reference_bin(_port_cfg(cfg_j), str(ckpt))


# ---------------------------------------------------------------------------
# create_engine from a directory, and the offline quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["hf", "bin"])
@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
def test_create_engine_from_a_directory_matches_jax(rng, tmp_path, kind,
                                                    mode):
    cfg_j = j_get_config("debug")
    ckpt = (_write_hf(tmp_path / "hf", _hf_tensors(cfg_j, rng,
                                                   torch.float32))
            if kind == "hf" else
            _write_reference_bin(cfg_j, rng, tmp_path / "bin"))
    kw = dict(max_batch_size=2, max_seq_len=64, max_prefill_len=32,
              quant_mode=mode, quant_group_size=64)
    je = j_registry.create_engine("debug", str(ckpt), JEngineConfig(**kw))
    te = create_engine("debug", str(ckpt), EngineConfig(**kw), device="cpu")
    _cmp_params(te.params, je.params)
    prompts = [rng.integers(3, 256, n).tolist() for n in (7, 19)]
    sp = dict(greedy=True, max_new_tokens=10)
    rj = je.generate(prompts, JSamplingParams(**sp), eos_token_id=None)
    rt = te.generate(prompts, SamplingParams(**sp), eos_token_id=None)
    assert rt.token_ids == rj.token_ids


def test_create_engine_refuses_a_missing_directory():
    with pytest.raises(FileNotFoundError):
        create_engine("debug", "/nonexistent/checkpoint", device="cpu")
    with pytest.raises(FileNotFoundError, match="safetensors"):
        weights.load_hf_safetensors(_port_cfg(j_get_config("debug")),
                                    str(REPO / "docs"))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_tool_npz_serves_the_jax_engine(rng, tmp_path, mode,
                                                 capsys):
    """The port's tools/quantize .npz, loaded by the JAX engine, gives the
    ids of the JAX tool's .npz (and equals it leaf for leaf)."""
    cfg_j = j_get_config("debug")
    ckpt = _write_hf(tmp_path / "hf", _hf_tensors(cfg_j, rng, torch.bfloat16))
    common = ["--model", "debug", "--checkpoint", str(ckpt), "--mode", mode,
              "--group-size", "64"]
    out_t, out_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    assert t_quantize.main(common + ["--out", out_t, "--device", "cpu"]) == 0
    assert j_quantize.main(common + ["--out", out_j]) == 0
    assert "wrote" in capsys.readouterr().out
    _cmp_params(weights.load_saved_params(out_t),
                j_weights.load_saved_params(out_j, device=False))
    kw = dict(max_batch_size=2, max_seq_len=64, quant_mode=mode,
              quant_group_size=64)
    prompts = [rng.integers(3, 256, n).tolist() for n in (9, 4)]
    sp = JSamplingParams(greedy=True, max_new_tokens=8)
    ids = [j_registry.create_engine("debug", p, JEngineConfig(**kw))
           .generate(prompts, sp, eos_token_id=None).token_ids
           for p in (out_t, out_j)]
    assert ids[0] == ids[1]


def test_quantize_script_runs_the_ports_tool():
    proc = subprocess.run([sys.executable, "tools/quantize.py", "--help"],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "llm-torch-quantize" in proc.stdout


def test_quantize_tool_refuses_what_is_not_ported(rng, tmp_path):
    """``--calibrate random:64`` writes an .npz that the JAX package's
    ``load_saved_params`` reads leaf for leaf as the port's in-process
    ``quantize_params_calibrated`` over the same 64 tokens; without a card
    the default ``--device cuda`` is refused."""
    cfg_j = j_get_config("debug")
    cfg = _port_cfg(cfg_j)
    ckpt = _write_hf(tmp_path / "hf", _hf_tensors(cfg_j, rng, torch.bfloat16))
    out = str(tmp_path / "cal.npz")
    args = ["--model", "debug", "--checkpoint", str(ckpt), "--mode", "int4",
            "--group-size", "64", "--out", out]
    assert t_quantize.main(args + ["--calibrate", "random:64",
                                   "--device", "cpu"]) == 0
    params = weights.load_hf_safetensors(cfg, str(ckpt))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 64))
    act_sq = weights.calibrate_act_sq(cfg, params, [toks.astype(np.int32)])
    want = weights.quantize_params_calibrated(params, act_sq, "int4", 64)
    _cmp_params(want, j_weights.load_saved_params(out, device=False))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_quantize.main(args)


def test_hf_llama_logits_match_the_loaded_engine(rng, tmp_path):
    """A tiny transformers LlamaForCausalLM saved with save_pretrained,
    loaded by the port: last-token logits of a prefill equal the HF
    model's (f32), as tests/test_hf_parity.py holds the JAX package."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg = ModelConfig(
        name="hf-tiny", vocab_size=128, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=16, rms_norm_eps=1e-5, rope_theta=10000.0,
        max_position_embeddings=128, dtype_name="float32")
    params = weights.load_hf_safetensors(cfg, str(tmp_path))
    eng = InferenceEngine(cfg, EngineConfig(max_batch_size=2,
                                            max_seq_len=64), params)
    ids = rng.integers(0, 128, size=(2, 12))
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits[:, -1].numpy()
    got = eng.prefill(ids.tolist()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


"""The decoder's final residual add, folded into the next norm, on the CPU.

Each layer of the port returns (down, residual) and hands their sum to the
norm that reads it next: the next layer's first norm, or the final norm,
is ``add_residual_rmsnorm(down, residual)`` (kernel A's residual mode on
the card). Held here, at the ``debug`` preset's shape widened to 3 layers
and hidden 256, in bf16 and f32:

- bit for bit against a loop written below that composes the unfolded
  ops (``rmsnorm`` first, ``add_residual`` at each layer's end, the final
  ``rmsnorm``): the fold stores the same f32 sum rounded once;
- against the JAX package's ``decoder_forward`` (its CPU path), within
  the tolerances of ``tests/test_torch_engine.py``: f32 1e-4 (summation
  order), bf16 2e-2 (a 1-ulp flip in one activation carries through the
  layers);
- by the launches it asks for: one forward calls ``rmsnorm`` once,
  ``add_residual_rmsnorm`` 2L times, ``silu_and_mul`` L times and
  ``add_residual`` never.

A source test holds every CUDA kernel launched as a programmatic
dependent to the rule of ``csrc/norm_act.cu``: ``griddepcontrol.wait``
comes before the kernel's first global store.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models import llama as j_llama
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.ops import kv_cache as j_kvc

from llm_inference_engine_tpu_torch.config import EngineConfig, ModelConfig
from llm_inference_engine_tpu_torch.models import llama
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops import _native, activations
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops.activations import add_residual
from llm_inference_engine_tpu_torch.ops.embedding import embedding_lookup
from llm_inference_engine_tpu_torch.ops.rmsnorm import rmsnorm
from llm_inference_engine_tpu_torch.ops.rope import rope_cos_sin

B, S, T = 3, 32, 8
Q_START = np.array([0, 4, 20], np.int32)
KV_LEN = Q_START + np.array([8, 5, 1], np.int32)
# (dtype, head_dim, tolerance against the JAX package)
CASES = {"float32": (16, 1e-4), "bfloat16": (128, 2e-2)}


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _model(dtype):
    head_dim, _ = CASES[dtype]
    cfg_j = j_get_config("debug").replace(
        dtype_name=dtype, num_layers=3, hidden_size=256, head_dim=head_dim)
    jp = j_init_dummy_params(cfg_j, 0)
    cfg = ModelConfig(**{f: getattr(cfg_j, f)
                         for f in ModelConfig.__dataclass_fields__})
    return cfg_j, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp))


def _cache(cfg):
    return kvc.new_kv_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                            cfg.head_dim, dtype=cfg.dtype)


def _inputs(rng, cfg):
    ids = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    return (torch.from_numpy(ids), torch.from_numpy(Q_START),
            torch.from_numpy(KV_LEN))


def _unfolded_forward(cfg, eng, params, ids, cache, q_start, kv_len):
    """decoder_forward as the unfolded ops compose it: rmsnorm, the
    layer, ``add_residual`` at its end; the final rmsnorm."""
    positions = (q_start[:, None]
                 + torch.arange(ids.shape[1], dtype=torch.int32)[None, :])
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x = embedding_lookup(params["embed"], ids).to(cfg.dtype)
    eps = cfg.rms_norm_eps
    for i in range(cache.num_layers):
        layer = {name: w[i] for name, w in params["layers"].items()}
        h_norm = rmsnorm(x, layer["attn_norm"], eps)
        down, resid = llama.whole(llama._layer_gen(
            cfg, eng, h_norm, x, layer, i, cache, cos, sin, q_start, kv_len,
            True))
        x = add_residual(down, resid)
    cache.lengths.copy_(kv_len)
    return rmsnorm(x, params["final_norm"], eps)


@pytest.mark.parametrize("dtype", list(CASES))
def test_folded_forward_is_bit_identical_to_the_unfolded_ops(rng, dtype):
    _, _, cfg, params = _model(dtype)
    eng = EngineConfig()
    ids, q_start, kv_len = _inputs(rng, cfg)
    folded_cache, unfolded_cache = _cache(cfg), _cache(cfg)
    got, _ = llama.decoder_forward(cfg, eng, params, ids, folded_cache,
                                   q_start, kv_len)
    want = _unfolded_forward(cfg, eng, params, ids, unfolded_cache, q_start,
                             kv_len)
    assert got.dtype == cfg.dtype and got.shape == (B, T, cfg.hidden_size)
    assert torch.equal(got, want)
    assert torch.equal(folded_cache.k, unfolded_cache.k)
    assert torch.equal(folded_cache.v, unfolded_cache.v)
    assert torch.equal(folded_cache.lengths, unfolded_cache.lengths)


@pytest.mark.parametrize("dtype", list(CASES))
def test_folded_forward_matches_jax_decoder_forward(rng, dtype):
    cfg_j, jp, cfg, params = _model(dtype)
    _, tol = CASES[dtype]
    ids, q_start, kv_len = _inputs(rng, cfg)
    jc = j_kvc.new_kv_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                            cfg.head_dim, dtype=cfg_j.dtype)
    want, jc = j_llama.decoder_forward(
        cfg_j, JEngineConfig(kernels="xla"), jp, jnp.asarray(ids.numpy()),
        jc, jnp.asarray(Q_START), jnp.asarray(KV_LEN))
    cache = _cache(cfg)
    got, cache = llama.decoder_forward(cfg, EngineConfig(), params, ids,
                                       cache, q_start, kv_len)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_array_equal(cache.lengths.numpy(), KV_LEN)


@pytest.mark.parametrize("layers", [1, 3])
def test_one_forward_calls_each_norm_as_folded(rng, monkeypatch, layers):
    """Counted at the names the decoder calls: ``rmsnorm`` once,
    ``add_residual_rmsnorm`` 2L times, ``silu_and_mul`` L times,
    ``add_residual`` never."""
    _, _, cfg, params = _model("float32")
    cfg = cfg.replace(num_layers=layers)
    params = dict(params, layers={k: v[:layers]
                                  for k, v in params["layers"].items()})
    calls = {}

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)
    for name in ("rmsnorm", "add_residual_rmsnorm", "silu_and_mul"):
        counted(llama, name)
    counted(activations, "add_residual")
    ids, q_start, kv_len = _inputs(rng, cfg)
    llama.decoder_forward(cfg, EngineConfig(), params, ids, _cache(cfg),
                          q_start, kv_len)
    assert calls == {"rmsnorm": 1, "add_residual_rmsnorm": 2 * layers,
                     "silu_and_mul": layers}


# ---------------------------------------------------------------------------
# the PDL rule, read from the CUDA sources
# ---------------------------------------------------------------------------

def _source(name: str) -> str:
    """A csrc source, the csrc headers it includes written in place (a
    template such as quant_matmul.cuh is compiled by each source that
    includes it), without its // comments."""
    text = re.sub(r'#include "(\w+\.cuh)"',
                  lambda m: (_native.CSRC / m.group(1)).read_text(),
                  (_native.CSRC / name).read_text())
    return re.sub(r"//[^\n]*", "", text)


def _body(text: str, start: int) -> str:
    """The brace-matched body of the definition whose '{' follows
    ``start``."""
    i = text.index("{", start)
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise AssertionError("unbalanced braces")


def _pdl_kernels():
    """[(source, kernel name)] of every kernel a csrc/*.cu source launches
    with cudaLaunchAttributeProgrammaticStreamSerialization: the kernels
    passed to cudaLaunchKernelEx by a function that sets the attribute,
    directly, through ``auto kernel = name<...>``, or through a launcher
    template (``launch_pdl(name<...>, ...)``)."""
    found = []
    for src in sorted(_native.CSRC.glob("*.cu")):
        text = _source(src.name)
        for m in re.finditer(r"cudaLaunchAttributeProgrammaticStreamSerialization",
                             text):
            # the function around the attribute
            head = text.rfind("\n}", 0, m.start())
            fn = text[head:text.find("\n}", m.start())]
            names = set(re.findall(r"auto kernel = (\w+)<", fn))
            names |= set(re.findall(r"cudaLaunchKernelEx\(&cfg, (\w+)[,<]",
                                    fn)) - {"kernel"}
            launcher = re.search(r"\n(?:\w+ )*int (\w+)\(\w+ kernel", fn)
            if launcher:
                names |= set(re.findall(launcher.group(1) + r"\((\w+)<",
                                        text))
            assert names, f"{src.name}: no kernel found for the attribute"
            found += [(src.name, n) for n in sorted(names)]
    return found


def _waits(text: str) -> list:
    """Names of the device helpers whose body holds griddepcontrol.wait,
    and the spellings of the wait itself."""
    helpers = [m.group(1) for m in re.finditer(
        r"__device__[^;{]*?\b(\w+)\([^)]*\)\s*\{", text)
        if "griddepcontrol.wait" in _body(text, m.start())]
    return ["griddepcontrol.wait", "cudaGridDependencySynchronize("] + [
        h + "(" for h in helpers]


def _first_store(body: str, params: str):
    """Index of the first global store in a kernel body: a write through
    a non-const pointer parameter (``p[i] =``, ``*p =``, a cast of it), a
    store helper (``store_...(``), ``st.global``, an atomic, or a TMA
    store."""
    outs = [m.group(1) for m in re.finditer(r"(?<!const )\b\w+\s*\*\s*"
                                            r"(?:__restrict__\s*)?(\w+)",
                                            params)]
    patterns = [r"\bstore_\w*\(", r"st\.global", r"\batomic\w*\(",
                r"cp\.async\.bulk\.tensor[^;]*global\.shared"]
    for o in outs:
        patterns += [rf"\b{o}\s*\[[^\]]*\]\s*=[^=]",
                     rf"\*\s*{o}\b[^;]*=[^=]",
                     rf"reinterpret_cast<[^>]*>\(\s*{o}\b[^;]*\)\s*(\[[^\]]*\])?"
                     rf"\s*=[^=]"]
    hits = [m.start() for p in patterns for m in re.finditer(p, body)]
    return min(hits) if hits else None


def test_pdl_kernels_wait_before_their_first_global_store():
    kernels = _pdl_kernels()
    # kernels A (both modes) and B, and E/F's decode mode
    assert {n for _, n in kernels} >= {"rmsnorm_kernel", "silu_mul_kernel",
                                       "quant_matmul_decode"}
    for src, name in kernels:
        text = _source(src)
        m = re.search(rf"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                      rf"\s+{name}\(([^)]*)\)", text)
        assert m, f"{src}: kernel {name} not defined here"
        body = _body(text, m.end())
        waits = [body.find(w) for w in _waits(text) if w in body]
        assert waits, f"{src}: {name} never waits (griddepcontrol.wait)"
        store = _first_store(body, m.group(1))
        assert store is None or min(waits) < store, (
            f"{src}: {name} stores to global memory before "
            f"griddepcontrol.wait: {body[store:store + 60]!r}")

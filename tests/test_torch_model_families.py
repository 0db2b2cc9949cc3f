"""The model families beside Llama-2 on the CPU: a Qwen2-like model (the
packed qkv bias at G = 7), a Mistral-like one (a sliding window that
prompts and decodes pass) and a Llama-3.1-like one (its RoPE scaling at
positions past ``original_max_position_embeddings``), each held against
the JAX package's engine on the same weights.

Each configuration is the JAX ``debug`` preset with one family's feature,
at debug width; the JAX package makes the weights (``init_dummy_params``,
``init_dummy_quantized_params`` at group 32, which divides every k: 64,
128 and the Qwen2-like ``wo``'s 224) and ``params_from_numpy`` carries
them across. Held, per family: ``forward_hidden`` logits (f32 at 1e-4,
bf16 at 2e-2, as ``tests/test_torch_engine.py``: in bf16 a 1-ulp flip of
an activation moves logits of magnitude ~1 by ~1e-2), greedy ids over two
``generate`` rounds on the slot and the paged layout (pages of 16)
against the JAX slot engine, the INT4 engine's greedy ids, and a control: the same inputs with the feature
switched off must move the logits far past the parity tolerance, so the
checks above could see the feature. Each JAX engine is built once per
module (``_jax_engine``): its compiles set this file's time, so the INT4
engines' cases live in ``tests/test_torch_model_families_int4.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import RopeScaling as JRopeScaling
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models import llama as j_llama
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params,
    init_dummy_quantized_params as j_init_dummy_quantized_params)
from llm_inference_engine_tpu.ops import kv_cache as j_kvc
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, RopeScaling, SamplingParams)
from llm_inference_engine_tpu_torch.models import llama
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

# each family's feature on the debug preset; its switch-off for the control
FAMILIES = {
    "qwen2": (dict(attention_bias=True, num_heads=7, num_kv_heads=1,
                   head_dim=32), dict(attention_bias=False)),
    "mistral": (dict(sliding_window=6), dict(sliding_window=None)),
    "llama3.1": (dict(rope_scaling=JRopeScaling(8.0, 1.0, 4.0, 16)),
                 dict(rope_scaling=None)),
}
GROUP = 32
# slot engines chunk at 8 (prompts of 3-40 tokens: several chunks past the
# window); the paged engines at pages of 16. Every chunk of the rounds has
# a full row, so each JAX engine compiles one prefill bucket
SLOT = dict(max_batch_size=3, max_seq_len=96, max_prefill_len=8)
PAGED = dict(SLOT, kv_layout="paged", page_size=16)
ROUNDS = ((5, 40, 17), (3, 9, 24))
NEW = 12


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _j_cfg(family: str, dtype: str = "float32"):
    return j_get_config("debug").replace(name=f"debug-{family}",
                                         dtype_name=dtype,
                                         **FAMILIES[family][0])


def _port_cfg(cfg_j) -> ModelConfig:
    kw = {f: getattr(cfg_j, f) for f in ModelConfig.__dataclass_fields__}
    rs = kw["rope_scaling"]
    if isinstance(rs, JRopeScaling):
        kw["rope_scaling"] = RopeScaling(
            rs.factor, rs.low_freq_factor, rs.high_freq_factor,
            rs.original_max_position_embeddings)
    return ModelConfig(**kw)


def _off(cfg: ModelConfig, params: dict, family: str):
    """The control: the config and params with the family's feature
    switched off (no bias tensor for Qwen2's)."""
    cfg = cfg.replace(**FAMILIES[family][1])
    if family == "qwen2":
        params = {**params, "layers": {k: v for k, v in
                                       params["layers"].items()
                                       if k != "bqkv"}}
    return cfg, params


_CACHE: dict = {}


def _weights(family: str, kind: str, dtype: str = "float32"):
    """(JAX params, port params) of a family: dense (seed 0; bfloat16: the
    float32 draws cast, as the JAX init rounds them) or born INT4 (group
    32, seed 1)."""
    key = ("w", family, kind, dtype)
    if key not in _CACHE:
        if kind == "int4":
            jp = j_init_dummy_quantized_params(_j_cfg(family), "int4", GROUP,
                                               seed=1)
        elif dtype == "float32":
            jp = j_init_dummy_params(_j_cfg(family), 0)
        else:
            jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                              _weights(family, kind)[0])
        _CACHE[key] = jp, params_from_numpy(jax.tree.map(np.asarray, jp))
    return _CACHE[key]


def _engine_kw(kind: str, layout: dict) -> dict:
    return dict(layout, **({} if kind == "dense" else
                           dict(quant_mode="int4", quant_group_size=GROUP)))


def _jax_engine(family: str, kind: str):
    """The JAX slot engine of (family, weights), built once per module."""
    key = ("e", family, kind)
    if key not in _CACHE:
        jp, _ = _weights(family, kind)
        _CACHE[key] = JInferenceEngine(
            _j_cfg(family), JEngineConfig(kernels="xla",
                                          **_engine_kw(kind, SLOT)), jp)
    return _CACHE[key]


def _forward_inputs(rng, vocab):
    """Three rows at histories 0, 9 and 20 (past the window of 6 and the
    Llama-3.1-like original context of 16) of 12, 7 and 1 new tokens."""
    B, S, T = 3, 48, 12
    ids = rng.integers(0, vocab, size=(B, T)).astype(np.int32)
    q_start = np.array([0, 9, 20], np.int32)
    kv_len = q_start + np.array([12, 7, 1], np.int32)
    return ids, q_start, kv_len, S


def _port_logits(cfg, params, ids, q_start, kv_len, S, hist=None):
    """``forward_hidden`` of the port over a fresh cache; ``hist`` fills
    its rows below q_start first (the same rows both packages hold)."""
    cache = kvc.new_kv_cache(cfg.num_layers, ids.shape[0], cfg.num_kv_heads,
                             S, cfg.head_dim, dtype=cfg.dtype)
    if hist is not None:
        cache.k.copy_(hist[0])
        cache.v.copy_(hist[1])
    got, cache = llama.forward_hidden(
        cfg, EngineConfig(), params, torch.from_numpy(ids), cache,
        torch.from_numpy(q_start), torch.from_numpy(kv_len))
    return got


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_hidden_logits_match_jax(rng, family, dtype, tol):
    """Logits of the last valid row of each sequence against the JAX
    forward on the same weights and the same cache history (random rows
    below q_start, so the window and the scaled positions see keys the
    new tokens did not write)."""
    cfg_j = _j_cfg(family, dtype)
    cfg = _port_cfg(cfg_j)
    jp, tp = _weights(family, "dense", dtype)
    ids, q_start, kv_len, S = _forward_inputs(rng, cfg.vocab_size)
    shape = (cfg.num_layers, 3, S, cfg.num_kv_heads, cfg.head_dim)
    hist = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    jc = j_kvc.new_kv_cache(cfg.num_layers, 3, cfg.num_kv_heads, S,
                            cfg.head_dim, dtype=cfg_j.dtype)
    jc = dataclasses.replace(jc, k=jnp.asarray(hist[0]).astype(cfg_j.dtype),
                             v=jnp.asarray(hist[1]).astype(cfg_j.dtype))
    want, _ = j_llama.forward_hidden(cfg_j, JEngineConfig(kernels="xla"), jp,
                                     jnp.asarray(ids), jc,
                                     jnp.asarray(q_start),
                                     jnp.asarray(kv_len))
    hist_t = [torch.from_numpy(h).to(cfg.dtype) for h in hist]
    got = _port_logits(cfg, tp, ids, q_start, kv_len, S, hist_t)
    assert got.dtype == torch.float32 and got.shape == (3, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    # the control: the feature switched off moves the logits past twice
    # the tolerance (0.05-0.6 here, where the packages differ by < 1e-6)
    off = _port_logits(*_off(cfg, tp, family), ids, q_start, kv_len, S,
                       hist_t)
    moved = (off - got).abs().max().item()
    assert moved > 2 * tol, (family, dtype, moved)


def generate_against_jax(rng, family: str, kind: str, layout: str):
    """Prompts of 3-40 tokens in chunks of 8, then 12 greedy tokens, twice:
    every row passes the window and the scaled positions. Greedy ids
    equal the JAX slot engine's, logprobs within 1e-4. The slot engine
    appends the second round to the same slots, as the JAX one does. A
    paged engine (pages of 16) prefills only from page-aligned history, so
    its second round starts from fresh slots, held against the JAX
    engine's ids for those prompts from fresh slots (paged is slot's
    semantics: the JAX engine's layout does not change its ids)."""
    cfg = _port_cfg(_j_cfg(family))
    _, tp = _weights(family, kind)
    paged = layout == "paged"
    te = InferenceEngine(cfg, EngineConfig(**_engine_kw(
        kind, PAGED if paged else SLOT)), tp)
    je = _jax_engine(family, kind)
    je.reset()
    sp = dict(greedy=True, max_new_tokens=NEW)
    for lens in ROUNDS:
        prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lens]
        if paged:
            je.reset()
            te.reset()
        rj = je.generate(prompts, JSamplingParams(**sp), eos_token_id=None)
        rt = te.generate(prompts, SamplingParams(**sp), eos_token_id=None)
        assert rt.token_ids == rj.token_ids
        assert rt.num_generated == [NEW] * len(lens)
        np.testing.assert_allclose(np.array(rt.logprobs),
                                   np.array(rj.logprobs), atol=1e-4)


@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_generate_greedy_ids_match_jax_over_two_rounds(rng, family, layout):
    """The dense engines (``generate_against_jax``; INT4:
    ``tests/test_torch_model_families_int4.py``)."""
    generate_against_jax(rng, family, "dense", layout)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_feature_reaches_the_engine(rng, family):
    """The control at engine level: the prefill logits of the same prompts
    (past the window and the original context) differ with the feature
    switched off, in the slot engine and the paged one."""
    cfg = _port_cfg(_j_cfg(family))
    _, tp = _weights(family, "dense")
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
               for n in (40, 20, 17)]
    for layout in (SLOT, PAGED):
        eng = EngineConfig(**layout)
        cfg_off, tp_off = _off(cfg, tp, family)
        on = InferenceEngine(cfg, eng, tp).prefill(prompts)
        off = InferenceEngine(cfg_off, eng, tp_off).prefill(prompts)
        assert (on - off).abs().max().item() > 2e-3, family


@pytest.mark.parametrize("name", ["llama2-13b", "llama3-8b", "llama3.1-8b",
                                  "mistral-7b", "qwen2-7b"])
def test_family_presets_match_jax(name):
    """The port's presets of the families, field for field the JAX
    package's (the scaling by its fields), and ``resolve_rope_scaling``
    alike at the engine lengths 4u runs and under an NTK scaling."""
    from llm_inference_engine_tpu.config import NTKScaling as JNTK
    from llm_inference_engine_tpu.config import (
        resolve_rope_scaling as j_resolve)

    from llm_inference_engine_tpu_torch.config import (
        NTKScaling, get_config, resolve_rope_scaling)
    cfg, cfg_j = get_config(name), j_get_config(name)
    assert cfg == _port_cfg(cfg_j)
    ntk = dict(factor=4.0, original_max_position_embeddings=4096)
    for dynamic in (False, True):
        for a, b in ((cfg, cfg_j),
                     (cfg.replace(rope_scaling=NTKScaling(
                         **ntk, dynamic=dynamic)),
                      cfg_j.replace(rope_scaling=JNTK(**ntk,
                                                      dynamic=dynamic)))):
            for S in (2048, 8192):
                got, want = resolve_rope_scaling(a, S), j_resolve(b, S)
                assert got.rope_theta == want.rope_theta
                assert (got.rope_scaling is None) == (want.rope_scaling
                                                      is None)


def dummy_bias_matches_jax(quantized: bool) -> None:
    """A Qwen2-like model's dummy weights carry the packed qkv bias as the
    JAX package's do: ``bqkv`` [L, K*(G+2)*D] of the model dtype, never
    quantized (INT4 weights beside it), and ``params_from_numpy`` carries
    it across exactly."""
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_params, init_dummy_quantized_params)
    from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
    cfg = _port_cfg(_j_cfg("qwen2"))
    jp = _weights("qwen2", "int4" if quantized else "dense")[0]
    if quantized:
        tp = init_dummy_quantized_params(cfg, "int4", GROUP, seed=1)
        assert isinstance(tp["layers"]["wqkv"], QuantizedTensor)
    else:
        tp = init_dummy_params(cfg, seed=0)
    b = tp["layers"]["bqkv"]
    assert b.shape == (cfg.num_layers, cfg.qkv_size) == jp["layers"][
        "bqkv"].shape
    assert b.dtype == cfg.dtype and torch.isfinite(b).all()
    crossed = params_from_numpy(jax.tree.map(np.asarray, jp))
    np.testing.assert_array_equal(crossed["layers"]["bqkv"].numpy(),
                                  np.asarray(jp["layers"]["bqkv"]))


def test_dummy_bias_matches_jax_layout():
    dummy_bias_matches_jax(False)

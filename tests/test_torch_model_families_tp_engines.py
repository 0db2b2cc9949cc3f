"""The model families' mesh engines on the CPU: the Qwen2-like,
Mistral-like and Llama-3.1-like models of
``tests/test_torch_model_families_tp.py`` split over a mesh, their greedy
ids over two ``generate`` rounds held against the JAX mesh engine's on
the same weights, on the slot layout and on the paged layout (pages of
16), at (dp, tp) = (1, 2) and, for the Qwen2-like model, (2, 2); and the
Qwen2-like model's INT4 weights (group 32, born quantized by the JAX
package) at tp = 2, whose quantized ``wqkv`` and bias are split together.
Each JAX engine is built once per module.
"""

import numpy as np
import pytest

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params,
    init_dummy_quantized_params as j_init_dummy_quantized_params)
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)

from llm_inference_engine_tpu_torch.config import EngineConfig, SamplingParams
from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from test_torch_model_families import (  # noqa: F401 (a fixture)
    _port_cfg, _torch_threads)
from test_torch_model_families_tp import crossed, j_cfg, meshes

GROUP = 32
TOL = 1e-5
# slot engines chunk at 8 (prompts of 2-40 tokens: several chunks past the
# window and the original context); paged engines at pages of 16
SLOT = dict(max_batch_size=4, max_seq_len=96, max_prefill_len=8)
PAGED = dict(SLOT, kv_layout="paged", page_size=16)
ROUNDS = ((5, 40, 17, 9), (3, 9, 24, 2))
NEW = 12
ENGINE_CASES = [("qwen2", 1, 2), ("qwen2", 2, 2), ("mistral", 1, 2),
                ("llama3.1", 1, 2)]

_CACHE: dict = {}


def weights(family: str, kind: str):
    """(JAX params, port params) of a family: dense (seed 3) or born INT4
    (group 32, seed 1)."""
    key = ("w", family, kind)
    if key not in _CACHE:
        cfg = j_cfg(family)
        jp = (j_init_dummy_quantized_params(cfg, "int4", GROUP, seed=1)
              if kind == "int4" else j_init_dummy_params(cfg, seed=3))
        _CACHE[key] = jp, crossed(jp)
    return _CACHE[key]


def engine_kw(kind: str, layout: str) -> dict:
    kw = dict(PAGED if layout == "paged" else SLOT)
    if kind == "int4":
        kw.update(quant_mode="int4", quant_group_size=GROUP)
    return kw


def engines(family: str, kind: str, layout: str, dp: int, tp: int):
    """The JAX mesh engine (built once per module) and a fresh port mesh
    engine, same weights and config."""
    jp, params = weights(family, kind)
    kw = engine_kw(kind, layout)
    jmesh, mesh = meshes(dp, tp)
    key = ("e", family, kind, layout, dp, tp)
    if key not in _CACHE:
        _CACHE[key] = JInferenceEngine(
            j_cfg(family), JEngineConfig(kernels="xla", **kw), jp,
            mesh=jmesh)
    te = InferenceEngine(_port_cfg(j_cfg(family)), EngineConfig(**kw),
                         params, mesh=mesh)
    return _CACHE[key], te


def generate_rounds(rng, je, te, paged: bool) -> None:
    """Two rounds of greedy ``generate``: ids equal, logprobs within 1e-4.
    The slot engines append the second round to the same slots; a paged
    engine prefills only from page-aligned history, so both start it from
    fresh slots."""
    je.reset()
    sp = dict(greedy=True, max_new_tokens=NEW)
    for lens in ROUNDS:
        prompts = [rng.integers(3, 256, n).tolist() for n in lens]
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
@pytest.mark.parametrize("family,dp,tp", ENGINE_CASES)
def test_mesh_engine_greedy_ids_match_jax(rng, family, dp, tp, layout):
    je, te = engines(family, "dense", layout, dp, tp)
    generate_rounds(rng, je, te, layout == "paged")


def test_int4_qwen2_at_tp2_matches_jax(rng):
    """INT4 at group 32 at tp = 2: each rank's quantized ``wqkv`` columns
    and its ``bqkv`` are the same kv groups (the rank's wo rows, 224 =
    7 groups, hold whole groups); prefill logits within 1e-5 of the JAX
    mesh engine's, then the two rounds' greedy ids."""
    je, te = engines("qwen2", "int4", "slot", 1, 2)
    cfg = te.config
    K, D = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // K
    whole = weights("qwen2", "int4")[1]["layers"]
    for r, shard in enumerate(te.params.shards[0]):
        wqkv, bqkv = shard["layers"]["wqkv"], shard["layers"]["bqkv"]
        assert isinstance(wqkv, QuantizedTensor)
        assert wqkv.q.shape[-1] == bqkv.shape[-1] == (G + 2) * D
        assert wqkv.scale.shape[-1] == (G + 2) * D
        assert shard["layers"]["wo"].scale.shape[-2] == G * D // GROUP
        cols = slice(r * (G + 2) * D, (r + 1) * (G + 2) * D)
        assert (bqkv == whole["bqkv"][:, cols]).all()
    prompts = [rng.integers(3, 256, n).tolist() for n in (6, 33, 2, 19)]
    je.reset()
    np.testing.assert_allclose(te.prefill(prompts).numpy(),
                               np.asarray(je.prefill(prompts)), atol=TOL,
                               rtol=TOL)
    te.reset()
    generate_rounds(rng, je, te, False)


"""The model families with INT8 weights over an int8 slot cache on the
CPU: a Qwen2-like, a Mistral-like and a Llama-3.1-like model at debug
width (``tests/test_torch_model_families.py``'s configurations), born INT8
by the JAX package (``init_dummy_quantized_params``, per-channel scales,
seed 1) and carried across, their greedy ids over two ``generate`` rounds
on the same slots held against the JAX engine with the same weights and
an int8 cache (absmax scales in both packages). Prompts of 3-40 tokens in
chunks of 8 pass the Mistral-like window of 6 and the Llama-3.1-like
original context of 16, so the window bound meets the scale planes on
every row. Each JAX engine is built once per module.
"""

import jax
import numpy as np
import pytest

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.models.weights import (
    init_dummy_quantized_params as j_init_dummy_quantized_params)
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)

from llm_inference_engine_tpu_torch.config import EngineConfig, SamplingParams
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from test_torch_model_families import (  # noqa: F401 (a fixture)
    FAMILIES, NEW, ROUNDS, SLOT, _j_cfg, _port_cfg, _torch_threads)

INT8_KV8 = dict(SLOT, quant_mode="int8", kv_cache_dtype_name="int8")

_CACHE: dict = {}


def _int8_weights_and_engine(family: str):
    """(port params, JAX engine) of a family's INT8 weights, once per
    module."""
    if family not in _CACHE:
        jp = j_init_dummy_quantized_params(_j_cfg(family), "int8", seed=1)
        je = JInferenceEngine(_j_cfg(family),
                              JEngineConfig(kernels="xla", **INT8_KV8), jp)
        _CACHE[family] = (params_from_numpy(jax.tree.map(np.asarray, jp)),
                          je)
    return _CACHE[family]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_int8_weights_int8_cache_greedy_ids_match_jax(rng, family):
    cfg = _port_cfg(_j_cfg(family))
    tp, je = _int8_weights_and_engine(family)
    assert isinstance(tp["layers"]["wqkv"], QuantizedTensor)
    assert tp["layers"]["wqkv"].mode == "int8"
    te = InferenceEngine(cfg, EngineConfig(**INT8_KV8), tp)
    assert te.cache.quantized and not te.cache.snapped
    je.reset()
    sp = dict(greedy=True, max_new_tokens=NEW)
    for lens in ROUNDS:
        prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lens]
        rj = je.generate(prompts, JSamplingParams(**sp), eos_token_id=None)
        rt = te.generate(prompts, SamplingParams(**sp), eos_token_id=None)
        assert rt.token_ids == rj.token_ids
        assert rt.num_generated == [NEW] * len(lens)
        np.testing.assert_allclose(np.array(rt.logprobs),
                                   np.array(rj.logprobs), atol=1e-4)
        np.testing.assert_array_equal(te.cache.lengths.numpy(),
                                      np.asarray(je.cache.lengths))

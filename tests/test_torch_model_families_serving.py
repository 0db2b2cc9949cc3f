"""The model families through the serving path on the CPU: the
continuous-batching scheduler over a paged engine whose pool is int8, for
a Qwen2-like model (the packed qkv bias at G = 7), a Mistral-like one (a
window of 6 that every prompt passes) and a Llama-3.1-like one (RoPE
scaling past an original context of 16), each against the JAX package's
scheduler over its own int8 pool on the same requests and weights.

The configurations and weights are ``tests/test_torch_model_families.py``'s
(the JAX ``debug`` preset with one family's feature, f32, seed 0, carried
across by ``params_from_numpy``). The port's pool holds snapped scales,
the JAX package's embedded scale rows: the same codes, so greedy ids,
finish reasons and preemptions must be equal request by request. Six
requests share three slots and seven usable pages of 16, so admission waits
for slots and the pool runs out mid-decode: the scheduler preempts and
recomputes. Each
JAX engine is built once per module. INT8 weights over an int8 slot cache
are held in ``tests/test_torch_model_families_int8.py``.
"""

import numpy as np
import pytest

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)
from llm_inference_engine_tpu.runtime.scheduler import (
    ContinuousBatchingScheduler as JScheduler)

from llm_inference_engine_tpu_torch.config import EngineConfig, SamplingParams
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)
from test_torch_model_families import (  # noqa: F401 (a fixture)
    FAMILIES, _j_cfg, _port_cfg, _torch_threads, _weights)

# an int8 pool of 8 pages of 16 (page 0 reserved): 112 tokens for three
# slots of up to 96
POOL = dict(max_batch_size=3, max_seq_len=96, max_prefill_len=8,
            kv_layout="paged", page_size=16, num_pages=8,
            kv_cache_dtype_name="int8")
# prompt lengths (each past the window of 6, two past the original
# context of 16) and tokens to generate: the 40-token prompt with its 24
# tokens holds 4 pages
REQUESTS = ((5, 12), (40, 24), (17, 20), (24, 16), (9, 12), (33, 8))

_ENGINES: dict = {}


def _jax_pool_engine(family: str):
    if family not in _ENGINES:
        jp, _ = _weights(family, "dense")
        _ENGINES[family] = JInferenceEngine(
            _j_cfg(family), JEngineConfig(kernels="xla", **POOL), jp)
    return _ENGINES[family]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_scheduler_over_int8_pool_matches_jax(family):
    cfg = _port_cfg(_j_cfg(family))
    _, tp = _weights(family, "dense")
    te = InferenceEngine(cfg, EngineConfig(**POOL), tp)
    assert te.paged and te.cache.quantized and te.cache.snapped
    je = _jax_pool_engine(family)
    je.reset()
    rng = np.random.default_rng(26)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
               for n, _ in REQUESTS]
    js = JScheduler(je, eos_token_id=None)
    ts = ContinuousBatchingScheduler(te, eos_token_id=None)
    jr = [js.submit(p, JSamplingParams(greedy=True, max_new_tokens=m))
          for p, (_, m) in zip(prompts, REQUESTS)]
    tr = [ts.submit(p, SamplingParams(greedy=True, max_new_tokens=m))
          for p, (_, m) in zip(prompts, REQUESTS)]
    js.step()
    ts.step()
    assert [r.slot for r in tr] == [r.slot for r in jr]
    waiting = sum(r.slot < 0 for r in tr)
    js.run(max_steps=1000)
    ts.run(max_steps=1000)
    assert all(r.finished for r in tr) and all(r.finished for r in jr)
    assert [r.output_ids for r in tr] == [r.output_ids for r in jr]
    assert [len(r.output_ids) for r in tr] == [m for _, m in REQUESTS]
    assert [r.finish_reason for r in tr] == [r.finish_reason for r in jr]
    assert [r.preemptions for r in tr] == [r.preemptions for r in jr]
    np.testing.assert_allclose(
        np.concatenate([r.token_logprobs for r in tr]),
        np.concatenate([r.token_logprobs for r in jr]), atol=1e-4)
    assert te.free_pages == je.free_pages == te._allocator.num_pages - 1
    # what the pool is there to exercise: requests waited for a slot and
    # the pool ran out mid-decode
    assert waiting == 3 and sum(r.preemptions for r in tr) > 0

"""The KV cache's dtype when ``kv_cache_dtype_name`` names a float other
than the model's: the PyTorch port against the JAX package, on the CPU.

The JAX engines allocate every float cache in the model's dtype (slot,
paged pool and beam search alike) and read the name only for ``int8``;
the port follows them (``runtime.engine.kv_cache_dtype_of``). Here the
``debug`` preset runs as a float32 model with a cache named ``bfloat16``
and ``float16``, and as a float16 model with one named ``float32``, from
one set of JAX dummy weights (seed 4, ``params_from_numpy``): the JAX
engine (``kernels="xla"``, built once per module and case) against the
port's on CPU tensors, over the slot cache, the paged pool (pages of 16)
and ``BeamSearch``. The port's cache has the JAX engine's dtype.

Tolerances, those of ``tests/test_torch_dtypes.py``: prefill logits within
1e-4 relative L2 in float32 (the same f32 math summed in another order)
and 2e-2 in float16 (both round at the model dtype's points, but sum in
another order); greedy ids equal; beam sequences equal and their scores
within the same relative limits.
"""

import jax
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models import weights as j_weights
from llm_inference_engine_tpu.runtime.beam_search import (
    beam_search as j_beam_search)
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingParams)
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.runtime.beam_search import BeamSearch
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

# (model dtype, cache name): a float named other than the model's dtype
CASES = [("float32", "bfloat16"), ("float32", "float16"),
         ("float16", "float32")]
LAYOUTS = {"slot": {}, "paged": dict(kv_layout="paged", page_size=16)}
LIMIT = {"float16": 2e-2, "float32": 1e-4}
_KW = dict(max_batch_size=3, max_seq_len=64, max_prefill_len=16)
PROMPTS = ([5, 17, 93, 200, 3], list(range(40, 63)), [7, 250] * 9)
BEAM_PROMPT = [1, 13, 99, 2, 7]


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _dtype_name(dtype) -> str:
    """A JAX or torch dtype's name: "float32", "bfloat16", ..."""
    return str(dtype).split(".")[-1]


@pytest.fixture(scope="module")
def weights():
    """{model dtype: (JAX config, port config, JAX params, port params)}."""
    made = {}

    def get(dtype):
        if dtype not in made:
            cfg_j = j_get_config("debug").replace(dtype_name=dtype)
            jp = j_weights.init_dummy_params(cfg_j, seed=4)
            cfg = ModelConfig(**{f: getattr(cfg_j, f)
                                 for f in ModelConfig.__dataclass_fields__})
            made[dtype] = (cfg_j, cfg, jp,
                           params_from_numpy(jax.tree.map(np.asarray, jp)))
        return made[dtype]
    return get


@pytest.fixture(scope="module")
def runs(weights):
    """{(model, cache, layout): {"jax" / "port": (prefill logits, greedy
    ids, cache dtype name)}}, each engine built once."""
    done = {}

    def run(model, cache, layout):
        key = (model, cache, layout)
        if key not in done:
            cfg_j, cfg, jp, tp = weights(model)
            kw = dict(_KW, kv_cache_dtype_name=cache, **LAYOUTS[layout])
            je = JInferenceEngine(cfg_j, JEngineConfig(kernels="xla", **kw),
                                  jp)
            te = InferenceEngine(cfg, EngineConfig(**kw), tp, device="cpu")
            prompts = [list(p) for p in PROMPTS]
            out = {}
            for name, engine, sp in (("jax", je, JSamplingParams),
                                     ("port", te, SamplingParams)):
                logits = np.asarray(engine.prefill(prompts), np.float32)
                engine.reset()
                ids = engine.generate(prompts,
                                      sp(greedy=True, max_new_tokens=12),
                                      eos_token_id=None).token_ids
                out[name] = (logits, ids, _dtype_name(engine.cache.k.dtype))
            done[key] = out
        return done[key]
    return run


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("model,cache", CASES)
def test_float_cache_name_follows_the_jax_engine(runs, model, cache, layout):
    """The port's cache (slot or pool) has the JAX engine's dtype, the
    model's; prefill logits within LIMIT[model] relative L2 of the JAX
    engine's and greedy ids equal."""
    out = runs(model, cache, layout)
    (lj, ij, dj), (lt, it, dt) = out["jax"], out["port"]
    assert dj == model
    assert dt == dj
    assert lt.shape == lj.shape and np.isfinite(lt).all()
    rel = np.linalg.norm(lt - lj) / np.linalg.norm(lj)
    assert rel <= LIMIT[model], rel
    assert it == ij


@pytest.mark.parametrize("model,cache", CASES)
def test_beam_search_cache_follows_the_jax_engine(runs, weights, model,
                                                  cache):
    """``BeamSearch`` allocates its cache as the JAX beam search does, in
    the model's dtype (the JAX slot engine's, which allocates alike); its
    beams equal the JAX package's and their scores agree within
    LIMIT[model] relative."""
    cfg_j, cfg, jp, tp = weights(model)
    eng = dict(max_batch_size=2, max_seq_len=64, kv_cache_dtype_name=cache)
    want = j_beam_search(cfg_j, JEngineConfig(kernels="xla", **eng), jp,
                         BEAM_PROMPT, num_beams=2, max_new_tokens=6,
                         eos_token_id=None)
    beams = BeamSearch(cfg, EngineConfig(**eng), tp, num_beams=2,
                       device="cpu")
    assert _dtype_name(beams.cache.k.dtype) == runs(model, cache,
                                                     "slot")["jax"][2]
    got = beams.search(BEAM_PROMPT, max_new_tokens=6, eos_token_id=None)
    assert got.sequences == want.sequences
    np.testing.assert_allclose(got.scores, want.scores, rtol=LIMIT[model])

"""Float16 (and float32) models: the PyTorch port's plain route against the
JAX package, on the CPU, and the card's dtype check.

The JAX package takes a float32, float16 or bfloat16 model, its Pallas
kernels computing in f32 inside; on the card the port runs such a model
through the float instances of its kernels (``csrc/*_f16.cu``,
``csrc/*_f32.cu``, If in ``csrc/kv_write_quant.cu``, held against the plain
versions by the card tests). Here each path of the
``debug`` preset (2 layers, head_dim 16) in float16 runs on both sides
from one set of JAX dummy weights (``params_from_numpy``): the JAX engine
with ``kernels="pallas"`` in interpret mode (conftest), built once per
module and path, the port's on CPU tensors. Paths: the slot cache, the
paged pool, an int8 cache, INT4 weights (group 64) and INT8 weights.

Tolerances. Prefill logits within 2e-2 relative L2 in float16: both sides
round at the model dtype's points, but the Pallas kernels round their
softmax weights to float16 before P V (``p.astype(q.dtype)``) where the
port's plain attention keeps f32, and sums run in another order. Float32,
where a path has no float32 test elsewhere: 1e-4. Greedy ids equal.
"""

import jax
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models import weights as j_weights
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingParams)
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.runtime.engine import (
    InferenceEngine, check_kernel_dtypes)

PATHS = {
    "slot": {},
    "paged": dict(kv_layout="paged", page_size=16),
    "kv8": dict(kv_cache_dtype_name="int8"),
    "int4": dict(quant_mode="int4", quant_group_size=64),
    "int8w": dict(quant_mode="int8"),
}
LIMIT = {"float16": 2e-2, "float32": 1e-4}
# the Pallas kernels' interpret mode is slow at 128-row blocks
_KW = dict(max_batch_size=3, max_seq_len=64, max_prefill_len=32,
           block_q=16, block_kv=16, decode_block_kv=16)
PROMPTS = ([5, 17, 93, 200, 3], list(range(40, 63)), [7, 250] * 9)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    """{(dtype, path): (prefill logits, greedy ids)} of the JAX engine with
    kernels="pallas" and of the port's engine, each built once."""
    cache = {}

    def run(dtype, path):
        if (dtype, path) in cache:
            return cache[dtype, path]
        kw = PATHS[path]
        cfg_j = j_get_config("debug").replace(dtype_name=dtype)
        mode = kw.get("quant_mode")
        jp = (j_weights.init_dummy_params(cfg_j, seed=4) if mode is None
              else j_weights.init_dummy_quantized_params(cfg_j, mode, 64,
                                                          seed=4))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        je = JInferenceEngine(cfg_j, JEngineConfig(kernels="pallas", **_KW,
                                                   **kw), jp)
        cfg = ModelConfig(**{f: getattr(cfg_j, f)
                             for f in ModelConfig.__dataclass_fields__})
        port_kw = {k: v for k, v in _KW.items() if not k.endswith("block_kv")
                   and k != "block_q"}
        te = InferenceEngine(cfg, EngineConfig(**port_kw, **kw), tp,
                             device="cpu")
        prompts = [list(p) for p in PROMPTS]
        out = {}
        for name, engine, sp in (("jax", je, JSamplingParams),
                                 ("port", te, SamplingParams)):
            logits = np.asarray(engine.prefill(prompts), np.float32)
            engine.reset()
            ids = engine.generate(prompts, sp(greedy=True, max_new_tokens=12),
                                  eos_token_id=None).token_ids
            out[name] = (logits, ids)
        cache[dtype, path] = out
        return out
    return run


@pytest.mark.parametrize("dtype,path", [("float16", p) for p in PATHS]
                         + [("float32", "paged"), ("float32", "kv8")])
def test_float_model_matches_jax_pallas(runs, dtype, path):
    """Prefill logits within LIMIT[dtype] relative L2 and greedy ids equal,
    the port's plain route against the JAX engine's Pallas kernels."""
    out = runs(dtype, path)
    (lj, ij), (lt, it) = out["jax"], out["port"]
    assert lt.shape == lj.shape == (3, 256)
    assert np.isfinite(lt).all()
    rel = np.linalg.norm(lt - lj) / np.linalg.norm(lj)
    assert rel <= LIMIT[dtype], rel
    assert it == ij


@pytest.mark.parametrize("model,cache,refused", [
    ("float32", "", None), ("float32", "int8", None),
    ("float16", "", None), ("float16", "int8", None),
    ("float16", "float16", None), ("bfloat16", "int8", None),
    # a float cache of another dtype than the model's: the model's dtype,
    # as the JAX engine allocates it (the names kept from when the check
    # refused them)
    pytest.param("bfloat16", "float16", None, id="bfloat16-float16-KV cache "
                 "dtype torch.float16 with a torch.bfloat16 model"),
    pytest.param("float32", "bfloat16", None, id="float32-bfloat16-KV cache "
                 "dtype torch.bfloat16 with a torch.float32 model"),
    pytest.param("float16", "float32", None, id="float16-float32-KV cache "
                 "dtype torch.float32 with a torch.float16 model"),
    ("float64", "", "model dtype torch.float64"),
    ("float64", "int8", "model dtype torch.float64")])
def test_card_dtype_check(model, cache, refused):
    """On a CUDA device (no card needed: the check allocates nothing) a
    bfloat16, float16 or float32 model is taken with any cache name, the
    cache resolved as the JAX engine resolves it: int8, or the model's own
    dtype whatever float is named. A model dtype that no kernel takes
    (float64; no preset names it, so a stand-in carries it) is refused."""
    import types

    from llm_inference_engine_tpu_torch.config import get_config
    from llm_inference_engine_tpu_torch.runtime.engine import (
        kv_cache_dtype_of)
    cfg = (types.SimpleNamespace(name="debug", dtype=torch.float64)
           if model == "float64"
           else get_config("debug").replace(dtype_name=model))
    eng = EngineConfig(max_batch_size=2, max_seq_len=32,
                       kv_cache_dtype_name=cache)
    if refused is not None:
        with pytest.raises(ValueError, match=refused):
            check_kernel_dtypes(cfg, eng, torch.device("cuda"))
        return
    check_kernel_dtypes(cfg, eng, torch.device("cuda"))
    assert kv_cache_dtype_of(cfg, eng) == (
        (torch.int8, True) if cache == "int8" else (cfg.dtype, False))

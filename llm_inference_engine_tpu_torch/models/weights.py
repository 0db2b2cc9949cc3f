"""Parameter dicts: layouts, dummy init and the crossing from the JAX package.

Port of the main-path parts of ``llm_inference_engine_tpu/models/weights.py``.
Layouts are unchanged: every matmul weight is [in, out]; per-layer
weights are stacked on a leading [num_layers, ...] axis (a layer is the
free view ``w[i]``); QKV is packed group-major; gate|up is stacked
[L, in, 2, I].

Checkpoint loaders (HF safetensors, the reference engine's .bin, the JAX
package's .npz) and quantization are not ported yet (ROADMAP.md, queue 1,
"Checkpoint loading" and "INT8/INT4 weights").
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from llm_inference_engine_tpu_torch.config import ModelConfig

__all__ = ["init_dummy_params", "fuse_qkv", "fuse_gate_up",
           "params_from_numpy", "param_count", "param_bytes"]

Params = dict  # {'embed', 'layers': {...}, 'final_norm', 'lm_head'}


def fuse_qkv(wq: np.ndarray, wk: np.ndarray, wv: np.ndarray,
             num_heads: int, num_kv_heads: int, head_dim: int) -> np.ndarray:
    """Fuse separate [in, H*D]/[in, K*D] projections into the group-major
    packed layout [in, K*(G+2)*D]: for each KV group, its G query heads,
    then its k head, then its v head."""
    hidden = wq.shape[0]
    G = num_heads // num_kv_heads
    q = wq.reshape(hidden, num_kv_heads, G, head_dim)
    k = wk.reshape(hidden, num_kv_heads, 1, head_dim)
    v = wv.reshape(hidden, num_kv_heads, 1, head_dim)
    packed = np.concatenate([q, k, v], axis=2)       # [in, K, G+2, D]
    return packed.reshape(hidden, num_kv_heads * (G + 2) * head_dim)


def fuse_gate_up(wg: np.ndarray, wu: np.ndarray) -> np.ndarray:
    """Fuse [in, I] gate and up into [in, 2, I]."""
    return np.stack([wg, wu], axis=1)


def init_dummy_params(config: ModelConfig, seed: int = 0,
                      scale: float = 0.02,
                      device: Optional[torch.device] = None) -> Params:
    """Random dummy weights, deterministic per (seed, device type).

    Each tensor is drawn directly on ``device`` in the model dtype by one
    ``torch.Generator`` seeded with ``seed``: no full-precision staging
    copy is made (for Llama2-7B an f32 copy on the host would be ~27 GB).
    The values differ from the JAX package's (``jax.random`` is not
    reproducible in torch); tests that compare the packages carry the JAX
    weights across with :func:`params_from_numpy`."""
    L, Hd, dtype = config.num_layers, config.hidden_size, config.dtype
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)

    def norm_init(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def w_init(shape):
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(scale)

    params = {
        "embed": w_init((config.vocab_size, Hd)),
        "layers": {
            "attn_norm": norm_init((L, Hd)),
            "wqkv": w_init((L, Hd, config.qkv_size)),
            "wo": w_init((L, config.q_size, Hd)),
            "ffn_norm": norm_init((L, Hd)),
            "w_gate_up": w_init((L, Hd, 2, config.intermediate_size)),
            "w_down": w_init((L, config.intermediate_size, Hd)),
        },
        "final_norm": norm_init((Hd,)),
        "lm_head": w_init((Hd, config.vocab_size)),
    }
    if config.attention_bias:
        params["layers"]["bqkv"] = w_init((L, config.qkv_size))
    return params


def _tensor_from_numpy(a, device) -> torch.Tensor:
    if not isinstance(a, np.ndarray):
        raise NotImplementedError(
            f"parameter leaf of type {type(a).__name__}: quantized weights "
            "are not ported yet (ROADMAP.md, queue 1, 'INT8/INT4 weights')")
    if a.dtype.name == "bfloat16":      # ml_dtypes.bfloat16: no torch twin
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_numpy(tree: dict, device=None) -> Params:
    """The JAX package's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> this package's dict, same
    keys and layouts, on ``device``."""
    return {k: (params_from_numpy(v, device) if isinstance(v, dict)
                else _tensor_from_numpy(v, device))
            for k, v in tree.items()}


def _leaves(params):
    for v in params.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def param_count(params: Params) -> int:
    return sum(t.numel() for t in _leaves(params))


def param_bytes(params: Params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))

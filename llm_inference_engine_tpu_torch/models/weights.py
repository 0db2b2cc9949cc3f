"""Parameter dicts: layouts, dummy init, quantization, the ``.npz``
checkpoint and the crossing from the JAX package.

Port of the main-path parts of ``llm_inference_engine_tpu/models/weights.py``.
Layouts are unchanged: every matmul weight is [in, out]; per-layer
weights are stacked on a leading [num_layers, ...] axis (a layer is the
free view ``w[i]``); QKV is packed group-major; dense gate|up is stacked
[L, in, 2, I], quantized gate|up [L, 2, in', I] (the 2-axis leads);
quantized weights are :class:`~llm_inference_engine_tpu_torch.ops.quant.QuantizedTensor`
leaves. ``save_params`` / ``load_saved_params`` read and write the JAX
package's ``.npz`` format 1, so one file serves both packages.

Not ported yet: the HF safetensors and reference ``.bin`` loaders
(ROADMAP.md, queue 1, 'Checkpoint loading') and calibrated quantization
(queue 1, 'Evals, tools and utils').
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from llm_inference_engine_tpu_torch.config import ModelConfig
from llm_inference_engine_tpu_torch.ops.quant import (
    QuantizedTensor, quantize_tensor)

__all__ = ["init_dummy_params", "init_dummy_quantized_params",
           "quantize_params", "quantize_params_calibrated", "fuse_qkv",
           "fuse_gate_up",
           "params_from_numpy", "save_params", "load_saved_params",
           "param_count", "param_bytes"]

Params = dict  # {'embed', 'layers': {...}, 'final_norm', 'lm_head'}

_QUANT_KEYS = ("wqkv", "wo", "w_gate_up", "w_down")


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


def init_dummy_quantized_params(config: ModelConfig, mode: str = "int8",
                                group_size: int = 128, seed: int = 0,
                                scale: float = 0.02,
                                device: Optional[torch.device] = None
                                ) -> Params:
    """Random dummy weights born quantized on ``device`` (no full-precision
    original is ever made), from one ``torch.Generator`` seeded with
    ``seed``: int8 values uniform in [-127, 127] with scale 0.02/127, int4
    values uniform in [-8, 7] with scale 0.02/7, as in the JAX package.
    A random byte holds two independent uniform signed nibbles, so the
    packed int4 weight is drawn as bytes directly."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown quant mode {mode!r}")
    L, Hd, dtype = config.num_layers, config.hidden_size, config.dtype
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)

    def qdummy(lead, in_dim, out_dim):
        if mode == "int8":
            q = torch.randint(-127, 128, (*lead, in_dim, out_dim),
                              generator=gen, dtype=torch.int8, device=device)
            s = torch.full((*lead, 1, out_dim), scale / 127.0,
                           dtype=torch.float32, device=device)
        else:
            if in_dim % group_size:
                raise ValueError(f"in dim {in_dim} not divisible by group "
                                 f"{group_size}")
            q = torch.randint(-128, 128, (*lead, in_dim // 2, out_dim),
                              generator=gen, dtype=torch.int8, device=device)
            s = torch.full((*lead, in_dim // group_size, out_dim),
                           scale / 7.0, dtype=torch.float32, device=device)
        return QuantizedTensor(q=q, scale=s, mode=mode, group_size=group_size)

    def dense(shape):
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(scale)

    layers = {
        "attn_norm": torch.ones((L, Hd), dtype=dtype, device=device),
        "wqkv": qdummy((L,), Hd, config.qkv_size),
        "wo": qdummy((L,), config.q_size, Hd),
        "ffn_norm": torch.ones((L, Hd), dtype=dtype, device=device),
        "w_gate_up": qdummy((L, 2), Hd, config.intermediate_size),
        "w_down": qdummy((L,), config.intermediate_size, Hd),
    }
    if config.attention_bias:   # bias stays unquantized (tiny)
        layers["bqkv"] = dense((L, config.qkv_size))
    return {
        "embed": dense((config.vocab_size, Hd)),
        "layers": layers,
        "final_norm": torch.ones((Hd,), dtype=dtype, device=device),
        "lm_head": qdummy((), Hd, config.vocab_size),
    }


def quantize_params(params: Params, mode: str = "int8",
                    group_size: int = 128,
                    quantize_lm_head: bool = True) -> Params:
    """Quantize every matmul weight layer by layer (scales stacked on the
    same leading axis); the gate|up stack becomes [L, 2, in', I]."""
    if mode in ("none", None, ""):
        return params
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    layers = dict(params["layers"])
    for name in _QUANT_KEYS:
        w = layers[name]          # [L, in, out] (or [L, in, 2, I] gate|up)
        structured = w.dim() == 4
        if structured:
            w = w.reshape(w.shape[0], w.shape[1], -1)
        qs, ss = [], []
        for l in range(w.shape[0]):
            t = quantize_tensor(w[l], mode, group_size)
            q, s = t.q, t.scale
            if structured:        # [in', 2I] -> [2, in', I]
                q = q.reshape(q.shape[0], 2, -1).transpose(0, 1)
                s = s.reshape(s.shape[0], 2, -1).transpose(0, 1)
            qs.append(q)
            ss.append(s)
        layers[name] = QuantizedTensor(
            q=torch.stack(qs), scale=torch.stack(ss),
            mode=mode, group_size=group_size)
    out["layers"] = layers
    out["lm_head"] = (quantize_tensor(params["lm_head"], mode, group_size)
                      if quantize_lm_head else params["lm_head"])
    return out


def quantize_params_calibrated(params: Params, act_sq: dict,
                               mode: str = "int8", group_size: int = 128,
                               quantize_lm_head: bool = True) -> Params:
    """Calibration-aware quantization (the JAX package's AWQ-lite pass over
    activation statistics): not ported yet."""
    raise NotImplementedError(
        "quantize_params_calibrated is not ported yet (ROADMAP.md, queue 1, "
        "'Evals, tools and utils'); quantize_params and search_clip are")


def _tensor_from_numpy(a, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":      # ml_dtypes.bfloat16: no torch twin
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _leaf_from_numpy(v, device):
    # the JAX package's QuantizedTensor, recognised without importing it
    if all(hasattr(v, f) for f in ("q", "scale", "mode", "group_size")):
        return QuantizedTensor(
            q=_tensor_from_numpy(v.q, device),
            scale=_tensor_from_numpy(v.scale, device),
            mode=str(v.mode), group_size=int(v.group_size))
    if not isinstance(v, np.ndarray):
        raise TypeError(f"parameter leaf of type {type(v).__name__} is "
                        "neither a numpy array nor a quantized tensor")
    return _tensor_from_numpy(v, device)


def params_from_numpy(tree: dict, device=None) -> Params:
    """The JAX package's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``, quantized leaves included) ->
    this package's dict, same keys and layouts, on ``device``."""
    return {k: (params_from_numpy(v, device) if isinstance(v, dict)
                else _leaf_from_numpy(v, device))
            for k, v in tree.items()}


def _to_numpy(t: torch.Tensor):
    """(array, kind) in the ``.npz`` format: bf16 as uint16 bit patterns."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy(), "bf16"
    return t.numpy(), "raw"


def save_params(params: Params, path: str) -> None:
    """Write a params dict (quantized or not) to one ``.npz`` file in the
    JAX package's format 1: bf16 leaves as uint16 bit patterns, quantized
    leaves as ``<name>.q`` / ``<name>.scale`` with their mode and group in
    the ``__meta__`` JSON."""
    arrays: dict = {}
    meta: dict = {"format": 1, "leaves": {}}

    def put(prefix: str, v) -> None:
        if isinstance(v, QuantizedTensor):
            arrays[prefix + ".q"] = _to_numpy(v.q)[0]
            arrays[prefix + ".scale"] = _to_numpy(v.scale)[0]
            meta["leaves"][prefix] = {"kind": "quant", "mode": v.mode,
                                      "group_size": v.group_size}
        else:
            arrays[prefix], kind = _to_numpy(v)
            meta["leaves"][prefix] = {"kind": kind}

    put("embed", params["embed"])
    for name, v in params["layers"].items():
        put("layers." + name, v)
    put("final_norm", params["final_norm"])
    put("lm_head", params["lm_head"])
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                          np.uint8), **arrays)


def load_saved_params(path: str, device=None) -> Params:
    """Load a ``save_params`` checkpoint (written by either package) onto
    ``device``."""
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta.get("format") != 1:
        raise ValueError(f"unknown checkpoint format {meta.get('format')!r}")

    def tensor(a: np.ndarray, kind: str) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if kind == "bf16":
            t = t.view(torch.bfloat16)
        return t.to(device)

    def get(prefix: str):
        info = meta["leaves"][prefix]
        if info["kind"] == "quant":
            return QuantizedTensor(
                q=tensor(z[prefix + ".q"], "raw"),
                scale=tensor(z[prefix + ".scale"], "raw"),
                mode=info["mode"], group_size=int(info["group_size"]))
        return tensor(z[prefix], info["kind"])

    layer_names = sorted(
        {k.split(".")[1] for k in meta["leaves"] if k.startswith("layers.")})
    return {
        "embed": get("embed"),
        "layers": {n: get("layers." + n) for n in layer_names},
        "final_norm": get("final_norm"),
        "lm_head": get("lm_head"),
    }


def _leaves(params):
    for v in params.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def param_count(params: Params) -> int:
    """Stored elements; a quantized leaf counts its q and scale elements,
    as the JAX package counts its pytree leaves."""
    return sum(t.numel() for t in _leaves(params))


def param_bytes(params: Params) -> int:
    return sum(t.nbytes if isinstance(t, QuantizedTensor)
               else t.numel() * t.element_size() for t in _leaves(params))

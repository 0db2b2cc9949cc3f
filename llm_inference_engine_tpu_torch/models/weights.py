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

``load_hf_safetensors`` and ``load_reference_bin`` read checkpoint
directories through ``runtime/native_io.py`` (the native parallel pread)
and give the JAX loaders' parameters bit for bit: F16 and BF16 widen to
f32 exactly, the q|k|v and gate|up fusions only move values, and the one
rounding to the model dtype is round-to-nearest-even in both packages.
Unlike the JAX loaders, which stack whole-model f32 lists on the host
(about 54 GB for a 7B model), they fill preallocated stacked tensors of
the model dtype on the target device tensor by tensor, through one reused
staging buffer (pinned when the target is the card), and transpose and
fuse on the device.

Calibration-aware quantization (``calibrate_act_sq`` and
``quantize_params_calibrated``) is the JAX package's AWQ-lite pass: the
activation second moments of every matmul's input, gathered through the
forward's debug tap (``utils/debug.py``), weight the per-block clip
search of ``ops.quant.search_clip``. The JAX package dumps the tapped
tensors to ``.npy`` files and sums them on the host; here the tap hands
them to a sink that sums them on the device, in f64, as the files' sums
are taken.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from llm_inference_engine_tpu_torch.config import ModelConfig
from llm_inference_engine_tpu_torch.ops.quant import (
    QuantizedTensor, quantize_tensor, search_clip)

__all__ = ["init_dummy_params", "init_dummy_quantized_params",
           "quantize_params", "calibrate_act_sq",
           "quantize_params_calibrated", "fuse_qkv",
           "fuse_gate_up",
           "params_from_numpy", "save_params", "load_saved_params",
           "load_hf_safetensors", "load_reference_bin", "param_count",
           "param_bytes"]

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
    return _quantize(params, mode, group_size, quantize_lm_head, None)


def _quantize(params: Params, mode: str, group_size: int,
              quantize_lm_head: bool, clip_of: Optional[Callable]) -> Params:
    """quantize_params, each [in, out] weight ``w`` of matmul ``name``
    (layer ``l``; the lm_head: None) quantized with the clip factors
    ``clip_of(name, l, w)`` (None: round to nearest)."""
    if mode in ("none", None, ""):
        return params

    def quant(name, l, w):
        clip = clip_of(name, l, w) if clip_of is not None else None
        return quantize_tensor(w, mode, group_size, clip=clip)

    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    layers = dict(params["layers"])
    for name in _QUANT_KEYS:
        w = layers[name]          # [L, in, out] (or [L, in, 2, I] gate|up)
        structured = w.dim() == 4
        if structured:
            w = w.reshape(w.shape[0], w.shape[1], -1)
        qs, ss = [], []
        for l in range(w.shape[0]):
            t = quant(name, l, w[l])
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
    out["lm_head"] = (quant("lm_head", None, params["lm_head"])
                      if quantize_lm_head else params["lm_head"])
    return out


#: tap name -> the matmul whose INPUT it is (models/llama._layer_gen)
_CAL_TAPS = {"attn_norm": "wqkv", "attn_ctx": "wo",
             "ffn_in": "w_gate_up", "ffn_act": "w_down"}


def calibrate_act_sq(config: ModelConfig, params: Params, token_batches,
                     engine_config=None) -> dict:
    """Per-input-dim activation second moments for calibration-aware
    quantization (ops.quant.search_clip).

    Runs the real forward (models/llama.py, on the device of
    ``params``) teacher-forced over ``token_batches`` (a list of [B, T]
    int arrays or tensors), each batch into a fresh cache, with the debug
    tap capturing every matmul's input, and returns ``{"wqkv" | "wo" |
    "w_gate_up" | "w_down": [L, in] f32}``: E[x_i^2] per layer per input
    dimension, summed in f64 over every row of every batch."""
    from llm_inference_engine_tpu_torch.config import EngineConfig
    from llm_inference_engine_tpu_torch.models import llama
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.utils import debug

    L = config.num_layers
    device = params["embed"].device
    batches = [torch.as_tensor(np.asarray(t), dtype=torch.int32).to(device)
               for t in token_batches]
    max_t = max(t.shape[1] for t in batches)
    max_b = max(t.shape[0] for t in batches)
    eng = engine_config or EngineConfig(max_batch_size=max_b,
                                        max_seq_len=max(2 * max_t, 64))
    dims = {"wqkv": config.hidden_size, "wo": config.q_size,
            "w_gate_up": config.hidden_size,
            "w_down": config.intermediate_size}
    sums = {m: torch.zeros((L, d), dtype=torch.float64, device=device)
            for m, d in dims.items()}
    rows = {m: [0] * L for m in dims}

    def sink(name, value, layer):
        mm = _CAL_TAPS.get(name)
        if mm is None or layer is None:
            return
        x = value.reshape(-1, value.shape[-1]).to(torch.float64)
        sums[mm][layer] += x.square().sum(dim=0)
        rows[mm][layer] += x.shape[0]

    prev = debug.tap
    debug.tap = debug._SinkTap(sink, L)
    try:
        for tb in batches:
            B, T = tb.shape
            cache = kvc.new_kv_cache(L, B, config.num_kv_heads,
                                     eng.max_seq_len, config.head_dim,
                                     dtype=config.dtype, device=device)
            q0 = torch.zeros((B,), dtype=torch.int32, device=device)
            kv = torch.full((B,), T, dtype=torch.int32, device=device)
            llama.decoder_forward(config, eng, params, tb, cache, q0, kv)
    finally:
        debug.tap = prev
    return {m: (s / torch.tensor(rows[m], dtype=torch.float64,
                                 device=device).clamp_min(1.0)[:, None]
                ).to(torch.float32)
            for m, s in sums.items()}


def quantize_params_calibrated(params: Params, act_sq: dict,
                               mode: str = "int8", group_size: int = 128,
                               quantize_lm_head: bool = True) -> Params:
    """quantize_params with calibration-aware clip search (AWQ-lite,
    ops.quant.search_clip): per-scale-block clip factors minimize the
    activation-weighted weight error using ``act_sq`` from
    :func:`calibrate_act_sq`. The output format is identical to
    quantize_params: only q and the scales differ, so every kernel and
    loader works unchanged. The lm_head has no tap point for its input
    (the final norm's output): plain MSE clip search."""

    def clip_of(name, l, w):
        d = act_sq.get(name) if l is not None else None
        if d is not None:
            d = torch.as_tensor(d[l]).to(w.device)
        return search_clip(w, mode, group_size, act_sq=d)

    return _quantize(params, mode, group_size, quantize_lm_head, clip_of)


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


class _Staging:
    """One reused uint8 buffer that file reads land in before they move to
    ``device`` (pinned when ``device`` is the card, so the copy runs at the
    link's rate); None on the CPU, where the read tensor is used as is."""

    def __init__(self, device: torch.device, nbytes: int):
        self.buf = (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                    if device.type == "cuda" else None)
        self.device = device

    def to_device(self, read: Callable) -> torch.Tensor:
        # the copy out of a pinned buffer is synchronous, so the next read
        # may overwrite it
        return read(self.buf).to(self.device)


def _stacked(config: ModelConfig, dtype, device, bias: bool) -> dict:
    L, Hd, I = config.num_layers, config.hidden_size, config.intermediate_size

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)
    layers = {"attn_norm": empty(L, Hd), "wqkv": empty(L, Hd, config.qkv_size),
              "wo": empty(L, config.q_size, Hd), "ffn_norm": empty(L, Hd),
              "w_gate_up": empty(L, Hd, 2, I), "w_down": empty(L, I, Hd)}
    if bias:
        layers["bqkv"] = empty(L, config.qkv_size)
    return layers


def _put_qkv(config: ModelConfig, dst: torch.Tensor, q, k, v) -> None:
    """Write HF-layout [out, in] q/k/v projections (or [out] biases) into
    one layer's group-major packed ``dst`` ([in, K*(G+2)*D] or [K*(G+2)*D]),
    transposing on the fly: the fusion of :func:`fuse_qkv`."""
    K, D = config.num_kv_heads, config.head_dim
    G = config.num_heads // K
    packed = dst.view(*dst.shape[:-1], K, G + 2, D)
    for w, lo, hi in ((q, 0, G), (k, G, G + 1), (v, G + 1, G + 2)):
        w = w.view(K, hi - lo, D, *w.shape[1:])
        packed[..., lo:hi, :].copy_(w.permute(3, 0, 1, 2) if w.dim() == 4
                                    else w)


def _hf_tensor_reader(path: str) -> dict:
    """name -> the ``SafeTensorsFile`` that holds it, over all
    ``*.safetensors`` files in a directory (read through the native
    loader)."""
    from llm_inference_engine_tpu_torch.runtime.native_io import (
        SafeTensorsFile)

    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    index: dict = {}
    for f in files:
        sf = SafeTensorsFile(f)
        for name in sf.names:
            index[name] = sf
    return index


def load_hf_safetensors(config: ModelConfig, path: str, dtype=None,
                        device=None) -> Params:
    """Load a HF-format Llama checkpoint directory (one or more
    ``*.safetensors`` shards) into the fused layout on ``device``: q|k|v
    into the group-major packed ``wqkv`` (and a Qwen2-style ``bqkv``),
    gate|up into ``w_gate_up``, every [out, in] matrix to [in, out], and
    ``lm_head`` from the embedding when the checkpoint ties them."""
    dtype = dtype or config.dtype
    device = torch.device(device or "cpu")
    files = _hf_tensor_reader(path)
    stage = _Staging(device, max(f.nbytes(n) for n, f in files.items()))

    def fetch(name: str) -> torch.Tensor:
        return stage.to_device(lambda buf: files[name].raw(name, buf))

    has_bias = "model.layers.0.self_attn.q_proj.bias" in files
    layers = _stacked(config, dtype, device, has_bias)
    for l in range(config.num_layers):
        p = f"model.layers.{l}."
        a = p + "self_attn."
        _put_qkv(config, layers["wqkv"][l], fetch(a + "q_proj.weight"),
                 fetch(a + "k_proj.weight"), fetch(a + "v_proj.weight"))
        if has_bias:
            _put_qkv(config, layers["bqkv"][l], fetch(a + "q_proj.bias"),
                     fetch(a + "k_proj.bias"), fetch(a + "v_proj.bias"))
        layers["wo"][l].copy_(fetch(a + "o_proj.weight").T)
        gu = layers["w_gate_up"][l]
        gu[:, 0].copy_(fetch(p + "mlp.gate_proj.weight").T)
        gu[:, 1].copy_(fetch(p + "mlp.up_proj.weight").T)
        layers["w_down"][l].copy_(fetch(p + "mlp.down_proj.weight").T)
        layers["attn_norm"][l].copy_(fetch(p + "input_layernorm.weight"))
        layers["ffn_norm"][l].copy_(
            fetch(p + "post_attention_layernorm.weight"))

    embed = fetch("model.embed_tokens.weight").to(dtype)
    head = (fetch("lm_head.weight") if "lm_head.weight" in files
            else embed)                   # tied embeddings
    return {"embed": embed, "layers": layers,
            "final_norm": fetch("model.norm.weight").to(dtype),
            "lm_head": head.T.to(dtype).contiguous()}


def load_reference_bin(config: ModelConfig, path: str, dtype=None,
                       device=None) -> Params:
    """Load the reference engine's own checkpoint format: one raw
    little-endian f32 ``.bin`` per tensor with HF-style names, q|k|v and
    gate|up already fused ([out, in], packed in that order), e.g.
    ``model.layers.0.self_attn.qkv.weight.bin``."""
    from llm_inference_engine_tpu_torch.runtime.native_io import (
        read_bin_tensor)
    dtype = dtype or config.dtype
    device = torch.device(device or "cpu")
    Hd, I, V = config.hidden_size, config.intermediate_size, config.vocab_size
    stage = _Staging(device, 4 * max(config.qkv_size * Hd, 2 * I * Hd,
                                     V * Hd))

    def fetch(name: str, shape) -> torch.Tensor:
        fn = os.path.join(path, name + ".bin")
        expected = int(np.prod(shape)) * 4
        if os.path.getsize(fn) != expected:
            raise ValueError(f"{fn}: expected {expected} bytes "
                             f"({shape} f32), got {os.path.getsize(fn)}")
        return stage.to_device(
            lambda buf: read_bin_tensor(fn, shape, torch.float32, out=buf))

    q_end = config.q_size
    k_end = q_end + config.kv_size
    layers = _stacked(config, dtype, device, False)
    for l in range(config.num_layers):
        p = f"model.layers.{l}."
        qkv = fetch(p + "self_attn.qkv.weight", (config.qkv_size, Hd))
        _put_qkv(config, layers["wqkv"][l], qkv[:q_end], qkv[q_end:k_end],
                 qkv[k_end:])
        layers["wo"][l].copy_(
            fetch(p + "self_attn.o_proj.weight", (Hd, config.q_size)).T)
        gu = fetch(p + "mlp.gate_up_proj.weight", (2 * I, Hd))
        layers["w_gate_up"][l][:, 0].copy_(gu[:I].T)
        layers["w_gate_up"][l][:, 1].copy_(gu[I:].T)
        layers["w_down"][l].copy_(
            fetch(p + "mlp.down_proj.weight", (Hd, I)).T)
        layers["attn_norm"][l].copy_(
            fetch(p + "input_layernorm.weight", (Hd,)))
        layers["ffn_norm"][l].copy_(
            fetch(p + "post_attention_layernorm.weight", (Hd,)))
    return {
        "embed": fetch("model.embed_tokens.weight", (V, Hd)).to(dtype),
        "layers": layers,
        "final_norm": fetch("model.norm.weight", (Hd,)).to(dtype),
        "lm_head": fetch("lm_head.weight", (V, Hd)).T.to(dtype).contiguous(),
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

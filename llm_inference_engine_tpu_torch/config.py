"""Model / engine / sampling configuration.

Port of ``llm_inference_engine_tpu/config.py`` with torch dtypes. The
model presets, the JSON loaders and the RoPE-scaling types are unchanged,
so a preset name means the same architecture in both packages.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import torch

from llm_inference_engine_tpu_torch.utils.common import KERNEL_CHOICES

__all__ = [
    "ModelConfig",
    "EngineConfig",
    "SamplingParams",
    "RopeScaling",
    "NTKScaling",
    "resolve_rope_scaling",
    "PRESETS",
    "get_config",
]


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1-style frequency-dependent RoPE scaling (HF rope_type
    "llama3"): low-frequency bands are slowed by ``factor``, high-frequency
    bands kept, with a smooth ramp between."""
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class NTKScaling:
    """NTK-aware RoPE scaling (HF rope_types "ntk"/"dynamic"): the rope base
    becomes ``theta * s^(dim / (dim - 2))``, with ``s = factor`` for the
    static flavor and, for ``dynamic=True``,
    ``s = factor * L / original - (factor - 1)`` at context length L. The
    engine fixes L at its ``max_seq_len`` once (``resolve_rope_scaling``),
    so cached keys stay consistent."""
    factor: float = 2.0
    original_max_position_embeddings: int = 4096
    dynamic: bool = False

    def effective_theta(self, theta: float, head_dim: int,
                        seq_len: int) -> float:
        if self.dynamic:
            s = (self.factor * max(seq_len, 1)
                 / self.original_max_position_embeddings
                 - (self.factor - 1.0))
            s = max(s, 1.0)
        else:
            s = self.factor
        return theta * s ** (head_dim / (head_dim - 2.0))


def resolve_rope_scaling(config: "ModelConfig",
                         max_seq_len: int) -> "ModelConfig":
    """Fold NTK scaling into a plain rope_theta for a given engine context
    length. Other scaling kinds pass through."""
    rs = config.rope_scaling
    if not isinstance(rs, NTKScaling):
        return config
    theta = rs.effective_theta(config.rope_theta, config.head_dim,
                               max_seq_len)
    return config.replace(rope_theta=theta, rope_scaling=None)


_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


def _dtype_from_str(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description of a Llama-class decoder-only model."""

    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # float = linear position scale; RopeScaling = llama3-style
    # frequency-dependent scaling; None = unscaled
    rope_scaling: Optional[Any] = None
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False          # packed qkv projection bias
    sliding_window: Optional[int] = None  # None = full causal
    dtype_name: str = "bfloat16"          # parameter / activation dtype

    @property
    def dtype(self) -> torch.dtype:
        return _dtype_from_str(self.dtype_name)

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def qkv_size(self) -> int:
        return self.q_size + 2 * self.kv_size

    @property
    def group_size(self) -> int:
        """Number of query heads sharing one KV head (GQA group)."""
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {self.num_heads} is not a multiple "
                             f"of num_kv_heads {self.num_kv_heads}")
        return self.num_heads // self.num_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_json(path: str) -> "ModelConfig":
        """Load from a JSON file (this package's names, HF ``config.json``
        names, or the reference engine's llama_config.json names)."""
        with open(path) as f:
            raw = json.load(f)
        return ModelConfig.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "ModelConfig":
        alias = {
            # HF config.json names
            "num_hidden_layers": "num_layers",
            "num_attention_heads": "num_heads",
            "num_key_value_heads": "num_kv_heads",
            "rms_norm_eps": "rms_norm_eps",
            # reference llama_config.json names
            "head_num": "num_heads",
            "kv_head_num": "num_kv_heads",
            "head_size": "head_dim",
            "inter_size": "intermediate_size",
            "inter_dim": "intermediate_size",
            "num_layer": "num_layers",
            "rope_base": "rope_theta",
            "max_seq_len": "max_position_embeddings",
            "hidden_units": "hidden_size",
        }
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        kw: dict[str, Any] = {}
        for k, v in raw.items():
            k = alias.get(k, k)
            if k in fields and v is not None:   # HF configs carry explicit
                kw[k] = v                       # None for derived fields
        if "head_dim" not in kw and {"hidden_size", "num_heads"} <= set(kw):
            kw["head_dim"] = kw["hidden_size"] // kw["num_heads"]
        rs = kw.get("rope_scaling")
        if isinstance(rs, dict):
            rtype = rs.get("rope_type", rs.get("type", "default"))
            if rtype == "linear":
                kw["rope_scaling"] = float(rs["factor"])
            elif rtype == "llama3":
                kw["rope_scaling"] = RopeScaling(
                    factor=float(rs.get("factor", 8.0)),
                    low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
                    high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
                    original_max_position_embeddings=int(
                        rs.get("original_max_position_embeddings", 8192)))
            elif rtype in ("ntk", "dynamic"):
                kw["rope_scaling"] = NTKScaling(
                    factor=float(rs.get("factor", 2.0)),
                    original_max_position_embeddings=int(
                        rs.get("original_max_position_embeddings",
                               kw.get("max_position_embeddings", 4096))),
                    dynamic=rtype == "dynamic")
            elif rtype == "default":
                kw["rope_scaling"] = None
            else:
                raise ValueError(f"unsupported rope_scaling type {rtype!r}")
        # HF quirks: Qwen2 configs carry sliding_window but gate it off by
        # default, and mark their qkv bias only via model_type
        if raw.get("use_sliding_window") is False:
            kw.pop("sliding_window", None)
        if raw.get("model_type") == "qwen2":
            kw.setdefault("attention_bias", True)
        cfg = ModelConfig(**kw)
        # the reference engine's own config carries an inconsistent
        # hidden_units; trust heads * head_dim there
        if cfg.hidden_size != cfg.num_heads * cfg.head_dim and "head_num" in raw:
            cfg = cfg.replace(hidden_size=cfg.num_heads * cfg.head_dim)
        return cfg


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static runtime/engine shape configuration.

    The fields mirror the JAX package's ``EngineConfig``. Its TPU tiling
    knobs (attention block sizes, layer-scan unroll, page sizes), the
    unused ``max_prefill_batch`` and the int4 group size have no
    counterpart here yet. Values outside the ported slice (quantized
    weights, an int8 KV cache, meshes, the paged layout) are accepted by
    the dataclass and refused by the engine with ``NotImplementedError``.
    """

    max_batch_size: int = 8          # decode batch slots
    max_seq_len: int = 2048          # KV cache capacity per slot
    max_prefill_len: int = 512       # per-chunk prefill length
    kv_cache_dtype_name: str = ""    # "" = same as model dtype
    quant_mode: str = "none"         # none | int8 | int4 (weight-only)
    dp: int = 1
    tp: int = 1
    cp: int = 1
    # "auto": hand kernels on CUDA tensors, plain torch on CPU tensors;
    # "torch": plain torch everywhere; "cuda": hand kernels, CPU raises
    kernels: str = "auto"
    kv_layout: str = "slot"

    def __post_init__(self):
        if self.kernels not in KERNEL_CHOICES:
            raise ValueError(f"kernels must be one of {KERNEL_CHOICES}, got "
                             f"{self.kernels!r}")

    @property
    def kv_cache_dtype(self) -> Optional[torch.dtype]:
        if self.kv_cache_dtype_name in ("", "none"):
            return None
        if self.kv_cache_dtype_name == "int8":
            return torch.int8
        return _dtype_from_str(self.kv_cache_dtype_name)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration."""

    temperature: float = 1.0
    top_k: int = 5
    top_p: float = 1.0
    min_p: float = 0.0               # drop candidates below min_p * p_max
    repetition_penalty: float = 1.0  # HF-style, over the full context
    presence_penalty: float = 0.0    # OpenAI-style, over generated tokens
    frequency_penalty: float = 0.0   # OpenAI-style, per occurrence
    greedy: bool = False
    max_new_tokens: int = 256
    stop_token_ids: tuple[int, ...] = ()


# ---------------------------------------------------------------------------
# Presets (identical to the JAX package's)
# ---------------------------------------------------------------------------

PRESETS: dict[str, ModelConfig] = {
    "llama2-7b": ModelConfig(
        name="llama2-7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=11008, num_layers=32, num_heads=32, num_kv_heads=32,
        head_dim=128, rope_theta=10000.0, max_position_embeddings=4096,
    ),
    "llama2-13b": ModelConfig(
        name="llama2-13b", vocab_size=32000, hidden_size=5120,
        intermediate_size=13824, num_layers=40, num_heads=40, num_kv_heads=40,
        head_dim=128, rope_theta=10000.0, max_position_embeddings=4096,
    ),
    "tinyllama-1.1b": ModelConfig(
        name="tinyllama-1.1b", vocab_size=32000, hidden_size=2048,
        intermediate_size=5632, num_layers=22, num_heads=32, num_kv_heads=4,
        head_dim=64, rope_theta=10000.0, max_position_embeddings=2048,
    ),
    "llama3-8b": ModelConfig(
        name="llama3-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, max_position_embeddings=8192,
    ),
    "llama3.1-8b": ModelConfig(
        name="llama3.1-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, max_position_embeddings=131072,
        rope_scaling=RopeScaling(factor=8.0, low_freq_factor=1.0,
                                 high_freq_factor=4.0,
                                 original_max_position_embeddings=8192),
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=1000000.0, max_position_embeddings=32768,
        sliding_window=4096,
    ),
    "qwen2-7b": ModelConfig(
        name="qwen2-7b", vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, rope_theta=1000000.0, max_position_embeddings=32768,
        attention_bias=True,
    ),
    # tiny debug model for tests (CPU-friendly)
    "debug": ModelConfig(
        name="debug", vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=10000.0, max_position_embeddings=128,
        dtype_name="float32",
    ),
}


def get_config(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]

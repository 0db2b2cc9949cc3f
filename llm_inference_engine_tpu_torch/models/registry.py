"""Model factory: ``create_engine`` (port of the JAX package's registry).

Dummy weights (bf16, or born quantized for ``quant_mode`` int8/int4) and
the JAX package's ``.npz`` checkpoint (``save_params``, quantize once /
serve many) are real. The HF safetensors and reference ``.bin`` loaders
raise ``NotImplementedError`` until they are ported (ROADMAP.md, queue 1,
'Checkpoint loading').
"""

from __future__ import annotations

import os
from typing import Optional

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, PRESETS, get_config)
from llm_inference_engine_tpu_torch.models import weights as W
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

__all__ = ["create_engine", "create_dummy_engine", "create_real_engine"]


def _resolve_config(model: str) -> ModelConfig:
    if model in PRESETS:
        return get_config(model)
    if os.path.exists(model):          # JSON config file (llama_config.json
        return ModelConfig.from_json(model)  # or HF config.json)
    raise ValueError(f"unknown model {model!r}: not a preset "
                     f"({sorted(PRESETS)}) nor a config file path")


def create_dummy_engine(model: str,
                        engine_config: EngineConfig = EngineConfig(),
                        seed: int = 0, device=None) -> InferenceEngine:
    """Engine with random weights drawn on ``device`` from ``seed``
    (born quantized when ``engine_config.quant_mode`` says so)."""
    cfg = _resolve_config(model)
    if engine_config.quant_mode in ("int8", "int4"):
        params = W.init_dummy_quantized_params(
            cfg, engine_config.quant_mode, engine_config.quant_group_size,
            seed=seed, device=device)
    else:
        params = W.init_dummy_params(cfg, seed=seed, device=device)
    return InferenceEngine(cfg, engine_config, params, device=device)


def create_real_engine(model: str, checkpoint_path: str,
                       engine_config: EngineConfig = EngineConfig(),
                       device=None) -> InferenceEngine:
    """Engine with real weights. A ``.npz`` file from ``save_params`` (of
    either package) loads as it is: no re-quantization."""
    cfg = _resolve_config(model)
    if checkpoint_path.endswith(".npz"):
        return InferenceEngine(cfg, engine_config,
                               W.load_saved_params(checkpoint_path, device),
                               device=device)
    raise NotImplementedError(
        "HF safetensors and reference .bin checkpoints are not ported yet "
        "(ROADMAP.md, queue 1, 'Checkpoint loading'); pass a save_params "
        ".npz file, or checkpoint_path=None for dummy weights")


def create_engine(model: str, checkpoint_path: Optional[str] = None,
                  engine_config: EngineConfig = EngineConfig(),
                  seed: int = 0, device=None) -> InferenceEngine:
    """Engine for ``model`` (a preset name or a config JSON path) on
    ``device`` (default: the CPU)."""
    if checkpoint_path:
        return create_real_engine(model, checkpoint_path, engine_config,
                                  device=device)
    return create_dummy_engine(model, engine_config, seed=seed, device=device)

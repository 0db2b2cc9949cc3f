"""Model factory: ``create_engine`` (port of the JAX package's registry).

The dummy-weight path is real. Checkpoint loading and quantized weights
raise ``NotImplementedError`` until they are ported (ROADMAP.md, queue 1,
"Checkpoint loading" and "INT8/INT4 weights").
"""

from __future__ import annotations

import os
from typing import Optional

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, PRESETS, get_config)
from llm_inference_engine_tpu_torch.models import weights as W
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

__all__ = ["create_engine", "create_dummy_engine"]


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
    """Engine with random weights drawn on ``device`` from ``seed``."""
    cfg = _resolve_config(model)
    if engine_config.quant_mode != "none":
        raise NotImplementedError(
            f"quant_mode={engine_config.quant_mode!r} is not ported yet "
            "(ROADMAP.md, queue 1, 'INT8/INT4 weights')")
    params = W.init_dummy_params(cfg, seed=seed, device=device)
    return InferenceEngine(cfg, engine_config, params, device=device)


def create_engine(model: str, checkpoint_path: Optional[str] = None,
                  engine_config: EngineConfig = EngineConfig(),
                  seed: int = 0, device=None) -> InferenceEngine:
    """Engine for ``model`` (a preset name or a config JSON path) on
    ``device`` (default: the CPU)."""
    if checkpoint_path:
        raise NotImplementedError(
            "checkpoint loading is not ported yet (ROADMAP.md, queue 1, "
            "'Checkpoint loading'); pass checkpoint_path=None for dummy "
            "weights")
    return create_dummy_engine(model, engine_config, seed=seed, device=device)

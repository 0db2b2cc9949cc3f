"""Model factory: ``create_engine`` (port of the JAX package's registry).

Dummy weights (bf16, or born quantized for ``quant_mode`` int8/int4), the
JAX package's ``.npz`` checkpoint (``save_params``, quantize once / serve
many), and checkpoint directories: HF safetensors when the directory holds
any ``*.safetensors``, else the reference's per-tensor ``.bin`` files,
quantized on load when ``quant_mode`` says so.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, PRESETS, get_config)
from llm_inference_engine_tpu_torch.models import weights as W
from llm_inference_engine_tpu_torch.runtime.engine import (
    InferenceEngine, check_kernel_dtypes)

__all__ = ["create_engine", "create_dummy_engine", "create_real_engine"]


def _resolve_config(model) -> ModelConfig:
    """``model``: a ModelConfig, a preset name or a config JSON path."""
    if isinstance(model, ModelConfig):
        return model
    if model in PRESETS:
        return get_config(model)
    if os.path.exists(model):          # JSON config file (llama_config.json
        return ModelConfig.from_json(model)  # or HF config.json)
    raise ValueError(f"unknown model {model!r}: not a preset "
                     f"({sorted(PRESETS)}) nor a config file path")


def _on_device(device) -> torch.device:
    """The factories' device: the card unless the caller asks for the CPU;
    no silent move to the CPU when there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"create_engine: device {device} asked for, but "
                           "no CUDA device is available (pass "
                           "device='cpu' to build on the CPU)")
    return device


def create_dummy_engine(model,
                        engine_config: EngineConfig = EngineConfig(),
                        seed: int = 0, device="cuda") -> InferenceEngine:
    """Engine with random weights drawn on ``device`` from ``seed``
    (born quantized when ``engine_config.quant_mode`` says so)."""
    device = _on_device(device)
    cfg = _resolve_config(model)
    check_kernel_dtypes(cfg, engine_config, device)
    if engine_config.quant_mode in ("int8", "int4"):
        params = W.init_dummy_quantized_params(
            cfg, engine_config.quant_mode, engine_config.quant_group_size,
            seed=seed, device=device)
    else:
        params = W.init_dummy_params(cfg, seed=seed, device=device)
    return InferenceEngine(cfg, engine_config, params, device=device)


def create_real_engine(model: str, checkpoint_path: str,
                       engine_config: EngineConfig = EngineConfig(),
                       device="cuda") -> InferenceEngine:
    """Engine with real weights on ``device``: a ``.npz`` file from
    ``save_params`` (of either package) loads as it is, with no
    re-quantization; an HF safetensors or reference ``.bin`` directory
    loads onto ``device`` and is quantized there when
    ``engine_config.quant_mode`` says so."""
    device = _on_device(device)
    cfg = _resolve_config(model)
    check_kernel_dtypes(cfg, engine_config, device)
    if checkpoint_path.endswith(".npz"):
        return InferenceEngine(cfg, engine_config,
                               W.load_saved_params(checkpoint_path, device),
                               device=device)
    params = load_checkpoint_dir(cfg, checkpoint_path, device)
    if engine_config.quant_mode in ("int8", "int4"):
        params = W.quantize_params(params, engine_config.quant_mode,
                                   engine_config.quant_group_size)
    return InferenceEngine(cfg, engine_config, params, device=device)


def load_checkpoint_dir(cfg: ModelConfig, path: str, device) -> dict:
    """An HF safetensors directory if it holds any ``*.safetensors``, else
    a reference ``.bin`` directory, loaded onto ``device``."""
    if any(f.endswith(".safetensors") for f in os.listdir(path)):
        return W.load_hf_safetensors(cfg, path, device=device)
    return W.load_reference_bin(cfg, path, device=device)


def create_engine(model, checkpoint_path: Optional[str] = None,
                  engine_config: EngineConfig = EngineConfig(),
                  seed: int = 0, device="cuda") -> InferenceEngine:
    """Engine for ``model`` (a preset name, a config JSON path or a
    ModelConfig) on
    ``device``: the card by default (RuntimeError when there is none);
    pass ``device="cpu"`` to build on the CPU."""
    if checkpoint_path:
        return create_real_engine(model, checkpoint_path, engine_config,
                                  device=device)
    return create_dummy_engine(model, engine_config, seed=seed, device=device)

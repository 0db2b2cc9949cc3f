"""Structured logging.

Port of ``llm_inference_engine_tpu/utils/logging.py``: one leveled logger
tree, silent below WARNING unless ``LLM_TPU_LOG_LEVEL`` (the JAX
package's variable, read here too) asks for more. The tree's root is
``llm_inference_engine_tpu_torch``.
"""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["get_logger"]

_ROOT = "llm_inference_engine_tpu_torch"
_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    level = os.environ.get("LLM_TPU_LOG_LEVEL", "WARNING").upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    root.setLevel(getattr(logging, level, logging.WARNING))
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"{_ROOT}.{name}")

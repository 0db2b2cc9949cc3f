"""PyTorch/CUDA port of the LLM inference engine, for one NVIDIA H100.

The JAX package ``llm_inference_engine_tpu`` is the reference; this
package mirrors its module tree and public names so that each part has an
obvious counterpart (``llm_inference_engine_tpu/ops/rmsnorm.py`` ->
``llm_inference_engine_tpu_torch/ops/rmsnorm.py``). Plain tensor code is
PyTorch; every Pallas kernel on the ported path is a kernel written by
hand for Hopper (Triton, or CUDA C++ under ``csrc/`` built with ``nvcc``
and bound with ``ctypes``). Each kernel's plain PyTorch version sits in
the same module: it serves CPU tensors and ``kernels="torch"``.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingParams)

__all__ = ["ModelConfig", "EngineConfig", "SamplingParams"]

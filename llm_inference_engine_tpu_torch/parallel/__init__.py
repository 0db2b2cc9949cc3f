"""Tensor, data, context and pipeline parallelism over a mesh of torch
devices, and the multi-host serving support (port of
``llm_inference_engine_tpu/parallel``)."""

from llm_inference_engine_tpu_torch.parallel.mesh import make_mesh
from llm_inference_engine_tpu_torch.parallel.multihost import (
    initialize_multihost, make_multihost_mesh)
from llm_inference_engine_tpu_torch.parallel import pipeline  # noqa: F401
from llm_inference_engine_tpu_torch.parallel import sharding  # noqa: F401

__all__ = ["make_mesh", "make_multihost_mesh", "initialize_multihost",
           "pipeline", "sharding"]

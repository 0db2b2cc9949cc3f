"""Compute ops.

Where the JAX package had a Pallas kernel on the ported path (rmsnorm,
activations, kv_cache, attention), the module holds a dispatcher
``<op>(..., kernels=...)`` and the plain version ``<op>_torch(...)``:
on CUDA tensors the dispatcher runs a kernel written by hand for Hopper
(Triton in ``_triton_kernels.py``, CUDA C++ in ``../csrc`` via
``_native.py``) and counts its launches in a ``launches`` attribute; on
CPU tensors, or with ``kernels="torch"``, it runs the plain version. The
other ops (embedding, linear, rope, sampling) are plain torch, as the
JAX package left them to XLA.
"""

from llm_inference_engine_tpu_torch.ops import (  # noqa: F401
    activations,
    attention,
    embedding,
    kv_cache,
    linear,
    rmsnorm,
    rope,
    sampling,
)

__all__ = ["activations", "attention", "embedding", "kv_cache", "linear",
           "rmsnorm", "rope", "sampling"]

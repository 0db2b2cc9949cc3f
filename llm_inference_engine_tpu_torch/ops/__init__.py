"""Compute ops.

Where the JAX package had a Pallas kernel on the ported path (rmsnorm,
activations, kv_cache, attention, quant), the module holds a dispatcher
``<op>(..., kernels=...)`` and the plain version ``<op>_torch(...)``:
on CUDA tensors the dispatcher runs a kernel written by hand for Hopper
(Triton in ``_triton_kernels.py``, CUDA C++ in ``../csrc`` via
``_native.py``) and counts its launches in a ``launches`` attribute; on
CPU tensors, or with ``kernels="torch"``, it runs the plain version.
rope's QKV split and rotation (kernel J) is such a pair too, though the
JAX package left it to XLA: eager torch has no fusion to take XLA's
place. The other ops (embedding, linear, sampling, rope's cos/sin) are
plain torch, as the JAX package left them to XLA. :func:`counted_wrappers`
lists every wrapper with a counter (a captured decode program adds its
launches on each replay, ``runtime/decode_graph.py``).
"""

from llm_inference_engine_tpu_torch.ops import (  # noqa: F401
    activations,
    attention,
    embedding,
    kv_cache,
    linear,
    paged_kv,
    quant,
    rmsnorm,
    rope,
    sampling,
)

__all__ = ["activations", "attention", "counted_wrappers", "embedding",
           "kv_cache", "linear", "paged_kv", "quant", "rmsnorm", "rope",
           "sampling"]


def counted_wrappers() -> list:
    """Every kernel wrapper with a launch counter (its ``launches``), in
    a fixed order."""
    found = []
    for module in (activations, attention, kv_cache, paged_kv, quant,
                   rmsnorm, rope):
        for name in sorted(vars(module)):
            f = getattr(module, name)
            if callable(f) and hasattr(f, "launches") and f not in found:
                found.append(f)
    return found

"""Dense (and, via ops.quant, dequantizing) matrix multiplication.

Port of ``llm_inference_engine_tpu/ops/linear.py``. The JAX package leaves
the dense matmul to XLA (``dot_general``); the port leaves it to
``torch.matmul`` (cuBLAS on the card). Weights are stored [in, out].
A :class:`~llm_inference_engine_tpu_torch.ops.quant.QuantizedTensor`
weight goes to ``quant.quantized_linear`` (kernels E, F and G).
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_inference_engine_tpu_torch.ops import quant

__all__ = ["linear"]


def linear(x: torch.Tensor, w, out_dtype: Optional[torch.dtype] = None, *,
           kernels: str = "auto") -> torch.Tensor:
    """y = x @ w. x: [..., in], w: [in, out] or [in, *out_dims] (trailing
    out dims are flattened, e.g. the [in, 2, I] gate|up stack), or a
    quantized weight (``kernels`` picks its kernels or plain versions).

    Products accumulate in f32. With ``out_dtype=torch.float32`` and
    half-precision inputs (the lm_head) the result is never rounded
    through the input dtype, matching the JAX package's
    ``preferred_element_type=f32``."""
    if isinstance(w, quant.QuantizedTensor):
        return quant.quantized_linear(x, w, out_dtype, kernels=kernels)
    out_dtype = out_dtype or x.dtype
    if w.dim() > 2:
        w = w.reshape(w.shape[0], -1)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if out_dtype == torch.float32 and x.dtype != torch.float32:
        if x.is_cuda:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        else:   # bf16 products are exact in f32, so this is the same sum
            y = x2.float() @ w.float()
    else:
        y = (x2 @ w).to(out_dtype)
    return y.reshape(*lead, w.shape[1])

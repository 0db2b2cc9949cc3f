"""Dense matrix multiplication.

Port of ``llm_inference_engine_tpu/ops/linear.py``. The JAX package leaves
the dense matmul to XLA (``dot_general``); the port leaves it to
``torch.matmul`` (cuBLAS on the card). Weights are stored [in, out].
Quantized weights are not ported yet (ROADMAP.md, queue 1, "INT8/INT4
weights").
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["linear"]


def linear(x: torch.Tensor, w: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ w. x: [..., in], w: [in, out] or [in, *out_dims] (trailing
    out dims are flattened, e.g. the [in, 2, I] gate|up stack).

    Products accumulate in f32. With ``out_dtype=torch.float32`` and
    half-precision inputs (the lm_head) the result is never rounded
    through the input dtype, matching the JAX package's
    ``preferred_element_type=f32``."""
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

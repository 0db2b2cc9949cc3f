from llm_inference_engine_tpu_torch.utils.checks import assert_finite, nan_guard
from llm_inference_engine_tpu_torch.utils.common import (
    KERNEL_CHOICES,
    cdiv,
    round_up,
    use_kernel,
)

__all__ = ["KERNEL_CHOICES", "assert_finite", "cdiv", "nan_guard",
           "round_up", "use_kernel"]

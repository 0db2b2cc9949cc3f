from llm_inference_engine_tpu_torch.utils.common import (
    KERNEL_CHOICES,
    cdiv,
    round_up,
    use_kernel,
)

__all__ = ["KERNEL_CHOICES", "cdiv", "round_up", "use_kernel"]

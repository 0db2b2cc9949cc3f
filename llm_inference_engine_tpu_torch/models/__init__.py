from llm_inference_engine_tpu_torch.models import llama, weights  # noqa: F401

__all__ = ["llama", "weights"]

from llm_inference_engine_tpu_torch.runtime.engine import (
    GenerationResult, InferenceEngine)

__all__ = ["InferenceEngine", "GenerationResult"]

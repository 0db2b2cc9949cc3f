"""Offline tools of the port (``python -m llm_inference_engine_tpu_torch.tools.<name>``)."""

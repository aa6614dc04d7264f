"""Runnable examples of the port (``python -m
cuauv_vision_pipeline_tpu_torch.examples.<name>``)."""

"""YOLO on PyTorch/CUDA: torch model (all five tasks), decode + NMS (a CUDA
kernel on the card), quantized serving, data classes, tracking, checkpoint
I/O and the trainer. Port of ``cuauv_vision_pipeline_tpu.models.yolo``."""

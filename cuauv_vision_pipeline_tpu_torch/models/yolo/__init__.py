"""YOLO on PyTorch/CUDA: torch model, decode + NMS (a CUDA kernel on the
card), data classes, tracking. Port of ``cuauv_vision_pipeline_tpu.models.yolo``
for the detect and obb tasks."""

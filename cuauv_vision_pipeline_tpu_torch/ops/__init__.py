"""Vision ops on torch tensors — the port of ``cuauv_vision_pipeline_tpu.ops``.

Functions take ``[..., H, W, C]`` (or ``[..., H, W]``) tensors on any device
and keep the reference's u8 semantics bit for bit (OpenCV's fixed-point
colorspaces, cv2.inRange, identity-bordered morphology, raster-root CCL
labels). Where the JAX package had a Pallas kernel, ``ops/cuda/`` holds a
hand-written CUDA kernel; its wrapper falls back to the plain torch version
only for a tensor that lies on the CPU.
"""

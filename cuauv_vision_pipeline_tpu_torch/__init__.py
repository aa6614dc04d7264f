"""cuauv_vision_pipeline_tpu_torch — the vision pipeline on PyTorch and CUDA.

The port of ``cuauv_vision_pipeline_tpu`` (JAX/Pallas, the frozen reference)
to PyTorch with hand-written CUDA kernels for NVIDIA Hopper (``sm_90a``).
It imports neither JAX nor the JAX package; the frame bus, shm groups and
tuner blocks keep the reference's wire format byte for byte, so processes of
both packages share one bus.

* ``native/``   — the C++ shared-memory frame bus, built with g++ at first use.
* ``core/``     — module framework (ModuleBase/@device_fn, tuners, shm, bus
                  binding over ctypes, capture-source harness).
* ``ops/``      — colorspace, threshold, morphology, connected components,
                  Canny/Hough/keypoints, balance and transforms as torch
                  ops; ``ops/cuda/`` wraps the CUDA kernels of ``csrc/``
                  (CCL union-find, fused 5x5 morphology, NMS, spacing).
* ``engine/``   — the red_buoy and HSV mask chains and the depth-N stream
                  executor.
* ``utils/``    — the numpy-in/numpy-out library (color, feature, transform,
                  undistort, contours, drawing, SIFT pose).
* ``capture_sources/``, ``modules/``, ``models/`` — cameras, the vision
                  modules and YOLO.

Entry points run on ``cuda`` unless ``--device cpu`` is given.
"""

__version__ = "0.1.0"

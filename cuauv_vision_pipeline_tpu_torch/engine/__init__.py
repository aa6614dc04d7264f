"""The execution engine: the red_buoy chain and the depth-N stream executor
that overlaps host-to-device copies, kernels and readback (the successor of
the reference's double-buffered ZED pipeline, reference
capture_sources/zed.py:129-253)."""

from .executor import DevicePipeline, StreamExecutor
from . import chains

__all__ = ["DevicePipeline", "StreamExecutor", "chains"]

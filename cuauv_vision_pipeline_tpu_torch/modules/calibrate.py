#!/usr/bin/env python3
"""Manual camera calibration UI: tuners mirrored into shm.camera_calibration.

Port of ``cuauv_vision_pipeline_tpu.modules.calibrate`` (reference
modules/calibrate.py:92-115), host only: a tuner per camera setting, each
pushed into ``shm.camera_calibration`` on change, with ``@sources`` views of
the ZED's forward, depth (normalized for display) and normal planes.

    python -m cuauv_vision_pipeline_tpu_torch.modules.calibrate zed [--device N|cpu]
"""

from __future__ import annotations

import numpy as np

from ..core import shm
from ..core.base import ModuleBase, sources
from ..core.tuners import DoubleTuner

_FIELDS = [
    ("brightness", 50.0, 0.0, 100.0),
    ("contrast", 50.0, 0.0, 100.0),
    ("hue", 0.0, -180.0, 180.0),
    ("saturation", 50.0, 0.0, 100.0),
    ("gamma", 50.0, 0.0, 100.0),
    ("sharpness", 50.0, 0.0, 100.0),
    ("white_balance", 4600.0, 2800.0, 6500.0),
    ("exposure", 50.0, 0.0, 100.0),
    ("gain", 50.0, 0.0, 100.0),
    ("red_gain", 1.0, 0.0, 4.0),
    ("green_gain", 1.0, 0.0, 4.0),
    ("blue_gain", 1.0, 0.0, 4.0),
]

module_tuners = [DoubleTuner(n, d, lo, hi) for n, d, lo, hi in _FIELDS]

ZED_MIN_M = 0.5
ZED_MAX_M = 10.0


class Calibrate(ModuleBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._last = {}

    def _sync_tuners_to_shm(self):
        for name, *_ in _FIELDS:
            value = self.tuners[name]
            if self._last.get(name) != value:
                self._last[name] = value
                shm.camera_calibration.set_field(name, value)

    @sources("zed[forward]", "zed[depth]", "zed[normal]")
    def handle(self, forward, depth, normal):
        self._sync_tuners_to_shm()
        self.post("forward", forward)

        depth_f = depth[..., 0] if depth.ndim == 3 else depth
        depth_u8 = np.clip(
            (depth_f.astype(np.float32) - ZED_MIN_M) * (255.0 / (ZED_MAX_M - ZED_MIN_M)),
            0,
            255,
        ).astype(np.uint8)
        self.post("depth", depth_u8, "GRAY")

        if normal.dtype != np.uint8:
            normal = np.clip(normal * 255.0, 0, 255).astype(np.uint8)
        self.post("normal", normal)


if __name__ == "__main__":
    Calibrate(["zed"], module_tuners)()

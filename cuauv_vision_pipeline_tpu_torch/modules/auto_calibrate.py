#!/usr/bin/env python3
"""Closed-loop exposure / white-balance controller.

Port of ``cuauv_vision_pipeline_tpu.modules.auto_calibrate`` (reference
modules/auto_calibrate.py:56-259), host only: the LAB-L brightness error
drives exponentially smoothed exposure updates; the RGB means of a
designated color box drive per-channel gain updates into
``shm.camera_calibration``. Control loops stay off the device.

    python -m cuauv_vision_pipeline_tpu_torch.modules.auto_calibrate forward [--device N|cpu]
"""

from __future__ import annotations

import numpy as np

from ..core import shm
from ..core.base import ModuleBase
from ..core.tuners import BoolTuner, DoubleTuner, IntTuner
from ..ops.color_np import lab_l_np
from ..utils.draw import Color, draw_rect

module_tuners = [
    BoolTuner("enable_exposure", True),
    BoolTuner("enable_white_balance", True),
    IntTuner("target_brightness", 127, 0, 255),
    DoubleTuner("exposure_rate", 0.1, 0.0, 1.0),
    DoubleTuner("gain_rate", 0.05, 0.0, 1.0),
    IntTuner("box_x", 100, 0, 4000),
    IntTuner("box_y", 100, 0, 4000),
    IntTuner("box_size", 50, 4, 500),
    # brightness-mean sampling stride: the exposure loop needs the MEAN L,
    # not per-pixel exactness; stride 1 is the reference's full-frame LAB
    IntTuner("sample_stride", 4, 1, 16),
]


class AutoCalibrate(ModuleBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._exposure_smooth = None

    def process(self, direction, img):
        calib = shm.camera_calibration

        if self.tuners["enable_exposure"]:
            s = max(int(self.tuners["sample_stride"]), 1)
            brightness = float(lab_l_np(img[::s, ::s]).mean())
            error = self.tuners["target_brightness"] - brightness
            rate = self.tuners["exposure_rate"]
            current = calib.exposure.get()
            # exponentially smoothed proportional update
            step = rate * error / 255.0 * 100.0
            if self._exposure_smooth is None:
                self._exposure_smooth = step
            else:
                self._exposure_smooth = 0.7 * self._exposure_smooth + 0.3 * step
            calib.exposure.set(float(np.clip(current + self._exposure_smooth, 0, 100)))

        annotated = img.copy()
        if self.tuners["enable_white_balance"]:
            x, y = self.tuners["box_x"], self.tuners["box_y"]
            size = self.tuners["box_size"]
            h, w = img.shape[:2]
            x = min(x, max(w - size, 0))
            y = min(y, max(h - size, 0))
            box = img[y : y + size, x : x + size].astype(np.float32)
            if box.size:
                b_mean, g_mean, r_mean = (box[..., c].mean() for c in range(3))
                gray = (b_mean + g_mean + r_mean) / 3.0
                rate = self.tuners["gain_rate"]

                def update(field, mean):
                    gain = getattr(calib, field).get()
                    target = gray / max(mean, 1.0)
                    getattr(calib, field).set(
                        float(np.clip(gain + rate * (target - gain), 0.1, 4.0))
                    )

                update("red_gain", r_mean)
                update("green_gain", g_mean)
                update("blue_gain", b_mean)
                draw_rect(annotated, (x, y), (x + size, y + size), Color.YELLOW, 2)

        self.post("calibration view", annotated)


if __name__ == "__main__":
    AutoCalibrate(["forward"], module_tuners)()

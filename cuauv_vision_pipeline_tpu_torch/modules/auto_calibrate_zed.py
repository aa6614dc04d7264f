#!/usr/bin/env python3
"""ZED auto-calibration: drives ZED exposure/gain from LAB-L brightness.

Port of ``cuauv_vision_pipeline_tpu.modules.auto_calibrate_zed`` (reference
modules/auto_calibrate_zed.py:55-185), host only: the brightness error moves
zed_exposure (spilling into zed_gain at the ends) in
``shm.zed_calibration``, with manual pass-through tuners for contrast, hue,
saturation, gamma, sharpness and white balance.

    python -m cuauv_vision_pipeline_tpu_torch.modules.auto_calibrate_zed zed [--device N|cpu]
"""

from __future__ import annotations

import numpy as np

from ..core import shm
from ..core.base import ModuleBase
from ..core.tuners import BoolTuner, DoubleTuner, IntTuner
from ..ops.color_np import lab_l_np

module_tuners = [
    BoolTuner("auto_exposure_loop", True),
    IntTuner("target_brightness", 127, 0, 255),
    DoubleTuner("exposure_rate", 0.1, 0.0, 1.0),
    DoubleTuner("contrast", 4.0, 0.0, 8.0),
    DoubleTuner("hue", 0.0, -180.0, 180.0),
    DoubleTuner("saturation", 4.0, 0.0, 8.0),
    DoubleTuner("gamma", 5.0, 0.0, 9.0),
    DoubleTuner("sharpness", 4.0, 0.0, 8.0),
    DoubleTuner("white_balance", 4600.0, 2800.0, 6500.0),
]

_PASSTHROUGH = ("contrast", "hue", "saturation", "gamma", "sharpness", "white_balance")


class AutoCalibrateZed(ModuleBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._last = {}

    def process(self, direction, img):
        calib = shm.zed_calibration

        for name in _PASSTHROUGH:
            value = self.tuners[name]
            if self._last.get(name) != value:
                self._last[name] = value
                calib.set_field(name, value)

        if self.tuners["auto_exposure_loop"]:
            error = self.tuners["target_brightness"] - float(lab_l_np(img).mean())
            rate = self.tuners["exposure_rate"]
            exposure = calib.zed_exposure.get()
            new_exposure = float(np.clip(exposure + rate * error / 255.0 * 100.0, 0, 100))
            calib.zed_exposure.set(new_exposure)
            # spill into gain when exposure saturates
            if new_exposure >= 99.0 and error > 5:
                calib.zed_gain.set(float(np.clip(calib.zed_gain.get() + 1, 0, 100)))
            elif new_exposure <= 1.0 and error < -5:
                calib.zed_gain.set(float(np.clip(calib.zed_gain.get() - 1, 0, 100)))

        self.post("view", img)


if __name__ == "__main__":
    AutoCalibrateZed(["zed"], module_tuners)()

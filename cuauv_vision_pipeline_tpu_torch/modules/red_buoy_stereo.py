#!/usr/bin/env python3
"""Stereo red_buoy: both ZED eyes detected in one device dispatch.

Port of ``cuauv_vision_pipeline_tpu.modules.red_buoy_stereo``. The forward
and forward2 planes stack into a ``[2, H, W, 3]`` batch through the red_buoy
chain (``engine/chains.py:red_buoy_fused``, which takes a batch): the
batched CUDA CCL (``label_cuda_batched``) labels both masks in one launch,
``fused_morph`` cleans both in one launch, and per-camera blob stats come
back as one packed fetch. The reference would run two module processes
for this (reference core/module_toggler.py); here it is one process and one
upload/compute/readback cycle.

    python -m cuauv_vision_pipeline_tpu_torch.modules.red_buoy_stereo zed [--device N|cpu]
"""

from __future__ import annotations

import torch

from ..core import shm
from ..core.base import DeviceResultMeta, ModuleBase, device_fn
from ..core.tuners import IntTuner
from ..engine.chains import red_buoy_fused

module_tuners = [
    IntTuner("thresh_min", 0, 0, 255),
    IntTuner("thresh_max", 255, 0, 255),
]

# the JAX module's group, byte for byte (field order is the layout)
RESULTS_SCHEMA = {
    "visible_left": "bool",
    "center_x_left": "float",
    "center_y_left": "float",
    "area_left": "float",
    "visible_right": "bool",
    "center_x_right": "float",
    "center_y_right": "float",
    "area_right": "float",
    "latency_ms": "float",
}
shm.define_group("red_buoy_stereo_results", RESULTS_SCHEMA)


class BuoyStereo(ModuleBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        shm.red_buoy_stereo_results.set(
            visible_left=False, visible_right=False, latency_ms=0.0
        )

    @device_fn("zed[forward]", "zed[forward2]", depth=2, async_fetch=True)
    def stereo_chain(self, forward, forward2, *, tuners, want_posts):
        """Both eyes as one ``[2, H, W, 3]`` batch through the red_buoy
        chain: LAB A channel -> inRange -> open + close (one ``fused_morph``
        launch for both; the composed plain version on the CPU, bit-equal to
        the JAX package's ``close_morph(open_morph(...))``) -> one batched
        CCL launch on the UN-cleaned masks -> each eye's largest blob."""
        masks, cleaned, best = red_buoy_fused(
            torch.stack([forward, forward2]), tuners["thresh_min"], tuners["thresh_max"]
        )
        best = {k: best[k] for k in ("area", "centroid", "found")}
        posts = (
            {"threshed_left": masks[0], "threshed_right": masks[1],
             "cleaned_left": cleaned[0], "cleaned_right": cleaned[1]}
            if want_posts
            else {}
        )
        return best, posts

    def on_device_result(self, best, posts, meta: DeviceResultMeta):
        values = {"latency_ms": float(meta.latency_ms())}
        for cam, side in enumerate(("left", "right")):
            found = bool(best["found"][cam])
            if found:
                cy, cx = (float(v) for v in best["centroid"][cam])
                ny, nx = self.normalize((cy, cx))
                area = float(best["area"][cam])
            else:
                ny = nx = area = 0.0
            values[f"visible_{side}"] = found
            values[f"center_x_{side}"] = nx
            values[f"center_y_{side}"] = ny
            values[f"area_{side}"] = area
        shm.red_buoy_stereo_results.set(**values)

        for name, img in posts.items():
            self.post(name, img, "GRAY")


if __name__ == "__main__":
    BuoyStereo(["zed"], module_tuners)()

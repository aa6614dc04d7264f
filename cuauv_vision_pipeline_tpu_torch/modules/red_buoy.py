#!/usr/bin/env python3
"""Red buoy detector — the canonical threshold+contour module, on PyTorch/CUDA.

Port of ``cuauv_vision_pipeline_tpu.modules.red_buoy`` (reference
modules/red_buoy.py:16-56). Pipeline: BGR -> LAB A channel -> inRange with
thresh_min/max IntTuners -> open+close with a 5x5 rect kernel -> connected
components (CUDA union-find) -> centroid/area of the largest blob ->
normalize -> shm.red_buoy_results + debug posts.

The chain (engine/chains.py red_buoy_fused) is the module's @device_fn;
ModuleBase runs it through a depth-2 StreamExecutor with async fetch, so
frame N's upload and kernels overlap the bus read of frame N+1. In
performance mode (`--enable-performance`) ``want_posts`` is False and only
the detection scalars cross back to the host.

    python -m cuauv_vision_pipeline_tpu_torch.modules.red_buoy zed [--device cpu]
"""

from __future__ import annotations

import numpy as np

from ..core import shm
from ..core.base import DeviceResultMeta, ModuleBase, device_fn
from ..core.tuners import IntTuner
from ..engine.chains import red_buoy_fused
from ..utils.draw import Color, draw_circle, draw_rect

module_tuners = [
    IntTuner("thresh_min", 0, 0, 255),
    IntTuner("thresh_max", 255, 0, 255),
]


class BuoyLAB(ModuleBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # fresh results on startup: stale values from a previous run must
        # not read as a live detection
        shm.red_buoy_results.set(
            visible=False,
            center_x=0.0,
            center_y=0.0,
            area=0.0,
            latency_ms=0.0,
            latency_newest_ms=0.0,
        )

    # only the forward plane ships to the device (the reference module also
    # took zed[normal] but never used it, reference modules/red_buoy.py:18);
    # depth-2 + async fetch keep upload, kernels and readback overlapped.
    # batch=4: when the module falls behind the camera each dispatch drains
    # up to 4 queued frames instead of dropping 3; batch_mode="map" runs
    # them one after another through the per-frame chain.
    @device_fn(
        "zed[forward]", depth=2, async_fetch=True, batch=4, batch_mode="map"
    )
    def buoy_chain(self, image, *, tuners, want_posts):
        threshed, cleaned, best = red_buoy_fused(
            image, tuners["thresh_min"], tuners["thresh_max"]
        )
        posts = (
            {"image": image, "threshed": threshed, "threshed_cleaned": cleaned}
            if want_posts
            else {}
        )
        return best, posts

    def on_device_result(self, best, posts, meta: DeviceResultMeta):
        found = bool(best["found"])
        if found:
            cy, cx = (float(v) for v in best["centroid"])
            area = float(best["area"])
            ny, nx = self.normalize((cy, cx))
        else:
            cy = cx = area = 0.0
            ny = nx = 0.0

        fields = dict(
            visible=found,
            center_x=nx,
            center_y=ny,
            area=area,
            latency_ms=float(meta.latency_ms()),
        )
        if meta.newest:
            # freshest-lane latency: drained stale lanes deliberately count
            # their queueing time in latency_ms; this field tracks how old
            # the newest detection is (the latest-wins-comparable number)
            fields["latency_newest_ms"] = fields["latency_ms"]
        shm.red_buoy_results.set(**fields)

        if posts:
            self.post("threshed", posts["threshed"], "GRAY")
            self.post("threshed_cleaned", posts["threshed_cleaned"], "GRAY")
            # unpacked results are views into the fetched buffer; the
            # annotation overlay needs a writable copy
            annotated = np.array(posts["image"], dtype=np.uint8, copy=True)
            if found:
                x, y, w, h = (int(v) for v in best["bbox"])
                draw_rect(
                    annotated, (x, y), (x + w, y + h), Color.GREEN, thickness=3
                )
                draw_circle(
                    annotated, (int(cx), int(cy)), 4, Color.YELLOW, thickness=-1
                )
            self.post("contours", annotated)


if __name__ == "__main__":
    BuoyLAB(["zed"], module_tuners)()

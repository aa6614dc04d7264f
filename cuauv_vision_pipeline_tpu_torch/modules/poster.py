#!/usr/bin/env python3
"""Poster: republishes the ZED planes for the WebGUI + end-to-end latency.

Port of ``cuauv_vision_pipeline_tpu.modules.poster`` (host only). Parity
target: reference modules/poster.py:26-72 — posts the four zed planes
(scaling depth by the ZED min/max range to u8, normals [0,1] -> u8), updates
shm.poster_status counters and the camera->GUI latency EMA from
zed_metrics.start_time_sec.

    python -m cuauv_vision_pipeline_tpu_torch.modules.poster zed
"""

from __future__ import annotations

import time

import numpy as np

from ..core import shm
from ..core.base import ModuleBase, sources

ZED_MIN_M = 0.5
ZED_MAX_M = 10.0
LATENCY_ALPHA = 0.1


class Poster(ModuleBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._latency_ema = 0.0
        self._frames = 0

    @sources("zed[forward]", "zed[forward2]", "zed[depth]", "zed[normal]")
    def handle(self, forward, forward2, depth, normal):
        self.post("forward", forward)
        self.post("forward2", forward2)

        depth_f = depth[..., 0] if depth.ndim == 3 else depth
        depth_u8 = np.clip(
            (depth_f.astype(np.float32) - ZED_MIN_M)
            * (255.0 / (ZED_MAX_M - ZED_MIN_M)),
            0,
            255,
        ).astype(np.uint8)
        self.post("depth", depth_u8, "GRAY")

        if normal.dtype != np.uint8:
            normal_u8 = np.clip(
                normal.astype(np.float32) * 255.0, 0, 255
            ).astype(np.uint8)
        else:
            normal_u8 = normal
        self.post("normal", normal_u8)

        self._frames += 1
        start = shm.zed_metrics.start_time_sec.get()
        if start > 0:
            latency = max(0.0, time.time() - start)
            self._latency_ema = (
                latency
                if self._frames == 1
                else self._latency_ema * (1 - LATENCY_ALPHA)
                + latency * LATENCY_ALPHA
            )
        shm.poster_status.set(
            frames_posted=self._frames, latency_ema_sec=self._latency_ema
        )


if __name__ == "__main__":
    Poster(["zed"], [])()

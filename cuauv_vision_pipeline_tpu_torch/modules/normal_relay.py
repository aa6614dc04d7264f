#!/usr/bin/env python3
"""Normal relay: samples surface normals around a requested point.

Port of ``cuauv_vision_pipeline_tpu.modules.normal_relay``: the decode runs
on the module's device (cuda:0 unless ``--device cpu``). Parity target:
reference modules/normal_relay.py:16-121 — reads the point from
shm.relay.point_x/y (normalized coords), denormalizes to pixels (the
reference applies a -50 x-offset quirk, normal_relay.py:20), samples 5
patches around the point, outlier-filters the normals, and averages into
shm.relay.normal_*_at_point.

    python -m cuauv_vision_pipeline_tpu_torch.modules.normal_relay zed [--device cpu]
"""

from __future__ import annotations

import numpy as np

from ..core import shm
from ..core.base import ModuleBase, sources
from ..utils.draw import Color, draw_circle
from ..utils.transform import decode_normal

X_OFFSET = -50  # reference quirk (normal_relay.py:20)
PATCH = 5


class NormalRelay(ModuleBase):
    @sources("zed[normal]")
    def handle(self, normal_u8):
        h, w = normal_u8.shape[:2]
        ny = shm.relay.point_y.get()
        nx = shm.relay.point_x.get()
        # invert the width-normalized centered coords (core/base.py normalize)
        px = int(nx * w + w / 2) + X_OFFSET
        py = int(ny * w + h / 2)
        px = int(np.clip(px, PATCH, w - PATCH - 1))
        py = int(np.clip(py, PATCH, h - PATCH - 1))

        normals = decode_normal(normal_u8, device=self.device)
        offsets = [(0, 0), (-PATCH, 0), (PATCH, 0), (0, -PATCH), (0, PATCH)]
        samples = []
        for dy, dx in offsets:
            sy, sx = py + dy, px + dx
            patch = normals[
                max(sy - 1, 0) : sy + 2, max(sx - 1, 0) : sx + 2
            ].reshape(-1, normals.shape[-1])[:, :3]
            samples.append(patch.mean(axis=0))
        samples = np.asarray(samples)

        # outlier filter: drop samples > 1.5 sigma from the median direction
        median = np.median(samples, axis=0)
        dists = np.linalg.norm(samples - median, axis=1)
        keep = dists <= max(1.5 * dists.std(), 1e-6) + dists.mean()
        mean_normal = samples[keep].mean(axis=0)
        norm = np.linalg.norm(mean_normal)
        if norm > 1e-6:
            mean_normal = mean_normal / norm

        shm.relay.set(
            normal_x_at_point=float(mean_normal[0]),
            normal_y_at_point=float(mean_normal[1]),
            normal_z_at_point=float(mean_normal[2]),
        )

        annotated = normal_u8.copy()
        draw_circle(annotated, (px, py), 6, Color.RED, 2)
        self.post("sample point", annotated)


if __name__ == "__main__":
    NormalRelay(["zed"], [])()

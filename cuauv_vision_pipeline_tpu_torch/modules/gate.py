#!/usr/bin/env python3
"""Gate module: pass-through diagnostics + optional GateOBB localization.

Port of ``cuauv_vision_pipeline_tpu.modules.gate`` (host only: no device
chain). Parity target: reference modules/gate.py:13-21 — posts the input per
direction and prints normalize/latency, the smallest real module. BASELINE
config 2 pairs it with the gate HANDLER ("gate module + handlers/gate.py
localization", reference handlers/gate.py:51-163): with
``CUAUV_GATE_LOCALIZE=1`` this module runs the full GateOBB localization
per frame — shark/saw detections (synthesized from deterministic scene
motion, standing in for the YOLO forward) through order_points, threshold
gating, drawing, normalization, and the shm.yolo_gate field writes — so the
handler's entire host path is in the measured loop.
"""

from __future__ import annotations

import math
import os
import time

from ..core.base import ModuleBase
from ..core.handlers import HandlerMixin
from ..core.tuners import DoubleTuner
from ..handlers.gate import GateOBB
from ..models.yolo.data import OBBData


def _orbit_obb(name, cls, h, w, t, phase, size=60.0):
    """A square OBB orbiting the frame center, rotated by t (the synthetic
    stand-in for a YOLO shark/saw detection)."""
    cy = h / 2 + 0.25 * h * math.sin(t * 0.6 + phase)
    cx = w / 2 + 0.25 * w * math.cos(t * 0.8 + phase)
    ang = t * 0.5 + phase
    c, s = math.cos(ang), math.sin(ang)
    half = size / 2
    corners = []
    for dx, dy in ((-half, -half), (half, -half), (half, half), (-half, half)):
        corners.append((cx + dx * c - dy * s, cy + dx * s + dy * c))
    (x1, y1), (x2, y2), (x3, y3), (x4, y4) = corners
    return OBBData(name, cls, 0.9, x1, y1, x2, y2, x3, y3, x4, y4)


class GateDetector(ModuleBase, HandlerMixin):
    def __init__(self, video_sources=["forward"], tuners=None, **kwargs):
        self._localize = os.environ.get("CUAUV_GATE_LOCALIZE", "") == "1"
        if tuners is None:
            tuners = []
        if self._localize and not any(
            t.name == "gate_threshold" for t in tuners
        ):
            # GateOBB.write_object reads this tuner every frame — localize
            # mode must have it regardless of how the tuner list was passed
            tuners = list(tuners) + [DoubleTuner("gate_threshold", 0.1, 0, 1)]
        ModuleBase.__init__(self, video_sources, tuners, **kwargs)
        if self._localize:
            HandlerMixin.__init__(self, [GateOBB("gate")])

    def process(self, direction, img):
        if self._localize:
            h, w = img.shape[:2]
            t = time.monotonic()
            sharks = [_orbit_obb("shark", 0, h, w, t, 0.0)]
            saws = [_orbit_obb("saw", 1, h, w, t, math.pi)]
            frame = img if self._performance_enabled else img.copy()
            self.handlers["gate"].process(direction, frame, sharks, saws)
            return
        self.post(direction, img)
        print(self.normalize((10, 10)), self.get_latency())


if __name__ == "__main__":
    GateDetector()()

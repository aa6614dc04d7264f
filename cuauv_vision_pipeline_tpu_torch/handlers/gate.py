"""Gate handler: shark + saw images on the gate.

Parity target: reference handlers/gate.py:51-163 — best shark/saw by
confidence gated on gate_threshold, corners into shm.yolo_gate."""

from __future__ import annotations

from typing import List

import numpy as np

from ..models.yolo.data import OBBData
from ..utils.draw import Color
from .obb_common import ObbHandlerBase


class GateOBB(ObbHandlerBase):
    shm_group = "yolo_gate"
    threshold_tuner = "gate_threshold"

    def process(
        self,
        direction: str,
        img: np.ndarray,
        shark_results: List[OBBData],
        saw_results: List[OBBData],
    ):
        self.write_object(img, "shark", shark_results, Color.CYAN)
        self.write_object(img, "saw", saw_results, Color.ORANGE)
        self.post("gate handler", img)

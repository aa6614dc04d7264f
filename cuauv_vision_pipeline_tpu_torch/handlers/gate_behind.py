"""Gate-behind handler.

Parity target: reference handlers/gate_behind.py — single gate_behind class
gated on gate_behind_threshold into shm.yolo_gate_behind."""

from __future__ import annotations

from typing import List

import numpy as np

from ..models.yolo.data import OBBData
from ..utils.draw import Color
from .obb_common import ObbHandlerBase


class GateBehindOBB(ObbHandlerBase):
    shm_group = "yolo_gate_behind"
    threshold_tuner = "gate_behind_threshold"

    def process(
        self, direction: str, img: np.ndarray, gate_behind_results: List[OBBData]
    ):
        self.write_object(img, "gate_behind", gate_behind_results, Color.YELLOW)
        self.post("gate behind handler", img)

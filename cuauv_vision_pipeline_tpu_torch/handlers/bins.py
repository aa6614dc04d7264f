"""Bins handler.

Parity target: reference handlers/bins.py — bin_shark / bin_saw / bin
classes gated on bins_threshold into shm.yolo_bins."""

from __future__ import annotations

from typing import List

import numpy as np

from ..models.yolo.data import OBBData
from ..utils.draw import Color
from .obb_common import ObbHandlerBase


class BinsOBB(ObbHandlerBase):
    shm_group = "yolo_bins"
    threshold_tuner = "bins_threshold"

    def process(
        self,
        direction: str,
        img: np.ndarray,
        bin_shark_results: List[OBBData],
        bin_saw_results: List[OBBData],
        bin_results: List[OBBData],
    ):
        self.write_object(img, "bin_shark", bin_shark_results, Color.CYAN)
        self.write_object(img, "bin_saw", bin_saw_results, Color.ORANGE)
        self.write_object(img, "bin", bin_results, Color.LIME)
        self.post("bins handler", img)

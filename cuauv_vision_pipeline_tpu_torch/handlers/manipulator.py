"""Manipulator handler.

Parity target: reference handlers/manipulator.py — spoon / cup /
pink_basket / yellow_basket gated on manipulator_threshold into
shm.yolo_manipulator, including num_spoons_detected
(reference manipulator.py:47)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..models.yolo.data import OBBData
from ..utils.draw import Color
from .obb_common import ObbHandlerBase


class ManipulatorOBB(ObbHandlerBase):
    shm_group = "yolo_manipulator"
    threshold_tuner = "manipulator_threshold"

    def process(
        self,
        direction: str,
        img: np.ndarray,
        spoon_results: List[OBBData],
        cup_results: List[OBBData],
        pink_basket_results: List[OBBData],
        yellow_basket_results: List[OBBData],
    ):
        threshold = float(self.tuners[self.threshold_tuner])
        group = self._group()
        group.num_spoons_detected.set(
            sum(1 for d in spoon_results if d.confidence >= threshold)
        )
        self.write_object(img, "spoon", spoon_results, Color.LIME)
        self.write_object(img, "cup", cup_results, Color.CYAN)
        self.write_object(img, "pink_basket", pink_basket_results, Color.PINK)
        self.write_object(
            img, "yellow_basket", yellow_basket_results, Color.YELLOW
        )
        self.post("manipulator handler", img)

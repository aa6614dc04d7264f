"""Slalom pole handler.

Parity target: reference handlers/slalom.py:63-113 + 314 — draws ALL poles
above threshold, maps the bottom-most red pole to slalom_red and splits the
white poles into slalom_left / slalom_right relative to the red pole's
center; bottom-most selection instead of best-confidence."""

from __future__ import annotations

from typing import List

import numpy as np

from ..models.yolo.data import OBBData
from ..utils.draw import Color, draw_polylines
from ..models.yolo.utils import order_points
from .obb_common import ObbHandlerBase


def _bottom_most(detections: List[OBBData]) -> OBBData:
    return max(detections, key=lambda d: d.center[1])


class SlalomOBB(ObbHandlerBase):
    shm_group = "yolo_slalom"
    threshold_tuner = "slalom_threshold"

    def process(
        self,
        direction: str,
        img: np.ndarray,
        red_results: List[OBBData],
        white_results: List[OBBData],
    ):
        threshold = float(self.tuners[self.threshold_tuner])

        # draw everything above threshold (reference slalom.py:63-93);
        # dead work in performance mode (posts are no-ops)
        for det in [] if self.performance else red_results + white_results:
            if det.confidence >= threshold:
                tl, tr, bl, br = order_points(det.corners)
                color = Color.RED if det in red_results else Color.WHITE
                draw_polylines(
                    img,
                    [np.array([br, tr, tl, bl], np.int32)],
                    True,
                    color,
                    2,
                )

        red = self.write_object(
            img, "slalom_red", red_results, Color.RED, pick=_bottom_most
        )

        group = self._group()
        if red is None:
            group.set(slalom_left_visible=0, slalom_right_visible=0)
        else:
            red_x = red.center[0]
            lefts = [d for d in white_results if d.center[0] < red_x]
            rights = [d for d in white_results if d.center[0] >= red_x]
            self.write_object(
                img, "slalom_left", lefts, Color.WHITE, pick=_bottom_most
            )
            self.write_object(
                img, "slalom_right", rights, Color.GREY, pick=_bottom_most
            )

        self.post("slalom handler", img)

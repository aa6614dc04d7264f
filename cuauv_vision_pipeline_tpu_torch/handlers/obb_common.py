"""Shared machinery for the OBB detection handlers.

Every reference handler repeats the same ~60-line block per object class:
pick the best detection by confidence, gate on a tuner threshold,
order_points the corners, draw, normalize to (y, x), and write a fixed shm
field set (reference handlers/torpedoes.py:51-205, gate.py:51-163,
slalom.py:63-113, bins.py, manipulator.py — SURVEY.md §2.6). This module
factors that block once; each concrete handler declares its objects and
class mapping. Port of ``cuauv_vision_pipeline_tpu.handlers.obb_common``
(host numpy throughout).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.handlers import HandlerBase
from ..models.yolo.data import OBBData
from ..models.yolo.utils import order_points, quad_area_normalized
from ..ops.color import bgr_to_gray
from ..utils.draw import Color, draw_polylines


def reverse(tup):
    return tup[1], tup[0]


class ObbHandlerBase(HandlerBase):
    """Base for handlers that map OBB detections into a shm group."""

    #: name of the shm group this handler writes
    shm_group: str = ""
    #: tuner name holding the confidence threshold
    threshold_tuner: str = ""

    def post_grayscale(self, img: np.ndarray) -> None:
        """Fallback post when this detector is inactive
        (reference modules/yolo.py post_grayscale path), computed on the
        host image: a device round trip for a debug post would cost more."""
        gray = bgr_to_gray(torch.from_numpy(np.ascontiguousarray(img))).numpy()
        self.post(f"{self.name} handler", np.repeat(gray[..., None], 3, -1))

    def _group(self):
        from ..core import shm

        return getattr(shm, self.shm_group)

    def write_object(
        self,
        img: np.ndarray,
        prefix: str,
        detections: List[OBBData],
        color: Color = Color.LIME,
        threshold: Optional[float] = None,
        pick=None,
    ) -> Optional[OBBData]:
        """Write the best detection for one object class into the group.

        Returns the chosen detection (or None). ``pick`` overrides the
        default best-by-confidence selection (slalom picks bottom-most,
        reference handlers/slalom.py:103-113).
        """
        group = self._group()
        if threshold is None:
            threshold = float(self.tuners[self.threshold_tuner])

        if not detections:
            group.set_field(f"{prefix}_visible", 0)
            return None
        best = (pick or (lambda ds: max(ds, key=lambda d: d.confidence)))(
            detections
        )
        if best.confidence < threshold:
            group.set_field(f"{prefix}_visible", 0)
            return None

        tl, tr, bl, br = order_points(best.corners)
        if not self.performance:  # annotation is dead work in perf mode
            draw_polylines(
                img,
                [np.array([br, tr, tl, bl], dtype=np.int32)],
                is_closed=True,
                color=color,
                thickness=3,
            )

        # normalize takes (y, x); corners are (x, y)
        ntl = self.normalize(reverse(tl))
        ntr = self.normalize(reverse(tr))
        nbl = self.normalize(reverse(bl))
        nbr = self.normalize(reverse(br))

        updates = {
            f"{prefix}_visible": 1,
            f"{prefix}_confidence": best.confidence,
            f"{prefix}_top_left_y": ntl[0],
            f"{prefix}_top_left_x": ntl[1],
            f"{prefix}_top_right_y": ntr[0],
            f"{prefix}_top_right_x": ntr[1],
            f"{prefix}_bottom_left_y": nbl[0],
            f"{prefix}_bottom_left_x": nbl[1],
            f"{prefix}_bottom_right_y": nbr[0],
            f"{prefix}_bottom_right_x": nbr[1],
            f"{prefix}_center_y": (ntl[0] + ntr[0] + nbl[0] + nbr[0]) / 4,
            f"{prefix}_center_x": (ntl[1] + ntr[1] + nbl[1] + nbr[1]) / 4,
            f"{prefix}_area": quad_area_normalized(
                [nbr, ntr, ntl, nbl], img.shape
            ),
        }
        group.set(**updates)
        return best

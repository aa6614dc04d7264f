"""Torpedoes board handler.

Parity target: reference handlers/torpedoes.py:51-205 — best board by
confidence gated on the torpedo_threshold tuner, ordered corners into
shm.yolo_torpedoes_board (board_*, shark_*, saw_* field sets), the board
aim point into shm.relay.point_x/y, shoelace area normalized to the image,
annotated post."""

from __future__ import annotations

from typing import List

import numpy as np

from ..core import shm
from ..models.yolo.data import OBBData
from ..models.yolo.utils import order_points
from ..utils.draw import Color
from .obb_common import ObbHandlerBase, reverse


class TorpedoesOBB(ObbHandlerBase):
    shm_group = "yolo_torpedoes_board"
    threshold_tuner = "torpedo_threshold"

    def process(
        self,
        direction: str,
        img: np.ndarray,
        board_results: List[OBBData],
        shark_hole_results: List[OBBData],
        saw_hole_results: List[OBBData],
    ):
        board = self.write_object(img, "board", board_results, Color.LIME)
        if board is not None:
            # aim point: center of the board in normalized coords
            tl, tr, bl, br = order_points(board.corners)
            ntl = self.normalize(reverse(tl))
            ntr = self.normalize(reverse(tr))
            nbl = self.normalize(reverse(bl))
            nbr = self.normalize(reverse(br))
            shm.relay.point_x.set(
                ((ntl[1] + nbl[1]) / 2 + (ntr[1] + nbr[1]) / 2) / 2
            )
            shm.relay.point_y.set(
                ((ntl[0] + ntr[0]) / 2 + (nbl[0] + nbr[0]) / 2) / 2
            )

        self.write_object(img, "shark", shark_hole_results, Color.CYAN)
        self.write_object(img, "saw", saw_hole_results, Color.ORANGE)
        self.post("torpedoes handler", img)

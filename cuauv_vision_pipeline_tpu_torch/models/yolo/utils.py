"""Geometric helpers for detection handlers (numpy only).

Copy of ``cuauv_vision_pipeline_tpu.models.yolo.utils``, kept in the port so
it imports nothing of the JAX package.

Reconstruction of the reference's external ``vision.yolo.utils`` (imported
by handlers/torpedoes.py:9 etc.): ``order_points`` sorts an OBB's 4 corners
into (top-left, top-right, bottom-left, bottom-right) — the unpack order
used at every call site (``tl, tr, bl, br = order_points(points)``,
reference handlers/torpedoes.py:81).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

Point = Tuple[float, float]


def order_points(points: Iterable[Point]) -> Tuple[Point, Point, Point, Point]:
    """Order 4 (x, y) corners as (tl, tr, bl, br).

    tl = min(x+y), br = max(x+y), tr = min(y-x), bl = max(y-x).
    """
    pts = np.asarray(list(points), dtype=np.float64).reshape(4, 2)
    s = pts.sum(axis=1)
    d = pts[:, 1] - pts[:, 0]
    tl = tuple(pts[int(np.argmin(s))])
    br = tuple(pts[int(np.argmax(s))])
    tr = tuple(pts[int(np.argmin(d))])
    bl = tuple(pts[int(np.argmax(d))])
    return tl, tr, bl, br


def quad_area_normalized(corners, img_shape) -> float:
    """Shoelace area over width-normalized (y, x) corners, rescaled so the
    full image has area 1.0 (reference handlers/torpedoes.py:24-49)."""
    x = [c[1] for c in corners]
    y = [c[0] for c in corners]
    area = 0.0
    n = len(x)
    for i in range(n):
        j = (i + 1) % n
        area += x[i] * y[j] - x[j] * y[i]
    raw = abs(area) / 2.0
    height, width = img_shape[0], img_shape[1]
    return raw * (width / height)

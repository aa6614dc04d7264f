"""Reference-compatible feature API (numpy in / numpy out).

Port of the part of ``cuauv_vision_pipeline_tpu.utils.feature`` that the
bins module and the builtin keypoint detector use (reference
utils/feature.py): contours (RETR_EXTERNAL / RETR_LIST), Shi-Tomasi corners,
contour properties (centroid/area/perimeter/approx) and enclosing shapes
(minAreaRect/minEnclosingCircle/fitEllipse). Contour tracing and polygon
geometry run on the host (utils/contours.py); the corner response runs in
torch on the CPU (ops/feature.py). Canny, ``find_lines``,
``find_line_segments`` and ``find_circles`` are not ported yet.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ops import feature as F
from . import contours as CT


def outer_contours(mat: np.ndarray) -> List[np.ndarray]:
    """Outermost contours (cv2.RETR_EXTERNAL; reference utils/feature.py:5-23).
    Full-boundary point lists (CHAIN_APPROX_NONE resolution)."""
    return CT.find_contours(np.asarray(mat), external_only=True)


def all_contours(mat: np.ndarray) -> List[np.ndarray]:
    """All contours incl. holes (cv2.RETR_LIST; reference feature.py:25-40)."""
    return CT.find_contours(np.asarray(mat), external_only=False)


def find_corners(
    mat: np.ndarray,
    max_corners: int,
    quality_thresh: float = 0.01,
    min_distance: int = 10,
) -> np.ndarray:
    """Shi-Tomasi corners (reference feature.py:104-125)."""
    return F.find_corners(np.asarray(mat), max_corners, quality_thresh, min_distance)


# --- contour properties -----------------------------------------------------


def contour_centroid(contour: np.ndarray) -> Tuple[int, int]:
    """(x, y) centroid via polygon moments (reference feature.py:240-252)."""
    m = CT.polygon_moments(contour)
    if m["m00"] == 0:
        pts = np.asarray(contour).reshape(-1, 2)
        return int(pts[:, 0].mean()), int(pts[:, 1].mean())
    return int(m["m10"] / m["m00"]), int(m["m01"] / m["m00"])


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea (reference feature.py:255-266)."""
    return CT.contour_area(contour)


def contour_perimeter(contour: np.ndarray, closed: bool = True) -> float:
    """cv2.arcLength (reference feature.py contour_perimeter)."""
    return CT.contour_perimeter(contour, closed)


def contour_approx(
    contour: np.ndarray, epsilon_ratio: float = 0.01, closed: bool = True
) -> np.ndarray:
    """cv2.approxPolyDP with epsilon relative to perimeter
    (reference feature.py contour_approx)."""
    eps = epsilon_ratio * CT.contour_perimeter(contour, closed)
    return CT.approx_poly_dp(contour, eps, closed)


def min_enclosing_rect(contour: np.ndarray):
    """cv2.minAreaRect (reference feature.py min_enclosing_rect)."""
    return CT.min_area_rect(contour)


def min_enclosing_circle(contour: np.ndarray):
    """cv2.minEnclosingCircle (reference feature.py min_enclosing_circle)."""
    return CT.min_enclosing_circle(contour)


def min_enclosing_ellipse(contour: np.ndarray):
    """cv2.fitEllipse (reference feature.py min_enclosing_ellipse)."""
    return CT.fit_ellipse(contour)

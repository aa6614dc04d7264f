"""Reference-compatible feature API (numpy in / numpy out).

Port of ``cuauv_vision_pipeline_tpu.utils.feature`` (reference
utils/feature.py): contours (RETR_EXTERNAL / RETR_LIST), Canny, Shi-Tomasi
corners, Hough lines, segments and circles, contour properties
(centroid/area/perimeter/approx) and enclosing shapes
(minAreaRect/minEnclosingCircle/fitEllipse). Edge maps, gradients, the
corner response and the Hough accumulator run on the caller's ``device``
(cuda:0 unless told ``cpu``; ``ops/feature.py``); contour tracing, peak
picks, segment splitting, circle voting and polygon geometry run on the
host (utils/contours.py), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, run_np
from ..ops import feature as F
from . import contours as CT


def outer_contours(mat: np.ndarray) -> List[np.ndarray]:
    """Outermost contours (cv2.RETR_EXTERNAL; reference utils/feature.py:5-23).
    Full-boundary point lists (CHAIN_APPROX_NONE resolution)."""
    return CT.find_contours(np.asarray(mat), external_only=True)


def all_contours(mat: np.ndarray) -> List[np.ndarray]:
    """All contours incl. holes (cv2.RETR_LIST; reference feature.py:25-40)."""
    return CT.find_contours(np.asarray(mat), external_only=False)


def canny(
    mat: np.ndarray, lower: int, upper: int, l2_gradient: bool = False, device: DeviceLike = None
) -> np.ndarray:
    """Canny edges, bit-exact vs cv2.Canny (reference feature.py:43-67)."""
    return run_np(lambda t: F.canny(t, lower, upper, l2_gradient), mat, device)


def simple_canny(
    mat: np.ndarray, sigma: float = 0.33, use_mean: bool = False, device: DeviceLike = None
) -> np.ndarray:
    """Auto-threshold Canny (reference feature.py:70-101): thresholds from
    the frame's median (numpy's, the mean of the two middle values) or mean
    on the host."""
    mid = float(np.mean(mat) if use_mean else np.median(mat))
    lower = int(max(0, (1.0 - sigma) * mid))
    upper = int(min(255, (1.0 + sigma) * mid))
    return canny(mat, lower, upper, device=device)


def find_corners(
    mat: np.ndarray,
    max_corners: int,
    quality_thresh: float = 0.01,
    min_distance: int = 10,
    device: DeviceLike = None,
) -> np.ndarray:
    """Shi-Tomasi corners (reference feature.py:104-125)."""
    return F.find_corners(np.asarray(mat), max_corners, quality_thresh, min_distance, device)


def find_lines(
    mat: np.ndarray,
    res_ratio: float = 1.0,
    theta_res: float = math.pi / 180,
    threshold: int = 100,
    device: DeviceLike = None,
) -> np.ndarray:
    """Hough lines -> [N, 1, 2] of (rho, theta) like cv2.HoughLines
    (reference feature.py find_lines)."""
    lines = F.find_lines(np.asarray(mat), res_ratio, theta_res, threshold, device=device)
    return lines.reshape(-1, 1, 2).astype(np.float32)


def polar_to_cartesian(rho: float, theta: float, length: float = 2000.0):
    """(rho, theta) -> two endpoints of the drawn line (reference helper for
    find_lines results)."""
    a, b = math.cos(theta), math.sin(theta)
    x0, y0 = a * rho, b * rho
    return (
        (int(x0 + length * (-b)), int(y0 + length * a)),
        (int(x0 - length * (-b)), int(y0 - length * a)),
    )


def find_line_segments(
    mat: np.ndarray,
    res_ratio: float = 1.0,
    theta_res: float = math.pi / 180,
    threshold: int = 50,
    min_line_length: float = 30.0,
    max_line_gap: float = 5.0,
    device: DeviceLike = None,
) -> np.ndarray:
    """Probabilistic-Hough-style segments -> [N, 1, 4] (x1,y1,x2,y2).

    Deterministic variant: standard Hough peaks (the accumulator on
    ``device``), then edge pixels near each peak line are projected onto it
    and split at gaps on the host (cv2.HoughLinesP's randomized scheme is
    not reproducible anyway)."""
    edges = np.asarray(mat) != 0
    lines = F.find_lines(edges.astype(np.uint8), res_ratio, theta_res, threshold, device=device)
    ys, xs = F.host_nonzero2d(edges)
    segments: List[Tuple[int, int, int, int]] = []
    for rho, theta in lines:
        a, b = math.cos(theta), math.sin(theta)
        dist = np.abs(xs * a + ys * b - rho)
        near = dist <= 1.5
        if near.sum() < 2:
            continue
        # project near pixels onto the line direction (-b, a)
        t = xs[near] * (-b) + ys[near] * a
        order = np.argsort(t)
        tx = t[order]
        px = xs[near][order]
        py = ys[near][order]
        start = 0
        for i in range(1, len(tx) + 1):
            if i == len(tx) or tx[i] - tx[i - 1] > max_line_gap:
                if tx[i - 1] - tx[start] >= min_line_length:
                    segments.append((px[start], py[start], px[i - 1], py[i - 1]))
                start = i
    if not segments:
        return np.empty((0, 1, 4), np.int32)
    return np.array(segments, np.int32).reshape(-1, 1, 4)


def find_circles(
    mat: np.ndarray,
    res_ratio: float = 1.0,
    min_distance: float = 20.0,
    canny_thresh: float = 100.0,
    vote_thresh: float = 30.0,
    min_radius: int = 0,
    max_radius: int = 0,
    device: DeviceLike = None,
) -> np.ndarray:
    """Hough-gradient circle detection -> [1, N, 3] (x, y, r) like
    cv2.HoughCircles (reference feature.py find_circles). Canny and the
    float32 Sobel (sums of small integers: exact) on ``device``; the voting
    and the radius search on the host."""
    gray = np.asarray(mat)
    edges = canny(gray, canny_thresh / 2, canny_thresh, device=device) != 0
    gx, gy = run_np(lambda t: torch.stack(F._sobel_3x3(t.to(torch.float32))), gray, device)

    H, W = gray.shape[:2]
    if max_radius <= 0:
        max_radius = min(H, W) // 2
    acc = np.zeros((H, W), np.int32)
    ys, xs = F.host_nonzero2d(edges)
    mag = np.hypot(gx[ys, xs], gy[ys, xs])
    ok = mag > 1e-3
    ys, xs, mag = ys[ok], xs[ok], mag[ok]
    dx = gx[ys, xs] / mag
    dy = gy[ys, xs] / mag
    for r in range(max(min_radius, 5), max_radius, max(1, int(res_ratio))):
        for sgn in (1, -1):
            cx = np.round(xs + sgn * r * dx).astype(int)
            cy = np.round(ys + sgn * r * dy).astype(int)
            valid = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
            np.add.at(acc, (cy[valid], cx[valid]), 1)

    circles: List[Tuple[float, float, float]] = []
    flat = acc.ravel()
    order = np.argsort(-flat)
    for idx in order[:512]:
        v = flat[idx]
        if v < vote_thresh:
            break
        cy, cx = divmod(int(idx), W)
        if any((cx - c[0]) ** 2 + (cy - c[1]) ** 2 < min_distance**2 for c in circles):
            continue
        # estimate radius: median distance of supporting edge pixels
        d = np.hypot(xs - cx, ys - cy)
        sel = (d >= min_radius) & (d <= max_radius)
        if not sel.any():
            continue
        hist, bin_edges = np.histogram(d[sel], bins=max_radius - min_radius or 1,
                                       range=(min_radius, max_radius))
        r = bin_edges[np.argmax(hist)] + 0.5
        circles.append((float(cx), float(cy), float(r)))
    if not circles:
        return np.empty((1, 0, 3), np.float32)
    return np.array(circles, np.float32).reshape(1, -1, 3)


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

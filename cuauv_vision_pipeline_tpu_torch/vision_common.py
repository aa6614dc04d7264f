"""Legacy shared helpers (the reference's grab-bag vision_common.py).

Port of ``cuauv_vision_pipeline_tpu.vision_common`` (reference
vision_common.py:25-292): module enumeration from shm flags, a double-fork
daemonizer, Hu-moment feature extraction, aspect-preserving resize, angle
helpers for rotated rects/ellipses, the contour Hierarchy navigator,
clipping/fill-ratio/center contour utilities. All host code but the resize
and ``post_colorspace``'s conversion, which run on a device (cuda:0 unless
told ``cpu``; ``post_colorspace`` takes the module's).
"""

from __future__ import annotations

import io
import math
import os
from typing import Iterable, List, Optional, Tuple

import numpy as np

from .core import shm
from .core.device import DeviceLike
from .utils import feature as F
from .utils.contours import polygon_moments
from .utils.draw import Color, draw_arrow


def all_vision_modules() -> List[str]:
    """Module names known to the toggler's vision_modules group
    (reference vision_common.py:25-35)."""
    try:
        names = shm.vision_modules.field_names()
    except KeyError:
        return []
    modules = set()
    for flag in names:
        if "_on_" in flag:
            modules.add(flag.split("_on_")[0])
    return sorted(modules)


def module_by_name(module_name: str, case_sensitive: bool = False) -> Optional[str]:
    for name in all_vision_modules():
        if name == module_name or (
            not case_sensitive and name.lower() == module_name.lower()
        ):
            return name
    return None


def fork(target, args=None, kwargs=None) -> int:
    """Double-fork daemonizer (reference vision_common.py:37-63). Returns
    the child pid in the parent; never returns in the grandchild."""
    args = args or ()
    kwargs = kwargs or {}
    pid = os.fork()
    if pid > 0:
        os.waitpid(pid, 0)
        return pid
    os.setsid()
    pid2 = os.fork()
    if pid2 > 0:
        os._exit(0)
    try:
        target(*args, **kwargs)
    finally:
        os._exit(0)


class NTee(io.IOBase):
    """Write-through to multiple streams."""

    def __init__(self, *dest):
        self.dest = dest

    def write(self, data):
        for d in self.dest:
            d.write(data)
        return len(data)

    def flush(self):
        for d in self.dest:
            d.flush()


def flatten(l: Iterable) -> List:
    out = []
    for item in l:
        if isinstance(item, (list, tuple)):
            out.extend(flatten(item))
        else:
            out.append(item)
    return out


def extract_features(image: np.ndarray) -> np.ndarray:
    """Hu-moment shape features of the largest contour
    (reference vision_common.py:97-148)."""
    contours = F.outer_contours(image)
    if not contours:
        return np.zeros(7, np.float64)
    contour = max(contours, key=F.contour_area)
    pts = np.asarray(contour, np.float64).reshape(-1, 2)
    m = polygon_moments(contour)
    if m["m00"] == 0:
        return np.zeros(7, np.float64)
    cx, cy = m["m10"] / m["m00"], m["m01"] / m["m00"]
    x = pts[:, 0] - cx
    y = pts[:, 1] - cy

    # central moments from the point set (discrete approximation)
    def mu(p, q):
        return float(np.sum((x**p) * (y**q)))

    mu00 = len(pts)
    def eta(p, q):
        return mu(p, q) / (mu00 ** (1 + (p + q) / 2.0))

    n20, n02, n11 = eta(2, 0), eta(0, 2), eta(1, 1)
    n30, n03, n21, n12 = eta(3, 0), eta(0, 3), eta(2, 1), eta(1, 2)
    h = np.zeros(7)
    h[0] = n20 + n02
    h[1] = (n20 - n02) ** 2 + 4 * n11**2
    h[2] = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    h[3] = (n30 + n12) ** 2 + (n21 + n03) ** 2
    h[4] = (n30 - 3 * n12) * (n30 + n12) * (
        (n30 + n12) ** 2 - 3 * (n21 + n03) ** 2
    ) + (3 * n21 - n03) * (n21 + n03) * (
        3 * (n30 + n12) ** 2 - (n21 + n03) ** 2
    )
    h[5] = (n20 - n02) * ((n30 + n12) ** 2 - (n21 + n03) ** 2) + 4 * n11 * (
        n30 + n12
    ) * (n21 + n03)
    h[6] = (3 * n21 - n03) * (n30 + n12) * (
        (n30 + n12) ** 2 - 3 * (n21 + n03) ** 2
    ) - (n30 - 3 * n12) * (n21 + n03) * (
        3 * (n30 + n12) ** 2 - (n21 + n03) ** 2
    )
    return h


def resize_keep_ratio(image: np.ndarray, desired_size: int, device: DeviceLike = None) -> np.ndarray:
    """Resize so the long side equals desired_size, padding the rest
    (reference vision_common.py:150-164)."""
    from .utils.transform import resize

    h, w = image.shape[:2]
    scale = desired_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize(image, (nw, nh), device=device)
    if image.ndim == 3:
        out = np.zeros((desired_size, desired_size, image.shape[2]), image.dtype)
    else:
        out = np.zeros((desired_size, desired_size), image.dtype)
    out[:nh, :nw] = resized
    return out


def get_angle_from_rotated_rect(rotrect) -> float:
    """Long-axis angle in degrees (reference vision_common.py:166-174)."""
    (_, _), (w, h), angle = rotrect
    if w < h:
        angle += 90.0
    return angle % 180.0


def get_angle_from_ellipse(ellipse) -> float:
    (_, _), (_, _), angle = ellipse
    return angle % 180.0


def draw_angled_arrow(image: np.ndarray, center: Tuple[int, int], angle: float):
    """Arrow along an angle (degrees from vertical), both directions."""
    rad = math.radians(angle)
    length = max(image.shape[:2]) // 8
    dx = int(length * math.sin(rad))
    dy = int(-length * math.cos(rad))
    cx, cy = int(center[0]), int(center[1])
    draw_arrow(image, (cx - dx, cy - dy), (cx + dx, cy + dy), Color.YELLOW, 2)


def zero_vision_group(group) -> None:
    """Reset all numeric fields of a shm group."""
    updates = {}
    for name in group.field_names():
        value = group.get_field(name)
        if isinstance(value, bool):
            updates[name] = False
        elif isinstance(value, (int, float)):
            updates[name] = 0
    group.set(**updates)


def post_colorspace(module, original: np.ndarray, colorspace: str) -> None:
    """Post every channel of a colorspace conversion for debugging (the
    conversion on the module's device)."""
    from .utils import color as UC

    fn = getattr(UC, f"bgr_to_{colorspace.lower()}", None)
    if fn is None:
        return
    _, channels = fn(original, device=module.device)
    for i, chan in enumerate(channels):
        module.post(f"{colorspace}_{i}", chan, "GRAY")


class Hierarchy:
    """Navigator over cv2-style contour hierarchy arrays
    (reference vision_common.py:223-269): [next, prev, child, parent]."""

    def __init__(self, hierarchy):
        self.hierarchy = np.asarray(hierarchy).reshape(-1, 4)

    def next(self, i: int) -> int:
        return int(self.hierarchy[i][0])

    def prev(self, i: int) -> int:
        return int(self.hierarchy[i][1])

    def first_child(self, i: int) -> int:
        return int(self.hierarchy[i][2])

    def parent(self, i: int) -> int:
        return int(self.hierarchy[i][3])

    def children(self, i: int) -> List[int]:
        out = []
        child = self.first_child(i)
        while child != -1:
            out.append(child)
            child = self.next(child)
        return out

    def siblings(self, i: int) -> List[int]:
        out = [i]
        j = self.next(i)
        while j != -1:
            out.append(j)
            j = self.next(j)
        j = self.prev(i)
        while j != -1:
            out.insert(0, j)
            j = self.prev(j)
        return out


def is_clipping(mat: np.ndarray, contour: np.ndarray) -> bool:
    """True when a contour touches the image border
    (reference vision_common.py:271-279)."""
    h, w = mat.shape[:2]
    pts = np.asarray(contour).reshape(-1, 2)
    return bool(
        (pts[:, 0] <= 0).any()
        or (pts[:, 1] <= 0).any()
        or (pts[:, 0] >= w - 1).any()
        or (pts[:, 1] >= h - 1).any()
    )


def fill_ratio(mat: np.ndarray, contour: np.ndarray, threshed: np.ndarray) -> float:
    """Fraction of the contour's bbox that is foreground
    (reference vision_common.py:281-287)."""
    pts = np.asarray(contour).reshape(-1, 2)
    x0, y0 = pts.min(axis=0)
    x1, y1 = pts.max(axis=0)
    region = threshed[y0 : y1 + 1, x0 : x1 + 1]
    if region.size == 0:
        return 0.0
    return float((region > 0).mean())


def contour_center(contour: np.ndarray) -> Tuple[int, int]:
    """(x, y) centroid (reference vision_common.py:289-292)."""
    return F.contour_centroid(contour)

"""Host-side drawing utilities (debug/GUI annotation).

Parity target: reference utils/draw.py (26-color BGR palette, circle/
ellipse/line/arrow/rect/rot_rect/text/text_with_background/contours/
polylines, all drawing in place on u8 BGR images). Implemented with
vectorized numpy rasterization plus PIL for text — no OpenCV dependency on
the product path. Drawing happens on host: it only serves debug posts and
the WebGUI, never the device compute chain.
"""

from __future__ import annotations

import math
from enum import Enum
from typing import Sequence, Tuple, Union

import numpy as np

ColorLike = Union["Color", Tuple[int, int, int]]


class Color(Enum):
    """BGR color palette (reference utils/draw.py:9-41)."""

    RED = (75, 25, 230)
    GREEN = (75, 180, 60)
    YELLOW = (0, 225, 255)
    BLUE = (200, 130, 0)
    ORANGE = (48, 130, 245)
    PURPLE = (180, 30, 145)
    CYAN = (240, 240, 70)
    MAGENTA = (230, 50, 240)
    LIME = (60, 245, 210)
    PINK = (212, 190, 250)
    TEAL = (128, 128, 0)
    LAVENDER = (255, 190, 220)
    BROWN = (40, 110, 170)
    BEIGE = (200, 250, 255)
    MAROON = (0, 0, 128)
    MINT = (195, 255, 170)
    OLIVE = (0, 128, 128)
    APRICOT = (180, 215, 255)
    NAVY = (128, 0, 0)
    GREY = (128, 128, 128)
    WHITE = (255, 255, 255)
    BLACK = (0, 0, 0)
    HOTPINK = (180, 105, 255)
    DEEPPINK = (147, 20, 255)
    FUCHSIA = (255, 0, 255)
    LEMON = (205, 250, 255)

    def __call__(self):
        return self.value

    def __str__(self):
        return f"{self.name.lower()} = {self.value}"


def get_color(color_name: str) -> Tuple[int, int, int]:
    try:
        return Color[color_name.upper()].value
    except KeyError:
        raise ValueError(f"{color_name} is not a valid color name")


def _bgr(color: ColorLike) -> np.ndarray:
    if isinstance(color, Color):
        color = color.value
    return np.asarray(color, dtype=np.uint8)


def _paint(mat: np.ndarray, mask: np.ndarray, color: ColorLike) -> None:
    """Set mat[mask] = color for gray or BGR images, in place."""
    if mat.ndim == 2 or mat.shape[-1] == 1:
        value = int(np.mean(_bgr(color)))
        mat[mask if mat.ndim == 2 else mask[..., None].repeat(1, -1)] = value
    else:
        mat[mask] = _bgr(color)


def _clip_box(
    mat: np.ndarray, x0: float, y0: float, x1: float, y1: float, margin: float
) -> Tuple[int, int, int, int]:
    h, w = mat.shape[:2]
    xa = int(max(0, math.floor(min(x0, x1) - margin)))
    ya = int(max(0, math.floor(min(y0, y1) - margin)))
    xb = int(min(w, math.ceil(max(x0, x1) + margin + 1)))
    yb = int(min(h, math.ceil(max(y0, y1) + margin + 1)))
    return xa, ya, xb, yb


def draw_circle(
    mat: np.ndarray,
    center: Tuple[int, int],
    radius: int,
    color: ColorLike = (0, 0, 255),
    thickness: int = 1,
) -> None:
    """Circle, in place. thickness=-1 fills (reference utils/draw.py:51-77)."""
    cx, cy = center
    margin = radius + max(thickness, 1)
    xa, ya, xb, yb = _clip_box(mat, cx, cy, cx, cy, margin)
    if xa >= xb or ya >= yb:
        return
    ys = np.arange(ya, yb)[:, None]
    xs = np.arange(xa, xb)[None, :]
    dist = np.sqrt((ys - cy) ** 2 + (xs - cx) ** 2)
    if thickness < 0:
        mask = dist <= radius + 0.5
    else:
        half = thickness / 2.0
        mask = np.abs(dist - radius) <= max(half, 0.5)
    _paint(mat[ya:yb, xa:xb], mask, color)


def draw_ellipse(
    mat: np.ndarray,
    center: Tuple[int, int],
    axes: Tuple[int, int],
    angle_deg: float = 0.0,
    color: ColorLike = (0, 0, 255),
    thickness: int = 1,
) -> None:
    """Ellipse outline/fill, in place."""
    cx, cy = center
    a, b = max(axes[0], 1), max(axes[1], 1)
    margin = max(a, b) + max(thickness, 1)
    xa, ya, xb, yb = _clip_box(mat, cx, cy, cx, cy, margin)
    if xa >= xb or ya >= yb:
        return
    ys = np.arange(ya, yb)[:, None] - cy
    xs = np.arange(xa, xb)[None, :] - cx
    rad = math.radians(angle_deg)
    xr = xs * math.cos(rad) + ys * math.sin(rad)
    yr = -xs * math.sin(rad) + ys * math.cos(rad)
    q = (xr / a) ** 2 + (yr / b) ** 2
    if thickness < 0:
        mask = q <= 1.0
    else:
        # approximate band: normalized distance within thickness/semiminor
        band = max(thickness, 1.0) / min(a, b)
        mask = np.abs(np.sqrt(q) - 1.0) <= band / 2.0 + 1e-6
    _paint(mat[ya:yb, xa:xb], mask, color)


def draw_line(
    mat: np.ndarray,
    pt1: Tuple[int, int],
    pt2: Tuple[int, int],
    color: ColorLike = (0, 0, 255),
    thickness: int = 1,
) -> None:
    """Line segment with thickness, in place."""
    x0, y0 = pt1
    x1, y1 = pt2
    half = max(thickness, 1) / 2.0
    xa, ya, xb, yb = _clip_box(mat, x0, y0, x1, y1, half + 1)
    if xa >= xb or ya >= yb:
        return
    ys = np.arange(ya, yb)[:, None].astype(np.float32)
    xs = np.arange(xa, xb)[None, :].astype(np.float32)
    dx, dy = x1 - x0, y1 - y0
    length2 = float(dx * dx + dy * dy)
    if length2 == 0:
        dist = np.sqrt((xs - x0) ** 2 + (ys - y0) ** 2)
    else:
        t = ((xs - x0) * dx + (ys - y0) * dy) / length2
        t = np.clip(t, 0.0, 1.0)
        dist = np.sqrt((xs - (x0 + t * dx)) ** 2 + (ys - (y0 + t * dy)) ** 2)
    _paint(mat[ya:yb, xa:xb], dist <= max(half, 0.5), color)


def draw_arrow(
    mat: np.ndarray,
    pt1: Tuple[int, int],
    pt2: Tuple[int, int],
    color: ColorLike = (0, 0, 255),
    thickness: int = 1,
    tip_length: float = 0.1,
) -> None:
    """Arrowed line, in place (reference draw_arrow)."""
    draw_line(mat, pt1, pt2, color, thickness)
    x0, y0 = pt1
    x1, y1 = pt2
    angle = math.atan2(y0 - y1, x0 - x1)
    tip = tip_length * math.hypot(x1 - x0, y1 - y0)
    for da in (math.pi / 4, -math.pi / 4):
        px = int(round(x1 + tip * math.cos(angle + da)))
        py = int(round(y1 + tip * math.sin(angle + da)))
        draw_line(mat, (px, py), (x1, y1), color, thickness)


def draw_rect(
    mat: np.ndarray,
    pt1: Tuple[int, int],
    pt2: Tuple[int, int],
    color: ColorLike = (0, 0, 255),
    thickness: int = 1,
) -> None:
    """Axis-aligned rectangle, in place. thickness=-1 fills."""
    x0, y0 = pt1
    x1, y1 = pt2
    if thickness < 0:
        xa, ya, xb, yb = _clip_box(mat, x0, y0, x1, y1, 0)
        if xa < xb and ya < yb:
            _paint(mat[ya:yb, xa:xb], np.ones((yb - ya, xb - xa), bool), color)
        return
    draw_line(mat, (x0, y0), (x1, y0), color, thickness)
    draw_line(mat, (x1, y0), (x1, y1), color, thickness)
    draw_line(mat, (x1, y1), (x0, y1), color, thickness)
    draw_line(mat, (x0, y1), (x0, y0), color, thickness)


def draw_rot_rect(
    mat: np.ndarray,
    center_x: float,
    center_y: float,
    width: float,
    height: float,
    angle_deg: float,
    color: ColorLike = (0, 0, 255),
    thickness: int = 1,
) -> None:
    """Rotated rectangle outline, in place."""
    rad = math.radians(angle_deg)
    c, s = math.cos(rad), math.sin(rad)
    hw, hh = width / 2.0, height / 2.0
    corners = []
    for dx, dy in ((-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh)):
        corners.append(
            (int(round(center_x + dx * c - dy * s)),
             int(round(center_y + dx * s + dy * c)))
        )
    draw_polylines(mat, [np.array(corners)], color=color, thickness=thickness)


def draw_text(
    mat: np.ndarray,
    text: str,
    org: Tuple[int, int],
    scale: float = 1.0,
    color: ColorLike = (0, 0, 255),
    thickness: int = 1,
) -> None:
    """Text, in place (PIL-rendered; org is the bottom-left like cv2)."""
    from PIL import Image, ImageDraw

    bgr = tuple(int(v) for v in _bgr(color))
    gray = mat.ndim == 2 or mat.shape[-1] == 1
    img = Image.fromarray(mat if gray else mat[..., ::-1])  # BGR -> RGB
    drawer = ImageDraw.Draw(img)
    size = max(int(16 * scale), 8)
    try:
        from PIL import ImageFont

        font = ImageFont.load_default(size=size)
    except Exception:
        font = None
    x, y = org
    fill = int(np.mean(bgr)) if gray else bgr[::-1]
    drawer.text((x, y - size), text, fill=fill, font=font)
    out = np.asarray(img)
    mat[:] = out if gray else out[..., ::-1]


def draw_text_with_background(
    mat: np.ndarray,
    text: str,
    org: Tuple[int, int],
    scale: float = 1.0,
    color: ColorLike = (255, 255, 255),
    background: ColorLike = (0, 0, 0),
    thickness: int = 1,
) -> None:
    size = max(int(16 * scale), 8)
    w = int(len(text) * size * 0.6)
    x, y = org
    draw_rect(mat, (x - 2, y - size - 2), (x + w, y + 4), background, -1)
    draw_text(mat, text, org, scale, color, thickness)


def draw_polylines(
    mat: np.ndarray,
    polys: Sequence[np.ndarray],
    is_closed: bool = True,
    color: ColorLike = (0, 0, 255),
    thickness: int = 1,
) -> None:
    """Polylines, in place. Each poly is [N, 2] (x, y) or [N, 1, 2]."""
    for poly in polys:
        pts = np.asarray(poly).reshape(-1, 2)
        n = len(pts)
        if n == 0:
            continue
        last = n if is_closed else n - 1
        for i in range(last):
            p0 = tuple(int(v) for v in pts[i])
            p1 = tuple(int(v) for v in pts[(i + 1) % n])
            draw_line(mat, p0, p1, color, thickness)


def draw_contours(
    mat: np.ndarray,
    contours: Sequence[np.ndarray],
    color: ColorLike = (0, 0, 255),
    thickness: int = 1,
) -> None:
    """Contours as closed polylines, in place
    (reference utils/draw.py draw_contours)."""
    draw_polylines(mat, contours, is_closed=True, color=color, thickness=thickness)

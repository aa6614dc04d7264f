"""Colorspace conversions on torch tensors, OpenCV-u8-exact.

Port of the integer paths of ``cuauv_vision_pipeline_tpu.ops.color``
(reference utils/color.py:11-32): pure functions over ``[..., H, W, 3]`` u8
tensors. All arithmetic is int32, as OpenCV's fixed-point pipelines are;
``>>`` on int32 tensors is an arithmetic shift, which ``_descale`` needs for
negative values. Lookup tables (``cvtables``) are gathered with index tensors
on the image's own device.

* ``bgr_to_gray``, ``bgr_to_hsv``, ``bgr_to_ycrcb``, ``bgr_to_lab`` —
  bit-exact vs OpenCV's u8 fixed-point pipelines (and vs the JAX package:
  tests/test_torch_ops.py).
"""

from __future__ import annotations

import functools

import torch

from . import cvtables as T


@functools.lru_cache(maxsize=None)
def _lut(name: str, device: torch.device) -> torch.Tensor:
    """A cvtables table as an int32 tensor on ``device`` (copied once)."""
    return torch.as_tensor(getattr(T, name), dtype=torch.int32, device=device)


def _descale(x: torch.Tensor, shift: int) -> torch.Tensor:
    """OpenCV CV_DESCALE: round-half-up fixed-point rescale (arithmetic
    shift, valid for negative values)."""
    return (x + (1 << (shift - 1))) >> shift


def _split_bgr(image: torch.Tensor):
    img = image.to(torch.int32)
    return img[..., 0], img[..., 1], img[..., 2]


def bgr_to_gray(image: torch.Tensor) -> torch.Tensor:
    """u8 BGR -> u8 GRAY, bit-exact vs cv2 (BT.601, 15-bit fixed point)."""
    b, g, r = _split_bgr(image)
    y = _descale(r * T.GRAY_R + g * T.GRAY_G + b * T.GRAY_B, T.GRAY_SHIFT)
    return y.to(torch.uint8)


def gray_to_bgr(image: torch.Tensor) -> torch.Tensor:
    """u8 GRAY -> u8 BGR (channel replication, exact)."""
    if image.ndim >= 1 and image.shape[-1] == 1:
        image = image[..., 0]
    return torch.stack([image, image, image], dim=-1).to(torch.uint8)


def bgr_to_hsv(image: torch.Tensor) -> torch.Tensor:
    """u8 BGR -> u8 HSV (H in [0,180)), bit-exact vs cv2's 12-bit tables."""
    b, g, r = _split_bgr(image)
    v = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = v - vmin

    sdiv = _lut("HSV_SDIV_TABLE", image.device)
    hdiv = _lut("HSV_HDIV_TABLE", image.device)
    half = 1 << (T.HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> T.HSV_SHIFT

    h_raw = torch.where(
        v == r,
        g - b,
        torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff),
    )
    h = (h_raw * hdiv[diff] + half) >> T.HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def bgr_to_ycrcb(image: torch.Tensor) -> torch.Tensor:
    """u8 BGR -> u8 YCrCb, bit-exact vs cv2 (14-bit fixed point)."""
    b, g, r = _split_bgr(image)
    y = _descale(
        r * T.YCRCB_YR + g * T.YCRCB_YG + b * T.YCRCB_YB, T.YCRCB_SHIFT
    )
    cr = _descale((r - y) * T.YCRCB_CR, T.YCRCB_SHIFT) + 128
    cb = _descale((b - y) * T.YCRCB_CB, T.YCRCB_SHIFT) + 128
    out = torch.stack([y, cr.clamp(0, 255), cb.clamp(0, 255)], dim=-1)
    return out.to(torch.uint8)


def bgr_to_lab(image: torch.Tensor) -> torch.Tensor:
    """u8 BGR (sRGB) -> u8 Lab, bit-exact vs cv2's integer LUT pipeline."""
    b8, g8, r8 = _split_bgr(image)
    gamma = _lut("LAB_GAMMA_TABLE", image.device)
    cbrt = _lut("LAB_CBRT_TABLE", image.device)
    C = [[int(c) for c in row] for row in T.LAB_XYZ_COEFFS]

    r, g, b = gamma[r8], gamma[g8], gamma[b8]

    def f(row):
        return cbrt[_descale(r * row[0] + g * row[1] + b * row[2], T.LAB_SHIFT)]

    fx, fy, fz = f(C[0]), f(C[1]), f(C[2])

    L = _descale(T.LAB_L_SCALE * fy + T.LAB_L_SHIFT, T.LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + (128 << T.LAB_SHIFT2), T.LAB_SHIFT2)
    bb = _descale(200 * (fy - fz) + (128 << T.LAB_SHIFT2), T.LAB_SHIFT2)
    out = torch.stack(
        [L.clamp(0, 255), a.clamp(0, 255), bb.clamp(0, 255)], dim=-1
    )
    return out.to(torch.uint8)

"""Plain reference of the red_buoy configuration, in PyTorch ops.

Independent of the program (it imports nothing of it): from u8 BGR frames to
the largest blob's stats, as the configuration states them.

1. OpenCV's u8 BGR -> Lab conversion (``cv::cvtColor(COLOR_BGR2Lab)`` on
   8-bit images, ``imgproc/src/color_lab.cpp``): sRGB gamma to fixed point
   (2^3 steps per level), the sRGB -> XYZ matrix over the D65 white point in
   12-bit fixed point, the f(t) table in 15-bit fixed point, then
   a* = descale(500 (f(X) - f(Y)) + 128 * 2^15, 15), saturated to u8. Only
   a* is needed.
2. ``cv2.inRange`` on a*: foreground where thresh_min <= a* <= thresh_max.
3. 8-connected components of that (un-cleaned) mask, each labelled by the
   raster index y*W + x of its topmost-leftmost pixel: min-propagation over
   the 3x3 neighbourhood with pointer jumping, to the fixpoint.
4. The ``max_components`` components whose labels are smallest (the first
   ones in raster order), their areas, (x, y, w, h) boxes and (y, x) means;
   the largest of them, the first on ties. ``found`` is False on a frame
   with no component, and then area and box are 0.

The centroid is the exact mean rounded once to float32. ``control`` gives the
same stats with the centroid computed in bfloat16, the precision below the
configuration's float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

_GAMMA_SHIFT = 3
_LAB_SHIFT = 12
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_SRGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                         [0.212671, 0.715160, 0.072169],
                         [0.019334, 0.119193, 0.950227]])
_D65 = np.array([0.950456, 1.0, 1.088754])
_BACKGROUND = float(2 ** 30)


def lab_tables():
    """(gamma table [256], f(t) table, XYZ coefficients [3, 3] int)."""
    x = np.arange(256, dtype=np.float64) / 255.0
    linear = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gamma = np.round(linear * 255 * (1 << _GAMMA_SHIFT)).astype(np.int64)
    size = 256 * 3 // 2 * (1 << _GAMMA_SHIFT)
    t = np.arange(size, dtype=np.float64) / (255.0 * (1 << _GAMMA_SHIFT))
    # OpenCV takes the cube root in single precision (its softfloat cbrt)
    cube_root = np.cbrt(t.astype(np.float32)).astype(np.float64)
    f = np.where(t < 0.008856, t * 7.787 + 16.0 / 116.0, cube_root)
    ftab = np.round(f * (1 << _LAB_SHIFT2)).astype(np.int64)
    coeffs = np.round(_SRGB_TO_XYZ / _D65[:, None] * (1 << _LAB_SHIFT)).astype(np.int64)
    return gamma, ftab, coeffs


def _descale(v: torch.Tensor, shift: int) -> torch.Tensor:
    return (v + (1 << (shift - 1))) >> shift


def lab_a(frames: torch.Tensor) -> torch.Tensor:
    """u8 BGR [..., H, W, 3] -> u8 a* [..., H, W]."""
    gamma, ftab, coeffs = (torch.as_tensor(t, device=frames.device) for t in lab_tables())
    bgr = frames.long()
    b, g, r = gamma[bgr[..., 0]], gamma[bgr[..., 1]], gamma[bgr[..., 2]]
    fx = ftab[_descale(r * int(coeffs[0, 0]) + g * int(coeffs[0, 1]) + b * int(coeffs[0, 2]), _LAB_SHIFT)]
    fy = ftab[_descale(r * int(coeffs[1, 0]) + g * int(coeffs[1, 1]) + b * int(coeffs[1, 2]), _LAB_SHIFT)]
    a = _descale(500 * (fx - fy) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    return a.clamp(0, 255).to(torch.uint8)


def components(mask: torch.Tensor) -> torch.Tensor:
    """8-connected labels of [B, H, W] masks (nonzero = foreground): the
    raster index of each component's topmost-leftmost pixel, as float64,
    2^30 on the background."""
    B, H, W = mask.shape
    fg = mask != 0
    raster = torch.arange(H * W, dtype=torch.float64, device=mask.device).view(1, H, W)
    lab = torch.where(fg, raster, _BACKGROUND)
    while True:
        # max-pool of the negated labels: the 3x3 minimum, -inf padding
        nb = -F.max_pool2d(-lab[:, None], 3, stride=1, padding=1)[:, 0]
        nb = torch.where(fg, nb, _BACKGROUND)
        flat = nb.reshape(B, H * W)
        jumped = torch.gather(flat, 1, flat.clamp(max=H * W - 1).long())
        new = torch.where(fg, torch.minimum(nb, jumped.view(B, H, W)), _BACKGROUND)
        if torch.equal(new, lab):
            return lab
        lab = new


def largest_blob(frames: torch.Tensor, thresh_min: int, thresh_max: int, max_components: int,
                 centroid_dtype: torch.dtype = torch.float32) -> Dict[str, np.ndarray]:
    """The configuration's answer for each of [B, H, W, 3] u8 BGR frames:
    {"found" [B] bool, "area" [B] int, "bbox" [B, 4] int (x, y, w, h),
    "centroid" [B, 2] float32 (y, x)}."""
    a = lab_a(frames)
    mask = (a >= thresh_min) & (a <= thresh_max)
    lab = components(mask)
    B, H, W = mask.shape
    raster = torch.arange(H * W, dtype=torch.float64, device=frames.device)
    ys = torch.arange(H, device=frames.device, dtype=torch.float64)
    xs = torch.arange(W, device=frames.device, dtype=torch.float64)
    out = {"found": np.zeros(B, bool), "area": np.zeros(B, np.int64),
           "bbox": np.zeros((B, 4), np.int64), "centroid": np.zeros((B, 2), np.float32)}
    for i in range(B):
        flat = lab[i].reshape(-1)
        roots = flat[(flat == raster) & (flat < _BACKGROUND)][:max_components]
        best = None
        for root in roots.tolist():
            member = lab[i] == root
            area = int(member.sum())
            if best is None or area > best[1]:
                best = (member, area)
        if best is None:
            continue
        member, area = best
        rows, cols = member.any(1), member.any(0)
        y_idx, x_idx = ys[rows], xs[cols]
        sum_y = float((member.sum(1).double() * ys).sum())
        sum_x = float((member.sum(0).double() * xs).sum())
        if centroid_dtype == torch.float32:
            centroid = np.array([sum_y / area, sum_x / area], np.float32)
        else:
            num = torch.tensor([sum_y, sum_x], dtype=torch.float64).to(centroid_dtype)
            centroid = (num / torch.tensor(float(area)).to(centroid_dtype)).float().numpy()
        x0, y0 = int(x_idx.min()), int(y_idx.min())
        out["found"][i] = True
        out["area"][i] = area
        out["bbox"][i] = (x0, y0, int(x_idx.max()) - x0 + 1, int(y_idx.max()) - y0 + 1)
        out["centroid"][i] = centroid
    return out


def control(frames, thresh_min, thresh_max, max_components):
    """The reference with its centroid in bfloat16: the step below the
    configuration's float32 that a later change might take."""
    return largest_blob(frames, thresh_min, thresh_max, max_components, torch.bfloat16)

"""Lens undistortion (the reference's camera_filters remnant, completed).

Port of ``cuauv_vision_pipeline_tpu.utils.undistort`` (reference
include/camera_filters.hpp:1-11, whose implementation was lost from the
reference tree): the inverse distortion sample map is built once on the
host (Brown-Conrady model, as cv2.initUndistortRectifyMap), and each frame
is resampled through it with bilinear weights on the device.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..core.device import DeviceLike, run_np
from ..ops.ieee import fma_rn


def load_camera_params(path: str) -> Dict:
    import yaml

    with open(path) as fh:
        return yaml.safe_load(fh)


def init_undistort_map(
    params: Dict, width: int = 0, height: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (map_x, map_y) float32 sample maps like cv2.initUndistortRectifyMap:
    for each undistorted output pixel, the distorted source location."""
    cm = params["camera_matrix"]
    dist = params.get("distortion", {})
    fx, fy = cm["fx"], cm["fy"]
    cx, cy = cm["cx"], cm["cy"]
    k1 = dist.get("k1", 0.0)
    k2 = dist.get("k2", 0.0)
    p1 = dist.get("p1", 0.0)
    p2 = dist.get("p2", 0.0)
    k3 = dist.get("k3", 0.0)
    if not width:
        width = params["image_size"]["width"]
    if not height:
        height = params["image_size"]["height"]

    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    # normalized camera coords of the undistorted grid
    xn = (xs - cx) / fx
    yn = (ys - cy) / fy
    # forward distortion model (same direction cv2 uses for the map)
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    map_x = (xd * fx + cx).astype(np.float32)
    map_y = (yd * fy + cy).astype(np.float32)
    return map_x, map_y


def _lerp(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a*(1-w) + b*w`` rounded as XLA:CPU compiles it at its default
    optimization level: the first product fused into the sum,
    ``fma(a, 1-w, b*w)``."""
    return fma_rn(a, 1 - w, b * w)


def _remap(image: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    chan_last = image.ndim >= 3
    H = image.shape[-3] if chan_last else image.shape[-2]
    W = image.shape[-2] if chan_last else image.shape[-1]

    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    wx = map_x - x0
    wy = map_y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    img = image.to(torch.float32)

    def sample(yi, xi):
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = yi.clamp(0, H - 1)
        xc = xi.clamp(0, W - 1)
        if chan_last:
            return torch.where(inside[..., None], img[..., yc, xc, :], 0.0)
        return torch.where(inside, img[..., yc, xc], 0.0)

    wxe = wx[..., None] if chan_last else wx
    wye = wy[..., None] if chan_last else wy
    top = _lerp(sample(y0i, x0i), sample(y0i, x0i + 1), wxe)
    bot = _lerp(sample(y0i + 1, x0i), sample(y0i + 1, x0i + 1), wxe)
    out = _lerp(top, bot, wye)
    if not image.dtype.is_floating_point:
        out = torch.clamp(torch.floor(out + 0.5), 0, 255)
    return out.to(image.dtype)


def undistort(
    image: Union[torch.Tensor, np.ndarray],
    map_x,
    map_y,
    device: DeviceLike = None,
):
    """Apply a (map_x, map_y) remap with bilinear sampling (cv2.remap
    INTER_LINEAR + BORDER_CONSTANT) to ``[..., H, W]`` or ``[..., H, W, C]``.

    A tensor is resampled on its own device and returned as a tensor; a
    numpy array on ``device`` (cuda:0 unless told ``cpu``), returned as
    numpy. Integer images round as floor(x + 0.5) in float32."""
    if isinstance(image, torch.Tensor):
        dev = image.device
        mx, my = (torch.as_tensor(m).to(device=dev, dtype=torch.float32) for m in (map_x, map_y))
        return _remap(image, mx, my)
    return run_np(lambda t: undistort(t, map_x, map_y), image, device)

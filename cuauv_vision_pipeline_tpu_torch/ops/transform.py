"""Geometric and filtering transforms on torch tensors.

Port of ``cuauv_vision_pipeline_tpu.ops.transform`` (reference
utils/transform.py:5-233): Gaussian blur, resize, warp_affine and the
rotate/translate built on it, and normal-map decode/encode. Images are
``[..., H, W]`` or, with three or more dims, ``[..., H, W, C]`` channels
last, as in the JAX version. The u8 Gaussian blur with ksize <= 9 is an
integer filter, bit-exact vs cv2; the float paths are tolerance-matched
(they feed display, debug and geometry, not the bit-exact mask contract).

Index grids and weights are built in float32 with the JAX version's
constants; an affine matrix is a host array and is inverted on the host,
so no call reads a device value back.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .threshold import _gaussian_kernel_1d


def _hw_axes(x: torch.Tensor) -> Tuple[int, int]:
    """(H axis, W axis): channels last from three dims up."""
    nd = x.ndim
    return (nd - 3, nd - 2) if nd >= 3 else (nd - 2, nd - 1)


def _reflect101(x: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    """Pad ``axis`` by ``pad`` on both sides, BORDER_REFLECT_101 (numpy's
    ``reflect``, period 2(n-1) for pads past the edge), by gathering along
    the axis; the index is built on the image's device."""
    n = x.shape[axis]
    i = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        idx = torch.zeros_like(i)
    else:
        j = torch.remainder(i, 2 * (n - 1))
        idx = torch.where(j >= n, 2 * (n - 1) - j, j)
    return x.index_select(axis, idx)


def gaussian_blur(image: torch.Tensor, kernel_size: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur with BORDER_REFLECT_101
    (reference utils/transform.py:5-25 simple_gaussian_blur).

    u8 inputs with kernel_size <= 9 (and sigma <= 0) reproduce
    cv2.GaussianBlur bit-exactly: OpenCV's binary-fraction kernels in 8-bit
    fixed point, a separable int32 filter of shifted slices, rounded as
    ``(acc + 2**15) >> 16``. Larger kernels filter in float32 with the
    getGaussianKernel formula (cv2.sepFilter2D), within a count or two of
    cv2.GaussianBlur, as the JAX version is."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel size must be odd")
    kf = _gaussian_kernel_1d(kernel_size, sigma)
    pad = kernel_size // 2

    is_u8 = image.dtype == torch.uint8 and kernel_size <= 9 and sigma <= 0
    if is_u8:
        k = [int(v) for v in np.round(kf * (1 << 8)).astype(np.int32)]
        x = image.to(torch.int32)
    else:
        k = [float(v) for v in kf.astype(np.float32)]
        x = image.to(torch.float32)

    h_axis, w_axis = _hw_axes(x)

    def conv1d(arr, axis):
        arr = _reflect101(arr, axis, pad)
        n = arr.shape[axis]
        acc = None
        for i in range(kernel_size):
            term = arr.narrow(axis, i, n - (kernel_size - 1)) * k[i]
            acc = term if acc is None else acc + term
        return acc

    out = conv1d(conv1d(x, h_axis), w_axis)
    if is_u8:
        out = ((out + (1 << 15)) >> 16).clamp(0, 255)
    elif not image.dtype.is_floating_point:
        out = torch.floor(out + 0.5).clamp(0, 255)
    return out.to(image.dtype)


def _f32(v: float) -> float:
    """A Python float rounded to float32 (JAX's weak-typed constant)."""
    return float(np.float32(v))


def resize(
    image: torch.Tensor,
    dsize: Tuple[int, int],
    interpolation: str = "linear",
) -> torch.Tensor:
    """cv2.resize semantics; dsize is (width, height) like OpenCV
    (reference utils/transform.py:167-183)."""
    out_w, out_h = dsize
    chan_last = image.ndim >= 3
    h_axis, w_axis = _hw_axes(image)
    in_h, in_w = image.shape[h_axis], image.shape[w_axis]
    dev = image.device

    def take(img, ys, xs):
        if chan_last:
            return img[..., ys[:, None], xs[None, :], :]
        return img[..., ys[:, None], xs[None, :]]

    if interpolation == "nearest":
        # cv2 INTER_NEAREST: src = floor(dst * scale)
        ys = torch.floor(torch.arange(out_h, dtype=torch.float32, device=dev) * _f32(in_h / out_h))
        xs = torch.floor(torch.arange(out_w, dtype=torch.float32, device=dev) * _f32(in_w / out_w))
        return take(image, ys.to(torch.int64).clamp(0, in_h - 1), xs.to(torch.int64).clamp(0, in_w - 1))

    # INTER_LINEAR with pixel-center alignment: src = (dst+0.5)*scale - 0.5
    fy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * _f32(in_h / out_h) - 0.5
    fx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * _f32(in_w / out_w) - 0.5
    y0 = torch.floor(fy).clamp(0, in_h - 1).to(torch.int64)
    x0 = torch.floor(fx).clamp(0, in_w - 1).to(torch.int64)
    y1 = (y0 + 1).clamp(0, in_h - 1)
    x1 = (x0 + 1).clamp(0, in_w - 1)
    wy = (fy - y0.to(torch.float32)).clamp(0.0, 1.0)
    wx = (fx - x0.to(torch.float32)).clamp(0.0, 1.0)

    img = image.to(torch.float32)
    wy_b = wy[:, None, None] if chan_last else wy[:, None]
    wx_b = wx[None, :, None] if chan_last else wx[None, :]
    top = take(img, y0, x0) * (1 - wx_b) + take(img, y0, x1) * wx_b
    bot = take(img, y1, x0) * (1 - wx_b) + take(img, y1, x1) * wx_b
    out = top * (1 - wy_b) + bot * wy_b
    if not image.dtype.is_floating_point:
        out = torch.floor(out + 0.5).clamp(0, 255)
    return out.to(image.dtype)


def warp_affine(
    image: torch.Tensor,
    matrix,
    dsize: Optional[Tuple[int, int]] = None,
    border_value: float = 0.0,
) -> torch.Tensor:
    """cv2.warpAffine with INTER_LINEAR + BORDER_CONSTANT.

    ``matrix`` is the 2x3 forward map as a host array (dst <- src uses its
    inverse, computed here in float32 as the JAX version computes it)."""
    chan_last = image.ndim >= 3
    h_axis, w_axis = _hw_axes(image)
    in_h, in_w = image.shape[h_axis], image.shape[w_axis]
    out_w, out_h = dsize if dsize is not None else (in_w, in_h)
    dev = image.device

    M = np.asarray(matrix, np.float32)
    A, b = M[:, :2], M[:, 2]
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    Ai = np.array([[A[1, 1], -A[0, 1]], [-A[1, 0], A[0, 0]]], np.float32) * (np.float32(1.0) / det)
    bi = -Ai @ b
    Ai, bi = Ai.tolist(), bi.tolist()

    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None].expand(out_h, out_w)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :].expand(out_h, out_w)
    sx = xs * Ai[0][0] + ys * Ai[0][1] + bi[0]
    sy = xs * Ai[1][0] + ys * Ai[1][1] + bi[1]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    img = image.to(torch.float32)

    def sample(yi, xi):
        inside = (yi >= 0) & (yi < in_h) & (xi >= 0) & (xi < in_w)
        yc = yi.clamp(0, in_h - 1)
        xc = xi.clamp(0, in_w - 1)
        if chan_last:
            return torch.where(inside[..., None], img[..., yc, xc, :], border_value)
        return torch.where(inside, img[..., yc, xc], border_value)

    wxe, wye = (wx[..., None], wy[..., None]) if chan_last else (wx, wy)
    top = sample(y0i, x0i) * (1 - wxe) + sample(y0i, x0i + 1) * wxe
    bot = sample(y0i + 1, x0i) * (1 - wxe) + sample(y0i + 1, x0i + 1) * wxe
    out = top * (1 - wye) + bot * wye
    if not image.dtype.is_floating_point:
        out = torch.floor(out + 0.5).clamp(0, 255)
    return out.to(image.dtype)


def rotation_matrix(
    center: Tuple[float, float], angle_deg: float, scale: float = 1.0
) -> np.ndarray:
    """cv2.getRotationMatrix2D."""
    a = math.radians(angle_deg)
    alpha = scale * math.cos(a)
    beta = scale * math.sin(a)
    cx, cy = center
    return np.array(
        [
            [alpha, beta, (1 - alpha) * cx - beta * cy],
            [-beta, alpha, beta * cx + (1 - alpha) * cy],
        ],
        dtype=np.float32,
    )


def rotate(image: torch.Tensor, angle_deg: float) -> torch.Tensor:
    """Rotate about the image center (reference utils/transform.py:186-200)."""
    h_axis, w_axis = _hw_axes(image)
    h, w = image.shape[h_axis], image.shape[w_axis]
    return warp_affine(image, rotation_matrix((w / 2.0, h / 2.0), angle_deg))


def translate(image: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """Translate by (dx, dy) pixels (reference utils/transform.py:203-216)."""
    M = np.array([[1.0, 0.0, dx], [0.0, 1.0, dy]], dtype=np.float32)
    return warp_affine(image, M)


def decode_normal(image: torch.Tensor) -> torch.Tensor:
    """u8-encoded normal map -> float32 in [-1, 1]
    (reference utils/transform.py:218-233)."""
    return image.to(torch.float32) * (2.0 / 255.0) - 1.0


def encode_normal(normals: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] normals -> u8 (inverse of decode_normal; used by the
    ZED postprocess path, reference capture_sources/zed.cpp:84-91)."""
    return torch.round((normals + 1.0) * (255.0 / 2.0)).clamp(0, 255).to(torch.uint8)

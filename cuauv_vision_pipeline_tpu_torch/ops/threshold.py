"""Thresholding on torch tensors, OpenCV-exact on the u8 paths.

Port of ``cuauv_vision_pipeline_tpu.ops.threshold`` (reference
utils/color.py:105-292): ``in_range`` (cv2.inRange), the cv2.threshold modes
(binary/inv/trunc/tozero/tozero_inv), Otsu, adaptive mean/gaussian, the
color distances, and the Gaussian kernel table that
``ops/transform.py:gaussian_blur`` takes. All run on the device of their
input, over ``[..., H, W]`` or ``[..., H, W, C]`` tensors.

Exactness: in_range and the fixed modes are plain comparisons. Otsu's
between-class variance comes from exact integer sums (cv2 computes it in
float64; the JAX package in float32). ``adaptive_mean`` sums its box in
int32 and rescales as the JAX package does (a multiply by the float32
reciprocal of k*k, as XLA rewrites the division). ``adaptive_gaussian``
adds its taps in the JAX package's order with the multiply-adds fused
(``ieee.fma_rn``) as XLA:CPU fuses them at its default optimization level,
so the u8 mask equals the JAX package's on every device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import ieee as I
from .balance import _histogram, _percentile
from .feature import sqrt_f32


def _bound(value, image: torch.Tensor):
    """Cast a bound to the image dtype, as ``jnp.asarray(v, image.dtype)``
    does. Scalars stay Python numbers (no host-to-device copy per call);
    per-channel bounds become a tensor on the image's device."""
    if isinstance(value, torch.Tensor):
        return value.to(device=image.device, dtype=image.dtype)
    np_dtype = torch.empty((), dtype=image.dtype).numpy().dtype
    arr = np.asarray(value).astype(np_dtype)
    if arr.ndim == 0:
        return arr.item()
    return torch.as_tensor(arr, device=image.device)


def in_range(image: torch.Tensor, lower, upper) -> torch.Tensor:
    """cv2.inRange: 255 where lower <= x <= upper, else 0 (u8).

    Scalar bounds treat the image as single-channel (any shape, including
    batched ``[B, H, W]``). 1-D bounds treat the last axis as channels and
    AND across them (``[..., H, W, C]``)."""
    lower = _bound(lower, image)
    upper = _bound(upper, image)
    per_channel = any(
        isinstance(v, torch.Tensor) and v.ndim >= 1 for v in (lower, upper)
    )
    mask = (image >= lower) & (image <= upper)
    if per_channel:
        mask = mask.all(dim=-1)
    elif image.ndim >= 3 and image.shape[-1] == 1:
        mask = mask[..., 0]
    return _u8_mask(mask)


# Reference naming (utils/color.py:105-121)
range_threshold = in_range


def _u8_mask(cond: torch.Tensor, maxval: int = 255) -> torch.Tensor:
    """``maxval`` where ``cond``, else 0, as u8."""
    return cond.to(torch.uint8) * maxval


def _thresh(thresh):
    """A threshold as the float32 the comparison uses: a tensor as it is,
    a number rounded to float32 (JAX's weak-typed scalar)."""
    if isinstance(thresh, torch.Tensor):
        return thresh.to(torch.float32)
    return float(np.float32(thresh))


def binary(image: torch.Tensor, thresh, maxval: int = 255) -> torch.Tensor:
    """cv2.THRESH_BINARY: x > thresh -> maxval else 0."""
    return _u8_mask(image.to(torch.float32) > _thresh(thresh), maxval)


def binary_inv(image: torch.Tensor, thresh, maxval: int = 255) -> torch.Tensor:
    """cv2.THRESH_BINARY_INV: x > thresh -> 0 else maxval."""
    return _u8_mask(image.to(torch.float32) <= _thresh(thresh), maxval)


def truncate(image: torch.Tensor, thresh) -> torch.Tensor:
    """cv2.THRESH_TRUNC: min(x, thresh)."""
    t = _thresh(thresh)
    t = torch.floor(t) if isinstance(t, torch.Tensor) else float(np.floor(t))
    return torch.clamp(image.to(torch.float32), max=t).to(image.dtype)


def to_zero(image: torch.Tensor, thresh) -> torch.Tensor:
    """cv2.THRESH_TOZERO: x > thresh ? x : 0."""
    return torch.where(image.to(torch.float32) > _thresh(thresh), image, 0).to(image.dtype)


def to_zero_inv(image: torch.Tensor, thresh) -> torch.Tensor:
    """cv2.THRESH_TOZERO_INV: x > thresh ? 0 : x."""
    return torch.where(image.to(torch.float32) > _thresh(thresh), 0, image).to(image.dtype)


def histogram_u8(image: torch.Tensor) -> torch.Tensor:
    """256-bin int32 histogram of a u8 image (all of it), by the segment sum
    that ``ops/balance.py`` takes its histograms with (no host sync)."""
    return _histogram(image.reshape(-1).to(torch.int64), 256, torch.int64).to(torch.int32)


def otsu(image: torch.Tensor, maxval: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """Otsu's threshold (reference utils/color.py:204-218).

    Returns (threshold, mask) like cv2.threshold(..., THRESH_OTSU): the first
    level t maximizing the between-class variance, then THRESH_BINARY with
    it; t is a float32 0-d tensor on the image's device.

    With w0, s0 the count and level sum of pixels <= t and w1, s1 those of
    the rest, the variance w0*w1*(s0/w0 - s1/w1)**2 equals
    (s0*w1 - s1*w0)**2 / (w0*w1): the difference is an exact int64, and an
    exact float64 below 255*N**2 < 2**53 (N < 5.9M pixels), the rest one
    float64 square and one division; the argmax is cv2's (float64) where
    the JAX package's float32 sums may round a near-tie the other way."""
    hist = histogram_u8(image).to(torch.int64)
    levels = torch.arange(256, dtype=torch.int64, device=hist.device)
    w0 = torch.cumsum(hist, 0)
    s0 = torch.cumsum(hist * levels, 0)
    w1 = w0[-1] - w0
    s1 = s0[-1] - s0
    d = (s0 * w1 - s1 * w0).to(torch.float64)
    valid = (w0 > 0) & (w1 > 0)
    between = torch.where(valid, d * d / (w0 * w1).clamp(min=1).to(torch.float64), -1.0)
    t = torch.argmax(between).to(torch.float32)
    return t, binary(image, t, maxval)


def _edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate the border ``pad`` pixels out on the last two axes (any
    dtype: a gather of clamped indices)."""
    for axis in (-2, -1):
        n = x.shape[axis]
        idx = torch.arange(-pad, n + pad, device=x.device).clamp(0, n - 1)
        x = x.index_select(x.ndim + axis, idx)
    return x


def _box_sum_replicate(image: torch.Tensor, ksize: int) -> torch.Tensor:
    """Sum over a ksize x ksize window with BORDER_REPLICATE, batched over
    leading dims, of an integer ``[..., H, W]`` image (exact: cumulative
    sums and their differences, in the image's dtype)."""
    p = _edge_pad(image, ksize // 2)
    for axis in (-2, -1):
        c = torch.cumsum(p, dim=axis, dtype=p.dtype)
        n = c.shape[axis]
        head = c.narrow(axis, ksize - 1, n - ksize + 1)
        lag = c.narrow(axis, 0, n - ksize)
        p = torch.cat([head.narrow(axis, 0, 1), head.narrow(axis, 1, n - ksize) - lag], dim=axis)
    return p


def _adaptive_mask(image: torch.Tensor, mean: torch.Tensor, bias: float, maxval: int,
                   inverse: bool) -> torch.Tensor:
    """cv2's comparison of src against its rounded local mean: src > mean -
    ceil(bias) (the u8 table cv2 builds), or its negation."""
    cond = image.to(torch.int32) > (mean - int(np.ceil(bias)))
    return _u8_mask(~cond if inverse else cond, maxval)


def adaptive_mean(
    image: torch.Tensor,
    neighborhood_size: int,
    bias: float = 0.0,
    maxval: int = 255,
    inverse: bool = False,
) -> torch.Tensor:
    """cv2.adaptiveThreshold(ADAPTIVE_THRESH_MEAN_C): x > mean(window) - bias,
    the mean rounded as floor(s/k^2 + 0.5) in float32."""
    k2 = neighborhood_size * neighborhood_size
    s = _box_sum_replicate(image.to(torch.int32), neighborhood_size)
    mean = torch.floor(s.to(torch.float32) * I.recip_f32(k2) + 0.5).to(torch.int32)
    return _adaptive_mask(image, mean, bias, maxval, inverse)


# cv2.getGaussianKernel returns these hardcoded binary-fraction kernels for
# small sizes with sigma <= 0 (exactly representable in 8-bit fixed point;
# ksize 9 is {4, 13, 30, 51, 60, 51, 30, 13, 4} / 256 in cv2's bit-exact path)
_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
    9: np.array([4.0, 13.0, 30.0, 51.0, 60.0, 51.0, 30.0, 13.0, 4.0]) / 256.0,
}


def _gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel semantics (float64, small-kernel table)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].copy()
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _fused_dot(xs, ws) -> torch.Tensor:
    """``sum_i ws[i] * xs[i]`` (float32 tensors, float weights) in order,
    rounded as XLA:CPU compiles ``acc + w[i] * x[i]`` at its default
    optimization level: the first two products meet in one FMA with the
    first product unrounded (LLVM contracts the add's first operand),
    ``fma(x0, w0, x1*w1)``, then ``acc = fma(x[i], w[i], acc)``. With two
    roundings per term instead, about a third of an 11-tap Gaussian's
    float32 sums lie an ulp off the JAX package's (measured on 64x96
    noise)."""
    if len(xs) == 1:
        return xs[0] * ws[0]
    acc = I.fma_rn(xs[0], torch.full_like(xs[0], ws[0]), xs[1] * ws[1])
    for x, w in zip(xs[2:], ws[2:]):
        acc = I.fma_rn(x, torch.full_like(x, w), acc)
    return acc


def _taps_fused(x: torch.Tensor, k, axis: int) -> torch.Tensor:
    """The 1-D filter ``sum_i k[i] * x[i : i + n]`` along ``axis``, in the
    JAX package's order and rounding (:func:`_fused_dot`)."""
    n = x.shape[axis] - (len(k) - 1)
    return _fused_dot([x.narrow(axis, i, n) for i in range(len(k))], k)


def adaptive_gaussian(
    image: torch.Tensor,
    neighborhood_size: int,
    bias: float = 0.0,
    maxval: int = 255,
    inverse: bool = False,
) -> torch.Tensor:
    """cv2.adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C): the separable
    float32 Gaussian (rows, then columns) over a replicate-padded image,
    rounded as floor(x + 0.5)."""
    k = [float(v) for v in _gaussian_kernel_1d(neighborhood_size).astype(np.float32)]
    padded = _edge_pad(image.to(torch.float32), neighborhood_size // 2)
    smoothed = _taps_fused(_taps_fused(padded, k, image.ndim - 2), k, image.ndim - 1)
    mean = torch.floor(smoothed + 0.5).to(torch.int32)
    return _adaptive_mask(image, mean, bias, maxval, inverse)


def color_distance(image: torch.Tensor, color: Sequence[float]) -> torch.Tensor:
    """Euclidean distance of each pixel to a color, float32
    (reference utils/color.py:35-63); the root correctly rounded."""
    c = torch.as_tensor(np.asarray(color, np.float32), device=image.device)
    diff = image.to(torch.float32) - c
    return sqrt_f32((diff * diff).sum(dim=-1))


def thresh_color_distance(
    image: torch.Tensor,
    color: Sequence[float],
    distance: float,
    auto_distance_percentile: Optional[float] = None,
    ignore_channels: Sequence[int] = (),
    weights: Sequence[float] = (1.0, 1.0, 1.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted color-distance threshold (reference utils/color.py:66-103).

    Returns (mask, distances_u8): mask is 255 where the weighted squared
    distance <= the limit (``distance**2``, or the image's own
    ``auto_distance_percentile`` if smaller); distances are the square root
    of the weighted squares, truncated to u8. The weighted sum adds the
    channels in order with the multiply-adds fused as XLA:CPU fuses them
    (:func:`_fused_dot`), so it is bit-equal to the JAX package's."""
    w = np.array(weights, dtype=np.float32)
    for idx in ignore_channels:
        w[idx] = 0.0
    w = w / np.linalg.norm(np.array(weights, dtype=np.float32))

    img = image.to(torch.float32)
    c = np.asarray(color, np.float32)
    keep = [i for i in range(image.shape[-1]) if i not in ignore_channels]
    if keep:
        sq = [(img[..., i] - float(c[i])) ** 2 for i in keep]
        dists = _fused_dot(sq, [float(w[i]) for i in keep])
    else:
        dists = torch.zeros(image.shape[:-1], dtype=torch.float32, device=image.device)

    limit = float(np.float32(distance**2))
    if auto_distance_percentile is not None:
        limit = torch.clamp(_percentile(dists, auto_distance_percentile), max=limit)
    mask = _u8_mask(dists <= limit)
    return mask, sqrt_f32(dists).to(torch.uint8)

"""Thresholding on torch tensors: cv2.inRange, and the Gaussian kernel
table that ``ops/transform.py:gaussian_blur`` takes.

Port of ``cuauv_vision_pipeline_tpu.ops.threshold.in_range`` (reference
utils/color.py:105-121) and ``_gaussian_kernel_1d``. ``in_range`` is
bit-exact by construction (plain comparisons).
"""

from __future__ import annotations

import numpy as np
import torch


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
    return mask.to(torch.uint8) * 255


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

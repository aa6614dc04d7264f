"""Thresholding on torch tensors: cv2.inRange.

Port of ``cuauv_vision_pipeline_tpu.ops.threshold.in_range`` (reference
utils/color.py:105-121). Bit-exact by construction (plain comparisons).
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

"""Numpy twins of colorspace ops for host paths.

Port of ``cuauv_vision_pipeline_tpu.ops.color_np``: the exact integer
pipeline of ``ops/color.py:bgr_to_gray`` in numpy, for host code that holds
a frame as an array (the bins module's pose template), bit-exact vs cv2 and
the torch version.
"""

from __future__ import annotations

import numpy as np

from . import cvtables as T


def _descale(x: np.ndarray, shift: int) -> np.ndarray:
    return (x + (1 << (shift - 1))) >> shift


def bgr_to_gray_np(image: np.ndarray) -> np.ndarray:
    """u8 BGR -> u8 GRAY, bit-exact vs cv2/ops.color.bgr_to_gray."""
    img = image.astype(np.int32)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    y = _descale(r * T.GRAY_R + g * T.GRAY_G + b * T.GRAY_B, T.GRAY_SHIFT)
    return y.astype(np.uint8)

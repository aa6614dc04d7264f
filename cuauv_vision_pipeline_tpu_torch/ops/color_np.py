"""Numpy twins of colorspace ops for host paths.

Port of ``cuauv_vision_pipeline_tpu.ops.color_np``: the exact integer
pipelines of ``ops/color.py:bgr_to_gray`` and the L channel of
``bgr_to_lab`` in numpy, for host code that holds a frame as an array (the
bins module's pose template, the exposure controllers of
``modules/auto_calibrate*.py``), bit-exact vs cv2 and the torch versions.
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


def lab_l_np(image: np.ndarray) -> np.ndarray:
    """u8 BGR -> the u8 L channel of Lab, bit-exact vs
    ops.color.bgr_to_lab (cv2's integer LUT pipeline)."""
    img = image.astype(np.int32)
    gamma = np.asarray(T.LAB_GAMMA_TABLE, dtype=np.int32)
    cbrt = np.asarray(T.LAB_CBRT_TABLE, dtype=np.int32)
    C = T.LAB_XYZ_COEFFS
    b = gamma[img[..., 0]]
    g = gamma[img[..., 1]]
    r = gamma[img[..., 2]]
    fy = cbrt[
        _descale(
            r * int(C[1, 0]) + g * int(C[1, 1]) + b * int(C[1, 2]),
            T.LAB_SHIFT,
        )
    ]
    L = _descale(T.LAB_L_SCALE * fy + T.LAB_L_SHIFT, T.LAB_SHIFT2)
    return L.astype(np.uint8)

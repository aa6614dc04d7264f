"""Reference-compatible colorspace conversions (numpy in, numpy out).

Port of the conversions of ``cuauv_vision_pipeline_tpu.utils.color``
(reference utils/color.py:11-32): each returns ``(converted,
split_channels)`` and runs the port's tensor op (``ops/color.py``) on the
caller's ``device`` (cuda:0 unless told ``cpu``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops import color as C
from ..core.device import DeviceLike, run_np

_Converted = Tuple[np.ndarray, Tuple[np.ndarray, ...]]


def _convert(fn, mat: np.ndarray, device: DeviceLike) -> _Converted:
    out = run_np(fn, mat, device)
    if out.ndim == 2:
        return out, (out,)
    return out, tuple(out[..., i] for i in range(out.shape[-1]))


def bgr_to_lab(mat: np.ndarray, device: DeviceLike = None) -> _Converted:
    """BGR -> LAB, returns (lab, (l, a, b)) (reference utils/color.py:11-32)."""
    return _convert(C.bgr_to_lab, mat, device)


def bgr_to_hsv(mat: np.ndarray, device: DeviceLike = None) -> _Converted:
    return _convert(C.bgr_to_hsv, mat, device)


def bgr_to_hls(mat: np.ndarray, device: DeviceLike = None) -> _Converted:
    return _convert(C.bgr_to_hls, mat, device)


def bgr_to_ycrcb(mat: np.ndarray, device: DeviceLike = None) -> _Converted:
    return _convert(C.bgr_to_ycrcb, mat, device)


def bgr_to_luv(mat: np.ndarray, device: DeviceLike = None) -> _Converted:
    return _convert(C.bgr_to_luv, mat, device)


def bgr_to_gray(mat: np.ndarray, device: DeviceLike = None) -> _Converted:
    return _convert(C.bgr_to_gray, mat, device)


def gray_to_bgr(mat: np.ndarray, device: DeviceLike = None) -> _Converted:
    return _convert(C.gray_to_bgr, mat, device)


def lab_to_bgr(mat: np.ndarray, device: DeviceLike = None) -> _Converted:
    return _convert(C.lab_to_bgr, mat, device)


def hsv_to_bgr(mat: np.ndarray, device: DeviceLike = None) -> _Converted:
    return _convert(C.hsv_to_bgr, mat, device)

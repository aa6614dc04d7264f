"""Reference-compatible transform API (numpy in, numpy out).

Port of ``cuauv_vision_pipeline_tpu.utils.transform`` (reference
utils/transform.py): Gaussian blur, structuring elements, erode/dilate, the
morphology compounds, resize/rotate/translate and normal-map decoding, each
running the port's tensor op on the caller's ``device`` (cuda:0 unless told
``cpu``). There is nothing to compile, so there is no per-parameter cache.

A ``[H, W, C]`` image is filtered per channel by the morphology wrappers,
as cv2 does (``ops/morphology.py:per_channel``); the JAX wrappers hand it
to ops that window over W and the channels instead.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from ..ops import morphology as M
from ..ops import transform as X
from ..core.device import DeviceLike, run_np


def simple_gaussian_blur(
    mat: np.ndarray, kernel_size: int, sigma: float = 0.0, device: DeviceLike = None
) -> np.ndarray:
    """Gaussian blur (reference utils/transform.py:5-25)."""
    return run_np(lambda t: X.gaussian_blur(t, kernel_size, sigma), mat, device)


def rect_kernel(size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """Rectangular structuring element (reference transform.py:56-77)."""
    return M.rect_kernel(size)


def elliptic_kernel(size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """Elliptical structuring element (reference transform.py:27-54)."""
    return M.ellipse_kernel(size)


def cross_kernel(size: Union[int, Tuple[int, int]]) -> np.ndarray:
    return M.cross_kernel(size)


def _morph(op, mat: np.ndarray, kernel: np.ndarray, device: DeviceLike, *extra) -> np.ndarray:
    kernel = np.asarray(kernel)
    return run_np(lambda t: M.per_channel(op, t, kernel, *extra), mat, device)


def erode(mat: np.ndarray, kernel: np.ndarray, iterations: int = 1,
          device: DeviceLike = None) -> np.ndarray:
    """cv2.erode (reference transform.py:80-95)."""
    return _morph(M.erode, mat, kernel, device, iterations)


def dilate(mat: np.ndarray, kernel: np.ndarray, iterations: int = 1,
           device: DeviceLike = None) -> np.ndarray:
    """cv2.dilate (reference transform.py:98-112)."""
    return _morph(M.dilate, mat, kernel, device, iterations)


def morph_remove_noise(mat: np.ndarray, kernel: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """MORPH_OPEN (reference transform.py:115-130)."""
    return _morph(M.open_morph, mat, kernel, device)


def morph_close_holes(mat: np.ndarray, kernel: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """MORPH_CLOSE (reference transform.py:133-147)."""
    return _morph(M.close_morph, mat, kernel, device)


def morph_borders(mat: np.ndarray, kernel: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """MORPH_GRADIENT (reference transform.py:150-164)."""
    return _morph(M.gradient, mat, kernel, device)


def resize(
    mat: np.ndarray, dsize: Tuple[int, int], interpolation: str = "linear",
    device: DeviceLike = None,
) -> np.ndarray:
    """cv2.resize, dsize = (width, height) (reference transform.py:167-183)."""
    dsize = tuple(int(v) for v in dsize)
    return run_np(lambda t: X.resize(t, dsize, interpolation), mat, device)


def rotate(mat: np.ndarray, angle_deg: float, device: DeviceLike = None) -> np.ndarray:
    """Rotate about the center (reference transform.py:186-200)."""
    return run_np(lambda t: X.rotate(t, angle_deg), mat, device)


def translate(mat: np.ndarray, dx: float, dy: float, device: DeviceLike = None) -> np.ndarray:
    """Translate (reference transform.py:203-216)."""
    return run_np(lambda t: X.translate(t, dx, dy), mat, device)


def decode_normal(mat: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """u8 normal map -> float [-1, 1] (reference transform.py:218-233)."""
    return run_np(X.decode_normal, mat, device)


def encode_normal(normals: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """float [-1, 1] normals -> u8."""
    return run_np(X.encode_normal, normals, device)

"""Rectangular-kernel morphology on torch tensors, bit-exact vs OpenCV.

Port of the rect path of ``cuauv_vision_pipeline_tpu.ops.morphology``
(reference utils/transform.py:27-147). Border semantics match cv2's default
BORDER_CONSTANT with the morphology identity: out-of-image pixels never win
(the dtype's max for erode, its min for dilate).

A full rectangle is a sliding max (dilate) or min (erode) over an
identity-padded image, i.e. ``max_pool2d``. ``max_pool2d`` takes no integer
tensors on CUDA, so integer images are widened to float32 first (exact for
every value of a u8/i16 image) and cast back.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

KernelLike = Union[np.ndarray, Tuple[int, int], int]


def rect_kernel(size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """All-ones structuring element (cv2.MORPH_RECT)."""
    if isinstance(size, int):
        size = (size, size)
    return np.ones(size, dtype=np.uint8)


def _rect_shape(kernel: KernelLike) -> Tuple[int, int]:
    k = rect_kernel(kernel) if isinstance(kernel, (int, tuple)) else np.asarray(kernel)
    if k.ndim != 2 or not k.all():
        raise ValueError("only full rectangular structuring elements are supported")
    return int(k.shape[0]), int(k.shape[1])


def _morph_rect(image: torch.Tensor, kh: int, kw: int, is_erode: bool) -> torch.Tensor:
    if image.dtype.is_floating_point:
        work = image
        ident = float("inf") if is_erode else float("-inf")
    elif image.dtype in (torch.uint8, torch.int8, torch.int16):
        work = image.to(torch.float32)
        info = torch.iinfo(image.dtype)
        ident = float(info.max if is_erode else info.min)
    else:
        raise TypeError(f"morphology on {image.dtype} is not supported")
    H, W = image.shape[-2], image.shape[-1]
    pad_h, pad_w = (kh - 1) // 2, (kw - 1) // 2
    x = work.reshape(-1, 1, H, W)
    if is_erode:  # min-pool = -max-pool(-x), identity padding negated too
        x = -F.max_pool2d(
            F.pad(-x, (pad_w, kw - 1 - pad_w, pad_h, kh - 1 - pad_h), value=-ident),
            (kh, kw), stride=1,
        )
    else:
        x = F.max_pool2d(
            F.pad(x, (pad_w, kw - 1 - pad_w, pad_h, kh - 1 - pad_h), value=ident),
            (kh, kw), stride=1,
        )
    return x.reshape(image.shape).to(image.dtype)


def _morph(image: torch.Tensor, kernel: KernelLike, is_erode: bool,
           iterations: int = 1) -> torch.Tensor:
    kh, kw = _rect_shape(kernel)
    out = image
    for _ in range(max(1, iterations)):
        out = _morph_rect(out, kh, kw, is_erode)
    return out


def erode(image: torch.Tensor, kernel: KernelLike, iterations: int = 1) -> torch.Tensor:
    """cv2.erode (reference utils/transform.py:80-95)."""
    return _morph(image, kernel, is_erode=True, iterations=iterations)


def dilate(image: torch.Tensor, kernel: KernelLike, iterations: int = 1) -> torch.Tensor:
    """cv2.dilate (reference utils/transform.py:98-112)."""
    return _morph(image, kernel, is_erode=False, iterations=iterations)


def open_morph(image: torch.Tensor, kernel: KernelLike) -> torch.Tensor:
    """cv2.MORPH_OPEN = erode then dilate (reference utils/transform.py:115-130)."""
    return dilate(erode(image, kernel), kernel)


def close_morph(image: torch.Tensor, kernel: KernelLike) -> torch.Tensor:
    """cv2.MORPH_CLOSE = dilate then erode (reference utils/transform.py:133-147)."""
    return erode(dilate(image, kernel), kernel)

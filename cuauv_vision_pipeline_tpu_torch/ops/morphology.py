"""Morphology on torch tensors, bit-exact vs OpenCV.

Port of ``cuauv_vision_pipeline_tpu.ops.morphology`` (reference
utils/transform.py:27-164): structuring elements (rect/ellipse/cross),
erode/dilate and the OPEN/CLOSE/GRADIENT compounds. Border semantics match
cv2's default BORDER_CONSTANT with the morphology identity: out-of-image
pixels never win (the dtype's max for erode, its min for dilate).

Every op windows over the last two axes, as the JAX version does; a
``[H, W, C]`` image goes through ``per_channel`` (what cv2 does with
one), not straight in, where the window would span W and the channels.

A full rectangle is a sliding max (dilate) or min (erode) over an
identity-padded image, i.e. ``max_pool2d``. ``max_pool2d`` takes no integer
tensors on CUDA, so integer images are widened to float32 first (exact for
every value of a u8/i16 image) and cast back. Any other 0/1 element is a
min/max over the shifted slices of the identity-padded image that it
selects.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

KernelLike = Union[np.ndarray, Tuple[int, int], int]


def rect_kernel(size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """All-ones structuring element (cv2.MORPH_RECT)."""
    if isinstance(size, int):
        size = (size, size)
    return np.ones(size, dtype=np.uint8)


def ellipse_kernel(size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """Elliptical structuring element matching cv2.getStructuringElement
    (cv2.MORPH_ELLIPSE)'s rasterization: per row, the horizontal span from
    the ellipse equation."""
    if isinstance(size, int):
        size = (size, size)
    rows, cols = size
    r = rows // 2
    c = cols // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    kernel = np.zeros((rows, cols), dtype=np.uint8)
    for i in range(rows):
        j1, j2 = 0, 0
        dy = i - r
        if abs(dy) <= r:
            if r == 0:
                dx = c
            else:
                dx = int(round(c * np.sqrt(max(0.0, 1.0 - dy * dy * inv_r2))))
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, cols)
        kernel[i, j1:j2] = 1
    return kernel


def cross_kernel(size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """Cross-shaped structuring element (cv2.MORPH_CROSS)."""
    if isinstance(size, int):
        size = (size, size)
    rows, cols = size
    kernel = np.zeros((rows, cols), dtype=np.uint8)
    kernel[rows // 2, :] = 1
    kernel[:, cols // 2] = 1
    return kernel


def _as_kernel(kernel: KernelLike) -> np.ndarray:
    k = rect_kernel(kernel) if isinstance(kernel, (int, tuple)) else np.asarray(kernel)
    if k.ndim != 2 or not k.any():
        raise ValueError("a structuring element is a non-empty 2-D 0/1 array")
    return k


def _identity(image: torch.Tensor, is_erode: bool) -> float:
    """The value that never wins: +-inf, or the integer dtype's max/min."""
    if image.dtype.is_floating_point:
        return float("inf") if is_erode else float("-inf")
    if image.dtype in (torch.uint8, torch.int8, torch.int16):
        info = torch.iinfo(image.dtype)
        return float(info.max if is_erode else info.min)
    raise TypeError(f"morphology on {image.dtype} is not supported")


def _morph_rect(image: torch.Tensor, kh: int, kw: int, is_erode: bool) -> torch.Tensor:
    ident = _identity(image, is_erode)
    work = image if image.dtype.is_floating_point else image.to(torch.float32)
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


def _morph_mask(image: torch.Tensor, kernel: np.ndarray, is_erode: bool) -> torch.Tensor:
    """Any 0/1 element: min/max over the selected shifted slices."""
    kh, kw = kernel.shape
    pad_h, pad_w = (kh - 1) // 2, (kw - 1) // 2
    H, W = image.shape[-2], image.shape[-1]
    padded = F.pad(image, (pad_w, kw - 1 - pad_w, pad_h, kh - 1 - pad_h),
                   value=_identity(image, is_erode))
    reduce = torch.minimum if is_erode else torch.maximum
    out = None
    for dy, dx in zip(*np.nonzero(kernel)):
        window = padded[..., dy : dy + H, dx : dx + W]
        out = window if out is None else reduce(out, window)
    return out.contiguous()


def _morph(image: torch.Tensor, kernel: KernelLike, is_erode: bool,
           iterations: int = 1) -> torch.Tensor:
    k = _as_kernel(kernel)
    out = image
    for _ in range(max(1, iterations)):
        if k.all():
            out = _morph_rect(out, k.shape[0], k.shape[1], is_erode)
        else:
            out = _morph_mask(out, k, is_erode)
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


def gradient(image: torch.Tensor, kernel: KernelLike) -> torch.Tensor:
    """cv2.MORPH_GRADIENT = dilate - erode (reference utils/transform.py:150-164)."""
    d = dilate(image, kernel).to(torch.int32)
    e = erode(image, kernel).to(torch.int32)
    return (d - e).clamp(0, 255).to(image.dtype)


def per_channel(op: Callable, image: torch.Tensor, *args) -> torch.Tensor:
    """``op(image, *args)`` over H and W of each channel of a ``[H, W, C]``
    image (cv2's semantics for a multi-channel image); a 2-D image as it
    is. The JAX package's ``utils.transform`` hands a ``[H, W, 3]`` frame
    straight to its ops, which then window over W and the channels."""
    if image.ndim == 3:
        return op(image.movedim(-1, 0), *args).movedim(0, -1).contiguous()
    return op(image, *args)

"""Small array helpers.

Port of ``cuauv_vision_pipeline_tpu.utils.helpers`` (reference
utils/helpers.py): odd-size helpers and the UMat/Mat conversions. The
reference used OpenCV's T-API UMat for optional GPU offload (reference
helpers.py:31-68); here the device array type is a torch tensor, so
``to_umat``/``from_umat`` map host numpy <-> device tensors with the same
call shape.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device


def next_odd(n: int) -> int:
    """Smallest odd integer >= n (kernel sizes must be odd)."""
    n = int(n)
    return n if n % 2 == 1 else n + 1


def make_odd(n: int) -> int:
    return next_odd(n)


def to_umat(mat: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """Host array -> tensor on ``device`` (cuda:0 unless told ``cpu``; the
    UMat analog: compute-resident)."""
    return torch.from_numpy(np.ascontiguousarray(mat)).to(resolve_device(device))


def as_mat(mat: Union[torch.Tensor, np.ndarray]) -> np.ndarray:
    """Anything -> host numpy array (reference helpers.py as_mat)."""
    if isinstance(mat, torch.Tensor):
        return mat.detach().cpu().numpy()
    return np.asarray(mat)


def from_umat(mat: Union[torch.Tensor, np.ndarray]) -> np.ndarray:
    """Device tensor -> host numpy array."""
    return as_mat(mat)

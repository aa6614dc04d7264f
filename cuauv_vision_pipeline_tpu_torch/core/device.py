"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU explicitly; with
no CUDA device and no explicit ``cpu`` they raise instead of carrying on
quietly on the host.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, int, torch.device]]


@contextlib.contextmanager
def full_f32():
    """Full float32 matrix products and convolutions inside the block: TF32
    off for cuBLAS and cuDNN (cuDNN's convolutions default to TF32)."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def resolve_device(spec: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``; ``N`` or ``"N"`` -> ``cuda:N``; ``"cpu"`` ->
    the CPU; a ``torch.device`` or ``"cuda:N"`` as given. Raises
    RuntimeError when CUDA is asked for (by default) but unavailable, or
    the ordinal is out of range."""
    if isinstance(spec, torch.device):
        device = spec
    elif spec is None:
        device = torch.device("cuda", 0)
    elif isinstance(spec, int) or str(spec).isdigit():
        device = torch.device("cuda", int(spec))
    else:
        device = torch.device(str(spec))
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise RuntimeError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the host"
        )
    index = 0 if device.index is None else device.index
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(
            f"device cuda:{index} out of range: this host has "
            f"{torch.cuda.device_count()} CUDA device(s)"
        )
    return torch.device("cuda", index)


def run_np(fn: Callable, mat: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """``fn(tensor)`` for the array ``mat`` on ``device`` (resolved as
    above: cuda:0 unless told ``cpu``), returned as a numpy array: the
    numpy-in/numpy-out API of ``utils/`` and ``ops/balance.process_frame``
    over the tensor ops."""
    t = torch.from_numpy(np.ascontiguousarray(mat)).to(resolve_device(device))
    return fn(t).cpu().numpy()

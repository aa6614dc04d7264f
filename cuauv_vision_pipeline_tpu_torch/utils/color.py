"""Reference-compatible color API (numpy in, numpy out).

Port of ``cuauv_vision_pipeline_tpu.utils.color`` (reference utils/color.py):
colorspace conversions returning ``(converted, split_channels)``, the
threshold family, color-distance thresholds, k-means color clustering and
gray-world white balance. Each runs the port's tensor ops (``ops/color.py``,
``ops/threshold.py``) on the caller's ``device`` (cuda:0 unless told
``cpu``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device, run_np
from ..ops import color as C
from ..ops import threshold as T
from ..ops.ieee import fma_rn, recip_f32
from ..ops.transform import gaussian_blur

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


def color_dist(mat: np.ndarray, c: Tuple[int, int, int], device: DeviceLike = None) -> np.ndarray:
    """Per-pixel euclidean distance to a color (reference color.py:35-63)."""
    return run_np(lambda t: T.color_distance(t, tuple(c)), mat, device)


def thresh_color_distance(
    split: List[np.ndarray],
    color: Tuple[int, int, int],
    distance: float,
    auto_distance_percentile: Optional[float] = None,
    ignore_channels: List[int] = [],
    weights: Tuple[float, float, float] = (1, 1, 1),
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted color-distance threshold over split channels
    (reference color.py:66-103). Returns (mask, distances_u8)."""
    image = np.stack([np.asarray(ch) for ch in split], axis=-1)
    out = run_np(
        lambda t: torch.stack(T.thresh_color_distance(
            t, tuple(color), distance, auto_distance_percentile, tuple(ignore_channels), tuple(weights)
        )),
        image,
        device,
    )
    return out[0], out[1]


def range_threshold(mat: np.ndarray, min: int, max: int, device: DeviceLike = None) -> np.ndarray:
    """cv2.inRange (reference color.py:105-121). Bit-exact."""
    return run_np(lambda t: T.in_range(t, min, max), mat, device)


def _thresh_shim(op, mat, threshold, device: DeviceLike) -> np.ndarray:
    return run_np(lambda t: op(t, threshold), mat, device)


def binary_threshold(mat: np.ndarray, threshold: int, device: DeviceLike = None) -> np.ndarray:
    return _thresh_shim(T.binary, mat, threshold, device)


def binary_threshold_inv(mat: np.ndarray, threshold: int, device: DeviceLike = None) -> np.ndarray:
    return _thresh_shim(T.binary_inv, mat, threshold, device)


def max_threshold(mat: np.ndarray, threshold: float, device: DeviceLike = None) -> np.ndarray:
    return _thresh_shim(T.truncate, mat, threshold, device)


def above_threshold(mat: np.ndarray, threshold: float, device: DeviceLike = None) -> np.ndarray:
    return _thresh_shim(T.to_zero, mat, threshold, device)


def below_threshold(mat: np.ndarray, threshold: float, device: DeviceLike = None) -> np.ndarray:
    return _thresh_shim(T.to_zero_inv, mat, threshold, device)


def otsu_threshold(mat: np.ndarray, device: DeviceLike = None) -> Tuple[float, np.ndarray]:
    t = torch.from_numpy(np.ascontiguousarray(mat)).to(resolve_device(device))
    thresh, mask = T.otsu(t)
    return float(thresh), mask.cpu().numpy()


def _adaptive_shim(op, mat, neighborhood_size: int, bias: float, inverse: bool,
                   device: DeviceLike) -> np.ndarray:
    return run_np(lambda t: op(t, neighborhood_size, bias, inverse=inverse), mat, device)


def adaptive_threshold_mean(
    mat: np.ndarray, neighborhood_size: int, bias: float = 0, device: DeviceLike = None
) -> np.ndarray:
    return _adaptive_shim(T.adaptive_mean, mat, neighborhood_size, bias, False, device)


def adaptive_threshold_mean_inv(
    mat: np.ndarray, neighborhood_size: int, bias: float = 0, device: DeviceLike = None
) -> np.ndarray:
    return _adaptive_shim(T.adaptive_mean, mat, neighborhood_size, bias, True, device)


def adaptive_threshold_gaussian(
    mat: np.ndarray, neighborhood_size: int, bias: float = 0, device: DeviceLike = None
) -> np.ndarray:
    return _adaptive_shim(T.adaptive_gaussian, mat, neighborhood_size, bias, False, device)


def adaptive_threshold_gaussian_inv(
    mat: np.ndarray, neighborhood_size: int, bias: float = 0, device: DeviceLike = None
) -> np.ndarray:
    return _adaptive_shim(T.adaptive_gaussian, mat, neighborhood_size, bias, True, device)


def _sq_dists(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[N, k] float32 squared distances, channel by channel (no [N, k, C]
    intermediate)."""
    d = None
    for ch in range(data.shape[1]):
        diff = data[:, ch : ch + 1] - centers[:, ch]
        d = diff * diff if d is None else d + diff * diff
    return d


def kmeans(
    mat: np.ndarray,
    num_centeroids: int,
    iterations: int = 10,
    epsilon: float = 1.0,
    device: DeviceLike = None,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """K-means color clustering (reference color.py:295-368).

    Returns (compactness, labels[H*W, 1] int32, centers[k, C] float32) like
    cv2.kmeans. Lloyd iterations on ``device``: distances in float32, the
    lowest-index centre on ties, per-cluster counts and sums as float64
    one-hot reductions (exact for u8 data, in any order; no atomics, which
    k addresses would serialize), an empty cluster keeping its centre.
    The initial centres are ``num_centeroids`` distinct pixels drawn by a
    ``torch.Generator`` seeded 0 (the JAX package draws with its own PRNG,
    cv2 with k-means++: cluster IDs may permute). ``epsilon`` is accepted
    and unused, as in the JAX package: every call runs ``iterations``."""
    mat = np.asarray(mat)
    data_np = mat.reshape(-1, mat.shape[-1] if mat.ndim == 3 else 1).astype(np.float32)
    k = num_centeroids
    dev = resolve_device(device)
    data = torch.from_numpy(data_np).to(dev)
    n = data.shape[0]
    pick = torch.randperm(n, generator=torch.Generator().manual_seed(0))[:k]
    centers = data[pick.to(dev)]
    data64 = data.to(torch.float64)
    clusters = torch.arange(k, device=dev)
    for _ in range(iterations):
        labels = torch.argmin(_sq_dists(data, centers), dim=1)
        onehot = (labels[:, None] == clusters).to(torch.float64)  # [N, k]
        counts = onehot.sum(dim=0)
        sums = onehot.T @ data64
        centers = torch.where(
            counts[:, None] > 0, (sums / counts.clamp(min=1)[:, None]).to(torch.float32), centers
        )
    d = _sq_dists(data, centers)
    best, labels = torch.min(d, dim=1)
    compactness = best.to(torch.float64).sum()
    return (
        float(compactness),
        labels.to(torch.int32).reshape(-1, 1).cpu().numpy(),
        centers.cpu().numpy(),
    )


def kmeans_mask(labels: np.ndarray, shape: Tuple[int, int], which: int) -> np.ndarray:
    """255 mask of one k-means cluster (the working version of the
    reference's partially-broken helper, reference color.py:320-322)."""
    return (labels.reshape(shape) == which).astype(np.uint8) * 255


_INV_255 = recip_f32(255.0)


def _frame_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` of a whole frame as XLA computes it: the sum (here in
    float64, exact for u8-valued data, rounded to float32) times the float32
    reciprocal of the count."""
    return x.to(torch.float64).sum().to(torch.float32) * recip_f32(x.numel())


def white_balance_bgr(mat: np.ndarray, blur_kernel: int = 0, device: DeviceLike = None) -> np.ndarray:
    """Gray-world white balance via LAB a/b recentering
    (reference color.py:370-392): a and b move toward 128 by their mean
    (over the frame, or a Gaussian of ``blur_kernel | 1``) scaled by
    luminance, ``x - (mean - 128) * (l / 255) * 1.1``, rounded as XLA:CPU
    compiles it at its default level: ``/ 255`` as a multiply by the
    float32 reciprocal, a frame mean's factor ``(mean - 128) / 255`` taken
    once as a scalar, and the last multiply-subtract fused (``fma_rn``)."""

    def run(img: torch.Tensor) -> torch.Tensor:
        lab = C.bgr_to_lab(img).to(torch.float32)
        l, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
        out = [l]
        for x in (a, b):
            if blur_kernel and blur_kernel > 1:
                shift = (gaussian_blur(x, blur_kernel | 1) - 128.0) * (l * _INV_255)
            else:
                shift = l * ((_frame_mean(x) - 128.0) * _INV_255)
            out.append(fma_rn(-shift, torch.full_like(shift, 1.1), x).clamp(0, 255))
        return C.lab_to_bgr(torch.stack(out, dim=-1).to(torch.uint8))

    return run_np(run, mat, device)

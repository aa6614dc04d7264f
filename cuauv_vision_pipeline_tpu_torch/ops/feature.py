"""Feature detection on torch tensors: Canny, Hough lines, corners, keypoints.

Port of ``cuauv_vision_pipeline_tpu.ops.feature`` (reference
utils/feature.py:43-237 and the device front end of the bins pose flow):
Sobel gradients; Canny, bit-exact against cv2.Canny, its hysteresis one
connected-component labeling of the candidate mask (``ops/ccl.label_fast``:
the CUDA union-find kernel on the card); the Hough line accumulator (integer
votes, the same on every device) and the host peak pick of ``find_lines``;
the Shi-Tomasi response and ``find_corners``; and ``detect_describe`` —
response, window NMS, a two-stage top-k, greedy min-distance spacing (the
CUDA kernel ``ops/cuda/spacing_kernel.py`` on the card) and oriented 128-D
descriptors — as one chain of device ops with no host sync.

Numbers follow the JAX package's f32 arithmetic operation for operation:
a division by a constant is a multiplication by its float32 reciprocal (as
XLA rewrites it, and as torch does on CUDA), so the response is bit-equal
to JAX's on the CPU and to the CPU's on the card. Top-k ties keep the lower
index first (``lax.top_k``'s order): a stable descending sort, not
``torch.topk``. The descriptor's bilinear contractions run in full float32
(TF32 off for their matrix products).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import DeviceLike, full_f32, resolve_device, run_np
from .ccl import label_fast
from .cuda.spacing_kernel import spacing_select
from .ieee import recip_f32 as _recip


_TWO_PI = 2 * np.pi
_INV_9 = _recip(9.0)
_INV_BIN8 = _recip(np.pi / 4)  # 8 orientation bins over 2*pi
_INV_BIN36 = _recip(2 * np.pi / 36)  # 36 orientation bins over 2*pi
# atan2 of a diagonal gradient (|gy| == |gx|), correctly rounded to float32
_PI_4 = float(np.float32(np.pi / 4))
_3PI_4 = float(np.float32(3 * np.pi / 4))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on any device: the float64
    root rounded to float32 (torch's vectorized CPU ``sqrt`` of float32 is
    not correctly rounded; CUDA's and XLA's are)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _angle(gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """``atan2(gy, gx) mod 2*pi`` with diagonal gradients correctly rounded.

    The 8 hard orientation bins of the axis-aligned descriptor have their
    edges at multiples of 45 degrees, which integer Sobel gradients hit
    exactly (|gy| == |gx|); torch's CPU and CUDA atan2 round half of those
    below the edge, XLA's atan2 and a correctly rounded one do not. Off the
    diagonals an integer gradient lies farther than an ulp from every edge,
    so the bins then agree whatever the atan2."""
    a = torch.atan2(gy, gx)
    diag = (gy.abs() == gx.abs()) & (gx != 0)
    a = torch.where(diag, torch.where(gx > 0, _PI_4, _3PI_4) * torch.sign(gy), a)
    return torch.remainder(a, _TWO_PI)


def host_nonzero2d(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(ys, xs) of a 2-D bool/num array via flatnonzero + divmod (row-major,
    the same order as ``np.nonzero``)."""
    mask = np.asarray(mask)
    return np.divmod(np.flatnonzero(mask.reshape(-1)), mask.shape[1])


def _pad_replicate(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicate ``pad`` pixels around the last two axes of ``a``."""
    lead = a.shape[:-2]
    p = F.pad(a.reshape(-1, 1, *a.shape[-2:]), (pad, pad, pad, pad), mode="replicate")
    return p.reshape(*lead, *p.shape[-2:])


def _sobel_3x3(gray_f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel dx/dy with BORDER_REPLICATE, [..., H, W] float32."""
    p = _pad_replicate(gray_f, 1)
    H, W = gray_f.shape[-2], gray_f.shape[-1]

    def sl(dy, dx):
        return p[..., dy : dy + H, dx : dx + W]

    # smoothing [1 2 1] x derivative [-1 0 1]
    gx = (sl(0, 2) + 2 * sl(1, 2) + sl(2, 2)) - (sl(0, 0) + 2 * sl(1, 0) + sl(2, 0))
    gy = (sl(2, 0) + 2 * sl(2, 1) + sl(2, 2)) - (sl(0, 0) + 2 * sl(0, 1) + sl(0, 2))
    return gx, gy


def min_eigenvalue_map(gray: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Shi-Tomasi corner response: min eigenvalue of the structure tensor
    (cv2.goodFeaturesToTrack's quality map), [..., H, W] float32.

    Everything up to the box sum is exact in float32 (integer Sobel values,
    ``* 0.25``, products and sums of multiples of 1/16 below 2**24), so the
    order of the box sum does not matter; the last four operations round as
    the JAX package's do (IEEE float32, the square root correctly
    rounded), so the map is bit-equal to JAX's and the same on every
    device."""
    g = gray.to(torch.float32)
    gx, gy = _sobel_3x3(g)
    # cv2 scales Sobel by 1/4 for blockSize summation via boxFilter
    gx = gx * 0.25
    gy = gy * 0.25
    prods = torch.stack([gx * gx, gy * gy, gx * gy])  # [3, ..., H, W]
    pad = block_size // 2
    p = _pad_replicate(prods, pad)
    H, W = g.shape[-2], g.shape[-1]
    rows = p[..., 0:H, :]
    for dy in range(1, block_size):
        rows = rows + p[..., dy : dy + H, :]
    box = rows[..., 0:W]
    for dx in range(1, block_size):
        box = box + rows[..., dx : dx + W]
    box = box * (_INV_9 if block_size == 3 else _recip(block_size * block_size))
    sxx, syy, sxy = box[0], box[1], box[2]
    tr = (sxx + syy) * 0.5
    det = sqrt_f32((sxx - syy) ** 2 * 0.25 + sxy * sxy)
    return tr - det


def find_corners(
    gray: np.ndarray,
    max_corners: int,
    quality_thresh: float = 0.01,
    min_distance: int = 10,
    device: DeviceLike = None,
) -> np.ndarray:
    """cv2.goodFeaturesToTrack equivalent (reference utils/feature.py:104-125):
    the response on ``device`` (cuda:0 unless told ``cpu``; bit-equal on
    every device), the 3x3 NMS and the spacing on the host in numpy.
    Returns [N, 1, 2] float32 (x, y) like cv2."""
    resp = run_np(min_eigenvalue_map, np.asarray(gray), device)
    thresh = resp.max() * quality_thresh
    # 3x3 NMS
    padded = np.pad(resp, 1, constant_values=-np.inf)
    windows = np.max(
        [padded[dy : dy + resp.shape[0], dx : dx + resp.shape[1]]
         for dy in range(3) for dx in range(3)],
        axis=0,
    )
    peaks = (resp == windows) & (resp > thresh)
    ys, xs = host_nonzero2d(peaks)
    order = np.argsort(-resp[ys, xs])
    ys, xs = ys[order], xs[order]

    selected = []
    min_d2 = min_distance * min_distance
    for y, x in zip(ys, xs):
        ok = True
        for sy, sx in selected:
            if (sy - y) ** 2 + (sx - x) ** 2 < min_d2:
                ok = False
                break
        if ok:
            selected.append((y, x))
            if len(selected) >= max_corners:
                break
    if not selected:
        return np.empty((0, 1, 2), np.float32)
    return np.array([[[float(x), float(y)]] for y, x in selected], dtype=np.float32)


# ---------------------------------------------------------------------------
# Canny and the Hough line accumulator
# ---------------------------------------------------------------------------


def _sobel_3x3_int(image_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 3x3 Sobel dx/dy on int32 with BORDER_REPLICATE — the CV_16S
    gradients cv2.Canny computes (sums of at most 4*255 in magnitude, so
    the float32 Sobel of the u8 values is exact)."""
    gx, gy = _sobel_3x3(image_u8.to(torch.float32))
    return gx.to(torch.int32), gy.to(torch.int32)


def canny_prep_thresholds(lower: float, upper: float, l2_gradient: bool) -> Tuple[int, int]:
    """cv2's host-side threshold prep (canny.cpp): swap, L2 squares +
    clamps, then cvFloor to int."""
    lo, hi = float(lower), float(upper)
    if lo > hi:
        lo, hi = hi, lo
    if l2_gradient:
        lo, hi = min(32767.0, lo), min(32767.0, hi)
        if lo > 0:
            lo *= lo
        if hi > 0:
            hi *= hi
    return int(math.floor(lo)), int(math.floor(hi))


def canny(image: torch.Tensor, lower: float, upper: float, l2_gradient: bool = False) -> torch.Tensor:
    """Canny edge detector, bit-exact vs cv2.Canny (aperture 3), on u8
    ``[H, W]`` or ``[B, H, W]`` grayscale: u8 {0, 255} edges."""
    low, high = canny_prep_thresholds(lower, upper, l2_gradient)
    return canny_core(image, low, high, l2_gradient)


def canny_core(image: torch.Tensor, low, high, l2_gradient: bool = False) -> torch.Tensor:
    """canny() after threshold prep; ``low``/``high`` are ints or 0-d
    tensors on the image's device.

    cv2's u8 path end to end: the candidate and strong masks of
    :func:`_canny_masks`, then cv2's hysteresis, a DFS from the strong
    pixels whose result is the set of candidates 8-connected to a strong
    pixel: here one labeling of the candidate mask (:func:`_hysteresis`),
    with no host read and no pass count."""
    return _hysteresis(*_canny_masks(image, low, high, l2_gradient)).to(torch.uint8) * 255


def _canny_masks(image: torch.Tensor, low, high, l2_gradient: bool = False):
    """(candidates, strong) bool masks of cv2.Canny before hysteresis: exact
    int32 Sobel with replicate border, integer L1 (or squared-L2) magnitude,
    NMS against a zero-padded magnitude with the TG22 = 13573 fixed-point
    sector boundaries and cv2's mix of strict and non-strict neighbour
    comparisons, candidates ``mag > low``, strong pixels ``mag > high``."""
    dx, dy = _sobel_3x3_int(image)
    mag = dx * dx + dy * dy if l2_gradient else dx.abs() + dy.abs()

    # cv2 pads every magnitude row with 0 at both ends and treats rows
    # above/below the image as all-zero — border pixels compare against 0
    mp = F.pad(mag, (1, 1, 1, 1))
    H, W = mag.shape[-2], mag.shape[-1]

    def sl(dy_, dx_):
        return mp[..., dy_ + 1 : dy_ + 1 + H, dx_ + 1 : dx_ + 1 + W]

    # sector quantization in cv2's fixed point: y*2^15 vs x*TG22 / x*TG67
    TG22 = 13573  # tan(22.5deg) * 2^15, rounded
    ax = dx.abs()
    ay15 = dy.abs() << 15
    tg22x = ax * TG22
    tg67x = tg22x + ((ax + ax) << 15)

    horizontal = ay15 < tg22x
    vertical = ay15 > tg67x
    same_sign = (dx ^ dy) >= 0  # cv2: s = (xs ^ ys) < 0 ? -1 : 1

    keep_h = (mag > sl(0, -1)) & (mag >= sl(0, 1))
    keep_v = (mag > sl(-1, 0)) & (mag >= sl(1, 0))
    keep_d1 = (mag > sl(-1, -1)) & (mag > sl(1, 1))  # s=+1: both strict
    keep_d2 = (mag > sl(-1, 1)) & (mag > sl(1, -1))  # s=-1: both strict
    keep = torch.where(
        horizontal, keep_h, torch.where(vertical, keep_v, torch.where(same_sign, keep_d1, keep_d2))
    )

    cand = keep & (mag > low)  # cv2 gates NMS on m > low
    return cand, cand & (mag > high)


def _hysteresis(cand: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """The candidates whose 8-connected candidate component holds a strong
    pixel: label the candidates (``label_fast``; ``[H, W]`` or a stack in
    one call), count the strong pixels under each root by a segment sum,
    and keep a candidate whose root counts any. Exact whatever the
    component's length (the JAX package's min-propagation stops after 64
    passes). Only strong pixels add to their root; every other pixel adds
    0 at its own index, so no two of them meet at one address (an atomic
    add per pixel, contended only within a component's strong pixels)."""
    H, W = cand.shape[-2], cand.shape[-1]
    hw = H * W
    labels = label_fast(cand if cand.ndim == 2 else cand.reshape(-1, H, W), 8)
    n = labels.numel() // hw
    dev = labels.device
    flat_cand, flat_strong = cand.reshape(n, hw), strong.reshape(n, hw)
    own = torch.arange(n * hw, device=dev).view(n, hw)
    base = torch.arange(n, device=dev)[:, None] * hw
    # a candidate's root in the flat stack; a background pixel (label
    # 2**30) stands for itself and is masked out below
    roots = torch.where(flat_cand, labels.reshape(n, hw).to(torch.int64) + base, own)
    hits = torch.zeros(n * hw, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(flat_strong, roots, own).reshape(-1), flat_strong.reshape(-1).to(torch.int32)
    )
    return (flat_cand & (hits[roots] > 0)).reshape(cand.shape)


def _hough_tables(n_theta: int, theta_res: float):
    """thetas[T] float32 as the JAX package makes them (``arange * res`` in
    float32), and their cos and sin in float64 rounded to float32: one
    table, so every device computes the same rho."""
    thetas = np.arange(n_theta, dtype=np.float32) * np.float32(theta_res)
    t64 = thetas.astype(np.float64)
    return thetas, np.cos(t64).astype(np.float32), np.sin(t64).astype(np.float32)


# votes in flight per chunk of thetas (int64 bins: 128 MB)
_HOUGH_CHUNK = 1 << 24


def hough_lines_accumulator(
    edges: torch.Tensor, rho_res: float = 1.0, theta_res: float = math.pi / 180
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Standard Hough accumulator over an ``[H, W]`` edge mask, on its device.

    Returns (acc[T, R] int32, thetas[T], rhos[R]); votes are edge-pixel
    counts. Each edge pixel votes ``round(rho / rho_res)`` (half to even, as
    ``jnp.round``) with ``rho = x*cos + y*sin`` in float32 (two roundings)
    from the host's table: the votes are the same on every device, and the
    JAX package's (its own cos/sin, its multiply-add fused) differ only for
    pixels whose rho lies within an ulp or so of a half-integer bin edge.
    Only the edge pixels vote (one ``nonzero``, a host sync), by integer
    ``index_add_`` into ``[T*R]`` (exact in any order), a chunk of thetas at
    a time."""
    H, W = edges.shape[-2], edges.shape[-1]
    dev = edges.device
    n_rho = int(2 * math.ceil(math.hypot(H, W) / rho_res)) + 1
    n_theta = int(round(math.pi / theta_res))
    rho_offset = (n_rho - 1) // 2
    thetas, cos, sin = _hough_tables(n_theta, theta_res)

    yx = torch.nonzero(edges != 0).to(torch.float32)
    ys, xs = yx[:, 0], yx[:, 1]
    acc = torch.zeros(n_theta * n_rho, dtype=torch.int32, device=dev)
    cos_t = torch.from_numpy(cos).to(dev)[:, None]
    sin_t = torch.from_numpy(sin).to(dev)[:, None]
    base = torch.arange(n_theta, device=dev)[:, None] * n_rho + rho_offset
    step = max(1, _HOUGH_CHUNK // max(1, ys.numel()))
    inv_res = _recip(rho_res)
    for t0 in range(0, n_theta if ys.numel() else 0, step):
        t1 = min(n_theta, t0 + step)
        rho = xs * cos_t[t0:t1] + ys * sin_t[t0:t1]
        bins = torch.round(rho * inv_res).to(torch.int64) + base[t0:t1]
        acc.index_add_(0, bins.reshape(-1), torch.ones(1, dtype=torch.int32, device=dev).expand(bins.numel()))
    rhos = (np.arange(n_rho, dtype=np.float32) - rho_offset) * np.float32(rho_res)
    return acc.view(n_theta, n_rho), torch.from_numpy(thetas).to(dev), torch.from_numpy(rhos).to(dev)


def find_lines(
    edges: np.ndarray,
    rho_res: float = 1.0,
    theta_res: float = math.pi / 180,
    threshold: int = 100,
    max_lines: int = 64,
    device: DeviceLike = None,
) -> np.ndarray:
    """cv2.HoughLines equivalent: returns [N, 2] (rho, theta) of peaks over
    ``threshold``, strongest first (reference utils/feature.py find_lines).
    The accumulator on ``device`` (cuda:0 unless told ``cpu``), the peak
    pick on the host."""
    edges_t = torch.from_numpy(np.ascontiguousarray(edges)).to(resolve_device(device))
    acc, thetas, rhos = (t.cpu().numpy() for t in hough_lines_accumulator(edges_t, rho_res, theta_res))
    # local maxima over the 4-neighborhood like cv2
    padded = np.pad(acc, 1)
    center = padded[1:-1, 1:-1]
    is_peak = (
        (center >= padded[1:-1, :-2])
        & (center >= padded[1:-1, 2:])
        & (center >= padded[:-2, 1:-1])
        & (center >= padded[2:, 1:-1])
        & (center > threshold)
    )
    ti, ri = host_nonzero2d(is_peak)
    votes = center[ti, ri]
    order = np.argsort(-votes)[:max_lines]
    return np.stack([rhos[ri[order]], thetas[ti[order]]], axis=-1)


# ---------------------------------------------------------------------------
# device keypoint detection + description (the pose front end)
# ---------------------------------------------------------------------------

_DESC_BORDER = 8  # half-size of the 16x16 descriptor patch


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer ``idx`` along a new last axis."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def _normalize_desc(d: torch.Tensor) -> torch.Tensor:
    """Rows of ``d`` [K, ...] flattened, L2-normalized, clipped at 0.2 and
    normalized again (SIFT's illumination normalization)."""
    v = d.reshape(d.shape[0], -1)
    v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=1, keepdim=True), 1e-9)
    v = torch.clamp_max(v, 0.2)
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=1, keepdim=True), 1e-9)


def _patches(field: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, size: int, half: int):
    """[..., K, size, size] windows of ``field`` [..., H, W] whose top-left
    corners are (ys - half, xs - half) (in bounds by the callers' clamps)."""
    r = torch.arange(size, device=ys.device)
    rows = (ys.to(torch.int64) - half)[:, None] + r  # [K, size]
    cols = (xs.to(torch.int64) - half)[:, None] + r
    return field[..., rows[:, :, None], cols[:, None, :]]


def _cell_w(coord: torch.Tensor) -> torch.Tensor:
    """Soft spatial-bin weights [256, 4] of the 16x16 sample grid along one
    axis: sample s lands at (s + 7.5)/4 - 0.5 in [-0.625, 3.625]; the two
    neighbouring cells share it linearly, out-of-range cells get nothing."""
    u = (coord.reshape(-1) + 7.5) / 4.0 - 0.5
    lo = torch.floor(u)
    f = u - lo
    w = torch.zeros((coord.numel(), 4), dtype=torch.float32, device=coord.device)
    for which, ww in ((lo, 1.0 - f), (lo + 1.0, f)):
        idx = torch.clamp(which, 0, 3).to(torch.int64)
        valid_w = ((which >= 0) & (which <= 3)).to(torch.float32) * ww
        w = w + _one_hot(idx, 4) * valid_w[:, None]
    return w


def _axis_w(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear taps along one axis as a [K, 256, size] weight matrix."""
    c0 = torch.floor(coord)
    f = coord - c0
    i0 = torch.clamp(c0, 0, size - 2).to(torch.int64)
    return _one_hot(i0, size) * (1.0 - f)[..., None] + _one_hot(i0 + 1, size) * f[..., None]


def describe_at(
    gray: torch.Tensor,
    ys: torch.Tensor,
    xs: torch.Tensor,
    oriented: bool = False,
) -> torch.Tensor:
    """SIFT-like 128-D descriptors at given pixel locations, for all
    keypoints at once: 8-bin gradient-orientation histograms over the 4x4
    cells of a 16x16 patch, L2-normalized with the standard 0.2 clip.
    Locations are clamped to the descriptor border.

    oriented=False is the host fallback descriptor's math (axis-aligned,
    hard bins). oriented=True adds rotation invariance: a 36-bin dominant
    orientation per keypoint (parabolic peak), the 16x16 grid rotated with
    it and the gradients bilinearly resampled from one 24x24 patch per
    keypoint (two batched contractions with one-hot tap weights), soft
    spatial and orientation bins and a Gaussian window.

    gray [H, W] -> des [K, 128] float32 (rows L2-unit or zero)."""
    g = gray.to(torch.float32)
    H, W = g.shape
    gx, gy = _sobel_3x3(g)

    # oriented sampling reaches 7.5*sqrt(2)+1 ~ 11.6 px; clamp keypoints
    # far enough in that no rotated sample lands on edge-replicated rows
    b = 12 if oriented else _DESC_BORDER
    ys = torch.clamp(ys, b, H - b - 1)
    xs = torch.clamp(xs, b, W - b - 1)
    b = _DESC_BORDER  # axis-aligned patch extraction stays 16x16

    if not oriented:
        mag = torch.hypot(gx, gy)
        bins = torch.remainder(torch.floor(_angle(gy, gx) * _INV_BIN8).to(torch.int64), 8)
        m = _patches(mag, ys, xs, 16, b)  # [K, 16, 16]
        a = _patches(bins, ys, xs, 16, b)
        patch = _one_hot(a, 8) * m[..., None]  # [K, 16, 16, 8]
        K = m.shape[0]
        return _normalize_desc(patch.reshape(K, 4, 4, 4, 4, 8).sum(dim=(2, 4)))

    P_SZ, P_HALF = 24, 12
    pg = _patches(torch.stack([gx, gy]), ys, xs, P_SZ, P_HALF).transpose(0, 1)  # [K, 2, 24, 24]
    K = pg.shape[0]
    dev = g.device

    # rotated sampling grid, shared by every keypoint
    off = torch.arange(16, dtype=torch.float32, device=dev) - 7.5
    gy_off, gx_off = torch.meshgrid(off, off, indexing="ij")  # [16, 16]
    w_cy = _cell_w(gy_off)  # [256, 4]
    w_cx = _cell_w(gx_off)
    gauss = torch.exp(-(gy_off.reshape(-1) ** 2 + gx_off.reshape(-1) ** 2) / (2.0 * 8.0**2))

    # 36-bin dominant orientation over the central 16x16 of each patch
    pm = torch.hypot(pg[:, 0], pg[:, 1])  # [K, 24, 24]
    pa = torch.remainder(torch.atan2(pg[:, 1], pg[:, 0]), _TWO_PI)
    lo, hi = P_HALF - b, P_HALF + b
    m16 = pm[:, lo:hi, lo:hi]
    a16 = pa[:, lo:hi, lo:hi]
    bin36 = torch.remainder(torch.floor(a16 * _INV_BIN36).to(torch.int64), 36)
    h36 = (_one_hot(bin36, 36) * m16[..., None]).sum(dim=(1, 2))  # [K, 36]
    k = torch.argmax(h36, dim=1)

    # parabolic peak interpolation between the neighbouring bins
    def _h_at(off_k):
        return torch.gather(h36, 1, torch.remainder(k + off_k, 36)[:, None])[:, 0]

    hm, h0, hp = _h_at(-1), _h_at(0), _h_at(1)
    denom = hm - 2.0 * h0 + hp
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (hm - hp) / denom, 0.0)
    theta = (k.to(torch.float32) + 0.5 + torch.clamp(delta, -0.5, 0.5)) * (2 * np.pi / 36)
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]  # [K, 1]

    # the descriptor grid rotated by +theta around the keypoint, in patch
    # coordinates (origin = keypoint - P_HALF)
    fx = gx_off.reshape(-1)[None, :]  # [1, 256]
    fy = gy_off.reshape(-1)[None, :]
    lx = P_HALF + fx * c - fy * s  # [K, 256], in [1.4, 22.6]
    ly = P_HALF + fx * s + fy * c

    # bilinear resampling as one-hot tap contractions, in full float32
    wy_t = _axis_w(ly, P_SZ)  # [K, 256, 24]
    wx_t = _axis_w(lx, P_SZ)
    with full_f32():
        tmp = torch.einsum("ksr,kfrc->kfsc", wy_t, pg)
        samp = torch.einsum("kfsc,ksc->kfs", tmp, wx_t)
    sgx, sgy = samp[:, 0], samp[:, 1]  # [K, 256]
    smag = torch.hypot(sgx, sgy) * gauss[None, :]
    rel = torch.remainder(torch.atan2(sgy, sgx) - theta[:, None], _TWO_PI)
    # soft orientation bins: linear between the two nearest bin centers
    pos = rel * _INV_BIN8 - 0.5
    k0 = torch.floor(pos)
    w1 = pos - k0
    k0i = torch.remainder(k0.to(torch.int64), 8)
    k1i = torch.remainder(k0i + 1, 8)
    w_o = _one_hot(k0i, 8) * (1.0 - w1)[..., None] + _one_hot(k1i, 8) * w1[..., None]  # [K, 256, 8]
    # trilinear accumulation: desc[k, cy, cx, b] = sum_s m * wy * wx * wo
    w_cell = (w_cy[:, :, None] * w_cx[:, None, :]).reshape(256, 16)
    with full_f32():
        d = torch.einsum("sq,ksb->kqb", w_cell, smag[..., None] * w_o)  # [K, 16, 8]
    return _normalize_desc(d)


def _top_k_stable(values: torch.Tensor, k: int):
    """The ``k`` largest along the last axis, equal values lowest index
    first (``jax.lax.top_k``'s order; ``torch.topk`` gives no such order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_candidates(
    gray: torch.Tensor,
    max_keypoints: int = 512,
    quality: float = 0.01,
    min_distance: int = 8,
    oriented: bool = True,
    force_global_topk: bool = False,
):
    """The first half of :func:`detect_describe`, up to the spacing
    selection: Shi-Tomasi response -> (2*min_distance+1) window NMS -> the
    ``max_keypoints`` strongest peaks (per-tile then global), strongest
    first. Returns (ys int32 [K], xs int32 [K], cand bool [K]); rows with
    ``cand`` False hold no peak."""
    g = gray.to(torch.float32)
    H, W = g.shape
    dev = g.device
    resp = min_eigenvalue_map(g)
    win = 2 * min_distance + 1
    # separable max filter; max_pool2d's implicit padding is -inf, as
    # reduce_window's pad value
    mx = F.max_pool2d(resp[None, None], (win, 1), stride=1, padding=(min_distance, 0))
    mx = F.max_pool2d(mx, (1, win), stride=1, padding=(0, min_distance))[0, 0]
    b = 12 if oriented else _DESC_BORDER
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inside = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
    peaks = (resp >= mx) & (resp > resp.max() * quality) & inside
    score = torch.where(peaks, resp, -math.inf)

    # two-stage top-k: each 32x32 tile's 32 strongest, then the global top
    # over the survivors. 32 slots hold every min_distance-spaced point of a
    # tile, so the tile stage drops only members of exact-response tie
    # clusters closer than min_distance
    T = 32
    TK = 32  # per-tile slots
    Hp = -(-H // T) * T
    Wp = -(-W // T) * T
    n_tiles = (Hp // T) * (Wp // T)
    if (
        not force_global_topk
        and (T // max(min_distance, 1) + 1) ** 2 <= TK
        and n_tiles * TK >= max_keypoints
    ):
        sp = F.pad(score, (0, Wp - W, 0, Hp - H), value=-math.inf)
        tiles = sp.reshape(Hp // T, T, Wp // T, T).transpose(1, 2).reshape(-1, T * T)
        tv, tf = _top_k_stable(tiles, TK)  # per-tile values + offsets
        t_idx = torch.arange(n_tiles, device=dev)
        trow = (t_idx // (Wp // T))[:, None] * T + tf // T
        tcol = (t_idx % (Wp // T))[:, None] * T + tf % T
        gflat = trow * W + tcol  # may index padding; value is -inf there
        vals, sub = _top_k_stable(tv.reshape(-1), max_keypoints)
        flat = gflat.reshape(-1)[sub]
    else:
        vals, flat = _top_k_stable(score.reshape(-1), max_keypoints)
    return (flat // W).to(torch.int32), (flat % W).to(torch.int32), torch.isfinite(vals)


def detect_describe(
    gray: torch.Tensor,
    max_keypoints: int = 512,
    quality: float = 0.01,
    min_distance: int = 8,
    oriented: bool = True,
    force_global_topk: bool = False,
):
    """Keypoint detection + description on the tensor's device, with no host
    sync: :func:`detect_candidates` -> greedy min-distance spacing (one
    CUDA launch on the card) -> 128-D descriptors (describe_at).

    Returns (kp [K, 2] float32 (x, y), des [K, 128] float32, n_valid int32
    0-d tensor) with valid rows first (strongest response order); rows past
    n_valid have kp=-1 and des=0."""
    g = gray.to(torch.float32)
    dev = g.device
    ys, xs, cand = detect_candidates(
        g, max_keypoints, quality, min_distance, oriented, force_global_topk
    )

    # greedy min-distance suppression, strongest first: the window NMS
    # passes both members of an exact response tie
    kept = spacing_select(ys, xs, cand, min_distance)

    # compact kept rows to the front, preserving strongest-first order: a
    # cumsum-addressed scatter, not a sort
    K = kept.shape[0]
    idx_k = torch.arange(K, device=dev)
    n_valid = kept.sum(dtype=torch.int32)
    pos = torch.where(kept, torch.cumsum(kept, 0) - 1, n_valid + torch.cumsum(~kept, 0) - 1)
    order = torch.zeros(K, dtype=torch.int64, device=dev).scatter_(0, pos, idx_k)
    ys, xs, valid = ys[order], xs[order], kept[order]

    des = describe_at(g, ys, xs, oriented=oriented)
    des = torch.where(valid[:, None], des, 0.0)
    kp = torch.stack([xs.to(torch.float32), ys.to(torch.float32)], dim=1)
    kp = torch.where(valid[:, None], kp, -1.0)
    return kp, des, n_valid

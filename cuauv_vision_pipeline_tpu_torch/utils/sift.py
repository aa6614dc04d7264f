"""Feature matching (SIFT-style) with descriptor matching on the device.

Port of ``cuauv_vision_pipeline_tpu.utils.sift`` (reference utils/sift.py:
14-165): named source images, 2-NN matching with Lowe's ratio test, RANSAC
homography, and a projected quad per detected source; plus
``draw_transformed_box``/``draw_keypoints``.

The all-pairs distance matrix and the 2-NN search are one matrix product
and two argmin passes on the descriptors' device (``_distance_topk``); in
the bins chain they run on the card beside detection (``device_match_topk``)
and only the top-2 buffers ride the packed fetch. RANSAC solves all minimal
sets in one batched LAPACK call and scores every candidate over every point
in one float32 numpy pass on the host, as the rest of the host leg; the
result never goes back to the card.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import full_f32
from ..ops.feature import _sobel_3x3, detect_describe, find_corners
from .draw import Color, draw_circle, draw_polylines

# Sentinel magnitude for padded descriptor/point rows: far beyond any real
# SIFT descriptor (cv2 norms ~512, d2 <= ~1e6) yet safely inside f32 range
# when squared and summed over 128 dims (~1.3e10).
_PAD_VAL = 1.0e4


def _distance_topk(query: torch.Tensor, train: torch.Tensor):
    """All-pairs L2 distances (one matrix product) + 2-NN per query row.

    query [N, D], train [M, D] (same device) -> (dist2 [N, 2], idx [N, 2]
    int32). Full float32 (TF32 off). The 2-NN is two argmin passes with the
    first pass's column masked to +inf by a one-hot: equal distances go to
    the lower index, as ``lax.top_k``'s order."""
    q2 = torch.sum(query * query, dim=1, keepdim=True)
    t2 = torch.sum(train * train, dim=1)[None, :]
    with full_f32():
        cross = query @ train.T
    d2 = torch.clamp_min(q2 + t2 - 2.0 * cross, 0.0)
    i1 = torch.argmin(d2, dim=1)
    v1 = torch.gather(d2, 1, i1[:, None])[:, 0]
    hit = i1[:, None] == torch.arange(d2.shape[1], device=d2.device)
    masked = torch.where(hit, torch.inf, d2)
    i2 = torch.argmin(masked, dim=1)
    v2 = torch.gather(masked, 1, i2[:, None])[:, 0]
    return torch.stack([v1, v2], dim=1), torch.stack([i1, i2], dim=1).to(torch.int32)


def device_match_topk(query_prep, des: torch.Tensor, n_valid) -> tuple:
    """2-NN match of a prepared template (``prepare_descriptors`` output, on
    the scene's device) against scene descriptors ``des`` [K, D] whose rows
    past ``n_valid`` (a 0-d tensor or an int) are masked to the far
    sentinel; no host sync. Finish on the host with
    ``SIFT.match_device_topk``."""
    if query_prep is None:
        raise ValueError(
            "device_match_topk: template has no descriptors (add_source "
            "stored des_prep=None for a featureless source)"
        )
    q, _ = query_prep
    rows = torch.arange(des.shape[0], device=des.device)
    train = torch.where((rows < n_valid)[:, None], des, _PAD_VAL)
    return _distance_topk(q, train)


def _next_pow2(n: int, lo: int = 64) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


def prepare_descriptors(
    arr: np.ndarray, role: str = "query", device: Union[str, torch.device] = "cpu"
):
    """Pad a fixed descriptor set to its power-of-2 row bucket and put it on
    ``device`` once: ``(tensor, n)``. A template is the query of every
    frame's match. Query rows pad with zeros (sliced off after), train rows
    with the far sentinel (never enter the top-2)."""
    fill = 0.0 if role == "query" else _PAD_VAL
    n = len(arr)
    out = np.full((_next_pow2(n), arr.shape[1]), fill, np.float32)
    out[:n] = np.asarray(arr, np.float32)
    return torch.from_numpy(out).to(device), n


def match_descriptors(
    query: Optional[np.ndarray] = None,
    train: Optional[np.ndarray] = None,
    ratio: float = 0.7,
    *,
    query_prep=None,
) -> List[Tuple[int, int, float]]:
    """Lowe-ratio 2-NN matching -> [(query_idx, train_idx, distance)].

    Runs on the device of ``query_prep`` (``prepare_descriptors(q, "query",
    device)``), else on the CPU. Padded train rows sit at distance ~1e10
    and never enter the top-2; padded query rows are sliced off before the
    ratio test."""
    if query_prep is not None:
        q, nq = query_prep
    else:
        nq = len(query)
        q = None
    nt = len(train)
    if nq == 0 or nt < 2:
        return []
    if q is None:
        q, _ = prepare_descriptors(query, "query")
    t, _ = prepare_descriptors(train, "train", q.device)
    d2, idx = _distance_topk(q, t)
    d = np.sqrt(d2.cpu().numpy()[:nq])
    idx = idx.cpu().numpy()[:nq]
    good = d[:, 0] < ratio * d[:, 1]
    return [(int(i), int(idx[i, 0]), float(d[i, 0])) for i in np.nonzero(good)[0]]


def _dlt_matrix(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The [2N, 9] DLT system of N correspondences (float64)."""
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    return np.asarray(A, np.float64)


def _homography_from_4(src: np.ndarray, dst: np.ndarray) -> Optional[np.ndarray]:
    """DLT homography from 4 correspondences (host, tiny)."""
    try:
        _, _, vt = np.linalg.svd(_dlt_matrix(src, dst))
    except np.linalg.LinAlgError:
        return None
    H = vt[-1].reshape(3, 3)
    if abs(H[2, 2]) < 1e-12:
        return None
    return H / H[2, 2]


def solve_minimal_sets(
    src: np.ndarray, dst: np.ndarray, iters: int, seed: int
) -> np.ndarray:
    """All RANSAC minimal-set candidate homographies at once: 4 distinct
    indices per candidate, the [iters, 8, 9] DLT systems assembled
    vectorized, ONE batched LAPACK svd call. Returns normalized candidates
    [K<=iters, 3, 3] (degenerate sets dropped)."""
    n = len(src)
    rng = np.random.default_rng(seed)
    sel = np.argsort(rng.random((iters, n)), axis=1)[:, :4]
    s4, d4 = src[sel], dst[sel]  # [iters, 4, 2]
    x, y = s4[..., 0], s4[..., 1]
    u, v = d4[..., 0], d4[..., 1]
    zero, one = np.zeros_like(x), np.ones_like(x)
    rows = np.stack(
        [
            np.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1),
            np.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1),
        ],
        axis=2,
    )  # [iters, 4, 2, 9]
    A = rows.reshape(iters, 8, 9)
    try:
        _, _, vt = np.linalg.svd(A)
        Hs_all = vt[:, -1].reshape(iters, 3, 3)
    except np.linalg.LinAlgError:  # batched non-convergence: per-set retry
        cands = [_homography_from_4(src[s], dst[s]) for s in sel]
        cands = [h for h in cands if h is not None]
        if not cands:
            return np.empty((0, 3, 3))
        Hs_all = np.stack(cands)
    keep = np.abs(Hs_all[:, 2, 2]) >= 1e-12
    return Hs_all[keep] / Hs_all[keep, 2:3, 2:3]


def ransac_homography(
    src_pts: np.ndarray,
    dst_pts: np.ndarray,
    thresh: float = 5.0,
    iters: int = 256,
    seed: int = 0,
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """RANSAC homography (cv2.findHomography(RANSAC) equivalent).

    Minimal-set solves are one batched SVD; consensus scoring of all
    candidates over all points is one float32 pass (``_ransac_score``).
    Returns (H or None, inlier_mask)."""
    src = np.asarray(src_pts, np.float64).reshape(-1, 2)
    dst = np.asarray(dst_pts, np.float64).reshape(-1, 2)
    n = len(src)
    if n < 4:
        return None, np.zeros(n, bool)

    candidates = solve_minimal_sets(src, dst, iters, seed)
    if len(candidates) == 0:
        return None, np.zeros(n, bool)

    # candidates pad to `iters` by repeating the last real H (duplicates
    # tie, argmax keeps the earliest), points pad to a power-of-2 bucket
    # with dst=+1e9 (never an inlier): the JAX package's fixed shapes, kept
    # so both score the same buffers
    Hs = np.asarray(candidates, np.float32)
    if len(Hs) < iters:
        Hs = np.concatenate([Hs, np.repeat(Hs[-1:], iters - len(Hs), axis=0)])
    nb = _next_pow2(n)
    s = np.ones((nb, 3), np.float32)
    s[:n, :2] = src
    d = np.full((nb, 2), 1.0e9, np.float32)
    d[:n] = dst
    mask = _ransac_score(Hs, s, d, thresh)[:n]
    if mask.sum() < 4:
        return None, mask

    # refit on all inliers (least squares DLT)
    H = _refit(src[mask], dst[mask])
    return H, mask


def _ransac_score(Hs: np.ndarray, s: np.ndarray, d: np.ndarray, thresh: float) -> np.ndarray:
    """Score all RANSAC candidates [C, 3, 3] over all points (homogeneous
    ``s`` [N, 3], targets ``d`` [N, 2]), all float32; return the best
    candidate's inlier mask [N] (the first of equal counts).

    numpy, single-threaded: the arrays are ~100 KB, and torch's CPU thread
    pool woken between numpy's SVDs made the whole RANSAC several times
    slower on the card's host."""
    proj = np.einsum("cij,nj->cni", Hs, s)
    w = np.where(np.abs(proj[..., 2]) < 1e-9, np.float32(1e-9), proj[..., 2])
    uv = proj[..., :2] / w[..., None]
    diff = uv - d[None]
    err = np.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])  # [C, N]
    inliers = err < np.float32(thresh)
    return inliers[np.argmax(inliers.sum(axis=1))]


def _refit(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares DLT homography over all inliers."""
    _, _, vt = np.linalg.svd(_dlt_matrix(src, dst))
    H = vt[-1].reshape(3, 3)
    return H / H[2, 2]


def _builtin_detect_and_compute(gray: np.ndarray, max_keypoints: int = 500):
    """Fallback detector/descriptor when OpenCV SIFT is unavailable:
    Shi-Tomasi keypoints + 4x4-cell gradient-orientation histograms (a
    SIFT-like 128-D descriptor), on the host. Not scale invariant; adequate
    for the planar-target matching the reference uses it for."""
    pts = find_corners(gray, max_keypoints, 0.01, 8, device="cpu").reshape(-1, 2)
    gx, gy = _sobel_3x3(torch.as_tensor(np.asarray(gray), dtype=torch.float32))
    gx = gx.numpy()
    gy = gy.numpy()
    mag = np.hypot(gx, gy)
    ang = np.arctan2(gy, gx) % (2 * np.pi)

    H, W = gray.shape[:2]
    descs = []
    kps = []
    for x, y in pts:
        xi, yi = int(x), int(y)
        if xi < 8 or yi < 8 or xi >= W - 8 or yi >= H - 8:
            continue
        patch_m = mag[yi - 8 : yi + 8, xi - 8 : xi + 8]
        patch_a = ang[yi - 8 : yi + 8, xi - 8 : xi + 8]
        desc = np.zeros((4, 4, 8), np.float32)
        bins = np.floor(patch_a / (2 * np.pi / 8)).astype(int) % 8
        for cy in range(4):
            for cx in range(4):
                sel = np.zeros((16, 16), bool)
                sel[cy * 4 : cy * 4 + 4, cx * 4 : cx * 4 + 4] = True
                for b in range(8):
                    desc[cy, cx, b] = patch_m[sel & (bins == b)].sum()
        v = desc.reshape(-1)
        norm = np.linalg.norm(v)
        if norm > 0:
            v = np.minimum(v / norm, 0.2)
            v = v / max(np.linalg.norm(v), 1e-9)
        descs.append(v)
        kps.append((float(x), float(y)))
    if not descs:
        return np.empty((0, 2), np.float32), np.empty((0, 128), np.float32)
    return np.asarray(kps, np.float32), np.asarray(descs, np.float32)


def _device_detect_and_compute(
    gray: np.ndarray, max_keypoints: int = 512, device: Union[str, torch.device] = "cpu"
):
    """ops/feature.detect_describe on ``device`` (one launch of the spacing
    kernel on the card), read back: keypoints [n, 2] and descriptors
    [n, 128] of the n valid rows. Single-scale (planar-target matching)."""
    kp, des, n = detect_describe(torch.as_tensor(np.asarray(gray)).to(device), max_keypoints)
    n = int(n)
    return kp[:n].cpu().numpy(), des[:n].cpu().numpy()


def detect_and_compute(
    gray: np.ndarray,
    max_keypoints: int = 500,
    method: Optional[str] = None,
    device: Union[str, torch.device] = "cpu",
):
    """Keypoints [N, 2] (x, y) + descriptors [N, D].

    method (default env CUAUV_SIFT_DETECTOR, else "cv2"):
      * "cv2"     — OpenCV SIFT, the reference's own detector
        (reference utils/sift.py:24-30); host CPU, scale-invariant. Falls
        back to "builtin" where cv2 is not installed.
      * "device"  — ops/feature.detect_describe on ``device`` (single-scale;
        descriptors are NOT interchangeable with cv2's, so template and
        scene must use the same method).
      * "builtin" — host fallback; its axis-aligned descriptors match ONLY
        the device path's oriented=False variant."""
    method = method or os.environ.get("CUAUV_SIFT_DETECTOR", "cv2")
    if method == "device":
        return _device_detect_and_compute(np.asarray(gray), max_keypoints, device)
    if method == "cv2":
        try:
            import cv2

            sift = cv2.SIFT_create(nfeatures=max_keypoints)
            kp, des = sift.detectAndCompute(np.asarray(gray), None)
            if des is None or len(kp) == 0:
                return np.empty((0, 2), np.float32), np.empty((0, 128), np.float32)
            pts = np.asarray([k.pt for k in kp], np.float32)
            return pts, des.astype(np.float32)
        except Exception:
            pass
    return _builtin_detect_and_compute(np.asarray(gray), max_keypoints)


class SIFT:
    """Named-source feature matcher (reference utils/sift.py:14-142).

    ``detector`` picks the keypoint front end for BOTH templates and scenes
    (descriptors from different detectors don't mix): "cv2" for the
    reference's own SIFT, "device" for detect_describe, None to follow
    CUAUV_SIFT_DETECTOR. ``device`` is where "device" detection runs and
    where templates' prepared descriptors live (the module's device)."""

    def __init__(
        self,
        checks: int = 50,
        detector: Optional[str] = None,
        device: Union[str, torch.device] = "cpu",
    ):
        # `checks` tuned FLANN precision in the reference; the exact 2-NN
        # matmul here is always exhaustive (strictly more precise).
        self.checks = checks
        self.detector = detector
        self.device = torch.device(device)
        self.sources: Dict[str, dict] = {}

    def add_source(self, name: str, source: np.ndarray):
        kp, des = detect_and_compute(source, method=self.detector, device=self.device)
        self.sources[name] = {
            "name": name,
            "source": source,
            "kp": kp,
            "des": des,
            # padded and on the device once: this set is the query of every
            # frame's match
            "des_prep": prepare_descriptors(des, "query", self.device) if len(des) else None,
        }
        return kp, des

    def add_many(self, **kwargs):
        for name, source in kwargs.items():
            self.add_source(name, source)

    def warm(self, scene_max_keypoints: int = 1024, iters: int = 256) -> None:
        """Nothing to do: the JAX package compiles its matcher's shape
        buckets here; eager torch has no compile step. Kept so callers read
        as the JAX package's do."""

    def match(
        self,
        img: np.ndarray,
        min_match: int = 10,
        ratio: float = 0.7,
        draw: bool = False,
    ) -> List[dict]:
        """Find all sources in ``img``. Returns one dict per detected source
        with name/homography/quad/matches; optionally draws the quads."""
        kp_img, des_img = detect_and_compute(img, method=self.detector, device=self.device)
        return self.match_with_features(
            kp_img, des_img, min_match=min_match, ratio=ratio,
            draw_on=img if draw else None,
        )

    def match_with_features(
        self,
        kp_img: np.ndarray,
        des_img: np.ndarray,
        min_match: int = 10,
        ratio: float = 0.7,
        draw_on: Optional[np.ndarray] = None,
    ) -> List[dict]:
        """match() on pre-computed scene features."""
        results: List[dict] = []
        for name, src in self.sources.items():
            if len(src["des"]) < 2 or len(des_img) < 2:
                continue
            good = match_descriptors(None, des_img, ratio, query_prep=src["des_prep"])
            r = self._finish(name, good, kp_img, min_match, draw_on)
            if r is not None:
                results.append(r)
        return results

    def match_device_topk(
        self,
        name: str,
        d2: np.ndarray,
        idx: np.ndarray,
        kp_img: np.ndarray,
        min_match: int = 10,
        ratio: float = 0.7,
    ) -> List[dict]:
        """Finish a match whose 2-NN search already ran in a device chain
        (``device_match_topk``): the packed fetch carried only the top-2
        distance/index buffers and the keypoint coordinates. Host work is
        the ratio test + RANSAC."""
        src = self.sources[name]
        nq = src["des_prep"][1]
        d = np.sqrt(np.maximum(np.asarray(d2)[:nq], 0.0))
        ix = np.asarray(idx)[:nq]
        # a 2nd-NN at sentinel distance means the scene had <2 valid
        # descriptors (device_match_topk masks invalid rows to _PAD_VAL):
        # without this guard a single-keypoint frame would pass the ratio
        # test for EVERY template descriptor and publish a garbage pose
        sel = (d[:, 0] < ratio * d[:, 1]) & (d[:, 1] < _PAD_VAL)
        good = [(int(i), int(ix[i, 0]), float(d[i, 0])) for i in np.nonzero(sel)[0]]
        r = self._finish(name, good, kp_img, min_match)
        return [r] if r is not None else []

    def _finish(
        self,
        name: str,
        good: List[Tuple[int, int, float]],
        kp_img: np.ndarray,
        min_match: int,
        draw_on: Optional[np.ndarray] = None,
    ) -> Optional[dict]:
        """Ratio-tested matches -> RANSAC homography -> projected quad."""
        src = self.sources[name]
        if len(good) < min_match:
            return None
        src_pts = np.asarray([src["kp"][q] for q, _, _ in good])
        dst_pts = np.asarray([kp_img[t] for _, t, _ in good])
        H, mask = ransac_homography(src_pts, dst_pts)
        if H is None:
            return None
        h, w = src["source"].shape[:2]
        corners = np.asarray([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float64)
        ones = np.concatenate([corners, np.ones((4, 1))], axis=1)
        proj = ones @ H.T
        quad = (proj[:, :2] / proj[:, 2:3]).astype(np.int32)
        if draw_on is not None:
            draw_transformed_box(draw_on, quad)
        return {
            "name": name,
            "homography": H,
            "quad": quad,
            "matches": len(good),
            "inliers": int(mask.sum()),
        }


def draw_transformed_box(
    img: np.ndarray, quad: np.ndarray, color=Color.GREEN, thickness: int = 3
) -> None:
    """Draw a matched source's projected quad (reference sift.py:145-155)."""
    draw_polylines(img, [np.asarray(quad).reshape(-1, 2)], True, color, thickness)


def draw_keypoints(img: np.ndarray, keypoints: np.ndarray, color=Color.RED) -> None:
    """Mark keypoints (reference sift.py:158-165)."""
    for x, y in np.asarray(keypoints).reshape(-1, 2):
        draw_circle(img, (int(x), int(y)), 3, color, 1)

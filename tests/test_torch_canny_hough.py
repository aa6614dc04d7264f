"""The port's Canny, Hough and corner functions (``ops/feature.py`` and the
``utils/feature.py`` wrappers) against OpenCV and the JAX package on the
CPU, on the same numpy inputs (JAX's test scenes: 96x128 and 61x83 masks,
blurs and noise, 100x100 lines, a 120x120 disc).

Tolerances:
* Canny (L1 and L2, JAX ``tests/test_utils_feature.py``'s image x
  threshold grid, inverted thresholds included): bit-exact against cv2 and
  JAX; on one long diagonal edge whose strong end is ~190 px from its other
  end, bit-exact against cv2, where the JAX package's 64-pass
  min-propagation stops short (asserted, so the case stays one that needs
  more than 64 passes);
* the Hough accumulator: equal to JAX's but for votes of pixels whose
  rho/rho_res lies within 1e-3 of a half-integer (counted: each such vote
  may land one bin over; at most 1 % of the votes; measured: no vote
  moved);
* ``find_lines``, ``find_line_segments``, ``find_circles``, ``simple_canny``
  and ``find_corners`` on JAX's scenes: equal results.
"""

import math

import cv2
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.ops import feature as jF
from cuauv_vision_pipeline_tpu.utils import feature as jUF
from cuauv_vision_pipeline_tpu_torch.ops import feature as tF
from cuauv_vision_pipeline_tpu_torch.utils import feature as tUF


def _blobs(seed, shape=(96, 128), thresh=140):
    rng = np.random.default_rng(seed)
    blurred = cv2.GaussianBlur(rng.integers(0, 256, shape, dtype=np.uint8), (15, 15), 0)
    return ((blurred > thresh) * 255).astype(np.uint8)


# JAX tests/test_utils_feature.py:115-141's images and thresholds
_RNG = np.random.default_rng(3)
GRID_IMAGES = {
    "blobs": _blobs(5, thresh=120),
    "smooth": cv2.GaussianBlur(_RNG.integers(0, 256, (96, 128), np.uint8), (7, 7), 0),
    "noise": _RNG.integers(0, 256, (61, 83), np.uint8),
}
GRID_THRESHOLDS = [(50, 150, False), (150, 50, False), (30, 90, True)]


def diagonal_edge(n: int = 200) -> np.ndarray:
    """A step edge along the diagonal, weak (30 levels) but for its last
    ~10 rows (120 levels): its one candidate chain reaches cv2's strong
    pixels only ~190 px away."""
    ys, xs = np.mgrid[:n, :n]
    img = np.where(xs > ys, 30, 0).astype(np.uint8)
    img[(xs > ys) & (ys > n - 10)] = 120
    return img


@pytest.mark.parametrize("lo,hi,l2", GRID_THRESHOLDS, ids=["l1", "l1_swapped", "l2"])
@pytest.mark.parametrize("name", list(GRID_IMAGES))
def test_canny_bit_exact_vs_cv2_and_jax(name, lo, hi, l2):
    mat = GRID_IMAGES[name]
    got = tF.canny(torch.from_numpy(mat), lo, hi, l2).numpy()
    np.testing.assert_array_equal(got, cv2.Canny(mat, lo, hi, L2gradient=l2))
    np.testing.assert_array_equal(got, np.asarray(jUF.canny(mat, lo, hi, l2_gradient=l2)))
    np.testing.assert_array_equal(tUF.canny(mat, lo, hi, l2, device="cpu"), got)


def test_canny_long_edge_past_64_passes():
    mat = diagonal_edge()
    want = cv2.Canny(mat, 50, 200)
    got = tF.canny(torch.from_numpy(mat), 50, 200).numpy()
    np.testing.assert_array_equal(got, want)
    jax_edges = np.asarray(jUF.canny(mat, 50, 200))
    assert (jax_edges != want).sum() > 50, "the JAX package's hysteresis converged: not a >64-pass case"
    assert (want > 0).sum() > 380


def test_canny_batched_equals_per_image():
    stack = np.stack([GRID_IMAGES["blobs"], GRID_IMAGES["smooth"], diagonal_edge(200)[:96, :128]])
    got = tF.canny(torch.from_numpy(stack), 50, 150).numpy()
    for i, mat in enumerate(stack):
        np.testing.assert_array_equal(got[i], cv2.Canny(mat, 50, 150))


def test_canny_threshold_prep_matches_jax():
    for args in [(50, 150, False), (150, 50, False), (30.7, 90.2, True), (40000, 5, True), (-3, 7, True)]:
        assert tF.canny_prep_thresholds(*args) == jF.canny_prep_thresholds(*args)


def test_sobel_int_matches_jax():
    mat = GRID_IMAGES["noise"]
    for got, want in zip(tF._sobel_3x3_int(torch.from_numpy(mat)), jF._sobel_3x3_int(mat)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _near_half_votes(edges, thetas, rho_res):
    """Votes whose rho/rho_res lies within 1e-3 of a half-integer (float64)."""
    ys, xs = np.nonzero(edges)
    t = thetas.astype(np.float64)[:, None]
    rho = (xs[None] * np.cos(t) + ys[None] * np.sin(t)) / rho_res
    return int((np.abs(rho - np.floor(rho) - 0.5) < 1e-3).sum())


@pytest.mark.parametrize("rho_res", [1.0, 2.0, 0.5])
@pytest.mark.parametrize("name", ["smooth", "blobs", "line_y0"])
def test_hough_accumulator_matches_jax(name, rho_res):
    if name == "line_y0":  # rho = x/2 at 60 degrees: exact half-integers
        edges = np.zeros((64, 96), np.uint8)
        edges[0, :] = 255
        edges[40, 10:90] = 255
    else:
        edges = cv2.Canny(GRID_IMAGES[name], 50, 150)
    acc, thetas, rhos = tF.hough_lines_accumulator(torch.from_numpy(edges), rho_res)
    jacc, jthetas, jrhos = (np.asarray(a) for a in jF._hough_acc_jit(edges, rho_res, math.pi / 180))
    np.testing.assert_array_equal(thetas.numpy(), jthetas)
    np.testing.assert_array_equal(rhos.numpy(), jrhos)
    assert acc.dtype == torch.int32 and acc.shape == jacc.shape
    n_votes = int((edges != 0).sum()) * len(jthetas)
    assert int(acc.sum()) == n_votes == int(jacc.sum())
    near = _near_half_votes(edges != 0, jthetas, rho_res)
    moved = int(np.abs(acc.numpy().astype(np.int64) - jacc).sum()) // 2
    # near-half votes: ~0.2 % of a frame's (the 2e-3 wide window), up to
    # 0.74 % at rho_res 2, where the 0 and 90 degree rows put every odd x
    # or y on a bin edge; the votes that moved: none on these scenes
    assert moved <= near <= n_votes // 100, (moved, near, n_votes)


def test_find_lines_and_segments_match_jax():
    img = np.zeros((100, 100), np.uint8)
    img[50, 10:90] = 255  # horizontal line: rho=50, theta=pi/2
    got = tUF.find_lines(img, threshold=40, device="cpu")
    np.testing.assert_array_equal(got, jUF.find_lines(img, threshold=40))
    rho, theta = got[0, 0]
    assert abs(theta - math.pi / 2) < 0.05 and abs(rho - 50) <= 1.0

    img = np.zeros((100, 100), np.uint8)
    img[30, 20:80] = 255
    segs = tUF.find_line_segments(img, threshold=30, min_line_length=40, device="cpu")
    np.testing.assert_array_equal(segs, jUF.find_line_segments(img, threshold=30, min_line_length=40))
    x1, y1, x2, y2 = segs[0, 0]
    assert y1 == 30 and y2 == 30 and abs(min(x1, x2) - 20) <= 2 and abs(max(x1, x2) - 79) <= 2

    edges = cv2.Canny(GRID_IMAGES["smooth"], 50, 150)
    np.testing.assert_array_equal(tF.find_lines(edges, threshold=20, device="cpu"),
                                  jF.find_lines(edges, threshold=20))
    assert tUF.polar_to_cartesian(50.0, 1.2) == jUF.polar_to_cartesian(50.0, 1.2)


def test_find_circles_matches_jax():
    img = np.zeros((120, 120), np.uint8)
    cv2.circle(img, (60, 60), 25, 255, -1)
    img = cv2.GaussianBlur(img, (5, 5), 0)
    got = tUF.find_circles(img, vote_thresh=20, min_radius=10, max_radius=50, device="cpu")
    np.testing.assert_array_equal(got, jUF.find_circles(img, vote_thresh=20, min_radius=10, max_radius=50))
    x, y, r = got[0, 0]
    assert abs(x - 60) <= 3 and abs(y - 60) <= 3 and abs(r - 25) <= 4


def test_simple_canny_matches_jax():
    mat = GRID_IMAGES["smooth"]
    for use_mean in (False, True):
        np.testing.assert_array_equal(tUF.simple_canny(mat, use_mean=use_mean, device="cpu"),
                                      jUF.simple_canny(mat, use_mean=use_mean))


def test_find_corners_on_cpu_matches_jax():
    square = np.zeros((80, 80), np.uint8)
    square[20:60, 25:65] = 255
    for mat, n in ((square, 4), (GRID_IMAGES["smooth"], 40)):
        got = tUF.find_corners(mat, n, 0.01, 10, device="cpu")
        np.testing.assert_array_equal(got, jUF.find_corners(mat, n, 0.01, 10))

"""The feature, threshold and colour library on the card, against the same
calls on the CPU (held against OpenCV and the JAX package by
tests/test_torch_threshold.py, tests/test_torch_canny_hough.py and
tests/test_torch_library.py), at 1080p on the synthetic ZED frames and on
shapes that cross the CCL kernel's 32x32 tile seams:

* Canny (L1 and L2, one frame and a [B, H, W] stack, the long diagonal
  edge) exact, its hysteresis through ``label_cuda`` / ``label_cuda_batched``;
* ``HsvMaskPipeline``: masks, cleaned masks and every stat exact (centroids
  too: the same int64 sums on both devices), through ``fused_morph`` and
  ``label_cuda``;
* the Hough votes, ``find_lines``, ``find_line_segments``, ``find_circles``
  and ``find_corners`` exact;
* the threshold family, ``histogram_u8``, ``otsu``, ``adaptive_mean``,
  ``adaptive_gaussian``, the color distances exact;
* ``kmeans``: the same labels, centres within 1e-4, compactness rtol 1e-5;
* ``white_balance_bgr`` and ``undistort``: the same u8.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_library_cuda.py
"""

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
from cuauv_vision_pipeline_tpu_torch.engine.chains import HsvMaskPipeline
from cuauv_vision_pipeline_tpu_torch.ops import color as C
from cuauv_vision_pipeline_tpu_torch.ops import feature as F
from cuauv_vision_pipeline_tpu_torch.ops import threshold as T
from cuauv_vision_pipeline_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from cuauv_vision_pipeline_tpu_torch.utils import color as UC
from cuauv_vision_pipeline_tpu_torch.utils import feature as UF
from cuauv_vision_pipeline_tpu_torch.utils import undistort as U

pytestmark = pytest.mark.cuda

H, W = 1080, 1920
CAMERA = {
    "camera_matrix": {"fx": 1400.0, "fy": 1400.0, "cx": 960.0, "cy": 540.0},
    "distortion": {"k1": -0.2, "k2": 0.05, "p1": 0.001, "p2": -0.001},
    "image_size": {"width": W, "height": H},
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frames():
    return [buoy_frame((H, W), 0.4 * i) for i in range(3)]


def gray_of(frame):
    return C.bgr_to_gray(torch.from_numpy(frame)).numpy()


def diagonal_edge(n=1000):
    ys, xs = np.mgrid[:n, :n]
    img = np.where(xs > ys, 30, 0).astype(np.uint8)
    img[(xs > ys) & (ys > n - 10)] = 120
    return img


def _both(fn, arr, dev):
    """``fn`` of ``arr`` on the card and on the CPU, both as numpy."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = fn(t.to(dev))
    torch.cuda.synchronize()
    return out.cpu().numpy(), fn(t).numpy()


@pytest.mark.parametrize("l2", [False, True])
def test_canny_card_equals_cpu(dev, frames, l2):
    for mat in [gray_of(f) for f in frames] + [diagonal_edge()]:
        reset_launch_counts()
        card, cpu = _both(lambda t: F.canny(t, 30, 90, l2), mat, dev)
        assert launch_counts()["label_cuda"] == 1
        np.testing.assert_array_equal(card, cpu)
        assert (card > 0).sum() > 100
    stack = np.stack([gray_of(f) for f in frames])
    reset_launch_counts()
    card, cpu = _both(lambda t: F.canny(t, 30, 90, l2), stack, dev)
    assert launch_counts()["label_cuda_batched"] == 1
    np.testing.assert_array_equal(card, cpu)


def test_hsv_mask_pipeline_card_equals_cpu(dev, frames):
    lo, hi = (0, 100, 100), (10, 255, 255)  # the red disc
    card, cpu = HsvMaskPipeline(lo, hi, device=dev), HsvMaskPipeline(lo, hi, device="cpu")
    for frame in frames:
        reset_launch_counts()
        got = card.run_sync(frame)
        assert launch_counts()["fused_morph"] == 1 and launch_counts()["label_cuda"] == 1
        want = cpu.run_sync(frame)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2]["count"] > 0
        for key in want[2]:
            np.testing.assert_array_equal(got[2][key], want[2][key], err_msg=key)


def test_hough_and_lines_card_equal_cpu(dev, frames):
    edges = UF.canny(gray_of(frames[0]), 50, 150, device="cpu")
    for rho_res in (1.0, 2.0):
        card, cpu = (tuple(x.cpu().numpy() for x in F.hough_lines_accumulator(torch.from_numpy(edges).to(d), rho_res))
                     for d in (dev, "cpu"))
        for a, b in zip(card, cpu):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(UF.find_lines(edges, threshold=150, device=dev),
                                  UF.find_lines(edges, threshold=150, device="cpu"))
    np.testing.assert_array_equal(UF.find_line_segments(edges, threshold=150, device=dev),
                                  UF.find_line_segments(edges, threshold=150, device="cpu"))
    gray = gray_of(frames[1])[::4, ::4].copy()
    np.testing.assert_array_equal(UF.find_circles(gray, vote_thresh=40, device=dev),
                                  UF.find_circles(gray, vote_thresh=40, device="cpu"))
    np.testing.assert_array_equal(UF.find_corners(gray_of(frames[2]), 200, device=dev),
                                  UF.find_corners(gray_of(frames[2]), 200, device="cpu"))


def test_threshold_family_card_equals_cpu(dev, frames):
    gray = gray_of(frames[0])
    cases = {
        "binary": lambda t: T.binary(t, 100),
        "binary_inv": lambda t: T.binary_inv(t, 100),
        "truncate": lambda t: T.truncate(t, 100.5),
        "to_zero": lambda t: T.to_zero(t, 100),
        "to_zero_inv": lambda t: T.to_zero_inv(t, 100),
        "histogram_u8": T.histogram_u8,
        "otsu_t": lambda t: T.otsu(t)[0],
        "otsu_mask": lambda t: T.otsu(t)[1],
        "adaptive_mean": lambda t: T.adaptive_mean(t, 11, 2.0),
        "adaptive_gaussian": lambda t: T.adaptive_gaussian(t, 11, 2.0),
    }
    for name, fn in cases.items():
        card, cpu = _both(fn, gray, dev)
        np.testing.assert_array_equal(card, cpu, err_msg=name)
    bgr = frames[1]
    card, cpu = _both(lambda t: T.color_distance(t, (20, 30, 200)), bgr, dev)
    np.testing.assert_array_equal(card, cpu)
    for pct in (None, 10.0):
        card, cpu = _both(lambda t: torch.stack(T.thresh_color_distance(t, (20, 30, 200), 80.0, pct)), bgr, dev)
        np.testing.assert_array_equal(card, cpu)


def test_kmeans_white_balance_undistort_card_equal_cpu(dev, frames):
    small = frames[0][::4, ::4].copy()
    card = UC.kmeans(small, 4, 10, device=dev)
    cpu = UC.kmeans(small, 4, 10, device="cpu")
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_allclose(card[2], cpu[2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    for blur in (0, 5):
        np.testing.assert_array_equal(UC.white_balance_bgr(frames[1], blur, device=dev),
                                      UC.white_balance_bgr(frames[1], blur, device="cpu"))
    map_x, map_y = U.init_undistort_map(CAMERA)
    np.testing.assert_array_equal(U.undistort(frames[2], map_x, map_y, device=dev),
                                  U.undistort(frames[2], map_x, map_y, device="cpu"))

"""The rest of the port's library against the JAX package on the CPU, on the
same numpy inputs (64x96, 96x128, 80x100 and 20x20, from seeds): k-means,
white balance, undistort, the HSV mask chain and pipeline, the gray post,
``vision_common``, the helpers and ``stdlib``; then the two repairs (the
``--device`` flag's environment default, ``find_corners`` on a device) and
the rule that every numpy-in/numpy-out entry point runs on CUDA unless told
``cpu`` (here, with no card, it raises).

Tolerances:
* ``kmeans`` on well-separated clusters: the same partition as JAX up to a
  permutation of cluster IDs, centres within 1e-4 after matching (the port
  sums in float64, JAX in float32: measured <= 2e-5), compactness rtol
  1e-5; the initial picks differ by design (a torch Generator seeded 0 vs
  JAX's PRNG), and where JAX's picks land two centres in one cluster
  (seed 1, k = 4: a local minimum) the port is held to the true partition;
* ``white_balance_bgr`` (frame mean, blur 5 and 7) and ``undistort`` (BGR
  and gray): the same u8 as JAX at XLA's default level and at level 0;
* ``HsvMaskPipeline`` (JAX: interpret-mode ``label_pallas``) and
  ``hsv_mask_chain``: masks, cleaned masks, ``count``, ``area``, ``bbox``,
  ``first_pixel`` and ``valid`` exact, ``centroid`` within rtol 1e-5,
  atol 1e-3 (JAX sums in float32);
* ``vision_common``: the cases of JAX ``tests/test_orchestration.py:120``.
"""

import jax
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

import cv2
from cuauv_vision_pipeline_tpu import stdlib as jstdlib
from cuauv_vision_pipeline_tpu.engine import chains as jchains
from cuauv_vision_pipeline_tpu.utils import color as jUC
from cuauv_vision_pipeline_tpu.utils import undistort as jU
from cuauv_vision_pipeline_tpu_torch import stdlib as tstdlib
from cuauv_vision_pipeline_tpu_torch import vision_common as VC
from cuauv_vision_pipeline_tpu_torch.core import base as tbase
from cuauv_vision_pipeline_tpu_torch.engine import chains as tchains
from cuauv_vision_pipeline_tpu_torch.modules import red_buoy
from cuauv_vision_pipeline_tpu_torch.utils import color as tUC
from cuauv_vision_pipeline_tpu_torch.utils import feature as tUF
from cuauv_vision_pipeline_tpu_torch.utils import helpers as H
from cuauv_vision_pipeline_tpu_torch.utils import undistort as tU


def _jax_at(fn, *args, level):
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": level})
    return np.asarray(compiled(*args))


def clusters(seed, k, shape=(64, 96)):
    """k flat colors in the image's quadrants (k <= 4) plus N(0, 6) noise,
    and the true label of each pixel."""
    rng = np.random.default_rng(seed)
    colors = np.array([(200, 50, 50), (10, 200, 10), (30, 30, 220), (230, 230, 40)][:k])
    H_, W_ = shape
    truth = ((np.arange(H_)[:, None] >= H_ // 2) * 2 + (np.arange(W_)[None, :] >= W_ // 2)) % k
    img = colors[truth] + rng.normal(0, 6, (H_, W_, 3))
    return img.clip(0, 255).astype(np.uint8), truth


def _matching(a, b, k):
    """The one-to-one map from labels ``a`` to labels ``b`` if the two
    partitions are equal, else None."""
    table = np.zeros((k, k), int)
    np.add.at(table, (a.ravel(), b.ravel()), 1)
    if ((table > 0).sum(0) != 1).any() or ((table > 0).sum(1) != 1).any():
        return None
    return table.argmax(1)


@pytest.mark.parametrize("seed,k", [(0, 2), (0, 3), (0, 4), (2, 3), (2, 4), (3, 4)])
def test_kmeans_matches_jax(seed, k):
    img, _ = clusters(seed, k)
    jc, jl, jcen = jUC.kmeans(img, k, 10)
    tc, tl, tcen = tUC.kmeans(img, k, 10, device="cpu")
    assert tl.shape == jl.shape == (img.shape[0] * img.shape[1], 1) and tl.dtype == np.int32
    to_jax = _matching(tl, jl, k)
    assert to_jax is not None, "partitions differ"
    np.testing.assert_allclose(tcen, jcen[to_jax], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc, jc, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kmeans_finds_true_partition(seed):
    img, truth = clusters(seed, 4)
    _, labels, centers = tUC.kmeans(img, 4, 10, device="cpu")
    assert _matching(labels, truth, 4) is not None
    # the JAX package's own two-color case (tests/test_utils_draw_color.py)
    img = np.zeros((20, 20, 3), np.uint8)
    img[:, 10:] = (200, 50, 50)
    img[:, :10] = (10, 200, 10)
    _, labels, _ = tUC.kmeans(img, 2, iterations=15, device="cpu")
    left = int(labels.reshape(20, 20)[0, 0])
    mask = tUC.kmeans_mask(labels, (20, 20), left)
    assert (mask[:, :10] == 255).all() and (mask[:, 10:] == 0).all()
    np.testing.assert_array_equal(mask, jUC.kmeans_mask(labels, (20, 20), left))


def _jax_white_balance(blur):
    """JAX ``utils/color.white_balance_bgr``'s graph, to compile at a level."""
    import jax.numpy as jnp

    from cuauv_vision_pipeline_tpu.ops import color as jC
    from cuauv_vision_pipeline_tpu.ops.transform import gaussian_blur

    def run(img):
        lab = jC.bgr_to_lab(img).astype(jnp.float32)
        l, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
        if blur > 1:
            a_mean, b_mean = gaussian_blur(a, blur | 1), gaussian_blur(b, blur | 1)
        else:
            a_mean, b_mean = jnp.mean(a), jnp.mean(b)
        a2 = a - (a_mean - 128.0) * (l / 255.0) * 1.1
        b2 = b - (b_mean - 128.0) * (l / 255.0) * 1.1
        balanced = jnp.stack([l, jnp.clip(a2, 0, 255), jnp.clip(b2, 0, 255)], axis=-1).astype(jnp.uint8)
        return jC.lab_to_bgr(balanced)

    return run


@pytest.mark.parametrize("blur", [0, 5, 7])
def test_white_balance_matches_jax(blur):
    rng = np.random.default_rng(0)
    cast = rng.integers(60, 120, (64, 96, 3), dtype=np.uint8)
    cast[..., 0] = np.clip(cast[..., 0].astype(int) + 80, 0, 255)  # blue cast
    smooth = cv2.GaussianBlur(rng.integers(0, 256, (96, 128, 3), np.uint8), (9, 9), 0)
    for img in (cast, smooth):
        got = tUC.white_balance_bgr(img, blur, device="cpu")
        np.testing.assert_array_equal(got, jUC.white_balance_bgr(img, blur))
        np.testing.assert_array_equal(got, _jax_at(_jax_white_balance(blur), img, level=2))
    out = tUC.white_balance_bgr(cast, device="cpu")
    assert abs(int(out[..., 0].mean()) - int(out[..., 2].mean())) < abs(
        int(cast[..., 0].mean()) - int(cast[..., 2].mean()))


CAMERA = {
    "camera_matrix": {"fx": 120.0, "fy": 115.0, "cx": 50.0, "cy": 40.0},
    "distortion": {"k1": -0.2, "k2": 0.05, "p1": 0.001, "p2": -0.001},
    "image_size": {"width": 100, "height": 80},
}


def test_undistort_matches_jax():
    map_x, map_y = tU.init_undistort_map(CAMERA)
    jmap_x, jmap_y = jU.init_undistort_map(CAMERA)
    np.testing.assert_array_equal(map_x, jmap_x)
    np.testing.assert_array_equal(map_y, jmap_y)
    rng = np.random.default_rng(1)
    for img in (rng.integers(0, 255, (80, 100, 3), np.uint8), rng.integers(0, 255, (80, 100), np.uint8),
                rng.integers(0, 255, (80, 100)).astype(np.float32)):
        got = tU.undistort(img, map_x, map_y, device="cpu")
        assert got.dtype == img.dtype
        for level in (2, 0) if img.dtype == np.uint8 else (2,):
            want = _jax_at(jU.undistort, img, map_x, map_y, level=level)
            np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=f"level {level}")
        if img.dtype == np.uint8:  # the JAX package's own bound against cv2
            ref = cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR)
            assert (np.abs(got.astype(int) - ref.astype(int)) > 1).mean() < 0.02
    # identity map, tensor in -> tensor out on its device
    ys, xs = np.mgrid[:80, :100].astype(np.float32)
    t = torch.from_numpy(img.astype(np.uint8))
    np.testing.assert_array_equal(tU.undistort(t, xs, ys).numpy(), img.astype(np.uint8))


def hsv_scene(seed, shape=(96, 128)):
    """Dark noise with colored discs and one yellow-orange rectangle."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 60, (*shape, 3), dtype=np.uint8)
    for _ in range(6):
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        center = (int(rng.integers(0, shape[1])), int(rng.integers(0, shape[0])))
        cv2.circle(img, center, int(rng.integers(4, 20)), color, -1)
    cv2.rectangle(img, (10, 10), (40, 30), (30, 200, 220), -1)
    return img


HSV_LO, HSV_HI = (15, 100, 100), (40, 255, 255)


def _assert_stats_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in ("count", "area", "bbox", "first_pixel", "valid"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(np.asarray(got["centroid"]), np.asarray(want["centroid"]), rtol=1e-5, atol=1e-3)


def test_hsv_mask_pipeline_matches_jax():
    jpipe = jchains.HsvMaskPipeline(HSV_LO, HSV_HI)
    tpipe = tchains.HsvMaskPipeline(HSV_LO, HSV_HI, device="cpu")
    assert tpipe.device == torch.device("cpu")
    for seed in (0, 1, 2):
        img = hsv_scene(seed)
        jmask, jclean, jstats = jpipe.run_sync(img)
        tmask, tclean, tstats = tpipe.run_sync(img)
        np.testing.assert_array_equal(tmask, jmask)
        np.testing.assert_array_equal(tclean, jclean)
        assert tstats["count"] > 0
        _assert_stats_equal(tstats, jstats)


@pytest.mark.parametrize("kernel_size", [5, 3])
def test_hsv_mask_chain_matches_jax(kernel_size):
    lo, hi = np.asarray(HSV_LO, np.uint8), np.asarray(HSV_HI, np.uint8)
    jchain = jax.jit(jchains.hsv_mask_chain, static_argnums=(3, 4))
    for seed in (3, 4):
        img = hsv_scene(seed)
        jmask, jclean, jstats = jchain(img, lo, hi, kernel_size, 16)
        tmask, tclean, tstats = tchains.hsv_mask_chain(torch.from_numpy(img), lo, hi, kernel_size, 16)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(tclean.numpy(), np.asarray(jclean))
        _assert_stats_equal({k: v.numpy() for k, v in tstats.items()}, jstats)


def test_grayscale_post_chain_matches_jax():
    img = hsv_scene(5)
    np.testing.assert_array_equal(tchains.grayscale_post_chain(torch.from_numpy(img)).numpy(),
                                  np.asarray(jax.jit(jchains.grayscale_post_chain)(img)))


def test_vision_common_helpers():
    """The cases of the JAX package's tests/test_orchestration.py:120."""
    mask = np.zeros((60, 80), np.uint8)
    mask[10:40, 20:60] = 255
    contour = max(cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)[0], key=cv2.contourArea)
    assert not VC.is_clipping(mask, contour)
    assert VC.fill_ratio(mask, contour, mask) > 0.95
    cx, cy = VC.contour_center(contour)
    assert abs(cx - 39.5) < 2 and abs(cy - 24.5) < 2

    edge = np.zeros((60, 80), np.uint8)
    edge[0:30, 0:30] = 255
    c2 = cv2.findContours(edge, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)[0][0]
    assert VC.is_clipping(edge, c2)

    resized = VC.resize_keep_ratio(mask, 100, device="cpu")
    assert resized.shape == (100, 100)

    feats = VC.extract_features(mask)
    assert feats.shape == (7,)
    assert feats[0] != 0
    from cuauv_vision_pipeline_tpu import vision_common as jVC

    np.testing.assert_allclose(feats, jVC.extract_features(mask), rtol=1e-12)
    h = VC.Hierarchy(np.array([[[1, -1, 2, -1], [-1, 0, -1, -1], [-1, -1, -1, 0]]]))
    assert h.children(0) == [2] and h.siblings(1) == [0, 1] and h.parent(2) == 0
    assert VC.get_angle_from_rotated_rect(((0, 0), (2, 5), 30.0)) == 120.0
    assert VC.flatten([1, (2, [3, 4])]) == [1, 2, 3, 4]


def test_post_colorspace_runs_on_the_modules_device():
    posts = []

    class Module:
        device = torch.device("cpu")

        def post(self, name, image, space):
            posts.append((name, image, space))

    img = hsv_scene(6)
    VC.post_colorspace(Module(), img, "HSV")
    want = tUC.bgr_to_hsv(img, device="cpu")[1]
    assert [p[0] for p in posts] == ["HSV_0", "HSV_1", "HSV_2"]
    for (_, got, space), w in zip(posts, want):
        assert space == "GRAY"
        np.testing.assert_array_equal(got, w)


def test_helpers_and_stdlib():
    assert H.next_odd(4) == 5 and H.next_odd(5) == 5 and H.make_odd(8) == 9
    arr = np.arange(6).reshape(2, 3)
    dev = H.to_umat(arr, device="cpu")
    assert isinstance(dev, torch.Tensor) and dev.device == torch.device("cpu")
    np.testing.assert_array_equal(H.from_umat(dev), arr)
    np.testing.assert_array_equal(H.as_mat(dev), arr)
    np.testing.assert_array_equal(H.as_mat(arr), arr)
    assert tstdlib.COLORS == jstdlib.COLORS


@pytest.mark.parametrize("value,want", [("cpu", "cpu"), ("1", "1")])
def test_device_flag_reads_its_environment_default(monkeypatch, value, want):
    """$CUAUV_TPU_DEVICE reaches --device when the flag is absent (the
    launcher's way to pin one module per device); the flag still wins."""
    seen = []
    monkeypatch.setenv("CUAUV_TPU_DEVICE", value)
    monkeypatch.setattr(tbase, "resolve_device", lambda spec: seen.append(spec) or torch.device("cpu"))
    red_buoy.BuoyLAB(["zed"], red_buoy.module_tuners, argv=[])
    red_buoy.BuoyLAB(["zed"], red_buoy.module_tuners, argv=["--device", "cpu"])
    assert seen == [want, "cpu"]


def test_device_flag_cpu_from_environment(monkeypatch):
    monkeypatch.setenv("CUAUV_TPU_DEVICE", "cpu")
    module = red_buoy.BuoyLAB(["zed"], red_buoy.module_tuners, argv=[])
    assert module.device == torch.device("cpu")


GRAY = cv2.GaussianBlur(np.random.default_rng(8).integers(0, 256, (64, 96), np.uint8), (5, 5), 0)
BGR = hsv_scene(7, (64, 96))
NO_CARD_CALLS = {
    "canny": lambda: tUF.canny(GRAY, 50, 150),
    "simple_canny": lambda: tUF.simple_canny(GRAY),
    "find_corners": lambda: tUF.find_corners(GRAY, 10),
    "find_lines": lambda: tUF.find_lines(GRAY),
    "find_line_segments": lambda: tUF.find_line_segments(GRAY),
    "find_circles": lambda: tUF.find_circles(GRAY),
    "color_dist": lambda: tUC.color_dist(BGR, (1, 2, 3)),
    "thresh_color_distance": lambda: tUC.thresh_color_distance([BGR[..., i] for i in range(3)], (1, 2, 3), 9),
    "range_threshold": lambda: tUC.range_threshold(GRAY, 3, 9),
    "binary_threshold": lambda: tUC.binary_threshold(GRAY, 9),
    "otsu_threshold": lambda: tUC.otsu_threshold(GRAY),
    "adaptive_threshold_mean": lambda: tUC.adaptive_threshold_mean(GRAY, 11),
    "adaptive_threshold_gaussian": lambda: tUC.adaptive_threshold_gaussian(GRAY, 11),
    "kmeans": lambda: tUC.kmeans(BGR, 2),
    "white_balance_bgr": lambda: tUC.white_balance_bgr(BGR),
    "undistort": lambda: tU.undistort(BGR, *tU.init_undistort_map(CAMERA, 96, 64)),
    "HsvMaskPipeline": lambda: tchains.HsvMaskPipeline(HSV_LO, HSV_HI),
    "to_umat": lambda: H.to_umat(GRAY),
    "resize_keep_ratio": lambda: VC.resize_keep_ratio(GRAY, 50),
}


@pytest.mark.parametrize("name", list(NO_CARD_CALLS))
def test_entry_points_need_a_card_unless_told_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NO_CARD_CALLS[name]()

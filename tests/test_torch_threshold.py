"""The port's threshold and color-distance library (``ops/threshold.py`` and
its ``utils/color.py`` wrappers) against OpenCV and the JAX package on the
CPU, on the same numpy inputs (64x96 and 96x128, from seeds).

Tolerances:
* the fixed cv2.threshold modes, ``in_range`` / ``range_threshold``,
  ``histogram_u8``, ``adaptive_mean`` and ``otsu``'s threshold and mask:
  bit-exact against JAX and cv2 (JAX's grid of sizes and biases);
* ``adaptive_gaussian``: the same u8 mask as JAX at XLA's default
  optimization level (the port fuses the taps' multiply-adds as that level
  does; its float sums are bit-equal there) and at the tests' level 0; cv2
  within the JAX package's own bound (under 1 % of pixels);
* ``color_distance``: rtol 1e-6 (measured: equal); ``thresh_color_distance``
  masks and u8 distances exact, with and without the auto percentile.
"""

import cv2
import jax
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.ops import threshold as jT
from cuauv_vision_pipeline_tpu.utils import color as jUC
from cuauv_vision_pipeline_tpu_torch.ops import threshold as tT
from cuauv_vision_pipeline_tpu_torch.utils import color as tUC

RNG = np.random.default_rng(42)
GRAY = RNG.integers(0, 256, (64, 96), dtype=np.uint8)
BGR = RNG.integers(0, 256, (64, 96, 3), dtype=np.uint8)
SMOOTH = cv2.GaussianBlur(np.random.default_rng(7).integers(0, 256, (96, 128), np.uint8), (9, 9), 0)
BIMODAL = np.concatenate(
    [RNG.normal(60, 10, 2000).clip(0, 255), RNG.normal(190, 12, 2000).clip(0, 255)]
).astype(np.uint8).reshape(50, 80)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_at(fn, *args, level):
    """``fn`` jitted at an XLA CPU optimization level (2: the default, the
    level the JAX package's modules run at; 0: this suite's conftest)."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": level})
    return jax.tree.map(np.asarray, compiled(*args))


@pytest.mark.parametrize("thresh", [0, 57, 128, 254, 255, 99.5])
def test_fixed_threshold_modes_match_cv2_and_jax(thresh):
    for name, mode in [("binary", cv2.THRESH_BINARY), ("binary_inv", cv2.THRESH_BINARY_INV)]:
        want = cv2.threshold(GRAY, thresh, 255, mode)[1]
        got = getattr(tT, name)(_t(GRAY), thresh).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(getattr(jT, name)(GRAY, thresh, 255)))
    for name, mode in [("truncate", cv2.THRESH_TRUNC), ("to_zero", cv2.THRESH_TOZERO),
                       ("to_zero_inv", cv2.THRESH_TOZERO_INV)]:
        want = cv2.threshold(GRAY, thresh, 0, mode)[1]
        got = getattr(tT, name)(_t(GRAY), thresh).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(getattr(jT, name)(GRAY, thresh)))


def test_threshold_shims_match_jax():
    for name in ("binary_threshold", "binary_threshold_inv", "max_threshold",
                 "above_threshold", "below_threshold"):
        np.testing.assert_array_equal(
            getattr(tUC, name)(GRAY, 101, device="cpu"), getattr(jUC, name)(GRAY, 101), err_msg=name)
    np.testing.assert_array_equal(
        tUC.range_threshold(GRAY, 50, 180, device="cpu"), cv2.inRange(GRAY, 50, 180))
    np.testing.assert_array_equal(
        tUC.range_threshold(GRAY, 50, 180, device="cpu"), jUC.range_threshold(GRAY, 50, 180))
    lo, hi = (10, 50, 100), (200, 220, 240)
    np.testing.assert_array_equal(tT.in_range(_t(BGR), lo, hi).numpy(), cv2.inRange(BGR, lo, hi))
    np.testing.assert_array_equal(tT.range_threshold(_t(BGR), lo, hi).numpy(), np.asarray(jT.in_range(BGR, lo, hi)))


def test_histogram_matches_numpy_and_jax():
    got = tT.histogram_u8(_t(SMOOTH))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.bincount(SMOOTH.ravel(), minlength=256))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jT.histogram_u8(SMOOTH)))


@pytest.mark.parametrize("name", ["bimodal", "gray", "smooth", "constant_pair"])
def test_otsu_matches_cv2_and_jax(name):
    img = {
        "bimodal": BIMODAL,
        "gray": GRAY,
        "smooth": SMOOTH,
        "constant_pair": np.repeat(np.array([[30, 200]], np.uint8), 40, axis=0),
    }[name]
    want_t, want_mask = cv2.threshold(img, 0, 255, cv2.THRESH_OTSU)
    got_t, got_mask = tT.otsu(_t(img))
    jax_t, jax_mask = jT.otsu(img)
    assert float(got_t) == want_t == float(jax_t)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(jax_mask))
    t, mask = tUC.otsu_threshold(img, device="cpu")
    assert t == want_t
    np.testing.assert_array_equal(mask, want_mask)


@pytest.mark.parametrize("ksize,bias", [(11, 2.0), (7, 0.0), (21, -3.0), (3, 1.0)])
def test_adaptive_mean_matches_cv2_and_jax(ksize, bias):
    for img in (GRAY, SMOOTH):
        for inverse, mode in ((False, cv2.THRESH_BINARY), (True, cv2.THRESH_BINARY_INV)):
            want = cv2.adaptiveThreshold(img, 255, cv2.ADAPTIVE_THRESH_MEAN_C, mode, ksize, bias)
            got = tT.adaptive_mean(_t(img), ksize, bias, inverse=inverse).numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, np.asarray(jT.adaptive_mean(img, ksize, bias, inverse=inverse)))
    shim = tUC.adaptive_threshold_mean_inv if ksize == 3 else tUC.adaptive_threshold_mean
    jshim = jUC.adaptive_threshold_mean_inv if ksize == 3 else jUC.adaptive_threshold_mean
    np.testing.assert_array_equal(shim(GRAY, ksize, bias, device="cpu"), jshim(GRAY, ksize, bias))


def test_box_sum_matches_jax():
    for ksize in (3, 11, 21):
        np.testing.assert_array_equal(
            tT._box_sum_replicate(_t(GRAY.astype(np.int32)), ksize).numpy(),
            np.asarray(jT._box_sum_replicate(GRAY.astype(np.int32), ksize)))


@pytest.mark.parametrize("ksize,bias", [(11, 2.0), (15, 0.0), (5, 1.0)])
def test_adaptive_gaussian_matches_jax(ksize, bias):
    for img in (GRAY, SMOOTH):
        got = tT.adaptive_gaussian(_t(img), ksize, bias).numpy()
        for level in (2, 0):
            want = _jax_at(lambda g: jT.adaptive_gaussian(g, ksize, bias), img, level=level)
            np.testing.assert_array_equal(got, want, err_msg=f"level {level}")
        # against cv2: the JAX package's own bound (its float smoothing
        # flips a mask pixel only at a near-tie; measured: 3 of 12288
        # pixels at ksize 5 on SMOOTH, none elsewhere)
        ref = cv2.adaptiveThreshold(img, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY, ksize, bias)
        assert (got != ref).mean() < 0.01
    np.testing.assert_array_equal(
        tUC.adaptive_threshold_gaussian_inv(GRAY, ksize, bias, device="cpu"),
        255 - tUC.adaptive_threshold_gaussian(GRAY, ksize, bias, device="cpu"))


def test_adaptive_gaussian_sums_bit_equal_to_default_level():
    """The smoothed float32 sums themselves, rows then columns: bit-equal to
    XLA's at its default level (with two roundings per tap they are not)."""
    k = [float(v) for v in jT._gaussian_kernel_1d(11).astype(np.float32)]
    padded = np.pad(GRAY.astype(np.float32), 5, mode="edge")

    def jax_smooth(x):
        kx = jax.numpy.asarray(k, jax.numpy.float32)

        def conv(x, axis):
            n = x.shape[axis]
            acc = jax.numpy.zeros_like(jax.lax.slice_in_dim(x, 5, n - 5, axis=axis))
            for i in range(11):
                acc = acc + kx[i] * jax.lax.slice_in_dim(x, i, n - (10 - i), axis=axis)
            return acc

        return conv(conv(x, 0), 1)

    want = _jax_at(jax_smooth, padded, level=2)
    got = tT._taps_fused(tT._taps_fused(_t(padded), k, 0), k, 1).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_color_distance_matches_jax():
    for color in ((100, 100, 100), (103, 100, 96), (0, 255, 12)):
        want = np.asarray(jT.color_distance(BGR, color))
        np.testing.assert_allclose(tT.color_distance(_t(BGR), color).numpy(), want, rtol=1e-6, atol=0)
        np.testing.assert_allclose(tUC.color_dist(BGR, color, device="cpu"), np.asarray(jUC.color_dist(BGR, color)),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("kwargs", [
    {},
    {"auto_distance_percentile": 30.0},
    {"weights": (1.0, 2.0, 0.5)},
    {"ignore_channels": [1]},
    {"weights": (1.0, 2.0, 0.5), "auto_distance_percentile": 50.0},
], ids=["plain", "auto30", "weighted", "ignore1", "weighted_auto50"])
def test_thresh_color_distance_matches_jax(kwargs):
    for level in (2, 0):
        jm, jd = _jax_at(lambda im: jT.thresh_color_distance(im, (100, 90, 80), 60.0, **kwargs), BGR, level=level)
        tm, td = tT.thresh_color_distance(_t(BGR), (100, 90, 80), 60.0, **kwargs)
        np.testing.assert_array_equal(tm.numpy(), jm)
        np.testing.assert_array_equal(td.numpy(), jd)
    split = [BGR[..., i] for i in range(3)]
    for got, want in zip(tUC.thresh_color_distance(split, (100, 90, 80), 60.0, device="cpu", **kwargs),
                         jUC.thresh_color_distance(split, (100, 90, 80), 60.0, **kwargs)):
        np.testing.assert_array_equal(got, want)

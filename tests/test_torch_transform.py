"""The port's transforms and the rest of its morphology against OpenCV and
the JAX package on the CPU.

* ``gaussian_blur`` on u8, ksize 3-9: bit-exact against the JAX package and
  cv2 (an integer filter); ksize 11-31: within 1 count of both, the JAX
  package's stated bound.
* ``resize`` (nearest, linear), ``rotate``, ``translate``: within 1 count
  of the JAX package on 1- and 3-channel images.
* the normal map's decode/encode: a round trip, and the JAX package's
  values.
* ellipse and cross elements equal to cv2.getStructuringElement; erode,
  dilate and ``gradient`` with them exact against cv2 and the JAX package.
* A known difference: the JAX package's ``utils.transform.erode`` of a
  ``[H, W, 3]`` frame (what its preprocessor does) windows over W and the
  channels and so differs from ``cv2.erode``; the port's equals cv2, per
  channel.
"""

import cv2
import jax
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.ops import morphology as jmorph
from cuauv_vision_pipeline_tpu.ops import transform as jx
from cuauv_vision_pipeline_tpu.utils import transform as jut
from cuauv_vision_pipeline_tpu_torch.ops import morphology as tmorph
from cuauv_vision_pipeline_tpu_torch.ops import transform as tx
from cuauv_vision_pipeline_tpu_torch.utils import transform as tut


def _img(shape, seed=0):
    """A smooth gradient with noise: u8 values everywhere in 0..255."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    base = np.add.outer(np.linspace(0, 180, h), np.linspace(0, 60, w))
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 20
    return np.clip(base + rng.normal(0, 25, shape), 0, 255).astype(np.uint8)


SHAPES = [(37, 53), (48, 64, 3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ksize", [3, 5, 7, 9])
def test_gaussian_blur_u8_bit_exact(shape, ksize):
    img = _img(shape)
    got = tx.gaussian_blur(torch.from_numpy(img), ksize).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jx.gaussian_blur, static_argnums=1)(img, ksize)))
    np.testing.assert_array_equal(got, cv2.GaussianBlur(img, (ksize, ksize), 0))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ksize", [11, 15, 21, 31])
def test_gaussian_blur_large_kernels_within_one(shape, ksize):
    img = _img(shape)
    got = tx.gaussian_blur(torch.from_numpy(img), ksize).numpy().astype(int)
    want = np.asarray(jax.jit(jx.gaussian_blur, static_argnums=1)(img, ksize)).astype(int)
    assert np.abs(got - want).max() <= 1
    assert np.abs(got - cv2.GaussianBlur(img, (ksize, ksize), 0)).max() <= 1


def _within_one(got: torch.Tensor, want) -> None:
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dsize", [(32, 20), (101, 77)])
@pytest.mark.parametrize("interpolation", ["nearest", "linear"])
def test_resize_within_one(shape, dsize, interpolation):
    img = _img(shape)
    _within_one(tx.resize(torch.from_numpy(img), dsize, interpolation),
                jx.resize(img, dsize, interpolation))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("angle", [17.5, -90.0])
def test_rotate_within_one(shape, angle):
    img = _img(shape)
    _within_one(tx.rotate(torch.from_numpy(img), angle), jut.rotate(img, angle))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dx,dy", [(5, -3), (-12.5, 7.25)])
def test_translate_within_one(shape, dx, dy):
    img = _img(shape)
    _within_one(tx.translate(torch.from_numpy(img), dx, dy), jut.translate(img, dx, dy))


def test_normals_round_trip():
    u8 = _img((16, 24, 3))
    dec = tx.decode_normal(torch.from_numpy(u8))
    np.testing.assert_allclose(dec.numpy(), np.asarray(jx.decode_normal(u8)), atol=1e-6)
    np.testing.assert_array_equal(tx.encode_normal(dec).numpy(), u8)
    normals = np.random.default_rng(1).uniform(-1.1, 1.1, (16, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(tx.encode_normal(torch.from_numpy(normals)).numpy(),
                                  np.asarray(jx.encode_normal(normals)))
    np.testing.assert_array_equal(tut.encode_normal(tut.decode_normal(u8, device="cpu"), device="cpu"), u8)


@pytest.mark.parametrize("size", [3, 5, 7, (5, 9), (9, 4)])
def test_structuring_elements_equal_cv2(size):
    ksize = (size, size) if isinstance(size, int) else size  # (rows, cols)
    cv_size = (ksize[1], ksize[0])  # cv2 takes (width, height)
    np.testing.assert_array_equal(tmorph.ellipse_kernel(size),
                                  cv2.getStructuringElement(cv2.MORPH_ELLIPSE, cv_size))
    np.testing.assert_array_equal(tmorph.cross_kernel(size),
                                  cv2.getStructuringElement(cv2.MORPH_CROSS, cv_size))
    np.testing.assert_array_equal(tmorph.ellipse_kernel(size), jmorph.ellipse_kernel(size))


_CV_MORPH = {"erode": cv2.erode, "dilate": cv2.dilate,
             "gradient": lambda m, k: cv2.morphologyEx(m, cv2.MORPH_GRADIENT, k)}


@pytest.mark.parametrize("op", ["erode", "dilate", "gradient"])
@pytest.mark.parametrize("element", ["ellipse", "cross", "rect"])
def test_morphology_exact(op, element):
    mask = ((np.random.default_rng(3).random((41, 57)) < 0.45) * 255).astype(np.uint8)
    gray = _img((41, 57))
    kernel = getattr(tmorph, f"{element}_kernel")(5)
    for img in (mask, gray):
        got = getattr(tmorph, op)(torch.from_numpy(img), kernel).numpy()
        np.testing.assert_array_equal(got, _CV_MORPH[op](img, kernel))
        np.testing.assert_array_equal(got, np.asarray(getattr(jmorph, op)(img, kernel)))


@pytest.mark.parametrize("element", ["rect", "ellipse"])
def test_utils_morphology_on_bgr_is_per_channel(element):
    img = _img((40, 56, 3))
    kernel = getattr(tmorph, f"{element}_kernel")(5)
    for name, cv_fn in (("erode", cv2.erode), ("dilate", cv2.dilate)):
        np.testing.assert_array_equal(getattr(tut, name)(img, kernel, device="cpu"), cv_fn(img, kernel))
    np.testing.assert_array_equal(tut.morph_borders(img, kernel, device="cpu"),
                                  cv2.morphologyEx(img, cv2.MORPH_GRADIENT, kernel))


def test_known_difference_jax_erode_of_bgr_is_not_cv2():
    """The JAX package's erode of a [H, W, 3] frame windows over W and the
    channels (its ops window over the last two axes), so it differs from
    cv2.erode on most values; the port's equals cv2.erode per channel."""
    img = np.random.default_rng(4).integers(0, 256, (12, 16, 3), dtype=np.uint8)
    kernel = tmorph.rect_kernel(3)
    want = cv2.erode(img, kernel)
    jax_out = jut.erode(img, kernel)
    assert (jax_out != want).mean() > 0.5
    np.testing.assert_array_equal(tut.erode(img, kernel, device="cpu"), want)
    np.testing.assert_array_equal(tut.dilate(img, kernel, device="cpu"), cv2.dilate(img, kernel))


def test_utils_wrappers_match_ops():
    img = _img((30, 44, 3))
    t = torch.from_numpy(img)
    np.testing.assert_array_equal(tut.simple_gaussian_blur(img, 5, device="cpu"), tx.gaussian_blur(t, 5).numpy())
    np.testing.assert_array_equal(tut.resize(img, (22, 15), device="cpu"), tx.resize(t, (22, 15)).numpy())
    np.testing.assert_array_equal(tut.rotate(img, 30.0, device="cpu"), tx.rotate(t, 30.0).numpy())
    np.testing.assert_array_equal(tut.translate(img, 3, 4, device="cpu"), tx.translate(t, 3.0, 4.0).numpy())
    np.testing.assert_array_equal(tut.morph_remove_noise(img, tut.rect_kernel(3), device="cpu"),
                                  cv2.morphologyEx(img, cv2.MORPH_OPEN, tut.rect_kernel(3)))
    np.testing.assert_array_equal(tut.morph_close_holes(img, tut.cross_kernel(3), device="cpu"),
                                  cv2.morphologyEx(img, cv2.MORPH_CLOSE, tut.cross_kernel(3)))

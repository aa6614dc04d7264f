"""The PyTorch port's colorspace, threshold and morphology ops against the
JAX package on the CPU: bit-exact on every u8 path."""

import jax
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.ops import color as jcolor
from cuauv_vision_pipeline_tpu.ops import cvtables as jtables
from cuauv_vision_pipeline_tpu.ops import morphology as jmorph
from cuauv_vision_pipeline_tpu.ops import threshold as jthresh
from cuauv_vision_pipeline_tpu_torch.ops import color as tcolor
from cuauv_vision_pipeline_tpu_torch.ops import cvtables as ttables
from cuauv_vision_pipeline_tpu_torch.ops import morphology as tmorph
from cuauv_vision_pipeline_tpu_torch.ops import threshold as tthresh


def _colors() -> np.ndarray:
    """2**18 random BGR colors plus a 16-step grid of the 256^3 cube, as
    one [520, 512, 3] image (one shape: one JAX compile per function)."""
    rng = np.random.default_rng(0)
    sample = rng.integers(0, 256, (2**18, 3), dtype=np.uint8)
    axis = np.arange(0, 256, 16, dtype=np.uint8)
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([sample, grid]).reshape(520, 512, 3)


@pytest.mark.parametrize(
    "name", ["bgr_to_lab", "bgr_to_gray", "bgr_to_hsv", "bgr_to_ycrcb"]
)
def test_colorspace_bit_exact(name):
    img = _colors()
    want = np.asarray(jax.jit(getattr(jcolor, name))(img))
    got = getattr(tcolor, name)(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_gray_to_bgr_exact():
    gray = np.random.default_rng(1).integers(0, 256, (7, 9, 1), dtype=np.uint8)
    np.testing.assert_array_equal(
        tcolor.gray_to_bgr(torch.from_numpy(gray)).numpy(),
        np.asarray(jcolor.gray_to_bgr(gray)),
    )


def test_cvtables_equal():
    names = [n for n in dir(jtables) if n.isupper()]
    assert "LAB_CBRT_TABLE" in names and "HSV_SDIV_TABLE" in names
    for n in names:
        np.testing.assert_array_equal(getattr(ttables, n), getattr(jtables, n), err_msg=n)


@pytest.mark.parametrize(
    "lower,upper,shape",
    [
        (140, 255, (33, 47)),
        (np.int32(0), np.int32(255), (33, 47)),
        (150, 200, (2, 33, 47)),
        ((10, 20, 30), (200, 220, 240), (33, 47, 3)),
        (np.array([0, 100, 0]), np.array([255, 160, 90]), (2, 33, 47, 3)),
        (100, 180, (33, 47, 1)),
    ],
)
def test_in_range_exact(lower, upper, shape):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jthresh.in_range(img, lower, upper))
    got = tthresh.in_range(torch.from_numpy(img), lower, upper).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["erode", "dilate", "open_morph", "close_morph"])
@pytest.mark.parametrize("shape", [(37, 53), (2, 64, 96)])
def test_rect_morphology_exact(op, shape):
    rng = np.random.default_rng(3)
    mask = ((rng.random(shape) < 0.4) * 255).astype(np.uint8)
    kernel = jmorph.rect_kernel(5)
    want = np.asarray(getattr(jmorph, op)(mask, kernel))
    got = getattr(tmorph, op)(torch.from_numpy(mask), tmorph.rect_kernel(5)).numpy()
    np.testing.assert_array_equal(got, want)


def test_morphology_rejects_non_rect_kernel():
    """Non-rectangular 0/1 elements are supported since the correction
    chain's port (equal to the JAX package's shifted-slice reduction); what
    is still rejected is an element that is empty or not 2-D."""
    mask = ((np.random.default_rng(5).random((8, 8)) < 0.5) * 255).astype(np.uint8)
    kernel = np.eye(3, dtype=np.uint8)
    np.testing.assert_array_equal(tmorph.erode(torch.from_numpy(mask), kernel).numpy(),
                                  np.asarray(jmorph.erode(mask, kernel)))
    for bad in (np.zeros((3, 3), np.uint8), np.ones((3, 3, 1), np.uint8)):
        with pytest.raises(ValueError, match="structuring element"):
            tmorph.erode(torch.zeros((8, 8), dtype=torch.uint8), bad)

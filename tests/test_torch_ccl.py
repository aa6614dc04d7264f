"""The port's plain CCL (``ops.ccl.label``, what the CUDA kernel must equal)
against the JAX Pallas strip kernel in interpret mode and an exact labelling
built with scipy.ndimage, on the masks of tests/test_pallas_ccl.py and on
masks whose components cross the CUDA kernel's 32x32 tile seams
(tests/ccl_seam_masks.py).

The JAX XLA fixpoint ``ccl.label`` stops after 64 passes, so it is a
reference only on masks where it converges (smooth blobs, sparse noise)."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
from ccl_seam_masks import SMALL as SEAM_CASES
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.ops import ccl as jccl
from cuauv_vision_pipeline_tpu.ops.pallas.ccl_kernel import label_pallas
from cuauv_vision_pipeline_tpu_torch.ops import ccl as tccl

SENTINEL = 2**30


def blobs(seed, shape=(96, 128), box=7, thresh=140):
    """Random smooth blobs: box-blurred noise, thresholded (numpy only)."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, shape).astype(np.float64)
    pad = box // 2
    c = np.pad(noise, pad, mode="edge").cumsum(0).cumsum(1)
    c = np.pad(c, ((1, 0), (1, 0)))
    H, W = shape
    s = c[box:box + H, box:box + W] - c[:H, box:box + W] - c[box:box + H, :W] + c[:H, :W]
    return ((s / box**2 > thresh) * 255).astype(np.uint8)


def noise(seed, density, shape=(96, 128)):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density) * 255).astype(np.uint8)


def spiral():
    mask = np.zeros((64, 64), np.uint8)
    x0, x1, y0, y1 = 0, 63, 0, 63
    while x0 < x1:
        mask[y0, x0 : x1 + 1] = 255
        mask[y0 : y1 + 1, x1] = 255
        mask[y1, x0 : x1 + 1] = 255
        mask[y0 + 2 : y1 + 1, x0] = 255
        x0 += 4; x1 -= 4; y0 += 4; y1 -= 4
    return mask


def checkerboard():
    mask = np.zeros((24, 24), np.uint8)
    mask[::2, ::2] = 255
    mask[1::2, 1::2] = 255
    return mask


def vertical_bar():
    mask = np.zeros((150, 140), np.uint8)
    mask[:, 70:75] = 255
    return mask


def exact_labels(mask, connectivity=8):
    """Raster-root labels from scipy: each component's min raster index."""
    structure = np.ones((3, 3)) if connectivity == 8 else None
    lab, n = ndi.label(mask != 0, structure=structure)
    raster = np.arange(mask.size).reshape(mask.shape)
    roots = np.zeros(n + 1, np.int64)
    roots[1:] = ndi.minimum(raster, lab, index=np.arange(1, n + 1))
    out = np.full(mask.shape, SENTINEL, np.int32)
    out[lab > 0] = roots[lab[lab > 0]]
    return out


def port_label(mask, connectivity=8):
    out = tccl.label(torch.from_numpy(mask), connectivity=connectivity)
    assert out.dtype == torch.int32
    return out.numpy()


CASES = {
    "blobs_96x128": lambda: blobs(0),
    "strip_seams_140x150": lambda: blobs(7, shape=(140, 150)),
    "vertical_bar_150x140": vertical_bar,
    "spiral_64x64": spiral,
    "checkerboard_24x24": checkerboard,
    "ragged_33x130": lambda: blobs(5, shape=(33, 130)),
    "ragged_31x127": lambda: blobs(5, shape=(31, 127)),
    **SEAM_CASES,
}


@pytest.mark.parametrize("case", list(CASES))
def test_label_matches_pallas_and_exact(case):
    mask = CASES[case]()
    assert (mask != 0).any()
    got = port_label(mask)
    np.testing.assert_array_equal(got, exact_labels(mask))
    np.testing.assert_array_equal(got, np.asarray(label_pallas(mask, interpret=True)))


def test_checkerboard_4_connectivity():
    mask = checkerboard()
    got = port_label(mask, connectivity=4)
    np.testing.assert_array_equal(got, exact_labels(mask, connectivity=4))
    np.testing.assert_array_equal(
        got, np.asarray(label_pallas(mask, connectivity=4, interpret=True))
    )
    # 8-conn: one diagonal-linked component; 4-conn: every pixel alone
    assert len(np.unique(port_label(mask)[mask != 0])) == 1
    assert len(np.unique(got[mask != 0])) == (mask != 0).sum()


@pytest.mark.parametrize("case", list(SEAM_CASES))
def test_seam_cases_4_connectivity(case):
    mask = SEAM_CASES[case]()
    got = port_label(mask, connectivity=4)
    np.testing.assert_array_equal(got, exact_labels(mask, connectivity=4))
    np.testing.assert_array_equal(
        got, np.asarray(label_pallas(mask, connectivity=4, interpret=True))
    )


def test_seam_cases_have_the_components_they_are_built_for():
    """The lines stay one component each (8-connectivity) across the seams,
    and the up-right link is the only bridge of its two segments."""
    one = ("anti_diagonal_100x120", "diagonal_100x100", "seam_grid_130x130",
           "up_right_link_64x70")
    for case in one:
        got = port_label(SEAM_CASES[case]())
        assert len(np.unique(got[got < SENTINEL])) == 1, case
    for case in ("row_seams_140x100", "column_seams_100x140"):
        got = port_label(SEAM_CASES[case]())
        assert len(np.unique(got[got < SENTINEL])) == 4, case
    # 4-connectivity splits the diagonals into single pixels and the link
    mask = SEAM_CASES["up_right_link_64x70"]()
    assert len(np.unique(port_label(mask, 4)[mask != 0])) == 2


def test_dense_noise_matches_pallas_and_exact():
    """45% noise percolates; the JAX fixpoint ccl.label can stop at its
    64-pass cap on such masks, so only scipy and the Pallas kernel are
    references here."""
    mask = noise(11, 0.45)
    got = port_label(mask)
    np.testing.assert_array_equal(got, exact_labels(mask))
    np.testing.assert_array_equal(got, np.asarray(label_pallas(mask, interpret=True)))


@pytest.mark.parametrize("mask_fn", [lambda: blobs(0), lambda: blobs(1), lambda: noise(3, 0.3)])
def test_label_matches_xla_fixpoint_where_it_converges(mask_fn):
    mask = mask_fn()
    np.testing.assert_array_equal(port_label(mask), np.asarray(jccl.label(mask)))


def test_label_raises_instead_of_stopping_early():
    with pytest.raises(RuntimeError, match="did not converge"):
        tccl.label(torch.from_numpy(spiral()), max_iters=2)

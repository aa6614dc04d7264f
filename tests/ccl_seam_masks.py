"""Masks whose components cross the tile seams of the CUDA CCL kernel
(``cuauv_vision_pipeline_tpu_torch/csrc/ccl.cu``: 32x32 tiles), built with
numpy alone so that the tests on the card can use them without JAX."""

import numpy as np

TILE = 32


def anti_diagonal(shape):
    """A one-pixel line x = W-1-y: 8-connected only through up-right links,
    which cross tile corners and a tile's right column."""
    H, W = shape
    mask = np.zeros(shape, np.uint8)
    ys = np.arange(min(H, W))
    mask[ys, W - 1 - ys] = 255
    return mask


def diagonal(shape):
    """A one-pixel line x = y: up-left links only, through tile corners."""
    mask = np.zeros(shape, np.uint8)
    ys = np.arange(min(shape))
    mask[ys, ys] = 255
    return mask


def seam_lines(shape, axis):
    """One-pixel lines across the image on tile seams, alternately on a
    tile's first and on its last row (axis 0) or column (axis 1)."""
    mask = np.zeros(shape, np.uint8)
    at = [k * TILE - (k % 2 == 0) for k in range(1, shape[axis] // TILE + 1)]
    at = [i for i in at if i < shape[axis]]
    if axis == 0:
        mask[at, :] = 255
    else:
        mask[:, at] = 255
    return mask


def seam_grid(shape):
    """Lines on both kinds of seam, crossing: one component."""
    return np.maximum(seam_lines(shape, 0), seam_lines(shape, 1))


def up_right_link(shape=(64, 70)):
    """Two column segments on either side of a vertical seam, joined only by
    the up-right link of a right-column pixel below its tile's top row."""
    mask = np.zeros(shape, np.uint8)
    mask[35:46, TILE - 1] = 255
    mask[20:35, TILE] = 255
    return mask


def noise(seed, density, shape):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density) * 255).astype(np.uint8)


SMALL = {
    "anti_diagonal_100x120": lambda: anti_diagonal((100, 120)),
    "diagonal_100x100": lambda: diagonal((100, 100)),
    "row_seams_140x100": lambda: seam_lines((140, 100), 0),
    "column_seams_100x140": lambda: seam_lines((100, 140), 1),
    "seam_grid_130x130": lambda: seam_grid((130, 130)),
    "up_right_link_64x70": up_right_link,
    "ragged_noise_70x97": lambda: noise(2, 0.5, (70, 97)),
}

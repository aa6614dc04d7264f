"""The port's color-correction engine (``ops/balance.py``) against the JAX
package on the CPU, on synthetic buoy frames at 64x96 and 720p.

Configs: the default (extrema clipping, equalization, HSI stretch), each
stage alone, the default with blocks 4x3, and with the adaptive taper.

* The u8 percentile bounds are exact, the float percentiles equal
  ``jnp.percentile``'s within an ulp, the tile means are the correctly
  rounded float32 of the exact means.
* Every output value is within 1 count of the JAX package, except pixels
  whose HSI hue (the port's, before the HSI stretch) lies within 1e-5 rad
  of a sector edge, where an ulp picks the sector and so swaps two
  channels; such pixels are at most 1e-4 of the frame. Measured on this
  repo's frames: none at all (0 of 921,600 and of 6,144 pixels in every
  config).

The JAX reference is taken at two XLA optimization levels: the tests'
conftest level (0) and XLA's default (2), the level the JAX package's
modules run at. The two are the same program with another float32
rounding order, and they differ: at level 2 the HSV inverse fuses
``1 - s*frac`` into an FMA (1 count on some pixels, which the HSI stretch
then magnifies about fourfold), and the blocks-4x3 tile means, a one-hot
float32 matrix product, sum in another order (7 pixels of the 720p frame
change sector, as between the JAX package's jitted and eager runs). The
port sums the means exactly and fuses as level 2 does in the HSV inverse;
a pixel agrees if it agrees with either level.
"""

import math

import jax
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.ops import balance as jbal
from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
from cuauv_vision_pipeline_tpu_torch.ops import balance as tbal

Cfg = tbal.BalanceConfig
CONFIGS = {
    "default": Cfg(),
    "clip_only": Cfg(False, False, False, False, True),
    "equalize_only": Cfg(True, False, False, False, False),
    "rgb_contrast_only": Cfg(False, True, False, False, False),
    "hsv_contrast_only": Cfg(False, False, True, False, False),
    "hsi_contrast_only": Cfg(False, False, False, True, False),
    "blocks_4x3": Cfg(horizontal_blocks=4, vertical_blocks=3),
    "adaptive": Cfg(adaptive_cast_correction=True),
}
SIZES = {"64x96": (64, 96), "720p": (720, 1280)}
EDGE_RAD = 1e-5  # a hue this close to a sector edge may pick either sector
EDGE_SHARE = 1e-4  # of the frame's pixels, at most


def _frame(size):
    return buoy_frame(SIZES[size], 0.3)


def _jax_balance(img, cfg, level=None):
    """The JAX package's jitted ``balance``; at the tests' level, or at
    ``level`` whatever XLA_FLAGS this process set."""
    jcfg = jbal.BalanceConfig(*cfg)
    if level is None:
        return np.asarray(jax.jit(jbal.balance, static_argnums=1)(img, jcfg))
    compiled = jax.jit(jbal.balance, static_argnums=1).lower(img, jcfg).compile(
        compiler_options={"xla_backend_optimization_level": level})
    return np.asarray(compiled(img))


def _sector_edge_distance(h: np.ndarray) -> np.ndarray:
    h = np.where(h < 0, h + 2 * math.pi, h).astype(np.float64)
    third = 2 * math.pi / 3
    return np.abs(h - np.round(h / third) * third)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_balance_within_one_count_of_jax(name, size):
    cfg = CONFIGS[name]
    img = _frame(size)
    got = tbal.balance(torch.from_numpy(img), cfg).numpy().astype(int)
    assert got.shape == img.shape
    d = np.min([np.abs(got - _jax_balance(img, cfg, level).astype(int)).max(-1) for level in (None, 2)], axis=0)
    bad = d > 1
    near_edge = np.zeros_like(bad)
    if cfg.hsi_contrast_correct:
        h = tbal._rgb_to_hsi(*tbal.corrected_rgb(torch.from_numpy(img), cfg))[0].numpy()
        near_edge = _sector_edge_distance(h) < EDGE_RAD
    share = bad.mean()
    assert not (bad & ~near_edge).any(), f"{int((bad & ~near_edge).sum())} pixels off by up to {d.max()}"
    assert share <= EDGE_SHARE, f"sector flips on {share:.2e} of the frame"


@pytest.mark.parametrize("size", list(SIZES))
def test_u8_percentiles_exact(size):
    img = _frame(size)
    flat = np.full(SIZES[size], 77, np.uint8)
    two = np.where(np.arange(img.shape[1]) % 3 == 0, 10, 200).astype(np.uint8)[None].repeat(img.shape[0], 0)
    for ch in [img[..., c] for c in range(3)] + [flat, two]:
        for lo, hi in ((0.002, 0.998), (0.0, 1.0), (0.25, 0.5)):
            want = [float(v) for v in jbal._u8_percentiles(ch, lo, hi)]
            got = [float(v) for v in tbal._u8_percentiles(torch.from_numpy(ch).to(torch.float32), lo, hi)]
            assert got == want, (lo, hi)


def test_float_percentile_matches_jnp_percentile():
    x = np.random.default_rng(0).random((241, 333), np.float32) * 255
    for q in (0.2, 99.8, 50.0):
        want = np.float32(jax.jit(lambda a: jax.numpy.percentile(a, q))(x))
        got = np.float32(tbal._percentile(torch.from_numpy(x), q))
        assert abs(int(got.view(np.int32)) - int(want.view(np.int32))) <= 1, (q, got, want)


def test_block_means_exact():
    ch = _frame("720p")[..., 1].astype(np.float32)
    got = tbal._block_means(torch.from_numpy(ch), 4, 3).numpy()
    ys, xs = (np.arange(720) * 3) // 720, (np.arange(1280) * 4) // 1280
    tile = ys[:, None] * 4 + xs[None, :]
    exact = np.bincount(tile.ravel(), ch.ravel().astype(np.float64)) / np.bincount(tile.ravel())
    np.testing.assert_array_equal(got, exact.astype(np.float32)[tile])
    want = np.asarray(jax.jit(jbal._block_means, static_argnums=(1, 2))(ch, 4, 3))
    np.testing.assert_allclose(got, want, rtol=2e-7)


def test_process_frame_is_balance_on_the_device():
    img = _frame("64x96")
    flags = dict(rgb_contrast_correct=True, horizontal_blocks=2, vertical_blocks=2)
    np.testing.assert_array_equal(
        tbal.process_frame(img, device="cpu", **flags),
        tbal.balance(torch.from_numpy(img), Cfg(**flags)).numpy())

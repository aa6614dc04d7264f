"""The port's remaining colorspaces against OpenCV and the JAX package on
the CPU: HLS (through the emulated FMA of ``ops/ieee.py``), the HSV and Lab
inverses, LUV, the host L channel, and the IEEE helpers themselves.

* ``bgr_to_hls``: bit-exact against cv2 over all 256**3 colors (width >= 8:
  narrower rows take cv2's scalar loop, which rounds otherwise), and equal
  to the JAX package on a sample.
* ``ieee.fma_rn`` / ``div_rn``: bit-equal to the JAX package, and to the
  correctly rounded result of exact rational arithmetic on a sample.
* ``hsv_to_bgr``, ``lab_to_bgr``: within 2 counts of the JAX package and of
  cv2 (the JAX package's own tolerance against cv2); ``hsv_to_bgr`` is also
  equal to the JAX package compiled at XLA's default optimization level,
  which fuses ``1 - s*frac`` into an FMA as the port does (the tests'
  conftest compiles at level 0, where XLA fuses only some of them).
* ``bgr_to_luv``: within 1 count of the JAX package and of cv2.
* ``color_np.lab_l_np``: bit-exact against the JAX twin and the L of
  ``bgr_to_lab``.
"""

from fractions import Fraction

import cv2
import jax
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.ops import color as jcolor
from cuauv_vision_pipeline_tpu.ops import color_np as jcolor_np
from cuauv_vision_pipeline_tpu.ops import ieee as jieee
from cuauv_vision_pipeline_tpu_torch.ops import color as tcolor
from cuauv_vision_pipeline_tpu_torch.ops import color_np as tcolor_np
from cuauv_vision_pipeline_tpu_torch.ops import ieee as tieee

f32 = np.float32


def _cube() -> np.ndarray:
    b, g, r = np.meshgrid(*(np.arange(256, dtype=np.uint8),) * 3, indexing="ij")
    return np.stack([b, g, r], axis=-1).reshape(4096, 4096, 3)


def _sample(shape=(256, 512, 3), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _default_level(fn, *args):
    """``fn`` jitted at XLA's default CPU optimization level (the level the
    JAX package's modules run at), whatever XLA_FLAGS this process set."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 2})
    return np.asarray(compiled(*args))


def test_hls_full_cube_bit_exact_vs_cv2():
    cube = _cube()
    for rows in range(0, 4096, 512):
        part = cube[rows:rows + 512]
        got = tcolor.bgr_to_hls(torch.from_numpy(part)).numpy()
        np.testing.assert_array_equal(got, cv2.cvtColor(part, cv2.COLOR_BGR2HLS), err_msg=f"rows {rows}")


def test_hls_matches_jax():
    img = _sample()
    want = np.asarray(jax.jit(jcolor.bgr_to_hls)(img))
    np.testing.assert_array_equal(tcolor.bgr_to_hls(torch.from_numpy(img)).numpy(), want)


def _ieee_cases(n=4000, seed=0):
    """Random float32 triples over 1e-3..1e4 (no overflow, no subnormal
    error terms), half of them with c ~ -a*b (heavy cancellation), plus
    edge cases: exact products, c = -a*b exactly, zeros, powers of two,
    values an ulp apart."""
    rng = np.random.default_rng(seed)

    def rand(k):
        return ((rng.random(k, f32) * 2 - 1) * f32(10.0) ** rng.integers(-3, 5, k)).astype(f32)

    a, b = rand(n), rand(n)
    prod = a.astype(np.float64) * b.astype(np.float64)
    c = np.where(rng.random(n) < 0.5, (-prod).astype(f32) * (1 + rng.normal(0, 1e-7, n)).astype(f32), rand(n))
    edge_a = np.array([1, 3, 0.5, 0, 1, 255, 1 / 255, 60, 2 ** -10, 1 + 2 ** -23, 7], f32)
    edge_b = np.array([1, 3, 0.5, 7, 0, 1 / 255, 255, 1 / 3, 2 ** 10, 1 - 2 ** -23, -7], f32)
    edge_c = np.array([-1, -9, 0.25, 1, 0, -1, 360, -20, 0, -1, 49], f32)
    return (np.concatenate([a, edge_a]), np.concatenate([b, edge_b]),
            np.concatenate([c.astype(f32), edge_c]))


def _rn32(x: Fraction) -> np.float32:
    """Round a rational to binary32, to nearest, ties to even."""
    c = f32(float(x))
    for v in (np.nextafter(c, f32(np.inf)), np.nextafter(c, f32(-np.inf))):
        dc, dv = abs(x - Fraction(float(c))), abs(x - Fraction(float(v)))
        if dv < dc or (dv == dc and not (np.frombuffer(v.tobytes(), np.int32)[0] & 1)):
            c = v
    return c


def test_fma_rn_bit_equal_to_jax_and_correctly_rounded():
    a, b, c = _ieee_cases()
    want = np.asarray(jax.jit(jieee.fma_rn)(a, b, c))
    got = tieee.fma_rn(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for i in list(range(0, len(a), 23)) + list(range(len(a) - 11, len(a))):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        assert got[i] == _rn32(exact), (a[i], b[i], c[i])


def test_div_rn_bit_equal_to_jax_and_correctly_rounded():
    a, b, _ = _ieee_cases(seed=3)
    b = np.where(b == 0, f32(1.0), b).astype(f32)
    want = np.asarray(jax.jit(jieee.div_rn)(a, b))
    got = tieee.div_rn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for i in range(0, len(a), 19):
        assert got[i] == _rn32(Fraction(float(a[i])) / Fraction(float(b[i]))), (a[i], b[i])


def _hsv_cube(v_step=2) -> np.ndarray:
    h, s, v = np.meshgrid(np.arange(180, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                          np.arange(0, 256, v_step, dtype=np.uint8), indexing="ij")
    return np.stack([h, s, v], axis=-1).reshape(180 * 256, -1, 3)


def test_hsv_to_bgr_equals_jax_at_the_default_level():
    hsv = _hsv_cube()
    got = tcolor.hsv_to_bgr(torch.from_numpy(hsv)).numpy()
    np.testing.assert_array_equal(got, _default_level(jcolor.hsv_to_bgr, hsv))


@pytest.mark.parametrize("name,to_src,from_src,tol", [
    ("hsv_to_bgr", cv2.COLOR_BGR2HSV, cv2.COLOR_HSV2BGR, 2),
    ("lab_to_bgr", cv2.COLOR_BGR2LAB, cv2.COLOR_LAB2BGR, 2),
])
def test_inverse_within_tolerance(name, to_src, from_src, tol):
    src = cv2.cvtColor(_sample((64, 64, 3)), to_src)
    got = getattr(tcolor, name)(torch.from_numpy(src)).numpy().astype(int)
    want = np.asarray(jax.jit(getattr(jcolor, name))(src)).astype(int)
    assert np.abs(got - want).max() <= tol
    assert np.abs(got - cv2.cvtColor(src, from_src)).max() <= tol


def test_luv_within_one_count():
    img = _sample()
    got = tcolor.bgr_to_luv(torch.from_numpy(img)).numpy().astype(int)
    want = np.asarray(jax.jit(jcolor.bgr_to_luv)(img)).astype(int)
    assert np.abs(got - want).max() <= 1
    assert np.abs(got - cv2.cvtColor(img, cv2.COLOR_BGR2LUV)).max() <= 1


def test_lab_l_np_bit_exact():
    img = _sample()
    got = tcolor_np.lab_l_np(img)
    np.testing.assert_array_equal(got, jcolor_np.lab_l_np(img))
    np.testing.assert_array_equal(got, tcolor.bgr_to_lab(torch.from_numpy(img)).numpy()[..., 0])
    np.testing.assert_array_equal(got, cv2.cvtColor(img, cv2.COLOR_BGR2LAB)[..., 0])


def test_rgb_swaps_and_rgb_to_gray():
    img = _sample((9, 11, 3))
    t = torch.from_numpy(img)
    np.testing.assert_array_equal(tcolor.bgr_to_rgb(t).numpy(), np.asarray(jcolor.bgr_to_rgb(img)))
    np.testing.assert_array_equal(tcolor.rgb_to_bgr(tcolor.bgr_to_rgb(t)).numpy(), img)
    np.testing.assert_array_equal(tcolor.rgb_to_gray(t).numpy(), np.asarray(jcolor.rgb_to_gray(img)))

"""The port's keypoint front end (``ops/feature.py`` and the plain spacing
selection) against the JAX package's ``ops/feature.py`` on the CPU, on the
same numpy inputs.

Tolerances: the Shi-Tomasi response bit-equal (max difference 0: every
operation before the box sum is exact in float32, and the port rounds the
last four as XLA does, a division by a constant as a multiplication by its
float32 reciprocal and the square root correctly rounded); keypoints and
``n_valid`` equal; descriptors within atol 1e-5 (measured: <= 9e-7, from
the two libraries' atan2, hypot, cos/sin and summation orders).

The two-stage top-k must keep ``lax.top_k``'s order on exact ties (lowest
index first): a plateau case shows ``torch.topk`` failing it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from spacing_cases import cases as spacing_cases
from spacing_cases import greedy
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.capture_sources.synthetic import bin_texture, bins_frame
from cuauv_vision_pipeline_tpu.ops import feature as jfeature
from cuauv_vision_pipeline_tpu.ops.color_np import bgr_to_gray_np
from cuauv_vision_pipeline_tpu_torch.ops import feature as tfeature
from cuauv_vision_pipeline_tpu_torch.ops.cuda.spacing_kernel import (
    spacing_select,
    spacing_select_plain,
)


def textured(seed: int) -> np.ndarray:
    """A 96x128 u8 texture: 8x8 blocks of random levels plus noise."""
    rng = np.random.default_rng(seed)
    tex = np.kron(rng.integers(40, 216, (12, 16)), np.ones((8, 8))) + rng.normal(0, 6, (96, 128))
    return tex.clip(0, 255).astype(np.uint8)


INPUTS = {
    **{f"bins_720p_t{t}": (lambda t=t: bgr_to_gray_np(bins_frame((720, 1280), t))) for t in (0.0, 1.0, 2.5)},
    "template": lambda: bgr_to_gray_np(np.asarray(bin_texture())),
    "texture_seed1": lambda: textured(1),
    "texture_seed2": lambda: textured(2),
}

_jdetect = jax.jit(jfeature.detect_describe, static_argnums=(1, 2, 3, 4, 5))


@pytest.mark.parametrize("name", list(INPUTS))
def test_min_eigenvalue_map_matches_jax(name):
    gray = INPUTS[name]()
    want = np.asarray(jax.jit(jfeature.min_eigenvalue_map)(jnp.asarray(gray)))
    got = tfeature.min_eigenvalue_map(torch.from_numpy(gray)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("oriented", [False, True], ids=["axis_aligned", "oriented"])
@pytest.mark.parametrize("name", ["bins_720p_t1.0", "template", "texture_seed1"])
def test_describe_at_matches_jax(name, oriented):
    """The same keypoints (the JAX detector's, and the image corners, which
    the border clamp moves inward) described by both packages."""
    gray = INPUTS[name]()
    kp, _, n = _jdetect(jnp.asarray(gray), 512, 0.01, 8, True, False)
    n = int(n)
    H, W = gray.shape
    ys = np.concatenate([np.asarray(kp)[:n, 1], [0, 0, H - 1, H - 1]]).astype(np.int32)
    xs = np.concatenate([np.asarray(kp)[:n, 0], [0, W - 1, 0, W - 1]]).astype(np.int32)
    want = np.asarray(jfeature.describe_at(jnp.asarray(gray), jnp.asarray(ys), jnp.asarray(xs), oriented))
    got = tfeature.describe_at(torch.from_numpy(gray), torch.from_numpy(ys), torch.from_numpy(xs), oriented)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(INPUTS))
def test_detect_describe_matches_jax(name):
    gray = INPUTS[name]()
    kp_j, des_j, n_j = (np.asarray(a) for a in _jdetect(jnp.asarray(gray), 512, 0.01, 8, True, False))
    kp_t, des_t, n_t = tfeature.detect_describe(torch.from_numpy(gray))
    assert n_t.dtype == torch.int32 and n_t.ndim == 0
    assert int(n_t) == int(n_j) > 0
    np.testing.assert_array_equal(kp_t.numpy(), kp_j)
    np.testing.assert_allclose(des_t.numpy(), des_j, rtol=0, atol=1e-5)


def test_global_top_k_path_matches_jax():
    """The single-sort form (forced, and an image too small for the tile
    stage) selects as the JAX package's."""
    gray = bgr_to_gray_np(bins_frame((240, 320), 0.3))
    for img, k, force in ((gray, 128, True), (gray[:64, :64], 256, False)):
        want = _jdetect(jnp.asarray(img), k, 0.01, 8, True, force)
        got = tfeature.detect_describe(torch.from_numpy(img), k, 0.01, 8, True, force)
        assert int(got[2]) == int(want[2]) > 0
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def plateau_image() -> np.ndarray:
    """Flat squares with a step edge: the response is constant along
    each square's straight edges, so many window maxima tie exactly."""
    img = np.full((96, 128), 60, np.uint8)
    for y0, x0 in ((20, 20), (20, 70), (55, 40)):
        img[y0 : y0 + 24, x0 : x0 + 36] = 200
    return img


def test_plateau_ties_keep_lax_top_k_order(monkeypatch):
    """Exact-tie plateaus enter the candidate list lowest index first, as
    ``lax.top_k`` orders them; with ``torch.topk``'s order the same image
    keeps other keypoints, and the comparison fails."""
    gray = plateau_image()
    resp = tfeature.min_eigenvalue_map(torch.from_numpy(gray))
    assert resp.unique().numel() < resp.numel() // 50  # a plateau image
    want = np.asarray(_jdetect(jnp.asarray(gray), 64, 0.01, 8, True, True)[0])
    got = tfeature.detect_describe(torch.from_numpy(gray), 64, 0.01, 8, True, True)[0].numpy()
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(tfeature, "_top_k_stable", lambda v, k: torch.topk(v, k, dim=-1))
    unstable = tfeature.detect_describe(torch.from_numpy(gray), 64, 0.01, 8, True, True)[0].numpy()
    assert not np.array_equal(unstable, want)


def test_top_k_stable_is_lax_top_k():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 5, (40, 1024)).astype(np.float32)
    x[:, ::7] = -np.inf
    jv, ji = jax.lax.top_k(jnp.asarray(x), 32)
    tv, ti = tfeature._top_k_stable(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("case", list(spacing_cases()))
def test_spacing_plain_equals_sequential_greedy(case):
    ys, xs, cand, md = spacing_cases()[case]
    got = spacing_select(torch.from_numpy(ys), torch.from_numpy(xs), torch.from_numpy(cand), md)
    np.testing.assert_array_equal(got.numpy(), greedy(ys, xs, cand, md))


@settings(max_examples=60, deadline=None)
@given(
    pts=st.lists(st.tuples(st.integers(0, 40), st.integers(0, 40), st.booleans()), min_size=1, max_size=120),
    md=st.sampled_from([0, 1, 2, 4, 8, 10]),
)
def test_spacing_plain_equals_sequential_greedy_on_drawn_points(pts, md):
    """Clustered integer points with conflicts, exact repeats and
    multi-hop suppression chains."""
    ys = np.array([p[0] for p in pts], np.int32)
    xs = np.array([p[1] for p in pts], np.int32)
    cand = np.array([p[2] for p in pts], bool)
    got = spacing_select_plain(torch.from_numpy(ys), torch.from_numpy(xs), torch.from_numpy(cand), md)
    np.testing.assert_array_equal(got.numpy(), greedy(ys, xs, cand, md))


def test_detect_candidates_feed_detect_describe():
    """detect_describe = candidates -> spacing -> compaction: its valid
    keypoints are the kept candidates, in order."""
    gray = INPUTS["template"]()
    ys, xs, cand = tfeature.detect_candidates(torch.from_numpy(gray))
    kept = spacing_select_plain(ys, xs, cand, 8).numpy()
    kp, _, n = tfeature.detect_describe(torch.from_numpy(gray))
    want = np.stack([xs.numpy()[kept], ys.numpy()[kept]], 1).astype(np.float32)
    np.testing.assert_array_equal(kp.numpy()[: int(n)], want)
    assert (kp.numpy()[int(n):] == -1).all()

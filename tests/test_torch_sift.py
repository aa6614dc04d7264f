"""The port's matcher (``utils/sift.py``) against the JAX package's on the
CPU, on the same numpy inputs.

Tolerances: 2-NN indices equal (exact ties and the ``_PAD_VAL`` rows
included), squared distances within 1e-4 relative (a 128-term dot product
summed in another order); ratio-test matches equal; RANSAC with the same
seed gives the same inlier mask and a homography within 1e-6 (the minimal
sets, SVDs and refit are the same numpy calls; only the float32 scoring
pass is torch); the bins scene's pose quad within 1 px."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.capture_sources.synthetic import bin_texture, bins_frame
from cuauv_vision_pipeline_tpu.ops.color_np import bgr_to_gray_np
from cuauv_vision_pipeline_tpu.utils import sift as jsift
from cuauv_vision_pipeline_tpu_torch.utils import sift as tsift


def unit_rows(rng, n, d=128):
    v = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def descriptor_sets():
    rng = np.random.default_rng(21)
    q = unit_rows(rng, 64)
    t = unit_rows(rng, 96)
    t[10] = t[11] = t[40]  # exact ties: three equal train rows
    q[5] = t[40]  # ...at distance 0 from a query
    q[6] = q[7]
    padded = np.full((128, 128), tsift._PAD_VAL, np.float32)
    padded[:96] = t
    return {"random": (q, t), "ties": (q, np.concatenate([t, t[:8]])), "pad_rows": (q, padded)}


@pytest.mark.parametrize("case", list(descriptor_sets()))
def test_distance_topk_matches_jax(case):
    q, t = descriptor_sets()[case]
    jd, ji = (np.asarray(a) for a in jsift._distance_topk(jnp.asarray(q), jnp.asarray(t)))
    td, ti = tsift._distance_topk(torch.from_numpy(q), torch.from_numpy(t))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_valid", [0, 1, 2, 50, 96])
def test_device_match_topk_matches_jax(n_valid):
    """Scene rows past n_valid are masked to the far sentinel (so a scene
    with fewer than two descriptors never passes the ratio test)."""
    q, t = descriptor_sets()["random"]
    jprep = jsift.prepare_descriptors(q, "query")
    tprep = tsift.prepare_descriptors(q, "query", "cpu")
    assert tprep[1] == jprep[1] and tuple(tprep[0].shape) == tuple(jprep[0].shape)
    jd, ji = (np.asarray(a) for a in jsift.device_match_topk(jprep, jnp.asarray(t), n_valid))
    td, ti = tsift.device_match_topk(tprep, torch.from_numpy(t), torch.tensor(n_valid, dtype=torch.int32))
    nq = tprep[1]
    np.testing.assert_array_equal(ti.numpy()[:nq], ji[:nq])
    np.testing.assert_allclose(td.numpy()[:nq], jd[:nq], rtol=1e-4, atol=1e-5)


def test_match_descriptors_matches_jax():
    rng = np.random.default_rng(5)
    t = unit_rows(rng, 150)
    q = t[rng.permutation(150)[:70]] + rng.normal(0, 0.02, (70, 128)).astype(np.float32)
    q = np.concatenate([q, unit_rows(rng, 30)])  # 30 with no true partner
    want = jsift.match_descriptors(q, t, 0.7)
    got = tsift.match_descriptors(q, t, 0.7)
    assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in want] and len(got) >= 60
    np.testing.assert_allclose([d for *_, d in got], [d for *_, d in want], rtol=1e-5)
    prep = tsift.prepare_descriptors(q, "query", "cpu")
    assert tsift.match_descriptors(None, t, 0.7, query_prep=prep) == got
    assert tsift.match_descriptors(q[:1], t[:1]) == []


def correspondences(seed, n, outliers=0.3):
    rng = np.random.default_rng(seed)
    src = rng.random((n, 2)) * 300
    H = np.array([[1.1, 0.05, 20], [0.02, 0.95, -10], [1e-4, 2e-4, 1]])
    dst = np.c_[src, np.ones(n)] @ H.T
    dst = dst[:, :2] / dst[:, 2:]
    out = rng.random(n) < outliers
    dst[out] += rng.normal(0, 30, (out.sum(), 2))
    return src, dst + rng.normal(0, 1.5, dst.shape)


RANSAC_CASES = {
    **{f"seed{s}_n{n}": (lambda s=s, n=n: correspondences(s, n)) for s, n in ((1, 4), (2, 9), (3, 60), (4, 200))},
    "three_points": lambda: correspondences(5, 3),
    "collinear": lambda: (np.c_[np.arange(20.0), np.arange(20.0)], np.c_[np.arange(20.0), 2 * np.arange(20.0)]),
    "all_same_point": lambda: (np.ones((12, 2)), np.ones((12, 2)) * 5),
}


@pytest.mark.parametrize("case", list(RANSAC_CASES))
def test_ransac_homography_matches_jax(case):
    src, dst = RANSAC_CASES[case]()
    Hj, mj = jsift.ransac_homography(src, dst, seed=0)
    Ht, mt = tsift.ransac_homography(src, dst, seed=0)
    np.testing.assert_array_equal(mt, mj)
    assert (Ht is None) == (Hj is None)
    if Hj is not None:
        np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tsift.solve_minimal_sets(src, dst, 16, 0) if len(src) >= 4 else 0,
        jsift.solve_minimal_sets(src, dst, 16, 0) if len(src) >= 4 else 0,
    )


@pytest.fixture(scope="module")
def matchers():
    """The builtin template described by each package's device detector."""
    template = bgr_to_gray_np(np.asarray(bin_texture()))
    j = jsift.SIFT(detector="device")
    t = tsift.SIFT(detector="device", device="cpu")
    j.add_source("bin", template)
    t.add_source("bin", template)
    return j, t


@pytest.mark.parametrize("t", [1.0, 3.0])
def test_match_device_topk_on_the_bins_scene_matches_jax(matchers, t):
    """Detect, describe and 2-NN on the scene, ratio test and RANSAC on the
    host: the same quad (within 1 px), matches and inliers."""
    from cuauv_vision_pipeline_tpu.ops.feature import detect_describe_jit

    from cuauv_vision_pipeline_tpu_torch.ops.feature import detect_describe

    jm, tm = matchers
    gray = bgr_to_gray_np(bins_frame((720, 1280), t))
    kp, des, n = detect_describe_jit(jnp.asarray(gray), 512)
    jd2, jidx = jsift.device_match_topk(jm.sources["bin"]["des_prep"], des, n)
    want = jm.match_device_topk("bin", np.asarray(jd2), np.asarray(jidx), np.asarray(kp), min_match=8)
    kp, des, n = detect_describe(torch.from_numpy(gray))
    td2, tidx = tsift.device_match_topk(tm.sources["bin"]["des_prep"], des, n)
    got = tm.match_device_topk("bin", td2.numpy(), tidx.numpy(), kp.numpy(), min_match=8)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0]["quad"], want[0]["quad"], atol=1)
    assert got[0]["matches"] == want[0]["matches"] and got[0]["inliers"] == want[0]["inliers"] >= 8


def test_sift_match_on_host_features(matchers):
    """match() detects the scene itself (the device detector on the CPU)."""
    _, tm = matchers
    gray = bgr_to_gray_np(bins_frame((720, 1280), 2.0))
    got = tm.match(gray, min_match=8)
    assert len(got) == 1 and got[0]["inliers"] >= 8
    tm.warm()  # nothing to compile: a no-op


def test_builtin_detector_matches_jax():
    """The host fallback detector (Shi-Tomasi corners + axis-aligned
    histograms): the same keypoints, descriptors within 1e-5."""
    gray = bgr_to_gray_np(np.asarray(bin_texture()))
    kj, dj = jsift._builtin_detect_and_compute(gray, 200)
    kt, dt = tsift._builtin_detect_and_compute(gray, 200)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)


def test_cv2_method_falls_back_to_builtin(monkeypatch):
    """Where cv2 cannot be imported, method="cv2" is the builtin detector."""
    import builtins

    real = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    gray = bgr_to_gray_np(np.asarray(bin_texture()))
    kp, des = tsift.detect_and_compute(gray, 200, method="cv2")
    kb, db = tsift._builtin_detect_and_compute(gray, 200)
    np.testing.assert_array_equal(kp, kb)
    np.testing.assert_array_equal(des, db)

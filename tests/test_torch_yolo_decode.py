"""The port's YOLO decode and greedy NMS against the JAX package's, on
identical numpy inputs (CPU: the port's plain torch NMS).

Tolerances: ``valid``, ``cls`` and NMS picks exact; ``xyxy``, ``angle`` and
``score`` within rtol = atol = 1e-5 (float32 softmax/exp/cos of two
libraries). The tie-heavy case pins the pool order (equal scores lowest
anchor first, as ``jax.lax.top_k``): a pool taken with ``torch.topk`` fails
it, which the test shows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from nms_cases import cases as nms_cases
from nms_cases import poles
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.models.yolo import decode as jdecode
from cuauv_vision_pipeline_tpu_torch.models.yolo import decode as tdecode
from cuauv_vision_pipeline_tpu_torch.ops.cuda.nms_kernel import nms_fixed_plain

IMAGE = 128
NC = 3


def head_outputs(seed, task, cls_logits):
    """Per-scale NHWC head maps (numpy) at IMAGE: box N(0, 2) DFL logits,
    ``cls_logits(rng, shape)`` class logits, obb angle logits N(0, 1)."""
    rng = np.random.default_rng(seed)
    out = {"box": [], "cls": []}
    if task == "obb":
        out["angle"] = []
    for stride in jdecode.STRIDES:
        n = IMAGE // stride
        out["box"].append(rng.normal(0, 2, (1, n, n, 64)).astype(np.float32))
        out["cls"].append(cls_logits(rng, (1, n, n, NC)).astype(np.float32))
        if task == "obb":
            out["angle"].append(rng.normal(0, 1, (1, n, n, 1)).astype(np.float32))
    return out


def _fewer(rng, shape):
    """Five above-threshold anchors, all on the stride-8 scale."""
    logits = np.full(shape, -8.0)
    if shape[1] != IMAGE // 8:
        return logits
    flat = logits.reshape(-1, shape[-1])
    rows = rng.choice(flat.shape[0], 5, replace=False)
    flat[rows, rng.integers(0, shape[-1], 5)] = rng.uniform(0.5, 3, 5)
    return logits


DECODE_CASES = {
    # few distinct logits: many anchors share their score exactly
    "tie_heavy": (lambda rng, s: rng.choice([-3.0, 0.25, 1.0, 2.0], s), {}),
    # more candidates above the threshold than the pool holds
    "pool_overflow": (lambda rng, s: rng.normal(1.0, 1.0, s), {"nms_pool": 16}),
    "fewer_than_max_det": (_fewer, {}),
    "all_below_threshold": (lambda rng, s: rng.normal(-8.0, 0.5, s), {}),
}


def run_both(outputs, **kw):
    j = jdecode.decode({k: [jnp.asarray(m) for m in v] for k, v in outputs.items()}, IMAGE, **kw)
    t = tdecode.decode({k: [torch.from_numpy(m) for m in v] for k, v in outputs.items()}, IMAGE, **kw)
    return {k: np.asarray(v) for k, v in j.items()}, {k: v[0].numpy() for k, v in t.items()}


def assert_same(j, t):
    assert set(j) == set(t)
    np.testing.assert_array_equal(t["valid"].astype(bool), j["valid"])
    np.testing.assert_array_equal(t["cls"], j["cls"])
    for key in ("xyxy", "score", "angle"):
        if key in j:
            np.testing.assert_allclose(t[key], j[key], rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("task", ["detect", "obb"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_jax(case, task):
    logits, kw = DECODE_CASES[case]
    outputs = head_outputs(3, task, logits)
    j, t = run_both(outputs, max_det=32, **kw)
    assert_same(j, t)
    n_valid = int(j["valid"].sum())
    if case == "all_below_threshold":
        assert n_valid == 0
    elif case == "fewer_than_max_det":  # five candidates, overlaps may merge some
        assert 1 <= n_valid <= 5
    else:
        assert n_valid > 5


@pytest.mark.parametrize("task", ["detect", "obb"])
def test_tie_heavy_pool_order_is_lax_top_k(task, monkeypatch):
    """Equal scores enter the pool lowest anchor first; with torch.topk's
    order the same decode picks other anchors, and the comparison fails."""
    outputs = head_outputs(3, task, DECODE_CASES["tie_heavy"][0])
    j, _ = run_both(outputs, max_det=32)
    monkeypatch.setattr(tdecode, "_top_pool", lambda s, n: torch.topk(s, n, dim=1))
    _, t = run_both(outputs, max_det=32)
    with pytest.raises(AssertionError):
        assert_same(j, t)


def test_anchor_order_is_nhwc_row_major():
    """Anchors flatten from NHWC maps as the JAX package's: the same rows,
    centers and strides; flattening the NCHW conv output unpermuted would
    put every anchor elsewhere."""
    outputs = head_outputs(5, "obb", lambda rng, s: rng.normal(0, 1, s))
    jflat = jdecode._flatten_scales({k: [jnp.asarray(m) for m in v] for k, v in outputs.items()}, IMAGE)
    tflat = tdecode._flatten_scales({k: [torch.from_numpy(m) for m in v] for k, v in outputs.items()})
    for key in ("box", "cls", "angle", "centers", "strides"):
        np.testing.assert_array_equal(tflat[key].numpy(), np.asarray(jflat[key]), err_msg=key)
    nchw = torch.cat([torch.from_numpy(m).permute(0, 3, 1, 2).reshape(1, -1, m.shape[-1])
                      for m in outputs["cls"]], 1)
    assert not torch.equal(nchw, tflat["cls"])


_jnms = jax.jit(jdecode.nms_fixed, static_argnames=("iou_thresh", "max_det", "class_aware"))


@pytest.mark.parametrize("rotated", [True, False], ids=["probiou", "aabb"])
@pytest.mark.parametrize("case", list(nms_cases(small=True)))
def test_nms_plain_matches_jax(case, rotated):
    boxes, scores, classes, angles, max_det = nms_cases(small=True)[case]
    got = nms_fixed_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(classes), max_det=max_det,
                          angles=torch.from_numpy(angles) if rotated else None)
    for b in range(scores.shape[0]):
        want = _jnms(boxes[b], scores[b], classes[b], max_det=max_det,
                     angles=angles[b] if rotated else None)
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("rotated", [True, False], ids=["probiou", "aabb"])
def test_nms_nan_score_means_no_picks(rotated):
    """argmax takes NaN as the largest score (torch and jnp alike), so every
    round picks the NaN, finds it not > 0 and picks nothing: a pool with a
    NaN has no picks, though 0.9 and 0.5 lie far apart."""
    boxes = np.float32([[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50]])
    scores = np.float32([0.9, np.nan, 0.5])
    classes = np.zeros(3, np.int32)
    angles = np.zeros(3, np.float32)
    got = nms_fixed_plain(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes),
                          max_det=3, angles=torch.from_numpy(angles) if rotated else None)
    want = _jnms(boxes, scores, classes, max_det=3, angles=angles if rotated else None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].tolist() == [-1, -1, -1] and not got[1].any()
    scores[1] = 0.7  # without the NaN all three are picks
    assert nms_fixed_plain(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes),
                           max_det=3)[0].tolist() == [0, 1, 2]


def test_nms_rotated_poles_kept_aabb_merged():
    boxes, scores, classes, angles = (torch.from_numpy(a[0]) for a in poles(1)[:4])
    _, valid_rot = nms_fixed_plain(boxes, scores, classes, max_det=2, angles=angles)
    assert valid_rot.tolist() == [True, True]
    corners = tdecode.obb_corners(boxes.numpy(), angles.numpy())
    aabbs = torch.from_numpy(np.concatenate([corners.min(1), corners.max(1)], -1))
    _, valid_aabb = nms_fixed_plain(aabbs, scores, classes, max_det=2)
    assert valid_aabb.tolist() == [True, False]


def test_nms_class_aware_and_budget():
    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [0, 0, 10, 10], [50, 50, 60, 60]],
                         dtype=torch.float32)
    scores = torch.tensor([0.9, 0.8, 0.7, -0.5])
    picked, valid = nms_fixed_plain(boxes, scores, torch.tensor([0, 0, 1, 0], dtype=torch.int32),
                                    max_det=4)
    assert picked.tolist() == [0, 2, -1, -1] and valid.tolist() == [True, True, False, False]
    picked, _ = nms_fixed_plain(boxes, scores, torch.zeros(4, dtype=torch.int32), max_det=4,
                                class_aware=False)
    assert picked.tolist() == [0, -1, -1, -1]


@pytest.mark.parametrize("task", ["detect", "obb"])
def test_summarize_and_corners_equal_jax(task):
    outputs = head_outputs(7, task, lambda rng, s: rng.normal(0.5, 1.0, s))
    j, t = run_both(outputs, max_det=16)
    names = ["a", "b", "c"]
    kw = dict(scale=(2.5, 2.5), task=task, pad=(3.0, 17.0), clip_wh=(300.0, 200.0))
    assert tdecode.summarize(j, names, **kw) == jdecode.summarize(j, names, **kw)
    # the port's own decode summarises alike (a bool or 0/1 valid)
    t["valid"] = t["valid"].astype(np.uint8)
    got = tdecode.summarize(t, names, **kw)
    want = jdecode.summarize(j, names, **kw)
    assert [e["class"] for e in got] == [e["class"] for e in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(list(g["box"].values()), list(w["box"].values()), atol=1e-3)
    if task == "obb":
        np.testing.assert_array_equal(tdecode.obb_corners(j["xyxy"], j["angle"]),
                                      jdecode.obb_corners(j["xyxy"], j["angle"]))

"""The CUDA greedy-NMS kernel (``nms_fixed_cuda``, ``csrc/nms.cu``) against
its plain version (``ops.cuda.nms_kernel.nms_fixed_plain``, torch ops on
the same card tensors): the pools of ``tests/nms_cases.py`` (seeded pools of
1 to 8400 candidates, exact score ties, all scores below the threshold,
fewer candidates than ``max_det``, the rotated poles, a NaN, -inf and
negative scores, pools sorted as decode hands them over, ties across the
walk's 32-candidate chunks, picks deep in the order, the merge's padded
pool, ``max_det`` > P), one image and eight; ProbIoU and AABB IoU,
class-aware or not, each launched twice. Then the kernel's edges: the
1024-candidate batch it orders at a time (P = 1023, 1024, 1025, sorted or
not), picks past the 1024 kept in shared memory, P = 20000 and 58112, B = 8
rows with different numbers of survivors, one launch per call.
``picked`` and ``valid`` must be equal exactly.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_nms_cuda.py
"""

import numpy as np
import pytest
import torch
from nms_cases import cases
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.models.yolo.decode import decode
from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda
from cuauv_vision_pipeline_tpu_torch.ops.cuda.nms_kernel import _MAX_POOL, nms_fixed_plain

pytestmark = pytest.mark.cuda

CASES = cases()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("class_aware", [True, False], ids=["class_aware", "any_class"])
@pytest.mark.parametrize("rotated", [True, False], ids=["probiou", "aabb"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain(dev, case, rotated, class_aware):
    boxes, scores, classes, angles, max_det = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a for a in CASES[case])
    angles = angles if rotated else None
    want = nms_fixed_plain(boxes, scores, classes, 0.45, max_det, class_aware, angles)
    for _ in range(2):
        got = nms_fixed_cuda(boxes, scores, classes, angles, 0.45, max_det, class_aware)
        torch.cuda.synchronize()
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case.startswith("rotated_poles") and rotated:
        assert got[1].all()  # ProbIoU keeps both poles
    if case.startswith("all_below"):
        assert not got[1].any()


def assert_equal_to_plain(dev, arrays, rotated, max_det, class_aware=True):
    """Launch the kernel once on card copies of numpy ``arrays`` (boxes,
    scores, classes, angles) and hold it against the plain version;
    returns the kernel's (picked, valid)."""
    boxes, scores, classes, angles = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)
    angles = angles if rotated else None
    want = nms_fixed_plain(boxes, scores, classes, 0.45, max_det, class_aware, angles)
    before = nms_fixed_cuda.launches
    got = nms_fixed_cuda(boxes, scores, classes, angles, 0.45, max_det, class_aware)
    torch.cuda.synchronize()
    assert nms_fixed_cuda.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.parametrize("rotated", [True, False], ids=["probiou", "aabb"])
def test_pool_past_48kb_of_shared_memory(dev, rotated):
    """20000 candidates, unsorted (a 1024-px model has 21504 anchors): the
    kernel orders them 1024 at a time (a radix select, then a sort); the
    round-per-pick design kept all their scores in 80 KB of shared memory."""
    from nms_cases import pool

    got = assert_equal_to_plain(dev, pool(np.random.default_rng(3), 1, 20000), rotated, 32)
    assert got[1].all()


def spread_pool(rng, B, P, sort):
    """P candidates, all scores > 0, so the kernel orders all P: boxes in
    clusters (suppression happens) and, with ``sort``, in decode's order."""
    from nms_cases import pool, sorted_like_top_pool

    boxes, scores, classes, angles = pool(rng, B, P)
    scores = rng.uniform(0.3, 1.0, (B, P)).astype(np.float32)
    arrays = (boxes, scores, classes, angles)
    return sorted_like_top_pool(*arrays) if sort else arrays


@pytest.mark.parametrize("rotated", [True, False], ids=["probiou", "aabb"])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("P", [1023, 1024, 1025, 2049])
def test_batch_edges(dev, P, sort, rotated):
    """The kernel orders and walks 1024 candidates at a time: one batch
    below and at 1024, a radix-selected first batch and a second one
    above. max_det 1024 makes the walk reach past the first batch."""
    got = assert_equal_to_plain(dev, spread_pool(np.random.default_rng(P), 1, P, sort), rotated, 1024)
    assert got[1].any()


def grid_pool(P):
    """P small boxes on a 30-px grid, none overlapping: every positive
    candidate is a pick."""
    rng = np.random.default_rng(P)
    cols = 256
    ys, xs = np.divmod(np.arange(P), cols)
    boxes = np.stack([xs * 30.0, ys * 30.0, xs * 30.0 + 10, ys * 30.0 + 8], -1)[None].astype(np.float32)
    scores = rng.uniform(0.3, 1.0, (1, P)).astype(np.float32)
    classes = rng.integers(0, 3, (1, P)).astype(np.int32)
    angles = rng.uniform(0, 1, (1, P)).astype(np.float32)
    return boxes, scores, classes, angles


@pytest.mark.parametrize("rotated", [True, False], ids=["probiou", "aabb"])
@pytest.mark.parametrize("max_det", [1024, 1025, 1100, 1500])
def test_picks_past_shared_memory(dev, max_det, rotated):
    """More than 1024 picks keep their IoU terms in a global scratch (the
    wrapper allocates it past ``nms_shared_picks``); 1100 candidates that
    do not overlap are all picks."""
    got = assert_equal_to_plain(dev, grid_pool(1100), rotated, max_det)
    assert int(got[1].sum()) == min(max_det, 1100)


@pytest.mark.parametrize("rotated", [True, False], ids=["probiou", "aabb"])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("P", [20000, _MAX_POOL])
def test_large_pools(dev, P, sort, rotated):
    """The largest pools the wrapper takes, in decode's order (the pool
    disabled) and unsorted."""
    from nms_cases import pool, sorted_like_top_pool

    arrays = pool(np.random.default_rng(P), 1, P)
    got = assert_equal_to_plain(dev, sorted_like_top_pool(*arrays) if sort else arrays, rotated, 32)
    assert got[1].all()


@pytest.mark.parametrize("class_aware", [True, False], ids=["class_aware", "any_class"])
@pytest.mark.parametrize("rotated", [True, False], ids=["probiou", "aabb"])
def test_rows_with_different_survivors(dev, rotated, class_aware):
    """B = 8 rows, each block on its own: row b keeps 6b + 1 positive
    scores (row 7 all but one), row 3 holds a NaN (no picks), row 5 none
    above zero."""
    from nms_cases import pool

    rng = np.random.default_rng(8)
    boxes, scores, classes, angles = pool(rng, 8, 600)
    scores = rng.uniform(0.3, 1.0, (8, 600)).astype(np.float32)
    for b in range(7):
        scores[b, 6 * b + 1:] = 0.0
    scores[7, 17] = 0.0
    scores[3, 2] = np.nan
    scores[5] = 0.0
    got = assert_equal_to_plain(dev, (boxes, scores, classes, angles), rotated, 32, class_aware)
    n = got[1].sum(1).tolist()
    assert n[3] == 0 and n[5] == 0 and n[0] == 1 and len(set(n)) >= 5


def test_decode_on_the_card_launches_the_kernel(dev):
    rng = np.random.default_rng(0)
    outputs = {"box": [], "cls": [], "angle": []}
    for n in (80, 40, 20):
        outputs["box"].append(torch.from_numpy(rng.normal(0, 2, (2, n, n, 64)).astype(np.float32)))
        outputs["cls"].append(torch.from_numpy(rng.normal(0, 1, (2, n, n, 15)).astype(np.float32)))
        outputs["angle"].append(torch.from_numpy(rng.normal(0, 1, (2, n, n, 1)).astype(np.float32)))
    want = decode(outputs, 640)
    before = nms_fixed_cuda.launches
    got = decode({k: [m.to(dev) for m in v] for k, v in outputs.items()}, 640)
    assert nms_fixed_cuda.launches == before + 1
    assert torch.equal(got["valid"].cpu(), want["valid"]) and torch.equal(got["cls"].cpu(), want["cls"])
    for key in ("xyxy", "score", "angle"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4, atol=1e-3)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    boxes = torch.zeros((1, 4, 4), device=dev)
    scores = torch.ones((1, 4), device=dev)
    classes = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    before = nms_fixed_cuda.launches
    with pytest.raises(TypeError, match="classes must be torch.int32"):
        nms_fixed_cuda(boxes, scores, torch.zeros((1, 4), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="boxes_xyxy must have shape"):
        nms_fixed_cuda(boxes[:, :3], scores, classes)
    with pytest.raises(ValueError, match="non-empty"):
        nms_fixed_cuda(boxes[0], scores[0], classes[0])
    with pytest.raises(ValueError, match="max_det >= 1"):
        nms_fixed_cuda(boxes, scores, classes, max_det=0)
    big = _MAX_POOL + 1
    with pytest.raises(ValueError, match=f"P <= {_MAX_POOL}"):
        nms_fixed_cuda(torch.zeros((1, big, 4), device=dev), torch.ones((1, big), device=dev),
                       torch.zeros((1, big), dtype=torch.int32, device=dev))
    with pytest.raises(TypeError, match="angles must be torch.float32"):
        nms_fixed_cuda(boxes, scores, classes, torch.zeros((1, 4), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="scores must be a CUDA or CPU tensor"):
        nms_fixed_cuda(boxes.to("meta"), scores.to("meta"), classes.to("meta"))
    assert nms_fixed_cuda.launches == before

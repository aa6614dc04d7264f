"""The CUDA greedy-NMS kernel (``nms_fixed_cuda``, ``csrc/nms.cu``) against
its plain version (``ops.cuda.nms_kernel.nms_fixed_plain``, torch ops on
the same card tensors): seeded pools of 1 to 8400 candidates, exact score
ties, all scores below the threshold, fewer candidates than ``max_det``,
the rotated poles, one image and eight; ProbIoU and AABB IoU, class-aware
or not, each launched twice. ``picked`` and ``valid`` must be equal
exactly.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_nms_cuda.py
"""

import numpy as np
import pytest
import torch
from nms_cases import cases

from cuauv_vision_pipeline_tpu_torch.models.yolo.decode import decode
from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda
from cuauv_vision_pipeline_tpu_torch.ops.cuda.nms_kernel import nms_fixed_plain

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


@pytest.mark.parametrize("rotated", [True, False], ids=["probiou", "aabb"])
def test_pool_past_48kb_of_shared_memory(dev, rotated):
    """20000 alive scores need 80 KB of shared memory: the launch opts in
    to more than the default 48 KB (a 1024-px model has 21504 anchors)."""
    from nms_cases import pool

    boxes, scores, classes, angles = (torch.from_numpy(a).to(dev)
                                      for a in pool(np.random.default_rng(3), 1, 20000))
    angles = angles if rotated else None
    want = nms_fixed_plain(boxes, scores, classes, 0.45, 32, True, angles)
    got = nms_fixed_cuda(boxes, scores, classes, angles, 0.45, 32)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].all()


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
    with pytest.raises(TypeError, match="classes must be torch.int32"):
        nms_fixed_cuda(boxes, scores, torch.zeros((1, 4), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="boxes_xyxy must have shape"):
        nms_fixed_cuda(boxes[:, :3], scores, torch.zeros((1, 4), dtype=torch.int32, device=dev))

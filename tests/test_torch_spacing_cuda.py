"""The CUDA spacing kernel (``spacing_select``, ``csrc/spacing.cu``) against
its plain version (``spacing_select_plain``, torch ops on the same card
tensors): every K the block shape changes at (1 to 1024), threads owning
several candidates (K = 1025, 2048, 4096), no candidate, dense 3-px
grids, exact-tie plateaus, repeated points, other min_distances, and the
bins scenes' and the template's own candidates at K = 512, 2048 and 4096;
each launched twice, kept sets exact. Inputs the kernel does not take
raise; each launch counts once; ``detect_describe`` on the card launches it
once per call and keeps the CPU's keypoints, at K = 512 and 2048.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spacing_cuda.py
"""

import numpy as np
import pytest
import torch
from spacing_cases import cases, greedy
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import bin_texture, bins_frame
from cuauv_vision_pipeline_tpu_torch.ops.color_np import bgr_to_gray_np
from cuauv_vision_pipeline_tpu_torch.ops.cuda.spacing_kernel import spacing_select, spacing_select_plain
from cuauv_vision_pipeline_tpu_torch.ops.feature import detect_candidates, detect_describe

pytestmark = pytest.mark.cuda

CASES = cases()
GRAYS = {
    **{f"bins_720p_t{t}": (lambda t=t: bgr_to_gray_np(bins_frame((720, 1280), t))) for t in (0.0, 1.0, 2.5, 4.0)},
    "template": lambda: bgr_to_gray_np(np.asarray(bin_texture())),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def check(ys, xs, cand, md):
    want = spacing_select_plain(ys, xs, cand, md)
    for _ in range(2):
        got = spacing_select(ys, xs, cand, md)
        torch.cuda.synchronize()
        assert got.dtype == torch.bool and torch.equal(got, want)
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain(dev, case):
    ys, xs, cand, md = CASES[case]
    got = check(*(torch.from_numpy(a).to(dev) for a in (ys, xs, cand)), md)
    np.testing.assert_array_equal(got.cpu().numpy(), greedy(ys, xs, cand, md))


@pytest.mark.parametrize("name", list(GRAYS))
def test_kernel_equals_plain_on_scene_candidates(dev, name):
    ys, xs, cand = detect_candidates(torch.from_numpy(GRAYS[name]()).to(dev))
    assert int(cand.sum()) > 0
    check(ys, xs, cand, 8)


@pytest.mark.parametrize("K", [2048, 4096])
def test_kernel_equals_plain_on_a_scenes_top_k(dev, K):
    ys, xs, cand = detect_candidates(torch.from_numpy(GRAYS["bins_720p_t1.0"]()).to(dev), max_keypoints=K)
    assert cand.shape == (K,) and int(cand.sum()) > 0
    check(ys, xs, cand, 8)


def test_launch_count(dev):
    ys, xs, cand, md = (torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
                        for a in CASES["random_k512"])
    before = spacing_select.launches
    spacing_select(ys, xs, cand, md)
    assert spacing_select.launches == before + 1
    spacing_select_plain(ys, xs, cand, md)
    assert spacing_select.launches == before + 1


def test_rejects_what_the_kernel_does_not_take(dev):
    ys, xs, cand, md = (torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
                        for a in CASES["random_k1024"])
    with pytest.raises(TypeError):
        spacing_select(ys.long(), xs, cand, md)
    with pytest.raises(TypeError):
        spacing_select(ys, xs, cand.to(torch.uint8), md)
    with pytest.raises(ValueError, match="contiguous"):
        spacing_select(ys[::2], xs[::2].contiguous(), cand[::2].contiguous(), md)
    # K = 2048 is taken: exact as any K
    check(torch.cat([ys, ys]), torch.cat([xs, xs]), torch.cat([cand, cand]), md)
    with pytest.raises(ValueError, match="1 <= K"):
        spacing_select(ys[:0], xs[:0], cand[:0], md)
    with pytest.raises(ValueError, match="is on"):
        spacing_select(ys.cpu(), xs, cand, md)
    with pytest.raises(ValueError, match="min_distance"):
        spacing_select(ys, xs, cand, -1)


def check_describe(dev, K):
    """detect_describe on the card launches the kernel once and keeps the
    CPU's keypoints."""
    gray = torch.from_numpy(GRAYS["bins_720p_t1.0"]())
    before = spacing_select.launches
    kp, des, n = detect_describe(gray.to(dev), max_keypoints=K)
    assert spacing_select.launches == before + 1
    kp_cpu, des_cpu, n_cpu = detect_describe(gray, max_keypoints=K)
    assert int(n) == int(n_cpu) > 0
    assert torch.equal(kp.cpu(), kp_cpu)
    # rows whose dominant orientation flips on an atan2 ulp may differ more
    close = ((des.cpu() - des_cpu).abs().max(dim=1).values <= 1e-5).float().mean()
    assert close >= 0.95


def test_detect_describe_launches_once_and_keeps_the_cpus_keypoints(dev):
    check_describe(dev, 512)


def test_detect_describe_past_1024_keypoints_keeps_the_cpus_keypoints(dev):
    check_describe(dev, 2048)

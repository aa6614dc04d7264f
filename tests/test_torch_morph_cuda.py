"""The fused morphology kernel (``fused_morph``, ``csrc/morph.cu``) against
its plain version (``fused_morph_plain``, the composed ``ops.morphology``
calls) on the card: graded u8 values, ragged widths and heights, a view at
an odd address, B=8 stacks whose images differ at their seams, the buoy
masks and four ``max_pool2d`` calls. Exact equality throughout.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_morph_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
from cuauv_vision_pipeline_tpu_torch.engine.chains import red_buoy_fused
from cuauv_vision_pipeline_tpu_torch.ops.cuda.morph_kernel import fused_morph, fused_morph_plain

pytestmark = pytest.mark.cuda

H, W = 1080, 1920
OPS = ["open_close", "open", "close"]
SHAPES = [(H, W), (40, 130)] + [(h, w) for h in (1, 1079) for w in (1, 3, 5, 129, 1917)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def graded(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def check(mask, op):
    got = fused_morph(mask, op)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == mask.shape
    assert torch.equal(got, fused_morph_plain(mask, op))
    return got


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_graded_values(dev, shape, op):
    check(torch.from_numpy(graded(1, shape)).to(dev), op)


@pytest.mark.parametrize("op", OPS)
def test_ramp_and_binary_1080p(dev, op):
    ramp = (np.add.outer(3 * np.arange(H), 2 * np.arange(W)) // 16 % 256).astype(np.uint8)
    check(torch.from_numpy(ramp).to(dev), op)
    binary = (graded(2, (H, W)) < 128).astype(np.uint8) * 255
    check(torch.from_numpy(binary).to(dev), op)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shape", [(H, W), (1079, 1917)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_odd_address_takes_byte_loads(dev, shape, op):
    flat = torch.from_numpy(graded(3, shape[0] * shape[1] + 1)).to(dev)
    odd = flat[1:].view(shape)
    assert odd.data_ptr() % 4 and odd.is_contiguous()
    check(odd, op)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shape", [(H, W), (1079, 1917), (37, 129)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_stack_equals_each_image(dev, shape, op):
    """Even images end bright, odd ones start dark: a row read across an
    image seam shows in the next erode or dilate."""
    stack = graded(4, (8, *shape))
    stack[0::2, -3:] = 255
    stack[1::2, :3] = 0
    stack = torch.from_numpy(stack).to(dev)
    got = check(stack, op)
    for b in range(stack.shape[0]):
        assert torch.equal(got[b], fused_morph(stack[b], op))


@pytest.mark.parametrize("op", OPS)
def test_buoy_masks(dev, op):
    frames = torch.from_numpy(np.stack([buoy_frame((H, W), 0.4 * i) for i in range(8)])).to(dev)
    masks = red_buoy_fused(frames, 140, 255)[0]
    check(masks, op)
    check(masks[3], op)


def test_equals_four_max_pools(dev):
    mask = torch.from_numpy(graded(5, (H, W))).to(dev)
    x = mask.to(torch.float32).view(1, 1, H, W)
    x = -F.max_pool2d(-x, 5, stride=1, padding=2)
    x = F.max_pool2d(x, 5, stride=1, padding=2)
    x = F.max_pool2d(x, 5, stride=1, padding=2)
    x = -F.max_pool2d(-x, 5, stride=1, padding=2)
    assert torch.equal(fused_morph(mask), x.to(torch.uint8)[0, 0])


def test_one_launch_per_call(dev):
    mask = torch.zeros((8, 64, 64), dtype=torch.uint8, device=dev)
    before = fused_morph.launches
    fused_morph(mask)
    fused_morph(mask[0], "open")
    assert fused_morph.launches == before + 2


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    with pytest.raises(ValueError, match="65535"):
        fused_morph(torch.zeros((65536, 1, 1), dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError, match="65535"):
        fused_morph(torch.zeros((65535 * 16 + 1, 1), dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        fused_morph(torch.zeros((64, 64), dtype=torch.uint8, device=dev)[:, ::2])
    with pytest.raises(TypeError, match="uint8"):
        fused_morph(torch.zeros((64, 64), dtype=torch.float32, device=dev))

"""The CUDA CCL kernel (``label_cuda``, ``label_cuda_batched``) against the
plain ``ops.ccl.label`` on the card: the tile-seam masks of
tests/ccl_seam_masks.py at their small sizes and at 1080p, launched twice
(the atomics land in another order; the labels must not change). Exact
equality throughout.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ccl_cuda.py
"""

import numpy as np
import pytest
import torch
from ccl_seam_masks import SMALL, anti_diagonal, noise, seam_grid, seam_lines
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.ops.ccl import label, label_fast
from cuauv_vision_pipeline_tpu_torch.ops.cuda import label_cuda, label_cuda_batched

pytestmark = pytest.mark.cuda

H, W = 1080, 1920
FULL = {
    "all_fg_1080p": lambda: np.full((H, W), 255, np.uint8),
    "noise45_1080p": lambda: noise(3, 0.45, (H, W)),
    "anti_diagonal_1080p": lambda: anti_diagonal((H, W)),
    "row_seams_1080p": lambda: seam_lines((H, W), 0),
    "column_seams_1080p": lambda: seam_lines((H, W), 1),
    "seam_grid_1079x1917": lambda: seam_grid((1079, 1917)),
    "noise50_1079x1917": lambda: noise(4, 0.5, (1079, 1917)),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def check(got, want):
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("case", list(SMALL) + list(FULL))
def test_label_cuda_equals_plain(dev, case, connectivity):
    mask = torch.from_numpy({**SMALL, **FULL}[case]()).to(dev)
    first = label_cuda(mask, connectivity)
    check(first, label(mask, connectivity))
    check(label_cuda(mask, connectivity), first)


def test_batched_equals_plain_across_image_seams(dev):
    """Each image's last and the next one's first row are foreground; a
    column joins them, so each image is one component with root 0."""
    masks = torch.zeros((8, H, W), dtype=torch.uint8, device=dev)
    masks[:, 0] = 255
    masks[:, -1] = 255
    masks[:, :, W // 2] = 255
    got = label_cuda_batched(masks)
    check(got, label(masks))
    assert (got[masks != 0] == 0).all()
    check(label_fast(masks), got)


@pytest.mark.parametrize("case", ["all_fg_1080p", "noise45_1080p", "anti_diagonal_1080p"])
def test_batched_equals_per_image(dev, case):
    masks = torch.from_numpy(np.stack([FULL[case]()] * 4)).to(dev)
    masks[1] = masks[1].flip(1)
    got = label_cuda_batched(masks)
    check(got, label(masks))
    for b in range(masks.shape[0]):
        check(got[b], label_cuda(masks[b]))


def test_unaligned_mask_takes_byte_loads(dev):
    """A mask at an odd address (W a multiple of 4) loads byte by byte."""
    base = torch.from_numpy(noise(5, 0.5, (65, 129))).to(dev)
    odd = base.flatten()[1 : 1 + 64 * 128].view(64, 128)
    assert odd.data_ptr() % 4 and odd.is_contiguous()
    check(label_cuda(odd), label(odd))
    check(label_cuda_batched(odd[None]), label(odd[None]))
    with pytest.raises(ValueError, match="contiguous"):
        label_cuda(base[:, ::2])

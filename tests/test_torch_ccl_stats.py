"""The port's batched labelling, blob statistics and fused morphology against
the JAX package on the CPU, and the kernel wrappers' CPU routing."""

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.ops import ccl as jccl
from cuauv_vision_pipeline_tpu.ops.pallas.ccl_kernel import label_pallas_batched
from cuauv_vision_pipeline_tpu.ops.pallas.morph_kernel import fused_morph as jfused_morph
from cuauv_vision_pipeline_tpu_torch.ops import ccl as tccl
from cuauv_vision_pipeline_tpu_torch.ops.cuda import (
    fused_morph,
    label_cuda,
    label_cuda_batched,
    launch_counts,
)
from cuauv_vision_pipeline_tpu_torch.ops.cuda.morph_kernel import fused_morph_plain
from test_torch_ccl import blobs, exact_labels, noise, spiral


def test_batched_matches_per_image_and_pallas():
    masks = np.stack([blobs(s, shape=(72, 96)) for s in (3, 4, 5)])
    masks[0, 0] = 255  # components touching the stack seams
    masks[0, -1] = 255
    masks[1, -1] = 255
    masks[2, 0] = 255
    got = tccl.label(torch.from_numpy(masks)).numpy()
    for b in range(masks.shape[0]):
        np.testing.assert_array_equal(got[b], exact_labels(masks[b]))
    np.testing.assert_array_equal(
        got, np.asarray(label_pallas_batched(masks, interpret=True))
    )


def test_batched_separator_never_bridges():
    masks = torch.full((2, 24, 40), 255, dtype=torch.uint8)
    got = label_cuda_batched(masks)
    assert (got == 0).all()  # each image one component with local root 0


def test_cpu_wrappers_route_to_plain_versions():
    mask = torch.from_numpy(noise(4, 0.35, shape=(40, 52)))
    before = launch_counts()
    assert torch.equal(label_cuda(mask), tccl.label(mask))
    assert torch.equal(label_cuda(mask, 4), tccl.label(mask, 4))
    assert torch.equal(label_cuda_batched(mask[None]), tccl.label(mask[None]))
    assert torch.equal(tccl.label_fast(mask), tccl.label(mask))
    assert torch.equal(fused_morph(mask, "open"), fused_morph_plain(mask, "open"))
    assert launch_counts() == before  # CPU tensors launch no kernel


@pytest.mark.parametrize("fn", [label_cuda, lambda m: fused_morph(m, "open_close")])
def test_wrappers_raise_on_non_cpu_non_cuda_tensors(fn):
    """Only CPU tensors take the plain version; any other device must launch
    the kernel or raise, never fall back."""
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.empty((8, 8), dtype=torch.uint8, device="meta"))


@pytest.mark.parametrize(
    "mask_fn,K",
    [
        (lambda: blobs(0), 8),
        (lambda: blobs(1), 32),
        (lambda: noise(5, 0.3), 8),
        (spiral, 8),  # one component: 7 padding slots match the background
    ],
)
def test_component_stats_match_jax(mask_fn, K):
    mask = mask_fn()
    labels = tccl.label(torch.from_numpy(mask))
    got = {k: v.numpy() for k, v in tccl.component_stats(labels, K).items()}
    want = {
        k: np.asarray(v)
        for k, v in jccl.component_stats(labels.numpy(), max_components=K).items()
    }
    assert got.keys() == want.keys()
    for key in ("count", "area", "bbox", "first_pixel", "valid"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # float32 sums are taken in another order
    np.testing.assert_allclose(got["centroid"], want["centroid"], rtol=1e-5, atol=1e-3)
    assert int(got["valid"].sum()) == min(K, int(got["count"]))


def test_component_stats_batched_equals_per_lane():
    masks = np.stack([blobs(s, shape=(48, 64)) for s in (6, 7)])
    labels = tccl.label(torch.from_numpy(masks))
    batched = tccl.component_stats(labels, 8)
    for b in range(2):
        lane = tccl.component_stats(labels[b], 8)
        for key, v in lane.items():
            assert torch.equal(batched[key][b], v), key


@pytest.mark.parametrize("operation", ["open_close", "open", "close"])
def test_fused_morph_plain_matches_pallas(operation):
    mask = noise(8, 0.5, shape=(70, 150))  # two Pallas strips, ragged width
    want = np.asarray(jfused_morph(mask, operation, interpret=True))
    got = fused_morph(torch.from_numpy(mask), operation).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != mask).any()


@pytest.mark.parametrize("operation", ["open_close", "open", "close"])
def test_fused_morph_graded_matches_pallas(operation):
    """Any u8 values, not only 0/255: a uniform noise and a smooth ramp."""
    rng = np.random.default_rng(9)
    noise_mask = rng.integers(0, 256, (70, 150), dtype=np.uint8)
    ramp = (np.add.outer(3 * np.arange(70), 2 * np.arange(150)) // 16 % 256).astype(np.uint8)
    for mask in (noise_mask, ramp):
        want = np.asarray(jfused_morph(mask, operation, interpret=True))
        got = fused_morph(torch.from_numpy(mask), operation).numpy()
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) > 2


@pytest.mark.parametrize("operation", ["open_close", "open", "close"])
def test_fused_morph_batch_equals_each_image(operation):
    """A [B, H, W] stack equals each image alone (the Pallas kernel takes one
    image): neighbouring images differ at their seam rows, so a row read
    across a seam would show."""
    rng = np.random.default_rng(10)
    masks = rng.integers(0, 256, (3, 40, 67), dtype=np.uint8)
    masks[0::2, -3:] = 255
    masks[1::2, :3] = 0
    got = fused_morph(torch.from_numpy(masks), operation).numpy()
    for b in range(masks.shape[0]):
        want = np.asarray(jfused_morph(masks[b], operation, interpret=True))
        np.testing.assert_array_equal(got[b], want)

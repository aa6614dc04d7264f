"""The device chains on torch tensors.

Port of ``cuauv_vision_pipeline_tpu.engine.chains``: the red_buoy chain
(``red_buoy_chain``, ``red_buoy_fused``, ``RedBuoyPipeline``; reference
modules/red_buoy.py:18-52) and the HSV mask chain (``hsv_mask_chain``,
``HsvMaskPipeline``; reference modules/bins.py:10-81) with the gray post
(``grayscale_post_chain``). PyTorch runs eagerly, so a chain is a plain
function over tensors on one device; thresholds are Python/numpy scalars (a
tuner change costs nothing). The red_buoy functions take ``[H, W, 3]`` or a
batch ``[B, H, W, 3]`` of u8 BGR frames; a batch is one dimension written
out (one CCL launch for all B frames), where the JAX package mapped the
per-frame chain over lanes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.trace import tracer
from ..ops import ccl
from ..ops import color as C
from ..ops import morphology as M
from ..ops import threshold as T
from ..ops.cuda.morph_kernel import fused_morph
from ..utils.tree import tree_map

Result = Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]


def red_buoy_chain(image, thresh_min, thresh_max, max_components: int = 32) -> Result:
    """BGR -> LAB A channel -> inRange(tuners) -> open+close with a 5x5 rect
    kernel -> connected components + stats on the *un*-cleaned mask (the
    reference runs outer_contours on `threshed`, red_buoy.py:38).

    Returns (threshed, cleaned, stats-of-largest-blob)."""
    threshed = T.in_range(C.bgr_to_lab(image)[..., 1], thresh_min, thresh_max)
    kernel = M.rect_kernel(5)
    cleaned = M.close_morph(M.open_morph(threshed, kernel), kernel)
    stats = ccl.component_stats(ccl.label_fast(threshed), max_components)
    return threshed, cleaned, ccl.best_component(stats)


def red_buoy_fused(image, thresh_min, thresh_max, max_components: int = 8) -> Result:
    """The production red_buoy hot path: colorspace -> inRange -> open/close
    morphology (the fused CUDA kernel on the card, one launch; the composed
    calls of :func:`red_buoy_chain` on the CPU) -> CCL (the CUDA union-find
    kernel on the card) -> blob reductions -> argmax. Stats run on the
    UN-cleaned mask (reference modules/red_buoy.py:38); `cleaned` is for the
    debug post. Each stage runs in a span (``chain.lab_threshold``,
    ``chain.morph``, ``chain.ccl``, ``chain.stats``) while the tracer is on."""
    with tracer.span("chain.lab_threshold"):
        threshed = T.in_range(C.bgr_to_lab(image)[..., 1], thresh_min, thresh_max)
    with tracer.span("chain.morph"):
        cleaned = fused_morph(threshed, "open_close")
    with tracer.span("chain.ccl"):
        labels = ccl.label_fast(threshed)
    with tracer.span("chain.stats"):
        best = ccl.best_component(ccl.component_stats(labels, max_components))
    return threshed, cleaned, best


class RedBuoyPipeline:
    """The red_buoy hot path on one device (``cuda:0`` unless told).

    ``run_async`` enqueues one frame and returns device tensors without
    waiting; ``run_async_batched`` runs a ``[B, H, W, 3]`` batch with one CCL
    launch for all B frames; its lane b equals ``run_async`` of frame b."""

    def __init__(self, max_components: int = 8, device=None):
        self.max_components = max_components
        self.device = resolve_device(device)

    def _on_device(self, frames) -> torch.Tensor:
        return torch.as_tensor(frames).to(self.device)

    def __call__(self, image, tmin, tmax) -> Result:
        return self.run_async(image, tmin, tmax)

    def run_async(self, image, tmin, tmax) -> Result:
        return red_buoy_fused(self._on_device(image), tmin, tmax, self.max_components)

    # [B, H, W, 3] -> per-lane (threshed, cleaned, best): the chain takes the
    # batch dimension itself, so the batched lane is the same call
    run_async_batched = run_async

    def run_sync(self, image, tmin, tmax):
        """run_async, materialized as numpy (blocking)."""
        return tree_map(lambda t: t.cpu().numpy(), self.run_async(image, tmin, tmax))


def _open(mask: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Open with a square rect kernel: the fused CUDA kernel (one launch;
    its composed plain version on the CPU) for the 5x5 it implements, the
    composed ``ops.morphology`` calls for any other size."""
    if kernel_size == 5:
        return fused_morph(mask, "open")
    return M.open_morph(mask, M.rect_kernel(kernel_size))


def hsv_mask_chain(image, lower, upper, kernel_size: int = 5, max_components: int = 32):
    """HSV inRange + open + per-component stats (the bins-module shape,
    reference modules/bins.py:10-81): BGR -> HSV -> inRange(lower, upper) ->
    open with a ``kernel_size`` rect -> labels of the cleaned mask (the
    CUDA CCL kernel on the card) -> ``component_stats``.

    Returns (mask, cleaned, stats)."""
    mask = T.in_range(C.bgr_to_hsv(image), lower, upper)
    cleaned = _open(mask, kernel_size)
    stats = ccl.component_stats(ccl.label_fast(cleaned), max_components)
    return mask, cleaned, stats


def grayscale_post_chain(image: torch.Tensor) -> torch.Tensor:
    """BGR -> gray -> back to BGR (the yolo module's inactive-object
    fallback post, reference modules/yolo.py post_grayscale)."""
    return C.gray_to_bgr(C.bgr_to_gray(image))


class HsvMaskPipeline:
    """The bins-module hot path on one device (``cuda:0`` unless told):
    :func:`hsv_mask_chain` with fixed HSV bounds — on the card the fused
    morphology kernel and the CCL kernel, one launch each."""

    def __init__(self, lower, upper, kernel_size: int = 5, max_components: int = 32,
                 device=None):
        self.device = resolve_device(device)
        self.lower = np.asarray(lower, np.uint8)
        self.upper = np.asarray(upper, np.uint8)
        self.kernel_size = kernel_size
        self.max_components = max_components

    def run_async(self, image):
        """(mask, cleaned, stats) as device tensors, not waited for."""
        return hsv_mask_chain(torch.as_tensor(image).to(self.device), self.lower, self.upper,
                              self.kernel_size, self.max_components)

    def run_sync(self, image):
        """run_async, materialized as numpy (blocking)."""
        return tree_map(lambda t: t.cpu().numpy(), self.run_async(image))

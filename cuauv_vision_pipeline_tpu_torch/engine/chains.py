"""The red_buoy device chain on torch tensors.

Port of ``cuauv_vision_pipeline_tpu.engine.chains`` (``red_buoy_chain``,
``red_buoy_fused``, ``RedBuoyPipeline``); reference modules/red_buoy.py:18-52.
PyTorch runs eagerly, so a chain is a plain function over tensors on one
device; thresholds are Python/numpy scalars (a tuner change costs nothing).
Every function takes ``[H, W, 3]`` or a batch ``[B, H, W, 3]`` of u8 BGR
frames; a batch is one dimension written out (one CCL launch for all B
frames), where the JAX package mapped the per-frame chain over lanes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.device import resolve_device
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
    debug post."""
    threshed = T.in_range(C.bgr_to_lab(image)[..., 1], thresh_min, thresh_max)
    cleaned = fused_morph(threshed, "open_close")
    stats = ccl.component_stats(ccl.label_fast(threshed), max_components)
    return threshed, cleaned, ccl.best_component(stats)


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

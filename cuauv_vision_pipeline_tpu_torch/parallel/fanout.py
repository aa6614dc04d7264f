"""Multi-camera streaming fan-out: N cameras, one batched chain.

Port of ``cuauv_vision_pipeline_tpu.parallel.fanout``. The JAX package's
``make_fanout`` shard_maps :func:`chain_one` over a device mesh, one camera
per chip; on one card there is no mesh, so :func:`make_fanout` returns a
callable with the same contract that runs all N frames as ONE batched chain
on its device: one ``fused_morph`` launch and one ``label_cuda_batched``
launch for the N cameras. (The reference scaled by pinning one module
process per GPU; ``ModuleBase --device N`` still does that.)

On a mesh of ranks (``parallel/mesh.py``) each rank runs :func:`chain_one`
on its own camera's frame with no collective, as the JAX ``shard_map`` runs
it on each chip.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..core.device import resolve_device
from ..ops import ccl
from ..ops import color as C
from ..ops import threshold as T
from ..ops.cuda.morph_kernel import fused_morph


def chain_one(frame: torch.Tensor, tmin, tmax) -> Dict[str, torch.Tensor]:
    """The red_buoy chain on ``[H, W, 3]`` (or a batch ``[N, H, W, 3]``)
    u8 BGR frames: LAB A channel -> inRange -> open + close (``fused_morph``,
    bit-equal to the JAX package's composed ``close_morph(open_morph(...))``)
    -> CCL of the CLEANED mask (unlike ``engine/chains.py:red_buoy_fused``,
    which labels the un-cleaned one) -> the largest blob's area, centroid
    (y, x) and bbox (x, y, w, h), with the batch dimension leading."""
    mask = T.in_range(C.bgr_to_lab(frame)[..., 1], tmin, tmax)
    cleaned = fused_morph(mask, "open_close")
    labels = ccl.label_fast(cleaned > 0)
    best = ccl.best_component(ccl.component_stats(labels, max_components=8))
    return {k: best[k] for k in ("area", "centroid", "bbox")}


def make_fanout(device=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """The one-card counterpart of the JAX mesh fan-out: ``frames [N, H, W,
    3]`` (numpy or tensor) plus ``tmin``/``tmax`` -> per-camera blob stats
    ``[N, ...]``, computed on ``device`` (``cuda:0`` unless told) as one
    batched chain."""
    dev = resolve_device(device)

    def fan(frames, tmin, tmax) -> Dict[str, torch.Tensor]:
        return chain_one(torch.as_tensor(frames).to(dev), tmin, tmax)

    return fan


"""Cross-camera detection merge: one consensus list from every camera's.

Port of ``cuauv_vision_pipeline_tpu.parallel.crosscam``. Cameras with
overlapping fields of view (the zed stereo pair, forward + downward overlap
bands) each produce a fixed-shape detection list (modules/yolo_multicam.py).
A class-aware greedy NMS over all of them, in a shared coordinate frame,
suppresses cross-view duplicates and keeps the highest-confidence view of
each object.

Detections are ``[K, 6]`` rows ``(x1, y1, x2, y2, conf, cls)`` in a SHARED
frame (callers apply their camera extrinsics first); padding rows carry
conf <= 0 and are never selected. The NMS is the hand-written CUDA kernel
(``ops/cuda/nms_kernel.py:nms_fixed_cuda``, axis-aligned IoU) on the card,
one launch per merge; CPU tensors take its plain version.

The JAX package's mesh form (``make_cross_camera_merge``: an ``all_gather``
over the camera axis, then the merge replicated per device) is
:func:`make_mesh_cross_camera_merge` on a mesh of ranks (``parallel/mesh.py``);
on one card :func:`make_cross_camera_merge` keeps its contract.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.device import resolve_device
from ..ops.cuda.nms_kernel import nms_fixed_cuda


def _merge_flat(flat: torch.Tensor, iou_thresh: float, max_det: int) -> torch.Tensor:
    """Greedy class-aware NMS over a flat ``[N, 6]`` list -> ``[max_det, 6]``
    (suppressed/padding rows zeroed)."""
    flat = flat.to(torch.float32)
    idx, valid = nms_fixed_cuda(
        flat[None, :, :4].contiguous(),
        flat[None, :, 4].contiguous(),
        flat[None, :, 5].to(torch.int32),
        None,
        iou_thresh,
        max_det,
    )
    rows = flat[idx[0].clamp(min=0).long()]
    return torch.where(valid[0, :, None], rows, 0.0)


def cross_camera_nms(
    dets: torch.Tensor, iou_thresh: float = 0.55, max_det: int = 32
) -> torch.Tensor:
    """``[n_cam, K, 6]`` stacked per-camera lists -> ``[max_det, 6]`` merged
    consensus list."""
    return _merge_flat(dets.reshape(-1, dets.shape[-1]), iou_thresh, max_det)


def make_cross_camera_merge(
    device=None, iou_thresh: float = 0.55, max_det: int = 32
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The one-card counterpart of the JAX mesh merge: ``[n_cam, K, 6]``
    (numpy or tensor) -> ``[n_cam, max_det, 6]``, the same merged list in
    every camera's row, computed on ``device`` (``cuda:0`` unless told) with
    one NMS launch."""
    dev = resolve_device(device)

    def merge(dets) -> torch.Tensor:
        dets = torch.as_tensor(dets).to(dev)
        merged = cross_camera_nms(dets, iou_thresh, max_det)
        return merged[None].repeat(dets.shape[0], 1, 1)

    return merge


def make_mesh_cross_camera_merge(mesh, iou_thresh: float = 0.55, max_det: int = 32
                                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The JAX mesh merge on a mesh of ranks (one camera per rank on the
    ``data`` axis): ``merge(local [K, 6])`` on each rank all-gathers every
    camera's list over the data group and returns the merged ``[max_det,
    6]``, the same on every rank (one NMS launch each)."""
    from .mesh import gather_slices

    def merge(local: torch.Tensor) -> torch.Tensor:
        return cross_camera_nms(gather_slices(local[None], mesh.groups["data"], 0), iou_thresh, max_det)

    return merge

"""Connected-component labeling + per-blob statistics on torch tensors.

Port of ``cuauv_vision_pipeline_tpu.ops.ccl``. Label convention (shared with
the JAX package and the CUDA kernel): each foreground pixel holds the raster
index ``y*W + x`` of its component's topmost-leftmost pixel; background holds
``2**30``.

* :func:`label` is the plain version: min-propagation to the TRUE fixpoint.
  Each pass takes a 3x3 (or 4-neighbour) min and then a pointer-jumping hop
  (every pixel gathers the label at the pixel its label names, as the JAX
  ``propagate_min`` ``jump_mask`` hop does), which doubles the distance a
  label travels per pass, so even a full-frame 1080p component settles in a
  few dozen passes. It stops when nothing changes and raises if its cap is
  reached — it never returns a partial labeling. (The JAX ``ccl.label``
  stops silently after 64 passes and is inexact on dense noise.)
* :func:`label_fast` sends CUDA tensors to the union-find kernel
  (``ops/cuda/ccl_kernel.py``) and CPU tensors to :func:`label`.
* :func:`component_stats` keeps the JAX K-smallest-roots semantics: the K
  components with the smallest root raster index, in raster order. Sums are
  exact int64 reductions of row/column match counts, so only the centroid
  can differ from the JAX float32 sums (last-bit rounding).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .cuda.ccl_kernel import label_cuda, label_cuda_batched

_SENTINEL = 2**30


def _neighbor_min(lbl: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Min over the 3x3 (8-conn) or plus-shaped (4-conn) neighbourhood of
    ``[N, H, W]`` int32 labels; out-of-image neighbours are the sentinel."""
    H, W = lbl.shape[-2], lbl.shape[-1]
    padded = F.pad(lbl, (1, 1, 1, 1), value=_SENTINEL)
    out = lbl
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) == (0, 0) or (connectivity == 4 and dy and dx):
                continue
            out = torch.minimum(
                out, padded[:, 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
            )
    return out


def label(
    mask: torch.Tensor, connectivity: int = 8, max_iters: int = 10_000
) -> torch.Tensor:
    """Label connected components of ``[..., H, W]`` masks (nonzero = fg).

    Returns int32 ``[..., H, W]`` raster-root labels (background 2**30).
    Raises RuntimeError if the fixpoint is not reached in ``max_iters``
    passes."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    H, W = mask.shape[-2], mask.shape[-1]
    fg = (mask != 0).reshape(-1, H, W)
    n = fg.shape[0]
    raster = torch.arange(H * W, dtype=torch.int32, device=mask.device)
    lbl = torch.where(fg, raster.view(1, H, W), _SENTINEL)
    for _ in range(max_iters):
        nb = torch.where(fg, _neighbor_min(lbl, connectivity), _SENTINEL)
        flat = nb.reshape(n, H * W)
        hop = torch.gather(flat, 1, flat.clamp(max=H * W - 1).long())
        new = torch.where(fg, torch.minimum(flat, hop).view(n, H, W), _SENTINEL)
        if torch.equal(new, lbl):
            return new.reshape(mask.shape)
        lbl = new
    raise RuntimeError(f"label() did not converge in {max_iters} passes")


def label_fast(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """The CUDA union-find kernel for CUDA tensors (``[H, W]`` or
    ``[B, H, W]`` in one launch), the plain :func:`label` for CPU tensors."""
    if mask.ndim == 3:
        return label_cuda_batched(mask, connectivity=connectivity)
    return label_cuda(mask, connectivity=connectivity)


def component_stats(
    labels: torch.Tensor, max_components: int = 32
) -> Dict[str, torch.Tensor]:
    """Per-component reductions over ``[..., H, W]`` label maps.

    Returns a dict of fixed-shape tensors (leading dims kept; components in
    raster order of their first pixel; components beyond ``max_components``
    are dropped):
        count:       [] int32, number of components (clamped to capacity)
        area:        [K] int32 pixel counts
        centroid:    [K, 2] float32 (y, x) pixel-mass centroids
        bbox:        [K, 4] int32 (x, y, w, h), cv2.boundingRect convention
        first_pixel: [K] int32 raster index (the component's label value)
        valid:       [K] bool
    """
    K = max_components
    lead = labels.shape[:-2]
    H, W = labels.shape[-2], labels.shape[-1]
    dev = labels.device
    lab = labels.reshape(-1, H * W)
    n = lab.shape[0]

    raster = torch.arange(H * W, dtype=torch.int32, device=dev)
    fg = lab < _SENTINEL
    is_root = fg & (lab == raster)
    count = is_root.sum(dim=1, dtype=torch.int32)

    # K smallest root raster indices, ascending (padding = sentinel)
    root_vals = torch.where(is_root, lab, _SENTINEL)
    if H * W < K:
        root_vals = F.pad(root_vals, (0, K - H * W), value=_SENTINEL)
    roots = torch.topk(root_vals, K, dim=1, largest=False, sorted=True).values

    # match[n, y, x, k]: pixel (y, x) belongs to root k. Padding roots are
    # the sentinel and so match the background, exactly as in JAX; those
    # slots are marked invalid below. Everything reduces from row and column
    # match counts: exact integer sums, no atomics, no data-dependent order.
    match = lab.view(n, H, W, 1) == roots.view(n, 1, 1, K)
    row_cnt = match.sum(dim=2, dtype=torch.int64)  # [n, H, K]
    col_cnt = match.sum(dim=1, dtype=torch.int64)  # [n, W, K]
    ys = torch.arange(H, device=dev).view(1, H, 1)
    xs = torch.arange(W, device=dev).view(1, W, 1)
    area64 = row_cnt.sum(dim=1)
    sum_y = (row_cnt * ys).sum(dim=1)
    sum_x = (col_cnt * xs).sum(dim=1)
    min_y = torch.where(row_cnt > 0, ys, _SENTINEL).amin(dim=1)
    max_y = torch.where(row_cnt > 0, ys, -1).amax(dim=1)
    min_x = torch.where(col_cnt > 0, xs, _SENTINEL).amin(dim=1)
    max_x = torch.where(col_cnt > 0, xs, -1).amax(dim=1)

    valid = (area64 > 0) & (roots < _SENTINEL)
    area = torch.where(valid, area64, 0).to(torch.int32)
    safe_area = area64.clamp(min=1).double()
    centroid = torch.stack([sum_y / safe_area, sum_x / safe_area], dim=-1)
    zero = torch.zeros_like(min_x)
    bbox = torch.stack(
        [
            torch.where(valid, min_x, zero),
            torch.where(valid, min_y, zero),
            torch.where(valid, max_x - min_x + 1, zero),
            torch.where(valid, max_y - min_y + 1, zero),
        ],
        dim=-1,
    ).to(torch.int32)
    out = {
        "count": torch.clamp(count, max=K),
        "area": area,
        "centroid": centroid.to(torch.float32),
        "bbox": bbox,
        "first_pixel": roots,
        "valid": valid,
    }
    return {k: v.reshape(tuple(lead) + tuple(v.shape[1:])) for k, v in out.items()}


def best_component(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The largest component (first on ties, as ``jnp.argmax``) of
    :func:`component_stats` output, per leading index."""
    i = stats["area"].argmax(dim=-1, keepdim=True)
    return {
        "area": stats["area"].gather(-1, i)[..., 0],
        "centroid": torch.take_along_dim(stats["centroid"], i[..., None], dim=-2)[..., 0, :],
        "bbox": torch.take_along_dim(stats["bbox"], i[..., None], dim=-2)[..., 0, :],
        "found": stats["valid"].gather(-1, i)[..., 0],
    }


def connected_components_with_stats(
    mask: torch.Tensor, max_components: int = 32, connectivity: int = 8
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """label_fast() + component_stats()."""
    labels = label_fast(mask, connectivity=connectivity)
    return labels, component_stats(labels, max_components)


def largest_component(
    mask: torch.Tensor, connectivity: int = 8
) -> Dict[str, torch.Tensor]:
    """Stats of the largest blob (reference modules/red_buoy.py:40-50)."""
    _, stats = connected_components_with_stats(
        mask, max_components=32, connectivity=connectivity
    )
    return best_component(stats)

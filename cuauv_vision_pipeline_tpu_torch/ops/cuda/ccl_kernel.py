"""Connected-component labeling on the GPU: tile union-find in CUDA (``csrc/ccl.cu``).

Replaces the Pallas strip kernel
``cuauv_vision_pipeline_tpu/ops/pallas/ccl_kernel.py``: ``label_pallas``
(:139-228) and ``label_pallas_batched`` (:231-266). Same labels: each
foreground pixel gets the raster index ``y*W + x`` of its component's
topmost-leftmost pixel, background gets ``2**30``.

Design. The TPU kernel iterates a strip-local fixpoint in VMEM and re-runs
global halo passes checked by the host (capped at 64). On the GPU a
host-checked iteration would cost a device-to-host round trip per pass, so
this is a union-find (Playne & Hawick, arxiv 1708.08180) in three launches,
with no host round trip and no iteration count. The output tensor is the
forest itself (``out[p]`` = parent of ``p``), so no scratch is allocated.
Each launch runs one block per 32x32 tile: 8 warps, a warp per tile row,
4 rows per thread.

1. local — the tile's mask comes into shared memory in 4-byte loads (byte
   loads where ``W % 4`` or the address is odd); a warp ballot starts every
   pixel at the first pixel of its run in the row; runs link once to each
   run they touch in the row above, in a union-find on a shared-memory
   parent array; each pixel writes the raster index of its tile-local root.
   Contention stays in one SM's shared memory.
2. border — only pixels with a scanned neighbour (left, up-left, up,
   up-right for 8-connectivity; left, up for 4) in another tile: a tile's top
   row, left column and (8-connectivity) right column. The same
   once-per-pair-of-runs rules skip links that other links imply, so a solid
   tile makes two global links. Global ``atomicCAS`` links on ``out``.
3. final — ``out[p] = find(p)`` in place for foreground pixels, read from
   the mask. Each distinct tile-local root is resolved once per tile and
   shared through shared memory, so a frame-wide component does not send
   every warp to its root's entry.

Every link puts the larger root under the smaller with an ``atomicCAS``
that succeeds only while the larger one is still a root (retrying from the
new roots otherwise), so trees only merge at their roots and the path
halving of a union's finds is safe (an ``atomicMin`` link, which may
re-parent a non-root, races with compression and loses unions on dense
noise). The final phase stores only each pixel's own root. Every link
points to a smaller index, and tile-local raster order is monotone in the
image's, so each component's root is its minimum raster index whatever
order the atomics land in: the result is exact and deterministic (the
Pallas kernel may stop at its 64-pass cap on percolating noise; this one
cannot). The batched form gives each image its own forest at
``out + b*H*W`` (the batch is the grid's z dimension) and never reads a
neighbour outside rows ``[0, H)`` of its own image (that replaces the JAX
separator row): B images, one set of three launches.

Bound on this card: bytes. The least traffic is 1 B of mask read and 4 B of
labels written per pixel (10.37 MB at 1080p); the border and final phases
read the mask again and touch only foreground labels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SENTINEL = 2**30
_TILE = 32  # csrc/ccl.cu kTile
_MAX_GRID = 65535  # grid y (tile rows) and z (images)
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ccl_label": (_I, [_P, _P, _I, _I, _I, _I, _I, _P]),
    "ccl_error_string": (ctypes.c_char_p, [_I]),
}


def _check_mask(mask: torch.Tensor, ndim: int, connectivity: int) -> None:
    if mask.device.type != "cuda":
        raise ValueError(f"mask must be a CUDA tensor, got {mask.device}")
    if mask.dtype not in (torch.uint8, torch.bool):
        raise TypeError(f"mask must be uint8 or bool, got {mask.dtype}")
    if mask.ndim != ndim or 0 in mask.shape:
        raise ValueError(f"mask must be a non-empty {ndim}-D tensor, got {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if mask.numel() >= _SENTINEL:
        raise ValueError(f"B*H*W = {mask.numel()} must stay below 2**30")
    lead = mask.shape[0] if ndim == 3 else 1
    if lead > _MAX_GRID or -(-mask.shape[-2] // _TILE) > _MAX_GRID:
        raise ValueError(f"B and H/{_TILE} must stay within {_MAX_GRID}, got {tuple(mask.shape)}")


def _launch(mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    B, H, W = mask.shape
    lib = _build.load("ccl", _SIGNATURES)
    out = torch.empty((B, H, W), dtype=torch.int32, device=mask.device)
    err = lib.ccl_label(
        mask.data_ptr(), out.data_ptr(), B, H, W,
        connectivity, mask.device.index or 0,
        torch.cuda.current_stream(mask.device).cuda_stream,
    )
    _build.check(lib, "ccl", err, "ccl_label launch")
    return out


def label_cuda(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Label an ``[H, W]`` mask (nonzero = foreground) -> int32 ``[H, W]``.

    A CPU tensor goes to the plain ``ops.ccl.label``; a CUDA tensor launches
    the kernel (and counts one launch) or raises."""
    if mask.device.type == "cpu":
        from ..ccl import label

        return label(mask, connectivity=connectivity)
    _check_mask(mask, 2, connectivity)
    label_cuda.launches += 1
    return _launch(mask.unsqueeze(0), connectivity)[0]


def label_cuda_batched(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Label a ``[B, H, W]`` batch in one call -> per-image int32 labels
    (each image's own raster indices, as per-image :func:`label_cuda`)."""
    if mask.device.type == "cpu":
        from ..ccl import label

        return label(mask, connectivity=connectivity)
    _check_mask(mask, 3, connectivity)
    label_cuda_batched.launches += 1
    return _launch(mask, connectivity)


label_cuda.launches = 0
label_cuda_batched.launches = 0

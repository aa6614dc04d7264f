"""Connected-component labeling on the GPU: union-find in CUDA (``csrc/ccl.cu``).

Replaces the Pallas strip kernel
``cuauv_vision_pipeline_tpu/ops/pallas/ccl_kernel.py``: ``label_pallas``
(:139-228) and ``label_pallas_batched`` (:231-266). Same labels: each
foreground pixel gets the raster index ``y*W + x`` of its component's
topmost-leftmost pixel, background gets ``2**30``.

Design. The TPU kernel iterates a strip-local fixpoint in VMEM and re-runs
global halo passes checked by the host (capped at 64). On the GPU a
host-checked iteration would cost a device-to-host round trip per pass, so
this is the union-find of arxiv 1708.08180 (Playne & Hawick) on a parent
array in device memory, three launches with no host round trip and no
iteration count:

1. init — ``parent[p] = p`` for foreground, ``2**30`` for background;
2. merge — each foreground pixel unions with its already-scanned
   foreground neighbours (left, up-left, up, up-right for 8-connectivity;
   left, up for 4), always linking the larger root under the smaller one.
   The link is an ``atomicCAS`` that succeeds only while the larger one is
   still a root (retrying from the new roots otherwise), so trees only ever
   merge at their roots and the path compression done on the way is safe
   (an ``atomicMin`` link, which may re-parent a non-root, races with
   compression and loses unions on dense noise);
3. compress — ``out[p] = find(p)``.

Because every link points to a smaller index, each component's root is its
minimum raster index whatever order the atomics land in: the result is
exact and deterministic (the Pallas kernel may stop at its 64-pass cap on
percolating noise; this one cannot). The batched form stores
``b*H*W + y*W + x``, never looks at a neighbour outside rows ``[0, H)`` of
its own image (that replaces the JAX separator row) and subtracts ``b*H*W``
on output: B images, one set of three launches.

Bound on this card: bytes. The least traffic is 1 B of mask read and 4 B of
labels written per pixel (10.37 MB at 1080p); the parent array adds ~8 B per
pixel of scratch traffic, mostly L2-resident at 1080p.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SENTINEL = 2**30
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ccl_label": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
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


def _launch(mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    B, H, W = mask.shape
    lib = _build.load("ccl", _SIGNATURES)
    out = torch.empty((B, H, W), dtype=torch.int32, device=mask.device)
    parent = torch.empty((B * H * W,), dtype=torch.int32, device=mask.device)
    err = lib.ccl_label(
        mask.data_ptr(), out.data_ptr(), parent.data_ptr(), B, H, W,
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
    """Label a ``[B, H, W]`` batch in one launch -> per-image int32 labels
    (each image's own raster indices, as per-image :func:`label_cuda`)."""
    if mask.device.type == "cpu":
        from ..ccl import label

        return label(mask, connectivity=connectivity)
    _check_mask(mask, 3, connectivity)
    label_cuda_batched.launches += 1
    return _launch(mask, connectivity)


label_cuda.launches = 0
label_cuda_batched.launches = 0

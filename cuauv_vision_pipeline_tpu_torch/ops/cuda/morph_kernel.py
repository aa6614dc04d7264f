"""Fused 5x5-rect morphology on the GPU, one pass (``csrc/morph.cu``).

Replaces the Pallas kernel
``cuauv_vision_pipeline_tpu/ops/pallas/morph_kernel.py:fused_morph``
(:98-161): ``"open_close"`` (erode, dilate, dilate, erode — the red_buoy
chain's ``close_morph(open_morph(x))``), ``"open"`` or ``"close"`` on a u8
``[H, W]`` image or ``[B, H, W]`` stack of any values, in one launch, one
read and one write, bit-exact vs the composed ``ops.morphology`` calls.

Design. The Pallas kernel's strips span the full width and need halo rows
only. Here a block is one warp that owns a 128-px strip (4 pixels per lane,
as two u16x2 words) and ``kRows`` = 16 output rows plus a 2-px-per-stage
halo, all in registers. A three-input min/max of packed pixels is one
Hopper DPX instruction (``__vimin3_u16x2``); the horizontal 5-tap windows
take the neighbour lanes' edge words by warp shuffles, and neighbouring
windows (in a row and down a column) share their middle three taps, so a
5-tap pass costs 1.5 DPX ops per word. Each stage computes only the rows
its successors need. Cells outside the image are set to the stage's
identity (255 erode, 0 dilate: cv2 BORDER_CONSTANT, as the composed calls
re-pad per op) before each stage, and only in warps that touch the image
border; an image of a stack never reads a row of its neighbour. No shared
memory and no barrier.

Bound on this card: bytes — 1 B read + 1 B written per pixel (4.15 MB at
1080p, 1.24 us at 3.35 TB/s). The least integer work, one packed 5-tap op
per pixel per pass (8 per pixel over 4 stages), takes 0.5 us at the INT32
rate. Loads are 4 B per lane (a 128-B line per warp and row); rows whose
start is not 4-byte aligned (``W % 4``, or a view at an odd address) load
byte by byte.
"""

from __future__ import annotations

import ctypes

import torch

from .. import morphology as M
from . import _build

_ROWS_PER_BLOCK = 16  # csrc/morph.cu kRows: grid y = ceil(H / 16)
_MAX_GRID = 65535  # grid y and z (images)
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "morph_fused": (_I, [_P, _P, _I, _I, _I, ctypes.c_uint, _I, _I, _P]),
    "morph_error_string": (ctypes.c_char_p, [_I]),
}

# erode=True / dilate=False, applied in order
STAGES = {
    "open_close": (True, False, False, True),
    "open": (True, False),
    "close": (False, True),
}


def fused_morph_plain(mask: torch.Tensor, operation: str = "open_close") -> torch.Tensor:
    """The composed ops.morphology version (what the kernel must equal)."""
    out = mask
    for is_erode in STAGES[operation]:
        out = (M.erode if is_erode else M.dilate)(out, 5)
    return out


def fused_morph(mask: torch.Tensor, operation: str = "open_close") -> torch.Tensor:
    """Fused 5x5-rect morphology on a u8 ``[H, W]`` (or ``[B, H, W]``) mask.

    A CPU tensor goes to :func:`fused_morph_plain`; a CUDA tensor launches
    the kernel (and counts one launch) or raises."""
    stages = STAGES[operation]
    if mask.device.type == "cpu":
        return fused_morph_plain(mask, operation)
    if mask.device.type != "cuda":
        raise ValueError(f"mask must be a CUDA or CPU tensor, got {mask.device}")
    if mask.dtype != torch.uint8:
        raise TypeError(f"mask must be uint8, got {mask.dtype}")
    if mask.ndim not in (2, 3) or 0 in mask.shape:
        raise ValueError(f"mask must be non-empty [H, W] or [B, H, W], got {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    H, W = mask.shape[-2], mask.shape[-1]
    B = mask.shape[0] if mask.ndim == 3 else 1
    if B > _MAX_GRID or -(-H // _ROWS_PER_BLOCK) > _MAX_GRID:
        raise ValueError(
            f"B and H/{_ROWS_PER_BLOCK} must stay within {_MAX_GRID}, got {tuple(mask.shape)}"
        )
    bits = sum(1 << i for i, is_erode in enumerate(stages) if is_erode)

    lib = _build.load("morph", _SIGNATURES)
    out = torch.empty_like(mask)
    fused_morph.launches += 1
    err = lib.morph_fused(
        mask.data_ptr(), out.data_ptr(), B, H, W, bits, len(stages),
        mask.device.index or 0,
        torch.cuda.current_stream(mask.device).cuda_stream,
    )
    _build.check(lib, "morph", err, "morph_fused launch")
    return out


fused_morph.launches = 0

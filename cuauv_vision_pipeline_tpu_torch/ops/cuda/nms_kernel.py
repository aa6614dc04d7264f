"""Greedy fixed-budget NMS on the GPU, one launch per batch (``csrc/nms.cu``).

Replaces the NMS loop of the JAX package's YOLO decode
(``cuauv_vision_pipeline_tpu/models/yolo/decode.py:150-206`` ``nms_fixed``, a
``lax.fori_loop`` of ``max_det`` rounds inside the jitted graph; it has no
Pallas kernel). The plain version, :func:`nms_fixed_plain` below, is that
loop in torch ops: CPU tensors take it; CUDA tensors launch the kernel
(counting one launch) or raise.

Design (see the source's header): one thread block per image. What bounds
greedy NMS on this card is its chain of dependent steps, not bytes (the
pool is read once, ~14 KB at P = 512) or operations (a few thousand IoUs).
So the kernel orders the pool once and walks it: the picks are the
candidates met in (score desc, index asc) order that are > 0 and that no
earlier pick suppresses. A pool already in that order (decode's, sorted by
``_top_pool``) is walked in place; any other is ordered in shared memory,
up to 1024 candidates at a time (a radix select of the next 1024 keys when
more remain, then a bitonic sort). The walk takes 32 candidates at a time:
the chunk's 496 own pairs and the chunk against the picks so far in
parallel, one IoU per thread while there are at most 16 picks; then every
warp resolves the chunk alike with ``__ffs`` on bit masks. One block
barrier per chunk where a round per pick took three per pick.
IoU terms, classes and picks stay in shared memory (picks past 1024 spill
to a scratch allocated here). A row holding a NaN score has no picks, as
in the plain version (``torch.argmax`` takes NaN as the largest score, so
every round picks it and finds it not > 0). The arithmetic matches the
plain version operation for operation (built with ``--fmad=false``), so
picks are exact against it on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

# constants of the IoU arithmetic, as float32 values (shared with
# csrc/nms.cu, which must compute the same operations in the same order)
EPS = 1e-7
INV12 = 1.0 / 12.0
AABB_MIN_UNION = 1e-9

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "nms_fixed": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P]),
    "nms_shared_picks": (_I, []),
    "nms_error_string": (ctypes.c_char_p, [_I]),
}
# the largest pool taken (the kernel's keys hold a 16-bit index, so up to
# 65536 would do; this is the limit the wrapper has always had)
_MAX_POOL = 232448 // 4


def _nms_geometry(boxes_xyxy: torch.Tensor, angles=None) -> torch.Tensor:
    """Per-candidate terms of the IoU, ``[B, 6, P]``: for ProbIoU (angles
    given) the center x, y, the covariance a, b, c and sqrt(max(ab - c^2,
    0)); for AABB IoU x1, y1, x2, y2, the area and zeros. The kernel
    computes the same in its prologue, in this order."""
    x1, y1, x2, y2 = boxes_xyxy.unbind(-1)
    if angles is None:
        area = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
        return torch.stack([x1, y1, x2, y2, area, torch.zeros_like(area)], 1)
    w = x2 - x1
    h = y2 - y1
    w2 = w * w * INV12
    h2 = h * h * INV12
    c = torch.cos(angles)
    s = torch.sin(angles)
    a = w2 * c * c + h2 * s * s
    b = w2 * s * s + h2 * c * c
    cc = (w2 - h2) * c * s
    root = torch.sqrt(torch.clamp_min(a * b - cc * cc, 0.0))
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, a, b, cc, root], 1)


def _probiou_rows(g: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """ProbIoU of each image's candidate ``best`` [B] against all its
    candidates (Gaussian/Bhattacharyya, ultralytics' nms_rotated measure),
    from :func:`_nms_geometry` terms ``g`` [B, 6, P]."""
    k = g.gather(2, best[:, None, None].expand(-1, 6, 1))  # [B, 6, 1]
    x1, y1, a1, b1, c1, r1 = k.unbind(1)
    x2, y2, a2, b2, c2, r2 = g.unbind(1)
    sa, sb, sc = a1 + a2, b1 + b2, c1 + c2
    dx, dy = x1 - x2, y1 - y2
    det = sa * sb - sc * sc
    denom = det + EPS
    t1 = (sa * (dy * dy) + sb * (dx * dx)) / denom * 0.25
    t2 = sc * (x2 - x1) * dy / denom * 0.5
    t3 = 0.5 * torch.log(det / (4.0 * r1 * r2 + EPS) + EPS)
    bd = torch.clamp(t1 + t2 + t3, EPS, 100.0)
    return 1.0 - torch.sqrt(1.0 - torch.exp(-bd) + EPS)


def _aabb_rows(g: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU of each image's candidate ``best`` against all."""
    k = g.gather(2, best[:, None, None].expand(-1, 6, 1))
    x1 = torch.maximum(k[:, 0], g[:, 0])
    y1 = torch.maximum(k[:, 1], g[:, 1])
    x2 = torch.minimum(k[:, 2], g[:, 2])
    y2 = torch.minimum(k[:, 3], g[:, 3])
    inter = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    return inter / torch.clamp_min(k[:, 4] + g[:, 4] - inter, AABB_MIN_UNION)


def nms_fixed_plain(
    boxes_xyxy: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    iou_thresh: float = 0.45,
    max_det: int = 32,
    class_aware: bool = True,
    angles=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a fixed detection budget, in torch ops (the plain
    version of ``csrc/nms.cu``). Takes ``[P]`` or ``[B, P]`` candidates;
    returns (indices i32, valid bool), each ``[max_det]`` or ``[B,
    max_det]``. Scores <= 0 are never selected; each round picks the
    highest alive score (the lowest index among equals) and zeroes it and
    every same-class candidate whose IoU with it is >= ``iou_thresh``
    (rotated ProbIoU when ``angles`` is given). ``argmax`` takes NaN as
    the largest score, so a row holding a NaN has no picks, as with
    ``jnp.argmax`` in the JAX package."""
    single = scores.ndim == 1
    if single:
        boxes_xyxy, scores, classes = boxes_xyxy[None], scores[None], classes[None]
        angles = None if angles is None else angles[None]
    B = scores.shape[0]
    g = _nms_geometry(boxes_xyxy, angles)
    rows = _probiou_rows if angles is not None else _aabb_rows
    alive = scores.clone()
    picked = torch.full((B, max_det), -1, dtype=torch.int32, device=scores.device)
    valid = torch.zeros((B, max_det), dtype=torch.bool, device=scores.device)
    lanes = torch.arange(B, device=scores.device)
    for i in range(max_det):
        best = torch.argmax(alive, dim=1)
        ok = alive[lanes, best] > 0.0
        picked[:, i] = torch.where(ok, best, -1).to(torch.int32)
        valid[:, i] = ok
        suppress = rows(g, best) >= iou_thresh
        if class_aware:
            suppress &= classes == classes[lanes, best][:, None]
        suppress[lanes, best] = True
        alive = torch.where(suppress & ok[:, None], 0.0, alive)
    return (picked[0], valid[0]) if single else (picked, valid)


def nms_fixed_cuda(
    boxes_xyxy: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    angles: Optional[torch.Tensor] = None,
    iou_thresh: float = 0.45,
    max_det: int = 32,
    class_aware: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of ``[B, P]`` candidate pools: boxes f32 ``[B, P, 4]``
    xyxy, scores f32 ``[B, P]``, classes i32 ``[B, P]``, angles f32 ``[B,
    P]`` (rotated ProbIoU) or None (axis-aligned IoU). Returns picked i32
    ``[B, max_det]`` (pool indices, -1 past the last pick) and valid bool
    ``[B, max_det]``."""
    if scores.device.type == "cpu":
        return nms_fixed_plain(boxes_xyxy, scores, classes, iou_thresh, max_det, class_aware, angles)
    if scores.device.type != "cuda":
        raise ValueError(f"scores must be a CUDA or CPU tensor, got {scores.device}")
    if scores.ndim != 2 or 0 in scores.shape:
        raise ValueError(f"scores must be a non-empty [B, P], got {tuple(scores.shape)}")
    B, P = scores.shape
    if P > _MAX_POOL or max_det < 1:
        raise ValueError(f"need P <= {_MAX_POOL} and max_det >= 1, got P={P}, max_det={max_det}")
    dev = scores.device
    _build.check_tensor("scores", scores, torch.float32, (B, P), dev)
    _build.check_tensor("boxes_xyxy", boxes_xyxy, torch.float32, (B, P, 4), dev)
    _build.check_tensor("classes", classes, torch.int32, (B, P), dev)
    if angles is not None:
        _build.check_tensor("angles", angles, torch.float32, (B, P), dev)

    lib = _build.load("nms", _SIGNATURES)
    n_picks = min(max_det, P)
    scratch = (torch.empty((B, 7, n_picks), dtype=torch.int32, device=dev)
               if n_picks > lib.nms_shared_picks() else None)
    picked = torch.empty((B, max_det), dtype=torch.int32, device=dev)
    valid = torch.empty((B, max_det), dtype=torch.bool, device=dev)
    nms_fixed_cuda.launches += 1
    err = lib.nms_fixed(
        boxes_xyxy.data_ptr(), scores.data_ptr(), classes.data_ptr(),
        None if angles is None else angles.data_ptr(),
        None if scratch is None else scratch.data_ptr(), picked.data_ptr(), valid.data_ptr(),
        B, P, max_det, float(iou_thresh), int(bool(class_aware)),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "nms", err, "nms_fixed launch")
    return picked, valid


nms_fixed_cuda.launches = 0

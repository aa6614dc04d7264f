"""Detection decode + greedy NMS on the model's device.

Port of ``cuauv_vision_pipeline_tpu.models.yolo.decode``: DFL expectation,
anchor offsets (and ultralytics' dist2rbox for obb), score threshold, the
top-``nms_pool`` candidate pool and class-aware greedy NMS with fixed-size
outputs, then the winners' keypoints (pose) and instance masks (segment:
prototypes combined by their coefficients, cropped to the box, thresholded
to u8 on the device). Every function takes a leading batch axis ``[B, ...]``
(the JAX package decodes one image and vmaps).

On CUDA tensors :func:`decode` runs the NMS loop as one hand-written kernel
(``ops.cuda.nms_kernel.nms_fixed_cuda``); CPU tensors take its plain
version in torch ops (``nms_kernel.nms_fixed_plain``, the port of the JAX
package's ``nms_fixed``). There is no fallback: a kernel that fails to
build or launch raises.

Two orders carry over exactly from the JAX package, because tie-breaks
depend on them: anchors flatten from NHWC maps (row-major H, then W, scale
by scale), and the pool is a STABLE descending sort of the scores (equal
scores keep the lower anchor first, as ``jax.lax.top_k`` does;
``torch.topk`` does not promise that, and bf16 logits tie often).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ...ops.cuda.nms_kernel import nms_fixed_cuda

STRIDES = (8, 16, 32)

_ANCHORS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _anchors(shapes: Tuple[Tuple[int, int], ...], device: torch.device):
    """(centers [N, 2] (x, y), strides [N]) of the anchor grid, cached."""
    key = (shapes, str(device))
    if key not in _ANCHORS:
        centers, strides = [], []
        for (H, W), stride in zip(shapes, STRIDES):
            ys = (torch.arange(H, dtype=torch.float32) + 0.5) * stride
            xs = (torch.arange(W, dtype=torch.float32) + 0.5) * stride
            cy, cx = torch.meshgrid(ys, xs, indexing="ij")
            centers.append(torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1))
            strides.append(torch.full((H * W,), float(stride)))
        _ANCHORS[key] = (torch.cat(centers).to(device), torch.cat(strides).to(device))
    return _ANCHORS[key]


def _flatten_scales(outputs: Dict[str, List[torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Concatenate per-scale NHWC maps into per-anchor rows + anchor
    centers and strides."""
    shapes = tuple((bm.shape[1], bm.shape[2]) for bm in outputs["box"])
    out = {}
    for key in ("box", "cls", "angle", "kpts", "mcoef"):
        if key in outputs:
            out[key] = torch.cat([m.reshape(m.shape[0], -1, m.shape[-1]) for m in outputs[key]], 1)
    out["centers"], out["strides"] = _anchors(shapes, out["box"].device)
    return out


def compose_masks(proto: torch.Tensor, coefs: torch.Tensor, boxes_xyxy: torch.Tensor,
                  image_size: int) -> torch.Tensor:
    """Instance mask probabilities ``[B, M, Hp, Wp]`` from prototypes ``[B,
    Hp, Wp, nm]`` and each detection's coefficients ``[B, M, nm]``:
    sigmoid(proto . coefs), zeroed outside the detection's box (model-input
    xyxy, rescaled onto the prototype grid; right and bottom edges
    exclusive, as ultralytics' crop_mask)."""
    hp, wp = proto.shape[1], proto.shape[2]
    masks = torch.sigmoid(torch.einsum("bhwc,bmc->bmhw", proto, coefs))
    sx, sy = wp / float(image_size), hp / float(image_size)
    x1, y1, x2, y2 = (boxes_xyxy[..., i, None, None] * s for i, s in enumerate((sx, sy, sx, sy)))
    cols = torch.arange(wp, dtype=torch.float32, device=proto.device)
    rows = torch.arange(hp, dtype=torch.float32, device=proto.device)[:, None]
    inside = (cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2)
    return masks * inside.to(masks.dtype)


def _dfl_expectation(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """[..., 4*reg_max] logits -> [..., 4] expected ltrb distances."""
    probs = torch.softmax(box_logits.reshape(*box_logits.shape[:-1], 4, reg_max), dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=box_logits.device)
    return (probs * bins).sum(-1)


def decode_boxes(flat: Dict[str, torch.Tensor], reg_max: int = 16):
    """Per-anchor boxes ``[B, N, 4]`` xyxy and, for obb, angles ``[B, N]``
    (ultralytics' dist2rbox: angle = (sigmoid - 0.25) * pi, the ltrb center
    offset rotated by it; xyxy is the unrotated w x h box around the
    rotated center)."""
    dists = _dfl_expectation(flat["box"], reg_max) * flat["strides"][:, None]
    cx, cy = flat["centers"][:, 0], flat["centers"][:, 1]
    d0, d1, d2, d3 = dists.unbind(-1)
    if "angle" in flat:
        angle = (torch.sigmoid(flat["angle"][..., 0]) - 0.25) * math.pi
        fx = (d2 - d0) / 2
        fy = (d3 - d1) / 2
        cos, sin = torch.cos(angle), torch.sin(angle)
        cx = cx + fx * cos - fy * sin
        cy = cy + fx * sin + fy * cos
        w = d0 + d2
        h = d1 + d3
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1), angle
    return torch.stack([cx - d0, cy - d1, cx + d2, cy + d3], -1), None


def _top_pool(scores: torch.Tensor, pool: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``pool`` highest scores of each row and their indices, equal
    scores lowest index first (``jax.lax.top_k``'s order)."""
    scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return scores[:, :pool].contiguous(), idx[:, :pool]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, j], ...] for x [B, N, ...] and idx [B, M]."""
    if x.ndim == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def candidates(outputs: Dict[str, List[torch.Tensor]], reg_max: int = 16, conf_thresh: float = 0.25):
    """Raw head outputs -> every anchor's (boxes xyxy [B, N, 4], angles [B,
    N] or None, scores [B, N] zeroed below ``conf_thresh``, classes [B,
    N], extras): the elementwise half of :func:`decode`. ``extras`` holds
    what :func:`select` decodes for the winners only: the raw keypoints
    ``kpts`` [B, N, 3*nk] with the anchors' ``centers`` and ``strides``
    (pose), the mask coefficients ``mcoef`` [B, N, nm] and ``proto``
    (segment)."""
    flat = _flatten_scales(outputs)
    boxes_xyxy, angle = decode_boxes(flat, reg_max)
    # sigmoid is monotonic: the max over logits picks the class
    best_logit, classes = flat["cls"].max(-1)
    scores = torch.sigmoid(best_logit)
    scores = torch.where(scores >= conf_thresh, scores, 0.0)
    extras = {}
    if "kpts" in flat:
        extras.update(kpts=flat["kpts"], centers=flat["centers"], strides=flat["strides"])
    if "mcoef" in flat and "proto" in outputs:
        extras.update(mcoef=flat["mcoef"], proto=outputs["proto"])
    return boxes_xyxy, angle, scores, classes, extras


def select(
    boxes_xyxy: torch.Tensor,
    angle,
    scores: torch.Tensor,
    classes: torch.Tensor,
    extras: Dict[str, torch.Tensor],
    image_size: int,
    iou_thresh: float = 0.45,
    max_det: int = 32,
    nms_pool: int = 512,
) -> Dict[str, torch.Tensor]:
    """:func:`candidates` -> the fixed-size detections of :func:`decode`:
    the top-``nms_pool`` pool, greedy NMS and the gathers, then the
    winners' keypoints and masks."""
    scores, top_idx = _top_pool(scores, min(nms_pool, scores.shape[1]))
    boxes_xyxy = _take(boxes_xyxy, top_idx).contiguous()
    classes = _take(classes, top_idx).to(torch.int32).contiguous()
    if angle is not None:
        angle = _take(angle, top_idx).contiguous()

    picked, valid = nms_fixed_cuda(boxes_xyxy, scores, classes, angle, iou_thresh, max_det)
    safe = picked.long().clamp_min(0)
    out = {
        "xyxy": _take(boxes_xyxy, safe),
        "score": torch.where(valid, _take(scores, safe), 0.0),
        "cls": torch.where(valid, _take(classes, safe), -1),
        "valid": valid,
    }
    if angle is None:
        out["xyxy"] = torch.clamp(out["xyxy"], 0.0, float(image_size))
    else:
        out["angle"] = _take(angle, safe)
    if extras:
        orig = top_idx.gather(1, safe)  # the winners' anchor indices
    if "kpts" in extras:
        # gather the max_det winners first, then decode only their keypoints
        k = _take(extras["kpts"], orig)
        k = k.reshape(*k.shape[:2], -1, 3)
        centers, strides = extras["centers"][orig], extras["strides"][orig][..., None]
        kx = (k[..., 0] * 2.0) * strides + (centers[..., 0:1] - 0.5 * strides)
        ky = (k[..., 1] * 2.0) * strides + (centers[..., 1:2] - 0.5 * strides)
        out["kpts"] = torch.stack([kx, ky, torch.sigmoid(k[..., 2])], -1)
    if "mcoef" in extras:
        masks = compose_masks(extras["proto"], _take(extras["mcoef"], orig), out["xyxy"], image_size)
        # thresholded on the device (0.5 on probabilities is ultralytics'
        # .gt_(0) on logits) and fetched as u8; invalid slots are zero
        out["mask"] = ((masks >= 0.5) & valid[..., None, None]).to(torch.uint8)
    return out


def decode(
    outputs: Dict[str, List[torch.Tensor]],
    image_size: int,
    reg_max: int = 16,
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    max_det: int = 32,
    nms_pool: int = 512,
) -> Dict[str, torch.Tensor]:
    """Decode raw head outputs (per-scale NHWC maps, float32) into
    fixed-size detections: ``xyxy`` [B, max_det, 4], ``score``, ``cls``,
    ``valid`` [B, max_det], and ``angle`` (obb), ``kpts`` [B, max_det, nk,
    3] (x, y, visibility; pose) or ``mask`` [B, max_det, S/4, S/4] u8
    (segment). Coordinates are model input pixels; axis-aligned boxes are
    clipped to [0, image_size] after NMS, rotated ones are not.

    ``nms_pool``: NMS runs over the top-``nms_pool`` candidates by score
    (exact while the above-``conf_thresh`` candidates fit in the pool, as
    zeroed scores are never picked); pass the anchor count to disable."""
    return select(*candidates(outputs, reg_max, conf_thresh), image_size, iou_thresh, max_det, nms_pool)


def obb_corners(xyxy: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """[M, 4] xyxy + [M] angle -> [M, 4, 2] rotated corners (x, y), in
    numpy (the host summarize path)."""
    cx = (xyxy[:, 0] + xyxy[:, 2]) / 2
    cy = (xyxy[:, 1] + xyxy[:, 3]) / 2
    w = xyxy[:, 2] - xyxy[:, 0]
    h = xyxy[:, 3] - xyxy[:, 1]
    cos = np.cos(angle)
    sin = np.sin(angle)
    corners = []
    for sx, sy in ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)):
        dx = sx * w
        dy = sy * h
        corners.append(np.stack([cx + dx * cos - dy * sin, cy + dx * sin + dy * cos], -1))
    return np.stack(corners, 1)


def summarize(
    decoded: Dict[str, np.ndarray],
    class_names: List[str],
    scale: Tuple[float, float] = (1.0, 1.0),
    task: str = "detect",
    pad: Tuple[float, float] = (0.0, 0.0),
    clip_wh: Tuple[float, float] = None,
    image_size: int = None,
) -> List[Dict]:
    """One image's decoded detections (numpy) -> ultralytics
    Results.summary()-style dicts, the format MAP_FN parses. Coordinates map
    back to the original frame as (v - pad) * scale; clip_wh=(w, h) clamps
    detect boxes and pose keypoints to the frame; rotated OBB corners are
    never clipped. Pose entries carry ``keypoints: {x, y, visible}``;
    segment entries (which need ``image_size``, the model input square)
    carry ``segments: {x, y}``, the largest external polygon of the mask,
    traced on the prototype grid and mapped through pixel centers to the
    frame."""
    if task == "segment":
        from ...utils.contours import contour_area, find_contours
    results = []
    valid = np.asarray(decoded["valid"])
    xyxy = np.asarray(decoded["xyxy"])
    scores = np.asarray(decoded["score"])
    classes = np.asarray(decoded["cls"])
    sx, sy = scale
    px, py = pad

    def _cx(v: float) -> float:
        v = (v - px) * sx
        return min(max(v, 0.0), clip_wh[0]) if clip_wh else v

    def _cy(v: float) -> float:
        v = (v - py) * sy
        return min(max(v, 0.0), clip_wh[1]) if clip_wh else v

    if task == "obb":
        corners = obb_corners(xyxy, np.asarray(decoded["angle"]))

    for i in np.nonzero(valid)[0]:
        cls_id = int(classes[i])
        name = class_names[cls_id] if 0 <= cls_id < len(class_names) else str(cls_id)
        entry: Dict = {"name": name, "class": cls_id, "confidence": float(scores[i])}
        if task == "obb":
            c = corners[i]
            entry["box"] = {
                "x1": float((c[0, 0] - px) * sx), "y1": float((c[0, 1] - py) * sy),
                "x2": float((c[1, 0] - px) * sx), "y2": float((c[1, 1] - py) * sy),
                "x3": float((c[2, 0] - px) * sx), "y3": float((c[2, 1] - py) * sy),
                "x4": float((c[3, 0] - px) * sx), "y4": float((c[3, 1] - py) * sy),
            }
        else:
            entry["box"] = {
                "x1": float(_cx(xyxy[i, 0])), "y1": float(_cy(xyxy[i, 1])),
                "x2": float(_cx(xyxy[i, 2])), "y2": float(_cy(xyxy[i, 3])),
            }
        if task == "pose" and "kpts" in decoded:
            k = np.asarray(decoded["kpts"])[i]
            entry["keypoints"] = {
                "x": [float(_cx(v)) for v in k[:, 0]],
                "y": [float(_cy(v)) for v in k[:, 1]],
                "visible": [float(v) for v in k[:, 2]],
            }
        if task == "segment" and "mask" in decoded and image_size:
            mask = np.asarray(decoded["mask"])[i] >= 0.5
            factor = float(image_size) / mask.shape[0]  # mask pixel -> model pixels
            polys = find_contours(mask.astype(np.uint8))
            if polys:
                poly = max(polys, key=contour_area).reshape(-1, 2)
                entry["segments"] = {
                    "x": [float(_cx(v)) for v in (poly[:, 0] + 0.5) * factor],
                    "y": [float(_cy(v)) for v in (poly[:, 1] + 0.5) * factor],
                }
            else:
                entry["segments"] = {"x": [], "y": []}
        results.append(entry)
    return results

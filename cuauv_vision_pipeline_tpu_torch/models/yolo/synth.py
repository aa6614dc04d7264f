"""Synthetic detection scenes with exact ground truth (numpy only).

Copy of ``cuauv_vision_pipeline_tpu.models.yolo.synth``: the scene renderers
and ``match_detections`` that score the trained fixture checkpoints.

The reference consumes externally-trained ultralytics weights and has no
dataset in-repo (reference modules/yolo.py:44-55); the rebuild owns its
model and trainer (train.py), so it also owns a data source: procedurally
generated underwater-ish scenes whose labels are exact by construction.
Two classes — a filled disc ("disc", the buoy analog) and an axis-aligned
plate ("slab", the bins/gate analog) — over a noisy blue-green gradient.

Used by examples/train_synthetic.py to train the fixture checkpoint in
tests/fixtures/, and by the quantization accuracy-budget tests
(bf16 vs int8 / w8a8 agreement is only meaningful on weights that
actually detect something).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

CLASS_NAMES = ("disc", "slab")

# the gate fixture's classes match modules/yolo.py DETECTORS["gate"]
# (reference modules/yolo.py:101-165 buckets "shark"/"saw" detections into
# handlers/gate.py) so a checkpoint trained on render_gate_scene serves the
# REAL yolo-module -> GateOBB path in BASELINE config 2
GATE_CLASS_NAMES = ("shark", "saw")


def draw_gate_object(
    img: np.ndarray, cls_id: int, cx: float, cy: float, r: float
) -> np.ndarray:
    """Draw one gate object in-place (patch-local, cheap at 720p) and
    return its xyxy box. shark (cls 0): warm orange disc with a darker
    tail half; saw (cls 1): bright silver disc with a dark hub hole. The
    SAME primitive renders both the training scenes (render_gate_scene)
    and the bench/video gate scene (capture_sources/synthetic.py), so the
    serving distribution matches training by construction."""
    h, w = img.shape[:2]
    x0, x1 = max(int(cx - r) - 1, 0), min(int(cx + r) + 2, w)
    y0, y1 = max(int(cy - r) - 1, 0), min(int(cy + r) + 2, h)
    if x1 <= x0 or y1 <= y0:
        return np.array([cx - r, cy - r, cx + r, cy + r], np.float32)
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    disc = d2 <= r * r
    if cls_id == 0:  # shark
        col = np.array([25.0, 95.0, 235.0])  # BGR warm orange-red
        shade = 1.0 - 0.35 * ((xx - (cx - r)) / max(2 * r, 1.0))
        patch = col * shade[..., None]
    else:  # saw
        patch = np.full((*disc.shape, 3), (215.0, 212.0, 208.0))
        patch[d2 <= (0.35 * r) ** 2] = (45.0, 42.0, 48.0)
    region = img[y0:y1, x0:x1]
    region[disc] = np.clip(patch, 0, 255).astype(np.uint8)[disc]
    return np.array([cx - r, cy - r, cx + r, cy + r], np.float32)


def render_gate_scene(
    rng: np.random.Generator, size: int = 160, max_objects: int = 2
):
    """Gate-task scene: (img_u8_bgr, boxes_xyxy f32 [2, 4], cls i32 [2])
    with one shark and/or one saw at random positions/scales over the
    standard noisy gradient — labels exact by construction."""
    top = rng.uniform(20, 70, 3)
    bot = rng.uniform(20, 70, 3)
    t = np.linspace(0.0, 1.0, size, dtype=np.float32)[:, None, None]
    img = np.clip(
        top * (1 - t) + bot * t + rng.normal(0.0, 6.0, (size, size, 3)),
        0,
        255,
    ).astype(np.uint8)

    boxes = np.zeros((max_objects, 4), np.float32)
    cls = np.full((max_objects,), -1, np.int32)
    order = rng.permutation(2)[: int(rng.integers(1, max_objects + 1))]
    placed = 0
    for c in order:
        for _ in range(12):
            r = float(rng.uniform(size * 0.06, size * 0.16))
            cx = float(rng.uniform(r + 2, size - r - 2))
            cy = float(rng.uniform(r + 2, size - r - 2))
            box = np.array([cx - r, cy - r, cx + r, cy + r], np.float32)
            if any(_iou(box, boxes[i]) > 0.2 for i in range(placed)):
                continue
            draw_gate_object(img, int(c), cx, cy, r)
            boxes[placed] = box
            cls[placed] = int(c)
            placed += 1
            break
    return img, boxes, cls


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def render_scene(
    rng: np.random.Generator,
    size: int = 128,
    max_objects: int = 3,
    with_masks: bool = False,
):
    """One scene: (img_u8_bgr [size,size,3], boxes_xyxy f32 [max_objects,4],
    cls i32 [max_objects]); cls = -1 marks padding rows. with_masks=True
    appends exact instance masks on the segment task's prototype grid
    ([max_objects, size//4, size//4] f32 binary, block-mean >= 0.5 of the
    rendered pixel mask) — labels stay exact by construction.

    Objects are warm-colored (high red/orange) on a cool background so the
    task is learnable by a small model in a few hundred steps; positions
    are rejection-sampled to pairwise IoU <= 0.2 so one anchor cell rarely
    owns two objects (train.py assigns by center cell)."""
    # background: vertical blue-green gradient + per-pixel noise
    top = rng.uniform(20, 70, 3)
    bot = rng.uniform(20, 70, 3)
    t = np.linspace(0.0, 1.0, size, dtype=np.float32)[:, None, None]
    bg = top * (1 - t) + bot * t
    img = bg + rng.normal(0.0, 6.0, (size, size, 3))

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    boxes = np.zeros((max_objects, 4), np.float32)
    cls = np.full((max_objects,), -1, np.int32)
    hp = size // 4
    masks = np.zeros((max_objects, hp, hp), np.float32) if with_masks else None

    n = int(rng.integers(1, max_objects + 1))
    placed = 0
    for _ in range(12 * n):
        if placed == n:
            break
        c = int(rng.integers(0, len(CLASS_NAMES)))
        # warm BGR color: strong red, some green, little blue
        color = np.array(
            [rng.uniform(0, 60), rng.uniform(40, 140), rng.uniform(170, 255)]
        )
        if c == 0:  # disc
            r = float(rng.uniform(size * 0.06, size * 0.18))
            cx = float(rng.uniform(r + 2, size - r - 2))
            cy = float(rng.uniform(r + 2, size - r - 2))
            box = np.array([cx - r, cy - r, cx + r, cy + r], np.float32)
            mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        else:  # slab
            w = float(rng.uniform(size * 0.12, size * 0.4))
            h = float(rng.uniform(size * 0.08, size * 0.25))
            x0 = float(rng.uniform(2, size - w - 2))
            y0 = float(rng.uniform(2, size - h - 2))
            box = np.array([x0, y0, x0 + w, y0 + h], np.float32)
            mask = (xx >= x0) & (xx < x0 + w) & (yy >= y0) & (yy < y0 + h)
        if any(_iou(box, boxes[i]) > 0.2 for i in range(placed)):
            continue
        shade = 1.0 - 0.25 * ((yy - box[1]) / max(box[3] - box[1], 1.0))
        img = np.where(mask[..., None], color * shade[..., None], img)
        boxes[placed] = box
        cls[placed] = c
        if masks is not None:
            masks[placed] = (
                mask.astype(np.float32).reshape(hp, 4, hp, 4).mean((1, 3))
                >= 0.5
            )
        placed += 1

    img = np.clip(img, 0, 255).astype(np.uint8)
    if masks is not None:
        return img, boxes, cls, masks
    return img, boxes, cls


def make_batch(
    rng: np.random.Generator,
    batch: int,
    size: int = 128,
    max_objects: int = 3,
    with_masks: bool = False,
):
    """Stacked scenes shaped for train.make_train_step: images u8 BGR
    [B,S,S,3], targets_xyxy f32 [B,T,4] (model pixels), targets_cls i32
    [B,T] with -1 padding; with_masks=True appends targets_masks f32
    [B,T,S//4,S//4] (the segment step's trailing argument)."""
    scenes = [
        render_scene(rng, size, max_objects, with_masks=with_masks)
        for _ in range(batch)
    ]
    stacked = tuple(np.stack(part) for part in zip(*scenes))
    return stacked


def match_detections(
    decoded: dict,
    gt_boxes: np.ndarray,
    gt_cls: np.ndarray,
    conf: float = 0.25,
    iou_min: float = 0.5,
    return_pairs: bool = False,
):
    """Greedy-match one image's decode dict against its ground truth:
    (true_positives, n_gt, n_pred). A prediction matches an unclaimed gt
    of the same class with IoU >= iou_min; predictions are visited in
    score order (the fixed-shape decode is already score-sorted).
    return_pairs=True appends the matched (pred_idx, gt_idx) list — used
    by the segment eval to score mask IoU over matched detections."""
    xyxy = np.asarray(decoded["xyxy"], np.float32)
    score = np.asarray(decoded["score"], np.float32)
    dcls = np.asarray(decoded["cls"], np.int32)
    valid = np.asarray(decoded["valid"], bool)
    keep = valid & (score >= conf)
    gt_idx = [i for i in range(len(gt_cls)) if gt_cls[i] >= 0]
    claimed = set()
    pairs = []
    tp = 0
    for i in np.nonzero(keep)[0]:
        best, best_iou = None, iou_min
        for g in gt_idx:
            if g in claimed or int(gt_cls[g]) != int(dcls[i]):
                continue
            iou = _iou(xyxy[i], gt_boxes[g])
            if iou >= best_iou:
                best, best_iou = g, iou
        if best is not None:
            claimed.add(best)
            pairs.append((int(i), best))
            tp += 1
    if return_pairs:
        return tp, len(gt_idx), int(keep.sum()), pairs
    return tp, len(gt_idx), int(keep.sum())


OBB_CLASS_NAMES = ("slab",)
POSE_CLASS_NAMES = ("disc",)
POSE_NUM_KEYPOINTS = 5  # center + N/E/S/W rim points


def render_obb_scene(
    rng: np.random.Generator,
    size: int = 128,
    max_objects: int = 2,
):
    """Rotated-slab scene for the obb task: (img_u8_bgr, extents_xyxy f32
    [T, 4], cls i32 [T], angle f32 [T]). extents_xyxy encodes center +-
    (w/2, h/2) of the UNrotated rectangle — the decomposition dist2rbox
    decodes (decode.decode_boxes) and train.detection_loss regresses;
    angle lives inside the decodable (-pi/4, 3pi/4) range. Labels exact
    by construction."""
    top = rng.uniform(20, 70, 3)
    bot = rng.uniform(20, 70, 3)
    t = np.linspace(0.0, 1.0, size, dtype=np.float32)[:, None, None]
    img = top * (1 - t) + bot * t + rng.normal(0.0, 6.0, (size, size, 3))

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    boxes = np.zeros((max_objects, 4), np.float32)
    cls = np.full((max_objects,), -1, np.int32)
    angles = np.zeros((max_objects,), np.float32)

    n = int(rng.integers(1, max_objects + 1))
    placed = 0
    for _ in range(12 * n):
        if placed == n:
            break
        w = float(rng.uniform(size * 0.18, size * 0.42))
        h = float(rng.uniform(size * 0.08, w * 0.7))  # elongated: a square
        # slab's angle would be unidentifiable modulo pi/2
        theta = float(rng.uniform(-np.pi / 4 + 0.08, 3 * np.pi / 4 - 0.08))
        half_diag = 0.5 * np.hypot(w, h)
        cx = float(rng.uniform(half_diag + 2, size - half_diag - 2))
        cy = float(rng.uniform(half_diag + 2, size - half_diag - 2))
        box = np.array(
            [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], np.float32
        )
        if any(_iou(box, boxes[i]) > 0.1 for i in range(placed)):
            continue
        # inside test in the rectangle's rotated frame
        ux, uy = np.cos(theta), np.sin(theta)
        dx, dy = xx - cx, yy - cy
        mask = (np.abs(dx * ux + dy * uy) <= w / 2) & (
            np.abs(-dx * uy + dy * ux) <= h / 2
        )
        color = np.array(
            [rng.uniform(0, 60), rng.uniform(40, 140), rng.uniform(170, 255)]
        )
        img = np.where(mask[..., None], color, img)
        boxes[placed] = box
        cls[placed] = 0
        angles[placed] = theta
        placed += 1

    return np.clip(img, 0, 255).astype(np.uint8), boxes, cls, angles


def render_pose_scene(
    rng: np.random.Generator,
    size: int = 128,
    max_objects: int = 2,
):
    """Disc-with-keypoints scene for the pose task: (img_u8_bgr, boxes_xyxy
    f32 [T, 4], cls i32 [T], kpts f32 [T, 5, 3]) — keypoints are the disc
    center and its N/E/S/W rim points (all visibility 1), exact by
    construction. The rim is drawn brighter than the body so the
    keypoints are visually recoverable, not just statistically."""
    top = rng.uniform(20, 70, 3)
    bot = rng.uniform(20, 70, 3)
    t = np.linspace(0.0, 1.0, size, dtype=np.float32)[:, None, None]
    img = top * (1 - t) + bot * t + rng.normal(0.0, 6.0, (size, size, 3))

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    boxes = np.zeros((max_objects, 4), np.float32)
    cls = np.full((max_objects,), -1, np.int32)
    kpts = np.zeros((max_objects, POSE_NUM_KEYPOINTS, 3), np.float32)

    n = int(rng.integers(1, max_objects + 1))
    placed = 0
    for _ in range(12 * n):
        if placed == n:
            break
        r = float(rng.uniform(size * 0.1, size * 0.2))
        cx = float(rng.uniform(r + 2, size - r - 2))
        cy = float(rng.uniform(r + 2, size - r - 2))
        box = np.array([cx - r, cy - r, cx + r, cy + r], np.float32)
        if any(_iou(box, boxes[i]) > 0.1 for i in range(placed)):
            continue
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        body = d2 <= r * r
        rim = (d2 <= r * r) & (d2 >= (0.8 * r) ** 2)
        color = np.array(
            [rng.uniform(0, 60), rng.uniform(40, 140), rng.uniform(170, 255)]
        )
        img = np.where(body[..., None], color * 0.7, img)
        img = np.where(rim[..., None], color * 1.25, img)
        boxes[placed] = box
        cls[placed] = 0
        kpts[placed] = [
            (cx, cy, 1.0),
            (cx, cy - r, 1.0),
            (cx + r, cy, 1.0),
            (cx, cy + r, 1.0),
            (cx - r, cy, 1.0),
        ]
        placed += 1

    return np.clip(img, 0, 255).astype(np.uint8), boxes, cls, kpts


def make_task_batch(
    rng: np.random.Generator,
    batch: int,
    size: int = 128,
    task: str = "detect",
    max_objects: int = None,
):
    """Stacked scenes + the task's extra target (None / masks / angles /
    kpts), shaped for train.make_train_step's trailing argument.
    max_objects=None picks the task default (3; obb/pose 2 — rotated
    slabs and keypointed discs need more clearance per object)."""
    if max_objects is None:
        max_objects = 2 if task in ("obb", "pose", "gate") else 3
    if task == "segment":
        return make_batch(rng, batch, size, max_objects, with_masks=True)
    if task == "obb":
        scenes = [render_obb_scene(rng, size, max_objects) for _ in range(batch)]
    elif task == "pose":
        scenes = [render_pose_scene(rng, size, max_objects) for _ in range(batch)]
    elif task == "gate":
        # detect-head training on the gate (shark/saw) scene family; the
        # extra slot stays None like plain detect
        scenes = [render_gate_scene(rng, size, max_objects) for _ in range(batch)]
    else:
        return make_batch(rng, batch, size, max_objects)
    return tuple(np.stack(part) for part in zip(*scenes))


def mask_iou(pred_mask: np.ndarray, gt_mask: np.ndarray, thresh: float = 0.5) -> float:
    """IoU of a predicted mask (probabilities, cut at ``thresh``) against a
    binary gt mask on the same grid — the segment task's quality metric."""
    p = np.asarray(pred_mask) >= thresh
    g = np.asarray(gt_mask) >= 0.5
    union = (p | g).sum()
    return float((p & g).sum() / union) if union else 1.0


def to_model_input(images_u8_bgr: np.ndarray) -> np.ndarray:
    """u8 BGR [B,S,S,3] -> f32 RGB [0,1] — the square-frame special case of
    model.preprocess_fused (no resize/pad when the frame is already S x S), so
    training inputs match exactly what the predictor feeds at inference."""
    return images_u8_bgr[..., ::-1].astype(np.float32) / 255.0

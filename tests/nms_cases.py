"""Candidate pools for the greedy NMS checks (numpy, seeded), shared by the
CPU tests, the card tests and ``chip_smoke.py``'s ``nms`` phase.

Each case is ``(boxes [B, P, 4] f32 xyxy, scores [B, P] f32, classes [B, P]
i32, angles [B, P] f32, max_det)``; a check runs it with the angles
(rotated ProbIoU) and without (axis-aligned IoU).

:func:`cases` holds seeded pools of 1 to 8400 candidates and the pools the
kernel's ordered, chunked walk must get right (:func:`walk_cases`: a NaN,
-inf and negative scores, a pool as decode's ``_top_pool`` hands it over,
ties across its 32-candidate chunks, picks deep in the order, the
cross-camera merge's padded pool, ``max_det`` > P)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Case = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]


def pool(rng: np.random.Generator, B: int, P: int, size: float = 640.0,
         n_classes: int = 4, tie_levels: int = 0) -> Tuple[np.ndarray, ...]:
    """Clustered boxes (so suppression happens), scores in (0, 1) with a
    share below the 0.25 threshold zeroed, as decode hands them over. With
    ``tie_levels`` > 0 scores take only that many distinct values."""
    n_clusters = max(1, P // 6)
    centers = rng.uniform(0, size, (B, n_clusters, 2))
    pick = rng.integers(0, n_clusters, (B, P))
    c = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 6, (B, P, 2))
    wh = rng.uniform(8, 120, (B, P, 2)) * rng.uniform(0.3, 1.0, (B, P, 1))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if tie_levels:
        scores = rng.integers(1, tie_levels + 1, (B, P)) / (tie_levels + 1)
    else:
        scores = rng.uniform(0, 1, (B, P))
    scores = np.where(scores >= 0.25, scores, 0.0).astype(np.float32)
    classes = rng.integers(0, n_classes, (B, P)).astype(np.int32)
    angles = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, P)).astype(np.float32)
    return boxes, scores, classes, angles


def poles(B: int) -> Case:
    """Two 100x10 boxes at 45 degrees, centers 20 px apart across their
    long axis: the rotated boxes do not overlap, their AABBs do (IoU ~0.5),
    so ProbIoU keeps both and AABB IoU merges them."""
    w, h = 100.0, 10.0
    c1 = (100.0, 100.0)
    c2 = (100.0 + 20.0 / np.sqrt(2), 100.0 - 20.0 / np.sqrt(2))
    boxes = np.array([[c[0] - w / 2, c[1] - h / 2, c[0] + w / 2, c[1] + h / 2] for c in (c1, c2)],
                     np.float32)
    return (np.repeat(boxes[None], B, 0), np.tile(np.float32([0.9, 0.8]), (B, 1)),
            np.zeros((B, 2), np.int32), np.full((B, 2), np.pi / 4, np.float32), 2)


def sorted_like_top_pool(boxes, scores, classes, angles):
    """Each row reordered as decode's ``_top_pool`` hands a pool over:
    scores descending, equal scores lowest index first."""
    order = np.argsort(-scores, axis=1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], 1), np.take_along_axis(scores, order, 1),
            np.take_along_axis(classes, order, 1), np.take_along_axis(angles, order, 1))


def deep_picks(rng: np.random.Generator, B: int, P: int, n_copies: int):
    """A pool whose first pick suppresses hundreds: ``n_copies`` jittered
    copies of one class-0 box hold the highest scores, in random places;
    the other candidates are a seeded pool with scores below theirs, so
    every pick after the first lies deeper in the order than the copies."""
    boxes, scores, classes, angles = pool(rng, B, P)
    scores = scores * np.float32(0.8)
    for b in range(B):
        at = rng.choice(P, n_copies, replace=False)
        x, y = rng.uniform(100, 500, 2)
        base = np.array([x, y, x + 60, y + 40])
        boxes[b, at] = base + rng.uniform(-0.5, 0.5, (n_copies, 4))
        scores[b, at] = rng.uniform(0.85, 0.99, n_copies)
        classes[b, at] = 0
        angles[b, at] = np.float32(0.3) + rng.uniform(-0.01, 0.01, n_copies)
    return boxes.astype(np.float32), scores.astype(np.float32), classes, angles.astype(np.float32)


def merge_pool(rng: np.random.Generator, cams: int = 2, per_cam: int = 32, kept: int = 20):
    """The cross-camera merge's pool: ``cams`` detection lists of
    ``per_cam`` rows flattened into one, each list's rows past ``kept``
    zero pad (box, score and class 0); the cameras see the same objects
    a few pixels apart."""
    objects = rng.uniform(0, 600, (kept, 2))
    wh = rng.uniform(20, 90, (kept, 2))
    cls = rng.integers(0, 4, kept)
    boxes = np.zeros((cams, per_cam, 4), np.float32)
    scores = np.zeros((cams, per_cam), np.float32)
    classes = np.zeros((cams, per_cam), np.int32)
    for c in range(cams):
        centers = objects + rng.normal(0, 4, (kept, 2))
        boxes[c, :kept] = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
        scores[c, :kept] = rng.uniform(0.3, 1.0, kept)
        classes[c, :kept] = cls
    angles = np.zeros((1, cams * per_cam), np.float32)
    return (boxes.reshape(1, -1, 4), scores.reshape(1, -1), classes.reshape(1, -1), angles)


def walk_cases() -> Dict[str, Case]:
    """The pools that exercise the kernel's ordering and chunked walk, from
    a generator of their own."""
    rng = np.random.default_rng(23)
    out: Dict[str, Case] = {}
    for B in (1, 8):
        b, s, c, a = pool(rng, B, 300)
        s[0, rng.integers(0, 300)] = np.nan  # row 0 only: the other rows pick as usual
        out[f"nan_b{B}_p300"] = (b, s, c, a, 32)
    b, s, c, a = pool(rng, 2, 200)
    s[:, ::3] = -np.inf
    s[:, 1::7] = -rng.uniform(0.1, 1.0, s[:, 1::7].shape)
    s[1, 2] = np.inf  # an infinite score is a positive one
    out["neg_inf_and_negative_b2_p200"] = (b, s, c, a, 32)
    out["presorted_b2_p512"] = (*sorted_like_top_pool(*pool(rng, 2, 512)), 32)
    out["presorted_ties_b2_p512"] = (*sorted_like_top_pool(*pool(rng, 2, 512, tie_levels=3)), 32)
    # two score levels: runs of equal scores cross every 32-candidate chunk
    out["ties_across_chunks_b1_p150"] = (*pool(rng, 1, 150, tie_levels=2), 40)
    out["ties_across_chunks_sorted_b1_p150"] = (*sorted_like_top_pool(*pool(rng, 1, 150, tie_levels=2)), 40)
    out["deep_picks_b2_p700"] = (*deep_picks(rng, 2, 700, 400), 32)
    out["deep_picks_sorted_b1_p700"] = (*sorted_like_top_pool(*deep_picks(rng, 1, 700, 400)), 32)
    out["merge_p64"] = (*merge_pool(rng), 32)
    out["max_det_above_p_b2_p20"] = (*pool(rng, 2, 20), 50)
    return out


def cases(small: bool = False) -> Dict[str, Case]:
    """The named pools; ``small`` leaves out the 8400-candidate ones."""
    rng = np.random.default_rng(11)
    out: Dict[str, Case] = {}
    sizes = (1, 7, 33, 512) if small else (1, 7, 33, 512, 8400)
    for B in (1, 8):
        for P in sizes:
            out[f"seeded_b{B}_p{P}"] = (*pool(rng, B, P), 32)
        out[f"ties_b{B}_p512"] = (*pool(rng, B, 512, tie_levels=3), 32)
        b, s, c, a = pool(rng, B, 512)
        out[f"all_below_threshold_b{B}"] = (b, np.zeros_like(s), c, a, 32)
        b, s, c, a = pool(rng, B, 512)
        s[:, 5:] = 0.0  # five candidates, far fewer than max_det
        out[f"fewer_than_max_det_b{B}"] = (b, s, c, a, 32)
        out[f"rotated_poles_b{B}"] = poles(B)
    out.update(walk_cases())
    return out


def timing_pools() -> Dict[str, tuple]:
    """The shapes the kernel is timed at, each ``(boxes, scores, classes,
    angles or None, iou_thresh, max_det)``: decode's pool (B = 1 and the
    two-camera B = 2, 512 candidates, sorted as ``_top_pool`` hands them
    over, ProbIoU), the cross-camera merge (64 candidates, AABB, IoU 0.55),
    the pool disabled at 640 px (8400 anchors, sorted), 20000 and the
    largest pool the wrapper takes, sorted, and 8400 unsorted (the kernel
    orders it itself)."""
    rng = np.random.default_rng(31)
    out = {}
    sorted_pools = {name: (*sorted_like_top_pool(*pool(rng, B, P)), 0.45, 32)
                    for name, B, P in (("b1_p512", 1, 512), ("b2_p512", 2, 512), ("b1_p8400", 1, 8400),
                                       ("b1_p20000", 1, 20000), ("b1_p58112", 1, 232448 // 4))}
    boxes, scores, classes, _ = merge_pool(rng)
    unsorted = (*pool(rng, 1, 8400), 0.45, 32)
    # the largest last: a kernel that cannot launch it (the round-per-pick
    # design could not) leaves every pool before it timed
    return {"b1_p512_probiou": sorted_pools["b1_p512"], "b2_p512_probiou": sorted_pools["b2_p512"],
            "merge_p64_aabb": (boxes, scores, classes, None, 0.55, 32),
            "b1_p8400_probiou": sorted_pools["b1_p8400"], "b1_p8400_unsorted_probiou": unsorted,
            "b1_p20000_probiou": sorted_pools["b1_p20000"], "b1_p58112_probiou": sorted_pools["b1_p58112"]}

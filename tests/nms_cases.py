"""Candidate pools for the greedy NMS checks (numpy, seeded), shared by the
CPU tests, the card tests and ``chip_smoke.py``'s ``nms`` phase.

Each case is ``(boxes [B, P, 4] f32 xyxy, scores [B, P] f32, classes [B, P]
i32, angles [B, P] f32, max_det)``; a check runs it with the angles
(rotated ProbIoU) and without (axis-aligned IoU)."""

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
    return out

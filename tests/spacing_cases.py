"""Candidate sets for the greedy spacing checks (numpy, seeded), shared by
the CPU tests, the card tests and ``chip_smoke.py``'s ``spacing`` phase.

Each case is ``(ys int32 [K], xs int32 [K], cand bool [K], min_distance)``,
strongest candidate first. The bins scenes' and the template's own
candidates come from ``ops.feature.detect_candidates`` where a check runs
it; these are the synthetic ones: every K the kernel's block shapes change
at (up to 1024 a fixpoint thread per candidate, past it threads owning
several, so K = 1025, 2048 and 4096), no candidate at all, dense 3-px
grids, exact-tie plateaus (blocks of adjacent pixels of one response,
ordered lowest index first) and repeated points."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Case = Tuple[np.ndarray, np.ndarray, np.ndarray, int]


def greedy(ys, xs, cand, min_distance: int) -> np.ndarray:
    """The sequential strongest-first selection the kernel must equal."""
    kept = np.zeros(len(cand), bool)
    y = np.asarray(ys, np.int64)
    x = np.asarray(xs, np.int64)
    for i in range(len(cand)):
        if cand[i]:
            d2 = (y[i] - y) ** 2 + (x[i] - x) ** 2
            kept[i] = not np.any(kept & (d2 < min_distance * min_distance))
    return kept


def _points(rng: np.random.Generator, K: int, extent: int) -> Case:
    ys = rng.integers(0, extent, K).astype(np.int32)
    xs = rng.integers(0, extent, K).astype(np.int32)
    return ys, xs, rng.random(K) < 0.9, 8


def cases() -> Dict[str, Case]:
    rng = np.random.default_rng(13)
    out: Dict[str, Case] = {}
    for K in (1, 2, 31, 32, 33, 512, 1024):
        # extent so that about half of the candidates conflict
        out[f"random_k{K}"] = _points(rng, K, max(8, int(5 * np.sqrt(K))))
    for md in (0, 1, 3, 17):
        ys, xs, cand, _ = _points(rng, 512, 160)
        out[f"random_k512_md{md}"] = (ys, xs, cand, md)
    ys, xs, _, _ = _points(rng, 512, 100)
    out["all_false_k512"] = (ys, xs, np.zeros(512, bool), 8)
    gy, gx = np.meshgrid(np.arange(32) * 3, np.arange(32) * 3, indexing="ij")
    out["grid3_k1024"] = (gy.reshape(-1).astype(np.int32), gx.reshape(-1).astype(np.int32),
                          np.ones(1024, bool), 8)
    # plateaus: 4x4 blocks of adjacent pixels sharing one response, blocks
    # strongest first and each block's pixels in raster order
    corners = rng.integers(0, 200, (32, 2))
    dy, dx = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    ys = (corners[:, :1] + dy.reshape(1, -1)).reshape(-1).astype(np.int32)
    xs = (corners[:, 1:] + dx.reshape(1, -1)).reshape(-1).astype(np.int32)
    out["plateaus_k512"] = (ys, xs, np.ones(512, bool), 8)
    ys, xs, cand, _ = _points(rng, 128, 60)
    out["repeated_k512"] = (np.tile(ys, 4), np.tile(xs, 4), np.tile(cand, 4), 8)
    # past 1024 candidates (a generator of their own, so the cases
    # above keep their points)
    rng = np.random.default_rng(14)
    for K in (1025, 2048, 4096):
        out[f"random_k{K}"] = _points(rng, K, int(5 * np.sqrt(K)))
    gy, gx = np.meshgrid(np.arange(64) * 3, np.arange(64) * 3, indexing="ij")
    out["grid3_k4096"] = (gy.reshape(-1).astype(np.int32), gx.reshape(-1).astype(np.int32),
                          np.ones(4096, bool), 8)
    corners = rng.integers(0, 400, (128, 2))
    ys = (corners[:, :1] + dy.reshape(1, -1)).reshape(-1).astype(np.int32)
    xs = (corners[:, 1:] + dx.reshape(1, -1)).reshape(-1).astype(np.int32)
    out["plateaus_k2048"] = (ys, xs, np.ones(2048, bool), 8)
    return out

"""The benchmark's arithmetic: the card's peaks, window statistics and the
device-interval reduction that every cell shares.

Nothing here reads the program: rates, tails and shares are worked out from
the counts and times the harness takes itself.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

# Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense
# rates, at the full 700 W power limit). A card set below 700 W reaches less;
# the result line names the card and its limit beside every share.
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops_per_s": 989e12,
}


def rate(count: int, seconds: float) -> float:
    """Work per second over the whole window: every completed item counts,
    the window's whole length is the denominator."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (0 < q <= 100) over every value given:
    the smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    if not 0 < q <= 100:
        raise ValueError(f"q={q}")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def merge_intervals(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of half-open [start, end) intervals, sorted and disjoint."""
    merged: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def clip_intervals(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """Each interval cut to [lo, hi); the ones outside it dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_and_gaps(intervals: Iterable[Tuple[int, int]], lo: int, hi: int):
    """(busy length, idle gaps) of the union of ``intervals`` inside the
    window [lo, hi): the gaps are the window's stretches that no interval
    covers, as (start, end) pairs."""
    merged = merge_intervals(clip_intervals(intervals, lo, hi))
    busy = sum(e - s for s, e in merged)
    gaps, cursor = [], lo
    for s, e in merged:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < hi:
        gaps.append((cursor, hi))
    return busy, gaps

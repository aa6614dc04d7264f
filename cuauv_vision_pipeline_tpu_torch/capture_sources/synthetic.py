#!/usr/bin/env python3
"""Synthetic capture source: procedural scenes at any resolution.

New in the rebuild (no reference equivalent): generates frames with moving
colored blobs on a textured background — deterministic, asset-free feed for
tests and benchmarks. The "buoy" scene drops a red disc whose LAB-A response
exercises the red_buoy chain end to end.
"""

from __future__ import annotations

import argparse
import functools
import math
from typing import Tuple

import numpy as np

from ..core.capture_source import CaptureSource, FpsLimiter


@functools.lru_cache(maxsize=4)
def _backdrop(shape: Tuple[int, int], seed: int) -> np.ndarray:
    """Static teal noise backdrop (cached; regenerating 2M random pixels per
    frame would dominate the source's frame budget)."""
    h, w = shape
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 90, (h, w, 3), dtype=np.uint8)
    base[..., 0] = np.clip(base[..., 0].astype(np.int32) + 40, 0, 255)  # blue
    base[..., 1] = np.clip(base[..., 1].astype(np.int32) + 70, 0, 255)  # green
    base.setflags(write=False)
    return base


def buoy_frame(
    shape: Tuple[int, int],
    t: float,
    radius_frac: float = 0.08,
    seed: int = 7,
) -> np.ndarray:
    """A teal underwater backdrop with a red disc orbiting the center.

    The backdrop is green-shifted so its LAB A channel sits well below
    neutral (green = negative a*), leaving the red disc (a* >> 128) cleanly
    separable by the red_buoy threshold chain."""
    h, w = shape
    base = _backdrop(shape, seed)

    cy = h / 2 + 0.3 * h * math.sin(t * 0.7)
    cx = w / 2 + 0.3 * w * math.cos(t * 0.9)
    r = radius_frac * min(h, w)

    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    disc = (ys - cy) ** 2 + (xs - cx) ** 2 <= r * r
    frame = base.copy()
    frame[disc] = (30, 30, 220)  # BGR red buoy
    return frame


class Synthetic(CaptureSource):
    def __init__(
        self,
        direction: str,
        width: int = 1920,
        height: int = 1080,
        fps: int = 60,
        scene: str = "buoy",
        precompute: int = 0,
    ):
        super().__init__()
        if scene not in ("buoy", "zed"):
            raise ValueError(f"unknown scene {scene}")

        def gen(k: int) -> np.ndarray:
            return buoy_frame((height, width), k / max(fps, 1))

        # precompute>0: render N frames up front and cycle them, so the
        # producer's per-frame cost is pure bus memcpy — the max-rate feed
        # for end-to-end throughput benches
        pre = [gen(i) for i in range(precompute)] if precompute > 0 else None

        def udl(limiter: FpsLimiter, args):
            k = 0
            for t in limiter.rate(fps):
                frame = pre[k % len(pre)] if pre else gen(k)
                k += 1
                yield (direction, t, frame)

        def zed_udl(limiter: FpsLimiter, args):
            """Fake ZED: the production aggregated 4-plane layout
            (forward/forward2/depth/normal — reference zed.cpp:139-214),
            so zed-consuming modules run unmodified on a dev machine
            (the reference's fake-backend substitution strategy,
            SURVEY.md §4)."""
            depth = np.full((height, width, 1), 2.0, np.float32)
            normal = np.full((height, width, 3), 0.5, np.float32)
            k = 0
            for t in limiter.rate(fps):
                frame = pre[k % len(pre)] if pre else gen(k)
                k += 1
                yield (
                    direction,
                    t,
                    (frame, frame, depth, normal),
                    ("forward", "forward2", "depth", "normal"),
                )

        self.register_capture_udl(
            f"synthetic:{direction}", zed_udl if scene == "zed" else udl
        )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="synthetic procedural camera")
    parser.add_argument("direction")
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--scene", default="buoy")
    parser.add_argument(
        "--precompute",
        type=int,
        default=0,
        help="render N frames up front and cycle them (max-rate producer)",
    )
    args = parser.parse_args(argv)
    Synthetic(
        args.direction,
        args.width,
        args.height,
        args.fps,
        args.scene,
        args.precompute,
    ).run_event_loop()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Synthetic capture source: procedural scenes at any resolution.

New in the rebuild (no reference equivalent): generates frames with moving
colored blobs on a textured background — deterministic, asset-free feed for
tests and benchmarks. The "buoy" scene drops a red disc whose LAB-A response
exercises the red_buoy chain end to end; the "bins" scene translates the
textured bin plate (the bins module's beige mask and pose template) over the
same backdrop; the "gate" scene orbits a shark and a saw, the gate task's
two classes, drawn as the gate detector's training scenes draw them.
"""

from __future__ import annotations

import argparse
import functools
import math
from typing import Tuple

import numpy as np

from ..core.capture_source import CaptureSource, FpsLimiter
from ..models.yolo.synth import draw_gate_object


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


@functools.lru_cache(maxsize=2)
def bin_texture(h: int = 160, w: int = 320, seed: int = 11) -> np.ndarray:
    """The canonical bin face: a beige plate (HSV H 10-30, S 20-100 — inside
    the bins module's inRange window) with high-contrast speckles and grid
    lines so the keypoint detector finds repeatable keypoints. Doubles as the
    pose template (``CUAUV_BINS_POSE_TEMPLATE=builtin``) for BASELINE config
    3's "contour + sift pose estimation" flow (reference utils/sift.py:14-142)."""
    rng = np.random.default_rng(seed)
    tex = np.empty((h, w, 3), np.uint8)
    tex[:] = (150, 190, 215)  # BGR beige (cv2 HSV ~ H 20, S 77, V 215)
    # darker beige blotches (same hue family; stay inside the mask window)
    for _ in range(40):
        by, bx = rng.integers(0, h - 12), rng.integers(0, w - 24)
        bh, bw = rng.integers(6, 14), rng.integers(10, 26)
        shade = int(rng.integers(110, 190))
        tex[by : by + bh, bx : bx + bw] = (
            int(shade * 0.7),
            int(shade * 0.88),
            shade,
        )
    # grid lines: strong gradients at known spots
    tex[:: h // 8, :] = (90, 115, 140)
    tex[:, :: w // 8] = (90, 115, 140)
    tex.setflags(write=False)
    return tex


def bins_frame(shape: Tuple[int, int], t: float, seed: int = 7) -> np.ndarray:
    """Teal backdrop with the textured bin plate translating over time (at
    template scale, so keypoints match 1:1)."""
    h, w = shape
    base = _backdrop(shape, seed)
    tex = bin_texture()
    th, tw = tex.shape[:2]
    y0 = int((h - th) * (0.5 + 0.35 * math.sin(t * 0.5)))
    x0 = int((w - tw) * (0.5 + 0.35 * math.cos(t * 0.7)))
    frame = base.copy()
    frame[y0 : y0 + th, x0 : x0 + tw] = tex
    return frame


def gate_frame(shape: Tuple[int, int], t: float, seed: int = 7) -> np.ndarray:
    """Teal backdrop with a shark and a saw (the gate task's two classes)
    orbiting on opposite phases -- drawn by the SAME primitive the gate
    training scenes use (models/yolo/synth.draw_gate_object), so the
    in-repo gate checkpoint detects them without domain gap. Feeds
    BASELINE config 2's localization loop."""
    h, w = shape
    frame = _backdrop(shape, seed).copy()
    for cls_id, phase in ((0, 0.0), (1, math.pi)):
        cy = h / 2 + 0.28 * h * math.sin(t * 0.6 + phase)
        cx = w / 2 + 0.28 * w * math.cos(t * 0.8 + phase)
        r = 0.11 * min(h, w)
        draw_gate_object(frame, cls_id, cx, cy, r)
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
        if scene not in ("buoy", "zed", "bins", "gate"):
            raise ValueError(f"unknown scene {scene}")
        frame_fn = {"bins": bins_frame, "gate": gate_frame}.get(scene, buoy_frame)

        def gen(k: int) -> np.ndarray:
            return frame_fn((height, width), k / max(fps, 1))

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

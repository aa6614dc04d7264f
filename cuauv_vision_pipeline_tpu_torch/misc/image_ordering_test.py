#!/usr/bin/env python3
"""Manual IPC check: cycle solid-color frames through a block at 1 Hz.

Port of ``cuauv_vision_pipeline_tpu.misc.image_ordering_test`` on the port's
bus binding (one wire format: a JAX reader sees the same frames). Parity
target: reference misc/image_ordering_test.py:30-36 (written against a
legacy API and broken; this one works): writes a known color cycle so a
human watching the GUI (or stream client) can verify ordering and liveness.
``--frames N`` stops after N frames (default: until interrupted).

    python -m cuauv_vision_pipeline_tpu_torch.misc.image_ordering_test [DIRECTION] [--hz 1]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.bindings.frame_bus import BlockAccessor

COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
    (255, 0, 255), (0, 255, 255), (255, 255, 255), (0, 0, 0),
]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("direction", nargs="?", default="ordering_test")
    parser.add_argument("--hz", type=float, default=1.0)
    parser.add_argument("--frames", type=int, default=0, help="stop after this many (0: never)")
    args = parser.parse_args(argv)

    frame = np.zeros((240, 320, 3), np.uint8)
    with BlockAccessor(args.direction, frame.nbytes) as block:
        i = 0
        print(f"writing color cycle to '{args.direction}' at {args.hz} Hz")
        while not args.frames or i < args.frames:
            frame[:] = COLORS[i % len(COLORS)]
            block.write_frame(int(time.monotonic() * 1000), frame)
            print(f"frame {i}: color {COLORS[i % len(COLORS)]}")
            i += 1
            time.sleep(1.0 / args.hz)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Manual end-to-end latency check for a live camera.

Port of ``cuauv_vision_pipeline_tpu.misc.webcam_latency_test`` on the
port's bus binding. Parity target: reference misc/webcam_latency_test.py
(legacy API; rebuilt): reads a direction off the bus and prints the
camera->read latency per frame so a human can eyeball the pipeline delay.

    python -m cuauv_vision_pipeline_tpu_torch.misc.webcam_latency_test DIRECTION [--seconds 10]
"""

from __future__ import annotations

import argparse
import time

from ..core.bindings.frame_bus import BlockAccessor, ReadStatus


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("direction")
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)

    with BlockAccessor(args.direction, block_thread=True) as block:
        deadline = time.monotonic() + args.seconds
        n = 0
        total = 0.0
        while time.monotonic() < deadline:
            status, frame, acq_ms = block.read_frame()
            if status == ReadStatus.SUCCESS:
                latency = time.monotonic() * 1000 - acq_ms
                n += 1
                total += latency
                print(f"latency: {latency:7.2f} ms")
            elif status == ReadStatus.FRAMEWORK_DELETED:
                print("source deleted")
                break
        if n:
            print(f"avg over {n} frames: {total / n:.2f} ms")


if __name__ == "__main__":
    main()

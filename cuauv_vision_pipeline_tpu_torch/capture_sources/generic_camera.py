#!/usr/bin/env python3
"""Webcam capture source (any V4L device).

Port of ``cuauv_vision_pipeline_tpu.capture_sources.generic_camera``, a
copy (no device work). Parity target: reference
capture_sources/generic_camera.py:11-40 (installed as auv-webcam-camera) —
cv2.VideoCapture(index) at a capped fps.

    python -m cuauv_vision_pipeline_tpu_torch.capture_sources.generic_camera DIRECTION [--index 0] [--fps 15]
"""

from __future__ import annotations

import argparse

from ..core.capture_source import CaptureSource, FpsLimiter


class GenericCamera(CaptureSource):
    def __init__(self, index: int, direction: str, fps: int = 15):
        super().__init__()
        import cv2

        capture = cv2.VideoCapture(index)
        if not capture.isOpened():
            raise RuntimeError(f"cannot open camera index {index}")

        def udl(limiter: FpsLimiter, args):
            for t in limiter.rate(fps):
                ok, frame = capture.read()
                if not ok:
                    return
                yield (direction, t, frame)

        self.register_capture_udl(f"webcam:{index}", udl)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="webcam capture source")
    parser.add_argument("direction")
    parser.add_argument("--index", type=int, default=0)
    parser.add_argument("--fps", type=int, default=15)
    args = parser.parse_args(argv)
    GenericCamera(args.index, args.direction, args.fps).run_event_loop()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Video-file capture source: recorded video replay with fan-out.

Parity target: reference capture_sources/video.py:9-56 (installed as
auv-video-camera) — plays a video at its native fps, optionally looping,
fanning each frame out to multiple directions from a spec string
``filepath:dir1,dir2``. This is the record/replay resume story
(SURVEY.md §5 checkpoint/resume) and BASELINE config #2's feeder.

Port of ``cuauv_vision_pipeline_tpu.capture_sources.video``: cv2 decodes,
imported when a file is opened, so the module imports where cv2 is missing.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

from ..core.capture_source import CaptureSource, FpsLimiter


def parse_spec(spec: str) -> Tuple[str, List[str]]:
    """``path/to/file.mp4:dir1,dir2`` -> (path, [dir1, dir2])."""
    if ":" not in spec:
        raise ValueError(
            f"invalid spec '{spec}': expected filepath:direction[,direction...]"
        )
    path, dirs = spec.rsplit(":", maxsplit=1)
    directions = [d.strip() for d in dirs.split(",") if d.strip()]
    if not directions:
        raise ValueError(f"no directions in spec '{spec}'")
    return path, directions


class VideoFile(CaptureSource):
    def __init__(self, spec: str, loop: bool, fps_override: int = 0):
        super().__init__()
        import cv2  # host-side decode only

        path, directions = parse_spec(spec)
        capture = cv2.VideoCapture(path)
        if not capture.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        native_fps = capture.get(cv2.CAP_PROP_FPS) or 30
        fps = fps_override if fps_override > 0 else int(round(native_fps))

        def udl(limiter: FpsLimiter, args):
            while True:
                ok, frame = capture.read()
                if not ok:
                    if not loop:
                        return
                    capture.set(cv2.CAP_PROP_POS_FRAMES, 0)
                    continue
                t = next(iter(limiter.rate(fps)))
                for direction in directions:
                    yield (direction, t, frame)

        self.register_capture_udl(f"video:{path}", udl)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="replay a video as a capture source")
    parser.add_argument("spec", help="filepath:direction[,direction...]")
    parser.add_argument("--loop", action="store_true")
    parser.add_argument("--fps", type=int, default=0, help="override native fps")
    args = parser.parse_args(argv)
    VideoFile(args.spec, args.loop, args.fps).run_event_loop()


if __name__ == "__main__":
    main()

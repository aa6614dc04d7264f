#!/usr/bin/env python3
"""Image-directory capture source: a folder of stills as a fake camera.

Port of ``cuauv_vision_pipeline_tpu.capture_sources.image_directory``
(reference capture_sources/image_directory.py:13-54): loads every image in a
directory and yields them (looping unless ``--no-loop``) at ``--fps`` into
one direction. BASELINE config 1 pairs it with red_buoy.

Decoding keeps the JAX loader's order, cv2 and then PIL, so the frames are
the JAX loader's frames.

    python -m cuauv_vision_pipeline_tpu_torch.capture_sources.image_directory DIR DIRECTION [--fps N] [--no-loop]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List

import numpy as np

from ..core.capture_source import CaptureSource, FpsLimiter

_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp"}


def load_images(directory: str) -> List[np.ndarray]:
    """Load all images in a directory as u8 BGR arrays (sorted by name):
    through cv2 (files it cannot decode are skipped, as in the JAX
    loader), else PIL."""
    paths = sorted(
        p for p in Path(directory).iterdir() if p.suffix.lower() in _EXTENSIONS
    )
    if not paths:
        raise FileNotFoundError(f"no images found in {directory}")
    images = []
    try:
        import cv2

        for p in paths:
            img = cv2.imread(str(p), cv2.IMREAD_COLOR)
            if img is not None:
                images.append(img)
    except ImportError:
        from PIL import Image

        for p in paths:
            rgb = np.asarray(Image.open(p).convert("RGB"))
            images.append(rgb[..., ::-1].copy())  # RGB -> BGR
    if not images:
        raise RuntimeError(f"failed to decode any image in {directory}")
    return images


class ImageDirectory(CaptureSource):
    def __init__(self, directory: str, direction: str, fps: int, loop: bool):
        super().__init__()
        images = load_images(directory)

        def udl(limiter: FpsLimiter, args):
            while True:
                for img in images:
                    t = next(iter(limiter.rate(fps)))
                    yield (direction, t, img)
                if not loop:
                    return

        self.register_capture_udl(f"image_directory:{direction}", udl)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="stream a directory of images as a capture source"
    )
    parser.add_argument("directory", help="directory containing images")
    parser.add_argument("direction", help="frame bus direction to publish")
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--no-loop", action="store_true")
    args = parser.parse_args(argv)

    ImageDirectory(
        args.directory, args.direction, args.fps, not args.no_loop
    ).run_event_loop()


if __name__ == "__main__":
    main()

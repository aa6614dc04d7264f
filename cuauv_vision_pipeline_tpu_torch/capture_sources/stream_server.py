#!/usr/bin/env python3
"""Network stream bridge — publisher side.

Port of ``cuauv_vision_pipeline_tpu.capture_sources.stream_server``, a copy
with the same wire format (direction, acquisition time, JPEG), so a JAX
server feeds a port client and the other way round. Parity target:
reference capture_sources/stream_server.py:14-34 — read a direction's
frames from the bus, JPEG-encode, publish over the network at ~10 Hz. The
reference used nanomsg PUB/SUB on tcp:8081; this rebuild uses ZeroMQ
PUB/SUB (same pattern) and prefixes each message with the direction name so
one server can multiplex sources. Cameras on remote hosts reach the
accelerator host through this bridge (SURVEY.md §2.8 P7).

    python -m cuauv_vision_pipeline_tpu_torch.capture_sources.stream_server DIRECTION [--bind tcp://0.0.0.0:8081]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.bindings.frame_bus import BlockAccessor, ReadStatus
from ..core.log import log


def encode_jpeg(frame: np.ndarray, quality: int = 100) -> bytes:
    try:
        import cv2

        ok, buf = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        return buf.tobytes()
    except ImportError:
        import io

        from PIL import Image

        bio = io.BytesIO()
        rgb = frame[..., ::-1] if frame.ndim == 3 else frame
        Image.fromarray(rgb).save(bio, format="JPEG", quality=min(quality, 95))
        return bio.getvalue()


def serve(direction: str, bind: str = "tcp://0.0.0.0:8081", fps: int = 10,
          quality: int = 100) -> None:
    import zmq

    logger = log.vision.stream_server
    ctx = zmq.Context()
    sock = ctx.socket(zmq.PUB)
    sock.bind(bind)
    logger(f"publishing '{direction}' on {bind} at {fps} Hz", True)

    with BlockAccessor(direction) as block:
        period = 1.0 / fps
        while True:
            tick = time.monotonic()
            status, frame, acq_time = block.read_frame()
            if status == ReadStatus.FRAMEWORK_DELETED:
                logger("source deleted; stopping", True)
                return
            if status == ReadStatus.SUCCESS and frame is not None:
                primary = frame[0] if isinstance(frame, tuple) else frame
                payload = encode_jpeg(np.ascontiguousarray(primary), quality)
                sock.send_multipart(
                    [
                        direction.encode(),
                        str(acq_time).encode(),
                        payload,
                    ]
                )
            time.sleep(max(0.0, period - (time.monotonic() - tick)))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="JPEG stream publisher")
    parser.add_argument("direction")
    parser.add_argument("--bind", default="tcp://0.0.0.0:8081")
    parser.add_argument("--fps", type=int, default=10)
    parser.add_argument("--quality", type=int, default=100)
    args = parser.parse_args(argv)
    serve(args.direction, args.bind, args.fps, args.quality)


if __name__ == "__main__":
    main()

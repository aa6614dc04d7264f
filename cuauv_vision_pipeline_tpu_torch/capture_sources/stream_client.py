#!/usr/bin/env python3
"""Network stream bridge — subscriber side.

Port of ``cuauv_vision_pipeline_tpu.capture_sources.stream_client``, a copy
with the same wire format. Parity target: reference
capture_sources/stream_client.py:16-29 — receive JPEGs from a remote
stream_server, decode, and re-inject them into the local frame bus as
capture source ``<direction>_stream``.

    python -m cuauv_vision_pipeline_tpu_torch.capture_sources.stream_client tcp://HOST:8081 [--suffix _stream]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.capture_source import CaptureSource, FpsLimiter


def decode_jpeg(payload: bytes) -> np.ndarray:
    try:
        import cv2

        return cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR)
    except ImportError:
        import io

        from PIL import Image

        rgb = np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))
        return rgb[..., ::-1].copy()


class StreamClient(CaptureSource):
    def __init__(self, connect: str, suffix: str = "_stream"):
        super().__init__()
        import zmq

        ctx = zmq.Context()
        sock = ctx.socket(zmq.SUB)
        sock.connect(connect)
        sock.setsockopt(zmq.SUBSCRIBE, b"")
        sock.setsockopt(zmq.RCVTIMEO, 1000)

        def udl(limiter: FpsLimiter, args):
            import zmq as _zmq

            iterator = iter(limiter.rate(0))
            while True:
                t = next(iterator)  # raises StopIteration on quit
                try:
                    direction, acq, payload = sock.recv_multipart()
                except _zmq.Again:
                    continue
                frame = decode_jpeg(payload)
                if frame is None:
                    continue
                yield (direction.decode() + suffix, int(acq), frame)

        self.register_capture_udl("stream_client", udl)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="JPEG stream subscriber")
    parser.add_argument("connect", help="e.g. tcp://10.0.0.5:8081")
    parser.add_argument("--suffix", default="_stream")
    args = parser.parse_args(argv)
    StreamClient(args.connect, args.suffix).run_event_loop()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""ZED stereo capture source (software-pipelined, aggregated 4-plane frame).

Parity target: reference capture_sources/zed.py:14-298 (and the C++
zed.cpp:29-253): opens the ZED SDK at HD720/NEURAL depth/0.5-10 m METER
units, captures LEFT/RIGHT images + DEPTH (f32) + NORMALS, converts
RGBA->RGB and normals [-1,1]->[0,1], and writes ONE aggregated frame to
direction "zed" with plane names forward/forward2/depth/normal. A second
2 Hz UDL pushes shm.zed_calibration settings into the camera with
auto-exposure/AWB disabled (zed.cpp:218-253). Per-stage EMA timings print
every 3 s and fps/acquisition/postprocess EMAs land in shm.zed_metrics
(zed.py:53-80, 196-236).

Port of ``cuauv_vision_pipeline_tpu.capture_sources.zed``. The reference
overlapped SDK retrieves with numpy postprocessing through a double-buffered
thread pool (zed.py:129-253); here the postprocess (BGRA->RGB, depth holes
to 0, normal remap) runs as torch ops on ``$CUAUV_TPU_DEVICE`` (cuda:0
unless it says ``cpu``): the four SDK arrays go up, the four planes come
back in one packed copy, and a one-deep executor overlaps that with the
next grab. Requires pyzed; exits with a clear message otherwise.

    python -m cuauv_vision_pipeline_tpu_torch.capture_sources.zed [DIRECTION] [--split-directions]
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core import shm
from ..core.capture_source import CaptureSource, FpsLimiter
from ..core.device import DeviceLike, resolve_device
from ..core.log import log
from ..engine.executor import EmaTimer, pack_result, unpack_result

CAMERA_FPS = 30
OUTPUT_FPS = 15
CALIB_FPS = 2


def _postprocess_fn(device: DeviceLike = None):
    """The ZED planes from the SDK's arrays, as torch ops on ``device``
    (default ``$CUAUV_TPU_DEVICE``, else cuda:0): numpy BGRA eyes, f32
    depth and f32 XYZW normals in; numpy RGB eyes, depth ``[H, W, 1]`` with
    NaN and +-inf holes set to 0, and normals remapped to [0, 1] out, all
    fetched in one copy."""
    dev = resolve_device(os.environ.get("CUAUV_TPU_DEVICE") if device is None else device)

    def post(left_rgba, right_rgba, depth, normals):
        left, right, depth, normals = (
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (left_rgba, right_rgba, depth, normals)
        )
        left = left[..., :3].flip(-1)  # BGRA -> RGB order flip
        right = right[..., :3].flip(-1)
        depth = torch.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)
        n = torch.nan_to_num(normals[..., :3], nan=0.0)
        n01 = (n + 1.0) * 0.5  # [-1,1] -> [0,1] (zed.cpp:84-91)
        packed, spec = pack_result((left, right, depth[..., None], n01.to(torch.float32)))
        return unpack_result(packed.cpu().numpy(), spec)

    return post


class ZedSource(CaptureSource):
    def __init__(self, direction: str = "zed", split_directions: bool = False):
        """split_directions=True publishes forward2/forward/depth/normal as
        four independent blocks instead of one aggregated 4-plane frame (the
        reference's zed_sync variant, zed_sync.py:146-149); the aggregated
        layout is the production scheme (zed.cpp:29-34)."""
        super().__init__()
        self._split = split_directions
        try:
            import pyzed.sl as sl
        except ImportError as e:
            raise SystemExit(
                "pyzed (ZED SDK) is not installed; on dev machines use "
                "synthetic.py / video.py instead (SURVEY.md §4)"
            ) from e

        init = sl.InitParameters()
        init.camera_resolution = sl.RESOLUTION.HD720
        init.depth_mode = sl.DEPTH_MODE.NEURAL
        init.coordinate_units = sl.UNIT.METER
        init.depth_minimum_distance = 0.5
        init.depth_maximum_distance = 10.0
        init.camera_fps = CAMERA_FPS

        self.zed = sl.Camera()
        status = self.zed.open(init)
        if status != sl.ERROR_CODE.SUCCESS:
            raise SystemExit(f"ZED open failed: {status}")

        self.zed.set_camera_settings(sl.VIDEO_SETTINGS.AEC_AGC, 0)
        self.zed.set_camera_settings(sl.VIDEO_SETTINGS.WHITEBALANCE_AUTO, 0)

        self.register_capture_udl("zed capture", self._capture_udl, (direction,))
        self.register_logical_udl(self._calibration_udl)

    # -- capture ---------------------------------------------------------------

    def _capture_udl(self, limiter: FpsLimiter, args):
        import pyzed.sl as sl

        (direction,) = args
        post = _postprocess_fn()
        bench = EmaTimer(alpha=0.1, report_every_s=3.0)
        logger = log.vision.capture_source.zed
        executor = ThreadPoolExecutor(max_workers=1)

        # double-buffered SDK mats (zed.py:129-150)
        mats = [
            {
                "left": sl.Mat(), "right": sl.Mat(),
                "depth": sl.Mat(), "normals": sl.Mat(),
            }
            for _ in range(2)
        ]
        pending = None  # (future, acquisition_time)
        slot = 0
        runtime = sl.RuntimeParameters()
        fps_ema = 0.0
        last_t = None

        def process(mset, t_ms):
            t0 = time.monotonic()
            out = post(
                mset["left"].get_data(),
                mset["right"].get_data(),
                mset["depth"].get_data(),
                mset["normals"].get_data(),
            )
            left, right, depth, normal = out
            bench.record("postprocess", time.monotonic() - t0)
            return (
                direction,
                t_ms,
                (right, left, depth, normal),
                ("forward", "forward2", "depth", "normal"),
            )

        for t_ms in limiter.rate(OUTPUT_FPS):
            t0 = time.monotonic()
            if self.zed.grab(runtime) != sl.ERROR_CODE.SUCCESS:
                continue
            m = mats[slot]
            self.zed.retrieve_image(m["left"], sl.VIEW.LEFT)
            self.zed.retrieve_image(m["right"], sl.VIEW.RIGHT)
            self.zed.retrieve_measure(m["depth"], sl.MEASURE.DEPTH)
            self.zed.retrieve_measure(m["normals"], sl.MEASURE.NORMALS)
            acq = time.monotonic() - t0
            bench.record("acquisition", acq)

            # overlap: postprocess slot N while the SDK fills slot N+1
            if pending is not None:
                result = pending.result()
                if self._split:
                    _, t_prev, frames, names = result
                    for plane, name in zip(frames, names):
                        yield (name, t_prev, plane)
                else:
                    yield result
            pending = executor.submit(process, m, t_ms)
            slot ^= 1

            # shm metrics EMA (zed.cpp:160-207)
            alpha = shm.zed_metrics.alpha.get() or 0.1
            now = time.monotonic()
            if last_t is not None:
                inst = 1.0 / max(now - last_t, 1e-6)
                fps_ema = inst if fps_ema == 0 else (1 - alpha) * fps_ema + alpha * inst
            last_t = now
            period = max(now - t0, 1e-6)
            shm.zed_metrics.set(
                fps=fps_ema,
                acquisition_sec=bench.stages.get("acquisition", 0.0),
                acquisition_percent=100.0 * acq / period,
                postprocess_sec=bench.stages.get("postprocess", 0.0),
                postprocess_percent=100.0
                * bench.stages.get("postprocess", 0.0)
                / period,
                start_time_sec=time.time(),
            )
            bench.maybe_report(lambda msg: logger(msg, True))

        if pending is not None:
            result = pending.result()
            if self._split:
                _, t_prev, frames, names = result
                for plane, name in zip(frames, names):
                    yield (name, t_prev, plane)
            else:
                yield result

    # -- calibration watcher ------------------------------------------------

    def _calibration_udl(self, limiter: FpsLimiter, args) -> None:
        import pyzed.sl as sl

        settings = {
            "brightness": sl.VIDEO_SETTINGS.BRIGHTNESS,
            "contrast": sl.VIDEO_SETTINGS.CONTRAST,
            "hue": sl.VIDEO_SETTINGS.HUE,
            "saturation": sl.VIDEO_SETTINGS.SATURATION,
            "gamma": sl.VIDEO_SETTINGS.GAMMA,
            "sharpness": sl.VIDEO_SETTINGS.SHARPNESS,
            "white_balance": sl.VIDEO_SETTINGS.WHITEBALANCE_TEMPERATURE,
            "zed_exposure": sl.VIDEO_SETTINGS.EXPOSURE,
            "zed_gain": sl.VIDEO_SETTINGS.GAIN,
        }
        last = {}
        for _ in limiter.rate(CALIB_FPS):
            calib = shm.zed_calibration
            for field, setting in settings.items():
                value = int(calib.get_field(field))
                if last.get(field) != value:
                    last[field] = value
                    self.zed.set_camera_settings(setting, value)


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="ZED stereo capture source")
    parser.add_argument("direction", nargs="?", default="zed")
    parser.add_argument(
        "--split-directions",
        action="store_true",
        help="publish 4 separate blocks instead of one aggregated frame "
        "(the reference's zed_sync scheme)",
    )
    args = parser.parse_args(argv)
    ZedSource(args.direction, args.split_directions).run_event_loop()


if __name__ == "__main__":
    main()

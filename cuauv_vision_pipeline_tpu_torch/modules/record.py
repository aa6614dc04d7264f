#!/usr/bin/env python3
"""Mission recorder: synchronized mp4s of the ZED planes while a mission is
active.

Parity target: reference modules/record.py:47-137 — when
shm.active_mission.active turns on, open four mp4 writers (left/right/
depth-u8/normal-u8, 10 fps) in the mission log dir and write each bundle;
close them when the mission deactivates. Replay happens through
capture_sources/video.py (the system's record/replay resume story,
SURVEY.md §5).

Port of ``cuauv_vision_pipeline_tpu.modules.record``: host only, cv2
imported inside the methods that write, so the module imports where cv2 is
missing (and then fails only when a mission starts recording)."""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

from ..core import shm
from ..core.base import ModuleBase, sources

RECORD_FPS = 10
ZED_MIN_M = 0.5
ZED_MAX_M = 10.0


class Record(ModuleBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._writers: Dict[str, object] = {}
        self._dir: Optional[str] = None

    def _open_writers(self, shape) -> None:
        import cv2

        log_dir = shm.active_mission.log_path.get() or "/tmp"
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self._dir = os.path.join(log_dir, f"record-{stamp}")
        os.makedirs(self._dir, exist_ok=True)
        h, w = shape[:2]
        fourcc = cv2.VideoWriter_fourcc(*"avc1")
        for name in ("left", "right", "depth", "normal"):
            path = os.path.join(self._dir, f"{name}.mp4")
            writer = cv2.VideoWriter(path, fourcc, RECORD_FPS, (w, h))
            if not writer.isOpened():  # avc1 missing: fall back to mp4v
                writer = cv2.VideoWriter(
                    path, cv2.VideoWriter_fourcc(*"mp4v"), RECORD_FPS, (w, h)
                )
            self._writers[name] = writer

    def _close_writers(self) -> None:
        for writer in self._writers.values():
            writer.release()
        self._writers.clear()
        self._dir = None

    @sources("zed[forward]", "zed[forward2]", "zed[depth]", "zed[normal]")
    def handle(self, left, right, depth, normal):
        active = shm.active_mission.active.get()
        if not active:
            if self._writers:
                self._close_writers()
            return
        if not self._writers:
            self._open_writers(left.shape)

        depth_f = depth[..., 0] if depth.ndim == 3 else depth
        depth_u8 = np.clip(
            (depth_f.astype(np.float32) - ZED_MIN_M)
            * (255.0 / (ZED_MAX_M - ZED_MIN_M)),
            0,
            255,
        ).astype(np.uint8)
        depth_bgr = np.repeat(depth_u8[..., None], 3, axis=-1)
        if normal.dtype != np.uint8:
            normal_u8 = np.clip(normal * 255.0, 0, 255).astype(np.uint8)
        else:
            normal_u8 = normal

        self._writers["left"].write(np.ascontiguousarray(left))
        self._writers["right"].write(np.ascontiguousarray(right))
        self._writers["depth"].write(np.ascontiguousarray(depth_bgr))
        self._writers["normal"].write(np.ascontiguousarray(normal_u8))

    def __del__(self):
        if self._writers:
            self._close_writers()


class RecordMono(ModuleBase):
    """Single-plane recorder for ANY bus direction: one mp4 of the frames
    while the mission is active. The zed 4-plane Record above is the
    reference-parity recorder (reference modules/record.py:47-137); this
    generalizes the same record->replay resume story to arbitrary cameras
    so e.g. a gate run on `gatecam` can be captured and replayed through
    capture_sources/video.py (BASELINE config 2 measures exactly that
    loop)."""

    # rate-estimation buffer bounds: frames are only written on FRESH
    # source frames (ModuleBase fires process per NEW_FRAME), so the true
    # recording rate is the source DELIVERY rate, not the module's --fps
    # tick rate — a header written from --fps would make replay through
    # capture_sources/video.py run at the wrong speed whenever the two
    # diverge. The first ~1 s of frames buffer in memory while the actual
    # delivery rate is measured from their camera acquisition stamps; the
    # writer then opens with THAT rate in the header.
    _EST_FRAMES = 8
    _EST_WINDOW_MS = 1000

    def __init__(self, direction: str, fps: int = RECORD_FPS, **kwargs):
        super().__init__([direction], [], fps=fps, **kwargs)
        self._writer = None
        # fallback header rate when too few frames arrive to estimate
        # (also the estimator's sanity clamp anchor)
        self._record_fps = self._fps
        self._header_fps: float = float(self._fps)
        self._pending: list = []  # (acq_ms, frame) until the rate estimate
        self._written = 0
        self._t_first_ms: Optional[int] = None
        self._t_last_ms: Optional[int] = None
        self.path: str = ""

    def _open_writer(self, shape, fps: float) -> None:
        import cv2

        log_dir = shm.active_mission.log_path.get() or "/tmp"
        stamp = time.strftime("%Y%m%d-%H%M%S")
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"record-mono-{stamp}.mp4")
        h, w = shape[:2]
        self._header_fps = fps
        writer = cv2.VideoWriter(
            self.path, cv2.VideoWriter_fourcc(*"avc1"), fps, (w, h)
        )
        if not writer.isOpened():  # avc1 missing: fall back to mp4v
            writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
            )
        self._writer = writer

    def _estimated_fps(self) -> float:
        """Delivery rate from the buffered acquisition stamps, clamped to
        a sane band around plausible camera rates."""
        if len(self._pending) >= 2:
            span_ms = self._pending[-1][0] - self._pending[0][0]
            if span_ms > 0:
                est = (len(self._pending) - 1) * 1000.0 / span_ms
                return float(min(max(est, 1.0), 120.0))
        return float(self._record_fps)

    def _flush_pending(self) -> None:
        if self._writer is None and self._pending:
            self._open_writer(
                self._pending[0][1].shape, self._estimated_fps()
            )
        for _acq, frame in self._pending:
            self._writer.write(np.ascontiguousarray(frame))
            self._written += 1
        self._pending.clear()

    def _close_writer(self) -> None:
        if self._pending:  # short recording: flush at the estimated rate
            self._flush_pending()
        if self._writer is not None:
            self._writer.release()
            self._writer = None
            # header-vs-written divergence check: warn loudly when the
            # finished file would replay at a visibly wrong speed
            if (
                self._written >= 2
                and self._t_last_ms is not None
                and self._t_last_ms > self._t_first_ms
            ):
                measured = (
                    (self._written - 1)
                    * 1000.0
                    / (self._t_last_ms - self._t_first_ms)
                )
                if not 0.8 <= measured / self._header_fps <= 1.25:
                    print(
                        f"[record] WARNING: {self.path} header "
                        f"{self._header_fps:.1f} fps but frames arrived at "
                        f"{measured:.1f} fps — replay speed will be off "
                        f"(source rate changed mid-recording?)",
                        flush=True,
                    )
        self._written = 0
        self._t_first_ms = None
        self._t_last_ms = None

    def process(self, direction, img):
        active = shm.active_mission.active.get()
        if not active:
            if self._writer is not None or self._pending:
                self._close_writer()
            return
        acq = self._current_acquisition_time
        if self._t_first_ms is None:
            self._t_first_ms = acq
        self._t_last_ms = acq
        if self._writer is None:
            self._pending.append((acq, np.array(img, copy=True)))
            if (
                len(self._pending) >= self._EST_FRAMES
                or acq - self._pending[0][0] >= self._EST_WINDOW_MS
            ):
                self._flush_pending()
            return
        self._writer.write(np.ascontiguousarray(img))
        self._written += 1

    def __del__(self):
        if self._writer is not None or self._pending:
            self._close_writer()


if __name__ == "__main__":
    import sys

    # `record.py` -> zed 4-plane parity recorder; `record.py --mono DIR`
    # -> single-plane recorder on DIR
    if len(sys.argv) > 1 and sys.argv[1] == "--mono":
        direction = sys.argv[2] if len(sys.argv) > 2 else "forward"
        sys.argv = [sys.argv[0]] + sys.argv[3:]
        RecordMono(direction)()
    else:
        Record(["zed"], [], fps=RECORD_FPS)()

#!/usr/bin/env python3
"""Multi-camera YOLO: every camera through ONE batched device dispatch.

Port of ``cuauv_vision_pipeline_tpu.modules.yolo_multicam`` (beyond the
reference, whose yolo consumed only zed[forward], modules/yolo.py:101-165):
the ZED forward eye and the FLIR (downward) camera letterbox into one
``[2, S, S, 3]`` batch and share one conv stack at batch 2 and one decode,
whose NMS is one CUDA kernel launch for both cameras. Detections dispatch to
the same six OBB handlers, gated per camera direction ("forward" /
"downward") exactly like the reference's ``*_direction`` flags intend.

Run: ``python -m cuauv_vision_pipeline_tpu_torch.modules.yolo_multicam zed flir``
-- or ANY number of cameras, with directions as aliases
(``zed[forward] flir[downward] aux[forward]``): ``multicam_class`` builds
the N-lane chain at launch, so every added camera adds one batch lane to
the same dispatch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import shm
from ..core.base import device_fn
from ..models.yolo.model import letterbox_params
from ..models.yolo.tracker import ByteTracker
from ..parallel.crosscam import cross_camera_nms
from .yolo import HANDLERS, TUNERS, Yolo

# CUAUV_CROSSCAM_MERGE=1: append a cross-camera consensus list to the same
# dispatch -- each camera's detections are un-letterboxed to its native
# normalized frame, stacked, class-aware NMS'd (co-registered rigs like the
# zed stereo pair; other rigs apply extrinsics upstream), and the merged
# [max_det, 6] list (normalized coords) rides the packed fetch.
CROSSCAM_MERGE = os.environ.get("CUAUV_CROSSCAM_MERGE", "") == "1"


def _camera_dets(decoded, cam_hw, image_size) -> torch.Tensor:
    """Per-camera decode output -> ``[n_cam, K, 6]`` rows (x1, y1, x2, y2,
    conf, cls) in each camera's NORMALIZED frame.

    Boxes arrive in each camera's LETTERBOXED model frame; cameras with
    different native resolutions letterbox with different scale/pad, so the
    same physical object lands at different model-frame coords and
    cross-view suppression would misfire. Each camera's boxes are therefore
    un-letterboxed and normalized to its native [0,1]x[0,1] frame -- for
    co-registered same-FOV rigs the normalized frames coincide regardless of
    resolution, and IoU is invariant under the normalization."""
    xy = decoded["xyxy"]  # [n_cam, K, 4] model-frame pixels
    rows = []
    for i, (h, w) in enumerate(cam_hw):
        scale, left, top, _, _ = letterbox_params(h, w, image_size)
        b = xy[i]
        rows.append(
            torch.stack(
                [
                    (b[:, 0] - left) / (scale * w),
                    (b[:, 1] - top) / (scale * h),
                    (b[:, 2] - left) / (scale * w),
                    (b[:, 3] - top) / (scale * h),
                ],
                dim=-1,
            )
        )
    return torch.cat(
        [
            torch.stack(rows),
            decoded["score"][..., None],
            decoded["cls"].to(torch.float32)[..., None],
        ],
        dim=-1,
    )


def _merged_dets(decoded, cam_hw, image_size) -> torch.Tensor:
    """Per-camera decode output -> one consensus list ``[max_det, 6]`` in
    NORMALIZED coordinates (:func:`_camera_dets`, then the class-aware
    cross-camera NMS: one kernel launch on the card)."""
    return cross_camera_nms(_camera_dets(decoded, cam_hw, image_size))


class YoloMulticam(Yolo):
    # (alias, reference direction string) per camera, batch order
    CAMERAS = (("forward", "forward"), ("flir", "downward"))
    # post name per camera (index-matched with CAMERAS)
    POST_NAMES = ("image_forward", "image_downward")

    @device_fn("zed[forward]", "flir", depth=1, async_fetch=True)
    def detect_chain(self, fwd, flir, *, tuners, want_posts):
        """Letterbox both cameras, one batched forward, one decode + NMS
        launch for both; the [2, ...] decode dict rides one packed fetch.
        (Overrides the single-camera chain from Yolo.)"""
        return self._multicam_chain((fwd, flir), want_posts)

    def _multicam_chain(self, frames, want_posts):
        self._cam_hw = tuple(tuple(f.shape[:2]) for f in frames)
        decoded = dict(self.model.device_decode_multi(frames))
        if CROSSCAM_MERGE:
            decoded["crosscam_merged"] = _merged_dets(decoded, self._cam_hw, self.model.image_size)
        posts = dict(zip(self.POST_NAMES, frames)) if want_posts else {}
        return decoded, posts

    def on_device_result(self, decoded, posts, meta):
        if not hasattr(self, "_cam_trackers"):  # one track space per camera
            self._cam_trackers = [ByteTracker() for _ in self.CAMERAS]
        merged = decoded.pop("crosscam_merged", None)
        if merged is not None:
            # fleet-wide consensus list (rows zeroed when suppressed); kept
            # on the instance for consumers and tests -- per-camera handler
            # dispatch below is unchanged
            self.last_merged = np.asarray(merged)
            self.last_merged_count = int((self.last_merged[:, 4] > 0).sum())
        cam_hw = self._cam_hw
        for i, (_alias, direction) in enumerate(self.CAMERAS):
            cam = {k: v[i] for k, v in decoded.items()}
            results = self.model.summarize_decoded(cam, cam_hw[i])
            self._cam_trackers[i].update(results)

            image = posts.get(self.POST_NAMES[i])
            if image is None:
                image = self._dummy_frame(cam_hw[i])
            else:
                self.post(self.POST_NAMES[i], image)
            self._dispatch_detections(direction, image, results)

        self._frames_processed = getattr(self, "_frames_processed", 0) + 1
        shm.yolo_status.set(
            latency_ms=float(meta.latency_ms()),
            frames=self._frames_processed,
        )


def multicam_class(source_specs):
    """Build an N-camera YoloMulticam subclass bound to ``source_specs``
    (the CLI positional source strings): every camera letterboxes into the
    SAME single batched dispatch via ``$i`` placeholder specs, so adding a
    camera adds one lane, not one dispatch. Each camera's reference
    direction string comes from its first declared alias (``zed[forward]
    flir[downward] aux[forward]``); without aliases the first two default to
    the classic forward/downward pair. Repeated directions get numbered post
    names (image_forward, image_forward2)."""
    dirs = []
    for i, spec in enumerate(source_specs):
        if "[" in spec:
            dirs.append(spec.split("[", 1)[1].split(",")[0].split("]")[0].strip())
        else:
            dirs.append("downward" if i == 1 else "forward")
    post_names, seen = [], {}
    for d in dirs:
        seen[d] = seen.get(d, 0) + 1
        post_names.append(f"image_{d}" if seen[d] == 1 else f"image_{d}{seen[d]}")
    specs = tuple(f"${i}" for i in range(len(source_specs)))
    cameras = tuple((f"cam{i}", d) for i, d in enumerate(dirs))

    class MulticamN(YoloMulticam):
        CAMERAS = cameras
        POST_NAMES = tuple(post_names)

        @device_fn(*specs, depth=1, async_fetch=True)
        def detect_chain(self, *frames, tuners, want_posts):
            return self._multicam_chain(frames, want_posts)

    # keep the shm module name (and its post/tuner block names) stable
    # across camera counts: class names may not contain "_" (ModuleBase)
    MulticamN.__name__ = "YoloMulticam"
    MulticamN.__qualname__ = "YoloMulticam"
    return MulticamN


def cli_sources(argv):
    """The positional source specs of a ModuleBase command line: the values
    of ``-f/--fps`` and ``--device`` are not sources."""
    out, skip = [], False
    for arg in argv:
        if skip:
            skip = False
        elif arg in ("-f", "--fps", "--device"):
            skip = True
        elif not arg.startswith("-"):
            out.append(arg)
    return out


if __name__ == "__main__":
    import sys

    sources = cli_sources(sys.argv[1:]) or ["zed", "flir"]
    cls = multicam_class(sources)
    cls(video_sources=sources, tuners=TUNERS, handlers=HANDLERS)()

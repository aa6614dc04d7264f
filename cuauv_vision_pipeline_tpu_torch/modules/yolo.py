#!/usr/bin/env python3
"""YOLO detection module: device inference -> class buckets -> OBB handlers.

Port of ``cuauv_vision_pipeline_tpu.modules.yolo`` (reference
modules/yolo.py:38-237): loads a weight ($CUAUV_YOLO_WEIGHT, else the
default path, else seeded random init with a warning; a detect, obb, pose or
segment checkpoint), runs letterbox + YOLOv8 forward + decode + greedy NMS
(+ keypoints or masks) on the module's device (the NMS as one CUDA kernel on
the card), maps each detection via MAP_FN, buckets detections
per handler class, gates on shm.active_objects flags and per-detector
direction, and dispatches to the six OBB handlers. Camera-to-detection
telemetry goes to shm.yolo_status.

    python -m cuauv_vision_pipeline_tpu_torch.modules.yolo zed [--device N|cpu]
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Union

import numpy as np
import torch

from ..core import shm, tuners
from ..core.base import ModuleBase, device_fn
from ..core.handlers import HandlerMixin
from ..handlers.bins import BinsOBB
from ..handlers.gate import GateOBB
from ..handlers.gate_behind import GateBehindOBB
from ..handlers.manipulator import ManipulatorOBB
from ..handlers.slalom import SlalomOBB
from ..handlers.torpedoes import TorpedoesOBB
from ..models.yolo.data import MAP_FN, OBBData, PoseData, SegmentData, YOLOData
from ..models.yolo.predictor import YoloModel

DEFAULT_WEIGHT = os.environ.get("CUAUV_YOLO_WEIGHT", "obb_v14.msgpack")

HANDLERS = [
    TorpedoesOBB("torpedoes"),
    SlalomOBB("slalom"),
    GateOBB("gate"),
    GateBehindOBB("gate_behind"),
    BinsOBB("bins"),
    ManipulatorOBB("manipulator"),
]

TUNERS = [
    tuners.DoubleTuner("torpedo_threshold", 0.1, 0, 1),
    tuners.DoubleTuner("slalom_threshold", 0.0, 0, 1),
    tuners.DoubleTuner("gate_threshold", 0.1, 0, 1),
    tuners.DoubleTuner("gate_behind_threshold", 0.7, 0, 1),
    tuners.DoubleTuner("bins_threshold", 0.4, 0, 1),
    tuners.DoubleTuner("manipulator_threshold", 0.4, 0, 1),
]

DetectionData = Union[YOLOData, OBBData, PoseData, SegmentData]

# detector -> (class names it consumes, handler arg order)
DETECTORS: Dict[str, List[str]] = {
    "torpedoes": ["torpedo_board", "shark_hole", "saw_hole"],
    "slalom": ["pole_red", "pole_white"],
    "gate": ["shark", "saw"],
    "gate_behind": ["gate_behind"],
    "bins": ["bin_shark", "bin_saw", "bin"],
    "manipulator": ["spoon", "cup", "pink_basket", "yellow_basket"],
}

_ACTIVE_FLAG = {
    "torpedoes": "yolo_torpedoes_board",
    "slalom": "yolo_slalom",
    "gate": "yolo_gate",
    "gate_behind": "yolo_gate_behind",
    "bins": "yolo_bins",
    "manipulator": "yolo_manipulator",
}


class Yolo(ModuleBase, HandlerMixin):
    def __init__(self, video_sources, tuners, handlers, weight=None, **kwargs):
        ModuleBase.__init__(self, video_sources, tuners, **kwargs)
        HandlerMixin.__init__(self, handlers)

        self.weight_path = weight or DEFAULT_WEIGHT
        # an EXPLICITLY configured weight that is missing fails fast; the
        # unset default path falls back to random init (dev machines)
        explicit = weight is not None or bool(os.environ.get("CUAUV_YOLO_WEIGHT"))
        if explicit and not os.path.exists(self.weight_path):
            raise FileNotFoundError(
                f"configured YOLO weight '{self.weight_path}' does not exist "
                f"(weight arg / CUAUV_YOLO_WEIGHT)"
            )
        self.model = YoloModel(self.weight_path, task="obb", device=self.device)
        self.yolo_model_type = self.model.task
        if self.yolo_model_type not in MAP_FN:
            raise ValueError(
                f"weight '{self.weight_path}' is a '{self.yolo_model_type}' "
                f"model; the detection modules consume box-producing tasks "
                f"({sorted(MAP_FN)}). Whole-frame classifiers serve via "
                f"YoloModel.predict instead."
            )
        self.map_fn: Callable[[dict], DetectionData] = MAP_FN[self.yolo_model_type]

        print("YOLO MODEL INITIALIZED:")
        print(f"weight: \t{self.weight_path}")
        print(f"device: \t{self.device}")
        print(f"model type: \t{self.yolo_model_type}")

    @staticmethod
    def _active(detector: str) -> bool:
        return bool(shm.active_objects.get_field(_ACTIVE_FLAG[detector]))

    @staticmethod
    def _direction_matches(detector: str, direction: str) -> bool:
        return shm.active_objects.get_field(f"{_ACTIVE_FLAG[detector]}_direction") == direction

    # depth=1 + async fetch: one frame of queueing, the fetch of frame N
    # overlapping the upload and launches of frame N+1.
    # CUAUV_YOLO_BATCH=K (default 1): when the module falls behind, up to K
    # drained frames run as ONE K-batch conv stack (the chain takes the
    # stacked [K, H, W, 3] batch). CUAUV_YOLO_LATEST_ONLY=M instead drops
    # stale frames beyond a backlog of M (the reference's latest-wins).
    # "*": bind to the first source's first-arriving alias (the zed's
    # forward plane, or a single-plane camera's only plane).
    @device_fn(
        "*",
        depth=1,
        async_fetch=True,
        batch=int(os.environ.get("CUAUV_YOLO_BATCH", "1")),
        latest_only_backlog=(
            int(os.environ["CUAUV_YOLO_LATEST_ONLY"])
            if os.environ.get("CUAUV_YOLO_LATEST_ONLY")
            else None
        ),
    )
    def detect_chain(self, image, *, tuners, want_posts):
        """Letterbox + forward + decode + NMS on the device; the fixed-shape
        decode dict and the frame size ride back in one packed fetch."""
        h, w = image.shape[-3], image.shape[-2]
        if image.ndim == 4:  # a batched dispatch: [K, H, W, 3]
            decoded = dict(self.model.device_decode_batch(image))
            lanes = (image.shape[0],)
        else:
            decoded = dict(self.model.device_decode(image))
            lanes = ()
        decoded["orig_h"] = torch.full(lanes, h, dtype=torch.int32, device=image.device)
        decoded["orig_w"] = torch.full(lanes, w, dtype=torch.int32, device=image.device)
        posts = {"image": image} if want_posts else {}
        return decoded, posts

    def on_device_result(self, decoded, posts, meta):
        direction = "forward"
        h = int(decoded.pop("orig_h"))
        w = int(decoded.pop("orig_w"))
        results = self.model.summarize_decoded(decoded, (h, w))
        self.model._tracker.update(results)

        image = posts.get("image")
        if image is None:  # performance mode: handlers never post
            image = self._dummy_frame((h, w))
        else:
            self.post("original image", image)

        self._dispatch_detections(direction, image, results)

        # camera-to-detection telemetry: frames counts processed frames;
        # latency covers capture -> bus -> H2D -> infer -> handlers
        self._frames_processed = getattr(self, "_frames_processed", 0) + 1
        lat = float(meta.latency_ms())
        fields = dict(
            latency_ms=lat,
            frames=self._frames_processed,
            lanes=len(meta.lane_acqs) if meta.lane_acqs else 1,
        )
        if meta.newest:
            fields["latency_newest_ms"] = lat
            # one bump per device round trip: frames/dispatches = mean drain
            self._dispatches = getattr(self, "_dispatches", 0) + 1
            fields["dispatches"] = self._dispatches
        shm.yolo_status.set(**fields)

    def _dummy_frame(self, hw) -> np.ndarray:
        cached = getattr(self, "_dummy", None)
        if cached is None or cached.shape[:2] != hw:
            self._dummy = np.zeros((*hw, 3), np.uint8)
        return self._dummy

    def _dispatch_detections(self, direction, image, results) -> None:
        buckets: Dict[str, Dict[str, List[DetectionData]]] = {
            det: {cls: [] for cls in classes}
            for det, classes in DETECTORS.items()
            if self._active(det)
        }
        for result in results:
            data = self.map_fn(result)
            for det, classes in DETECTORS.items():
                if data.name in classes and det in buckets:
                    buckets[det][data.name].append(data)
                    break

        for det, classes in DETECTORS.items():
            if not self._direction_matches(det, direction):
                continue
            if self._active(det):
                args = [buckets[det][cls] for cls in classes]
                # handlers annotate their copy (posts are fetched views);
                # in performance mode nothing draws, so skip the copy
                frame = image if self._performance_enabled else np.array(image, copy=True)
                self.handlers[det].process(direction, frame, *args)
            elif not self._performance_enabled:
                self.handlers[det].post_grayscale(image)


if __name__ == "__main__":
    Yolo(video_sources=["zed"], tuners=TUNERS, handlers=HANDLERS)()

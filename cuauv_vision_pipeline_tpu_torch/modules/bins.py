#!/usr/bin/env python3
"""Bin detector: beige HSV mask -> morphology -> minAreaRect + SIFT pose.

Port of ``cuauv_vision_pipeline_tpu.modules.bins`` (reference
modules/bins.py:10-81): HSV inRange for the beige background, overlay
visualization, open-morphology denoise, outer contours, minAreaRect
candidates filtered by area > 500 and aspect ratio in [1, 3], all drawn on
the overlay. BASELINE config 3 adds pose estimation (reference
utils/sift.py:14-142): set ``CUAUV_BINS_POSE_TEMPLATE`` to an image path
(or ``builtin`` for the synthetic bin texture) and each frame is matched
against the template, the projected quad written to ``shm.bins_pose``.

The device chain (``bins_chain``, depth 1 with async fetch) runs HSV +
inRange, the open morphology (the ``fused_morph`` CUDA kernel on the card),
the 0.7/0.3 overlay blend and, with pose on, keypoint detection +
description (``ops/feature.detect_describe``, whose spacing selection is
the ``spacing_select`` CUDA kernel on the card) and the template 2-NN match
— with no host sync. One packed fetch carries the cleaned mask, the
keypoints, the top-2 buffers and the overlay; contours, rectangles, the
ratio test and RANSAC run on the host.

    CUAUV_BINS_POSE_TEMPLATE=builtin \\
        python -m cuauv_vision_pipeline_tpu_torch.modules.bins forward [--device N|cpu]
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from ..core import shm
from ..core.base import ModuleBase, device_fn
from ..core.log import log
from ..ops import color as C
from ..ops import threshold as T
from ..ops.color_np import bgr_to_gray_np
from ..ops.cuda.morph_kernel import fused_morph
from ..ops.feature import detect_describe
from ..utils.draw import Color, draw_polylines
from ..utils.feature import min_enclosing_rect, outer_contours
from ..utils.sift import SIFT, device_match_topk

LOWER_BEIGE = np.array([10, 20, 60], np.uint8)
UPPER_BEIGE = np.array([30, 100, 255], np.uint8)


@functools.lru_cache(maxsize=None)
def _beige_bounds(device: torch.device):
    """The inRange bounds as u8 tensors on ``device``, copied once: a
    per-frame copy from host memory would wait for the card."""
    return tuple(torch.from_numpy(b).to(device) for b in (LOWER_BEIGE, UPPER_BEIGE))


def box_points(rect) -> np.ndarray:
    """cv2.boxPoints equivalent for our min_enclosing_rect tuples."""
    (cx, cy), (w, h), angle = rect
    rad = math.radians(angle)
    c, s = math.cos(rad), math.sin(rad)
    hw, hh = w / 2.0, h / 2.0
    pts = []
    for dx, dy in ((-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh)):
        pts.append((cx + dx * c - dy * s, cy + dx * s + dy * c))
    return np.array(pts, np.float32)


def _load_template(spec: str) -> np.ndarray:
    """The pose template as BGR u8: ``builtin`` (the synthetic bin face) or
    an image file (read with PIL)."""
    if spec == "builtin":
        from ..capture_sources.synthetic import bin_texture

        return np.asarray(bin_texture())
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"CUAUV_BINS_POSE_TEMPLATE={spec!r} is an image path, and reading it "
            "needs PIL, which is not installed; use 'builtin' or install Pillow"
        ) from e
    return np.asarray(Image.open(spec).convert("RGB"))[..., ::-1]  # BGR


class BinDetector(ModuleBase):
    # class default so chain-only instances (tests) skip pose
    _pose_sift = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_pose()

    def _init_pose(self) -> None:
        """Build the pose path when ``CUAUV_BINS_POSE_TEMPLATE`` is set: the
        template is described once, on the module's device."""
        template_spec = os.environ.get("CUAUV_BINS_POSE_TEMPLATE", "")
        if not template_spec:
            return
        # "device" (default): keypoints + descriptors computed inside the
        # bins chain and matched there; only keypoints and the top-2 buffers
        # ride the packed fetch. "cv2" is the reference's own detector on a
        # fetched gray frame (the builtin host detector where cv2 is absent).
        self._pose_detector = os.environ.get("CUAUV_SIFT_DETECTOR", "device")
        template = _load_template(template_spec)
        self._pose_sift = SIFT(detector=self._pose_detector, device=self.device)
        kp_t, _ = self._pose_sift.add_source("bin", bgr_to_gray_np(template))
        if self._pose_sift.sources["bin"]["des_prep"] is None:
            # a featureless template: the chain would have nothing to match
            log.vision.modules.bins(
                f"pose template {template_spec!r} yielded "
                f"{len(kp_t)} keypoint(s); pose estimation DISABLED "
                "(need >= 2 — use a textured template)",
                True,
            )
            self._pose_sift = None
            return
        self._pose_sift.warm()
        shm.bins_pose.set(visible=False, matches=0, inliers=0, seq_frames=0)

    @device_fn("*", depth=1, async_fetch=True)
    def bins_chain(self, img, *, tuners, want_posts):
        """HSV inRange + open morphology (+ pose detect/describe/match) + the
        reference's 0.7/0.3 overlay blend on the module's device; one packed
        fetch carries the cleaned mask, the pose buffers and the overlay."""
        hsv = C.bgr_to_hsv(img)
        mask = T.in_range(hsv, *_beige_bounds(img.device))
        cleaned = fused_morph(mask, "open")
        result = {"cleaned": cleaned}
        if self._pose_sift is not None:
            gray = C.bgr_to_gray(img)
            if self._pose_detector == "device":
                kp, des, n = detect_describe(gray)
                d2, idx = device_match_topk(
                    self._pose_sift.sources["bin"]["des_prep"], des, n
                )
                result["kp"] = kp
                result["pose_d2"] = d2
                result["pose_idx"] = idx
            else:
                result["gray"] = gray
        posts = {}
        if want_posts:
            # overlay = 0.7*img + 0.3*mask_bgr (the reference's viz); the
            # cast to u8 truncates
            blend = img.float() * 0.7 + mask[..., None].float() * 0.3
            posts["overlay"] = blend.to(img.dtype)
        return result, posts

    def on_device_result(self, result, posts, meta):
        cleaned = result["cleaned"]
        valid_rects = []
        for contour in outer_contours(cleaned):
            rect = min_enclosing_rect(contour)
            (_, (w, h), _) = rect
            if w * h < 500 or min(w, h) == 0:
                continue
            aspect = max(w, h) / min(w, h)
            if 1.0 <= aspect <= 3.0:
                valid_rects.append(rect)

        pose_quad = None
        if self._pose_sift is not None and ("gray" in result or "pose_d2" in result):
            pose_quad = self._estimate_pose(result, meta)

        overlayed = posts.get("overlay")
        if overlayed is not None:
            if not overlayed.flags.writeable:  # packed-fetch views are RO
                overlayed = overlayed.copy()
            for rect in valid_rects:
                pts = box_points(rect).astype(np.int32)
                draw_polylines(overlayed, [pts], True, Color.GREEN, 4)
            if pose_quad is not None:
                draw_polylines(overlayed, [pose_quad.astype(np.int32)], True, Color.RED, 3)
            self.post("bins", overlayed)

    def _estimate_pose(self, result, meta):
        """Template match -> homography quad -> shm.bins_pose."""
        grp = shm.bins_pose
        if "pose_d2" in result:  # device detector: the match rode the fetch
            matches = self._pose_sift.match_device_topk(
                "bin",
                result["pose_d2"],
                result["pose_idx"],
                np.asarray(result["kp"]),
                min_match=8,
            )
        else:
            matches = self._pose_sift.match(np.asarray(result["gray"]), min_match=8)
        # ONE group write (= one seq bump) per frame: a reader counts pose
        # results as seq changes, so a second write would double-count
        seq_frames = grp.seq_frames.get() + 1
        if not matches:
            grp.set(visible=False, seq_frames=seq_frames)
            return None
        m = matches[0]
        quad = np.asarray(m["quad"], np.float64)
        grp.set(
            visible=True,
            seq_frames=seq_frames,
            matches=m["matches"],
            inliers=m["inliers"],
            quad_x1=quad[0, 0],
            quad_y1=quad[0, 1],
            quad_x2=quad[1, 0],
            quad_y2=quad[1, 1],
            quad_x3=quad[2, 0],
            quad_y3=quad[2, 1],
            quad_x4=quad[3, 0],
            quad_y4=quad[3, 1],
            center_x=float(quad[:, 0].mean()),
            center_y=float(quad[:, 1].mean()),
            latency_ms=float(meta.latency_ms()),
        )
        return quad


if __name__ == "__main__":
    BinDetector(video_sources=["forward"], tuners=[])()

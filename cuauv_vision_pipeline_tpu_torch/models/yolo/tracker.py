"""ByteTrack-equivalent multi-object tracker (host side, numpy/scipy).

Copy of ``cuauv_vision_pipeline_tpu.models.yolo.tracker``.

The reference's modules call ``ultralytics.YOLO(...).track(image)``
(reference modules/yolo.py:113-116), which runs ByteTrack under the hood:
a constant-velocity Kalman filter per track and TWO association rounds —
high-confidence detections first (Hungarian assignment on IoU), then the
leftover tracks get a second chance against LOW-confidence detections
(the "byte" in ByteTrack: don't throw away low-score boxes, they're often
the occluded/blurred frames of a real target).  That second round is what
keeps track ids stable through the exact situations an AUV sees: a buoy
half-occluded by a gate post, a torpedo board washed out by backscatter.

This is a from-scratch implementation of that algorithm (Zhang et al.,
"ByteTrack: Multi-Object Tracking by Associating Every Detection Box",
ECCV 2022) on numpy/scipy:

* Kalman state ``[cx, cy, a, h, vcx, vcy, va, vh]`` (a = w/h aspect),
  constant velocity, with the standard h-proportional process/measurement
  noise (position std h/20, velocity std h/160).
* Association = Hungarian assignment (scipy linear_sum_assignment) on
  (1 - IoU), gated at ``match_thresh``; class mismatches are gated out.
* Track lifecycle: *tentative* on first sighting -> *tracked* once
  re-matched (or immediately when ``det_thresh`` is met) -> *lost* when
  unmatched -> removed after ``track_buffer`` frames lost.

The tracker is deliberately host-side: it's O(tracks x dets) tiny-matrix
work on a handful of boxes per frame — device round-trips would cost more
than the math.  All detection dicts get a ``track_id`` key; confirmed
tracks get a stable int, unmatched low-score detections get ``None``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:  # fall back to greedy assignment where scipy is absent
    from scipy.optimize import linear_sum_assignment

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False


def _det_aabb(det: Dict) -> Tuple[float, float, float, float]:
    """Axis-aligned bbox of a summary dict (handles OBB x1..x4 corners)."""
    box = det["box"]
    xs = [float(v) for k, v in box.items() if k.startswith("x")]
    ys = [float(v) for k, v in box.items() if k.startswith("y")]
    return min(xs), min(ys), max(xs), max(ys)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU between [N,4] and [M,4] xyxy boxes."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


class KalmanFilter:
    """Constant-velocity KF over [cx, cy, a, h] measurements."""

    NDIM = 4

    def __init__(self) -> None:
        self._F = np.eye(8, dtype=np.float64)
        self._F[:4, 4:] = np.eye(4)
        self._H = np.eye(4, 8, dtype=np.float64)
        self._std_pos = 1.0 / 20.0
        self._std_vel = 1.0 / 160.0

    def initiate(self, meas: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mean = np.zeros(8)
        mean[:4] = meas
        h = meas[3]
        std = np.array(
            [2 * self._std_pos * h, 2 * self._std_pos * h, 1e-2,
             2 * self._std_pos * h,
             10 * self._std_vel * h, 10 * self._std_vel * h, 1e-5,
             10 * self._std_vel * h]
        )
        return mean, np.diag(np.square(std))

    def _motion_cov(self, mean: np.ndarray) -> np.ndarray:
        h = mean[3]
        std = np.array(
            [self._std_pos * h, self._std_pos * h, 1e-2, self._std_pos * h,
             self._std_vel * h, self._std_vel * h, 1e-5, self._std_vel * h]
        )
        return np.diag(np.square(std))

    def predict(
        self, mean: np.ndarray, cov: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        mean = self._F @ mean
        cov = self._F @ cov @ self._F.T + self._motion_cov(mean)
        return mean, cov

    def update(
        self, mean: np.ndarray, cov: np.ndarray, meas: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        h = mean[3]
        r = np.diag(
            np.square(
                np.array(
                    [self._std_pos * h, self._std_pos * h, 1e-1,
                     self._std_pos * h]
                )
            )
        )
        s = self._H @ cov @ self._H.T + r
        k = np.linalg.solve(s.T, (cov @ self._H.T).T).T  # Kalman gain
        innov = meas - self._H @ mean
        mean = mean + k @ innov
        cov = cov - k @ s @ k.T
        return mean, cov


def _xyxy_to_cxcyah(b: Sequence[float]) -> np.ndarray:
    w = b[2] - b[0]
    h = max(b[3] - b[1], 1e-6)
    return np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2, w / h, h])


def _cxcyah_to_xyxy(m: np.ndarray) -> np.ndarray:
    cx, cy, a, h = m[0], m[1], m[2], m[3]
    w = a * h
    return np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])


class _Track:
    __slots__ = ("id", "cls", "mean", "cov", "lost_frames", "hits", "confirmed")

    def __init__(self, tid: int, cls: int, mean, cov, confirmed: bool):
        self.id = tid
        self.cls = cls
        self.mean = mean
        self.cov = cov
        self.lost_frames = 0
        self.hits = 1
        self.confirmed = confirmed

    @property
    def xyxy(self) -> np.ndarray:
        return _cxcyah_to_xyxy(self.mean)


def _assign(
    cost: np.ndarray, gate: float
) -> Tuple[List[Tuple[int, int]], List[int], List[int]]:
    """Min-cost assignment with gating; returns (matches, un_rows, un_cols)."""
    if cost.size == 0:
        return [], list(range(cost.shape[0])), list(range(cost.shape[1]))
    if _HAVE_SCIPY:
        rows, cols = linear_sum_assignment(cost)
        pairs = list(zip(rows.tolist(), cols.tolist()))
    else:  # pragma: no cover — greedy fallback
        pairs, used_r, used_c = [], set(), set()
        for r, c in sorted(
            np.ndindex(*cost.shape), key=lambda rc: cost[rc]
        ):
            if r not in used_r and c not in used_c:
                pairs.append((r, c))
                used_r.add(r)
                used_c.add(c)
    matches = [(r, c) for r, c in pairs if cost[r, c] <= gate]
    mr = {r for r, _ in matches}
    mc = {c for _, c in matches}
    un_rows = [r for r in range(cost.shape[0]) if r not in mr]
    un_cols = [c for c in range(cost.shape[1]) if c not in mc]
    return matches, un_rows, un_cols


class ByteTracker:
    """Two-stage (high/low score) Kalman-IoU tracker, ByteTrack semantics.

    ``update(detections)`` mutates each summary dict in place, adding a
    ``track_id`` (int for tracked targets, None for unconfirmed leftovers),
    matching the surface the reference gets from ultralytics'
    ``model.track(...)[0].summary()`` (reference modules/yolo.py:113-123).
    """

    def __init__(
        self,
        track_thresh: float = 0.5,
        det_thresh: float = 0.6,
        match_thresh: float = 0.8,
        low_match_thresh: float = 0.5,
        track_buffer: int = 30,
    ):
        self.track_thresh = track_thresh
        self.det_thresh = det_thresh
        self.match_thresh = match_thresh
        self.low_match_thresh = low_match_thresh
        self.track_buffer = track_buffer
        self.kf = KalmanFilter()
        self.tracks: List[_Track] = []
        self.next_id = 1

    def reset(self) -> None:
        self.tracks = []
        self.next_id = 1

    def _cost(self, tracks: List[_Track], dets: List[Dict],
              boxes: np.ndarray) -> np.ndarray:
        tboxes = np.array([t.xyxy for t in tracks]).reshape(-1, 4)
        cost = 1.0 - iou_matrix(tboxes, boxes)
        # gate out class mismatches (AUV targets are class-distinct)
        for i, t in enumerate(tracks):
            for j, d in enumerate(dets):
                if d.get("class") != t.cls:
                    cost[i, j] = 1.0
        return cost

    def update(self, detections: List[Dict]) -> None:
        for t in self.tracks:
            t.mean, t.cov = self.kf.predict(t.mean, t.cov)

        for det in detections:
            det["track_id"] = None

        high = [d for d in detections
                if d.get("confidence", 1.0) >= self.track_thresh]
        low = [d for d in detections
               if d.get("confidence", 1.0) < self.track_thresh]
        high_boxes = np.array([_det_aabb(d) for d in high]).reshape(-1, 4)
        low_boxes = np.array([_det_aabb(d) for d in low]).reshape(-1, 4)

        # ── round 1: confirmed+tentative tracks vs high-score detections
        cost = self._cost(self.tracks, high, high_boxes)
        matches, un_tracks, un_high = _assign(cost, self.match_thresh)
        for r, c in matches:
            self._hit(self.tracks[r], high[c], high_boxes[c])

        # ── round 2 (the "byte" step): leftover tracks vs LOW-score dets.
        # Only previously-confirmed tracks take low-score evidence; low
        # boxes never START a track.
        remain = [self.tracks[r] for r in un_tracks if self.tracks[r].confirmed]
        cost2 = self._cost(remain, low, low_boxes)
        matches2, un_remain, _ = _assign(cost2, self.low_match_thresh)
        for r, c in matches2:
            self._hit(remain[r], low[c], low_boxes[c])
        matched2 = {id(remain[r]) for r, _ in matches2}

        # ── unmatched tracks age; dead ones drop
        for r in un_tracks:
            t = self.tracks[r]
            if id(t) in matched2:
                continue
            t.lost_frames += 1
            if not t.confirmed:
                t.lost_frames = self.track_buffer + 1  # tentative: one strike
        self.tracks = [
            t for t in self.tracks if t.lost_frames <= self.track_buffer
        ]

        # ── unmatched high-score detections start new tracks
        for c in un_high:
            det = high[c]
            meas = _xyxy_to_cxcyah(high_boxes[c])
            mean, cov = self.kf.initiate(meas)
            confirmed = det.get("confidence", 1.0) >= self.det_thresh
            track = _Track(self.next_id, det.get("class"), mean, cov, confirmed)
            self.next_id += 1
            self.tracks.append(track)
            if confirmed:
                det["track_id"] = track.id

    def _hit(self, track: _Track, det: Dict, box: np.ndarray) -> None:
        track.mean, track.cov = self.kf.update(
            track.mean, track.cov, _xyxy_to_cxcyah(box)
        )
        track.lost_frames = 0
        track.hits += 1
        track.confirmed = True
        det["track_id"] = track.id

"""Detection data classes + result-dict parsers (no device code).

Copy of ``cuauv_vision_pipeline_tpu.models.yolo.data``.

Reconstruction of the reference's external ``vision.yolo.data`` module from
its call sites (reference modules/yolo.py:15,57-58,122-123 and
handlers/*.py): ``YOLOData`` (axis-aligned), ``OBBData`` (4 corners),
``PoseData`` (keypoints), and ``MAP_FN`` mapping a model task name to a
parser over ultralytics-style ``Results.summary()`` dicts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union


@dataclass
class YOLOData:
    """Axis-aligned detection (task 'detect')."""

    name: str
    class_id: int
    confidence: float
    x1: float
    y1: float
    x2: float
    y2: float
    track_id: Optional[int] = None

    @property
    def center(self) -> Tuple[float, float]:
        return ((self.x1 + self.x2) / 2.0, (self.y1 + self.y2) / 2.0)

    @property
    def area(self) -> float:
        return abs(self.x2 - self.x1) * abs(self.y2 - self.y1)

    @property
    def corners(self) -> List[Tuple[float, float]]:
        """The box as a 4-corner quad (tl, tr, br, bl) — the shape the OBB
        handlers consume (handlers/obb_common.py order_points), so
        detect/pose/segment checkpoints serve through the same six
        handlers instead of crashing on the missing attribute."""
        return [
            (self.x1, self.y1),
            (self.x2, self.y1),
            (self.x2, self.y2),
            (self.x1, self.y2),
        ]


@dataclass
class OBBData:
    """Oriented detection: 4 corners in pixel coordinates (task 'obb')."""

    name: str
    class_id: int
    confidence: float
    x1: float
    y1: float
    x2: float
    y2: float
    x3: float
    y3: float
    x4: float
    y4: float
    track_id: Optional[int] = None

    @property
    def corners(self) -> List[Tuple[float, float]]:
        return [
            (self.x1, self.y1),
            (self.x2, self.y2),
            (self.x3, self.y3),
            (self.x4, self.y4),
        ]

    @property
    def center(self) -> Tuple[float, float]:
        xs = (self.x1 + self.x2 + self.x3 + self.x4) / 4.0
        ys = (self.y1 + self.y2 + self.y3 + self.y4) / 4.0
        return xs, ys

    @property
    def area(self) -> float:
        """Shoelace area of the quad."""
        pts = self.corners
        total = 0.0
        for i in range(4):
            x0, y0 = pts[i]
            x1, y1 = pts[(i + 1) % 4]
            total += x0 * y1 - x1 * y0
        return abs(total) / 2.0


@dataclass
class PoseData(YOLOData):
    """Detection with keypoints (task 'pose'): [(x, y, visibility), ...]."""

    keypoints: List[Tuple[float, float, float]] = field(default_factory=list)


@dataclass
class SegmentData(YOLOData):
    """Detection with an instance-mask polygon (task 'segment'):
    [(x, y), ...] in frame pixels. Beyond the reference's MAP_FN (its
    modules stopped at detect/obb/pose, reference modules/yolo.py:54-55);
    handlers that only need the box treat it as YOLOData."""

    segments: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def polygon_area(self) -> float:
        """Shoelace area of the mask polygon (0 when empty)."""
        n = len(self.segments)
        if n < 3:
            return 0.0
        total = 0.0
        for i in range(n):
            x0, y0 = self.segments[i]
            x1, y1 = self.segments[(i + 1) % n]
            total += x0 * y1 - x1 * y0
        return abs(total) / 2.0


DetectionData = Union[YOLOData, OBBData, PoseData, SegmentData]


def _parse_detect(result: Dict) -> YOLOData:
    box = result.get("box", {})
    return YOLOData(
        name=result.get("name", ""),
        class_id=int(result.get("class", -1)),
        confidence=float(result.get("confidence", 0.0)),
        x1=float(box.get("x1", 0.0)),
        y1=float(box.get("y1", 0.0)),
        x2=float(box.get("x2", 0.0)),
        y2=float(box.get("y2", 0.0)),
        track_id=result.get("track_id"),
    )


def _parse_obb(result: Dict) -> OBBData:
    box = result.get("box", {})
    return OBBData(
        name=result.get("name", ""),
        class_id=int(result.get("class", -1)),
        confidence=float(result.get("confidence", 0.0)),
        x1=float(box.get("x1", 0.0)),
        y1=float(box.get("y1", 0.0)),
        x2=float(box.get("x2", 0.0)),
        y2=float(box.get("y2", 0.0)),
        x3=float(box.get("x3", 0.0)),
        y3=float(box.get("y3", 0.0)),
        x4=float(box.get("x4", 0.0)),
        y4=float(box.get("y4", 0.0)),
        track_id=result.get("track_id"),
    )


def _parse_pose(result: Dict) -> PoseData:
    base = _parse_detect(result)
    kpts = result.get("keypoints", {})
    xs = kpts.get("x", [])
    ys = kpts.get("y", [])
    vis = kpts.get("visible", [1.0] * len(xs))
    keypoints = [
        (float(x), float(y), float(v)) for x, y, v in zip(xs, ys, vis)
    ]
    return PoseData(
        name=base.name,
        class_id=base.class_id,
        confidence=base.confidence,
        x1=base.x1,
        y1=base.y1,
        x2=base.x2,
        y2=base.y2,
        track_id=base.track_id,
        keypoints=keypoints,
    )


def _parse_segment(result: Dict) -> SegmentData:
    base = _parse_detect(result)
    seg = result.get("segments", {})
    pts = [
        (float(x), float(y))
        for x, y in zip(seg.get("x", []), seg.get("y", []))
    ]
    return SegmentData(
        name=base.name,
        class_id=base.class_id,
        confidence=base.confidence,
        x1=base.x1,
        y1=base.y1,
        x2=base.x2,
        y2=base.y2,
        track_id=base.track_id,
        segments=pts,
    )


MAP_FN: Dict[str, Callable[[Dict], DetectionData]] = {
    "detect": _parse_detect,
    "obb": _parse_obb,
    "pose": _parse_pose,
    "segment": _parse_segment,
}

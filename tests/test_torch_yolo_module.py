"""The port's YOLO host side and module: tracker, MAP_FN and the torpedoes
handler, each case run on both packages; and the real entry points — the
port's synthetic camera and ``modules.yolo --device cpu`` with the trained
detect fixture as ``CUAUV_YOLO_WEIGHT`` — as subprocesses on a direction and
shm namespace of their own, until ``shm.yolo_status.frames`` advances."""

import os
import signal
import subprocess
import sys
import time
import types
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

import cuauv_vision_pipeline_tpu.core.shm as jshm
import cuauv_vision_pipeline_tpu.handlers.torpedoes as jtorpedoes
import cuauv_vision_pipeline_tpu.models.yolo.data as jdata
import cuauv_vision_pipeline_tpu.models.yolo.tracker as jtracker
import cuauv_vision_pipeline_tpu_torch.core.shm as tshm
import cuauv_vision_pipeline_tpu_torch.handlers.torpedoes as ttorpedoes
import cuauv_vision_pipeline_tpu_torch.models.yolo.data as tdata
import cuauv_vision_pipeline_tpu_torch.models.yolo.tracker as ttracker
from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BLOCK_STUB
from test_torch_private_shm import run_private

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "synth_pico_detect.msgpack"
PKGS = {"jax": (jtracker, jdata, jtorpedoes, jshm), "torch": (ttracker, tdata, ttorpedoes, tshm)}


def _det(x1, y1, x2, y2, conf=0.9, cls=0):
    return {"class": cls, "confidence": conf, "box": {"x1": x1, "y1": y1, "x2": x2, "y2": y2}}


def _moving(tr):
    ids = []
    for step in range(10):
        d = _det(10 + 3 * step, 20, 60 + 3 * step, 70)
        tr.update([d])
        ids.append(d["track_id"])
    return ids


def _low_score(tr):
    seq = [_det(10, 10, 50, 50, 0.9), _det(12, 11, 52, 51, 0.2), _det(14, 12, 54, 52, 0.9)]
    for d in seq:
        tr.update([d])
    return [d["track_id"] for d in seq]


def _gap(tr):
    d0 = _det(100, 100, 160, 180)
    tr.update([d0])
    for _ in range(5):
        tr.update([])
    d1 = _det(104, 102, 164, 182)
    tr.update([d1])
    return [d0["track_id"], d1["track_id"]]


def _class_gate(tr):
    a = _det(10, 10, 50, 50, cls=0)
    tr.update([a])
    b, far = _det(10, 10, 50, 50, cls=1), _det(200, 200, 250, 250, cls=0)
    tr.update([b, far])
    return [a["track_id"], b["track_id"], far["track_id"]]


def _no_swap(tr):
    left, right = _det(0, 0, 40, 40), _det(100, 0, 140, 40)
    tr.update([left, right])
    ids = [left["track_id"], right["track_id"]]
    for step in range(1, 8):
        l2, r2 = _det(4 * step, 0, 40 + 4 * step, 40), _det(100 - 4 * step, 0, 140 - 4 * step, 40)
        tr.update([r2, l2])
        ids += [l2["track_id"], r2["track_id"]]
    return ids


def _obb_corners(tr):
    d = {"class": 0, "confidence": 0.9,
         "box": {"x1": 10, "y1": 10, "x2": 50, "y2": 12, "x3": 48, "y3": 52, "x4": 8, "y4": 50}}
    low = _det(0, 0, 5, 5, conf=0.3)
    tr.update([d, low])
    return [d["track_id"], low["track_id"]]


TRACKER_CASES = {
    "stable_id_moving_target": (_moving, [1] * 10),
    "low_score_keeps_id": (_low_score, [1, 1, 1]),
    "survives_occlusion_gap": (_gap, [1, 1]),
    "new_target_new_id_and_class_gate": (_class_gate, [1, 2, 3]),
    "two_targets_no_id_swap": (_no_swap, [1, 2] * 8),
    "obb_corner_boxes_low_score_starts_none": (_obb_corners, [1, None]),
}


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("case", list(TRACKER_CASES))
def test_tracker(case, pkg):
    run, want = TRACKER_CASES[case]
    assert run(PKGS[pkg][0].ByteTracker()) == want


@pytest.mark.parametrize("pkg", list(PKGS))
def test_map_fn_parsers(pkg):
    data = PKGS[pkg][1]
    obb = data.MAP_FN["obb"]({"name": "torpedo_board", "class": 0, "confidence": 0.88,
                              "box": {"x1": 1, "y1": 2, "x2": 3, "y2": 4,
                                      "x3": 5, "y3": 6, "x4": 7, "y4": 8}})
    assert isinstance(obb, data.OBBData)
    assert obb.corners == [(1, 2), (3, 4), (5, 6), (7, 8)] and obb.area == 0.0
    assert obb.confidence == pytest.approx(0.88) and obb.center == (4.0, 5.0)
    det = data.MAP_FN["detect"]({"name": "x", "class": 1, "confidence": 0.5,
                                 "box": {"x1": 0, "y1": 0, "x2": 10, "y2": 20}})
    assert det.area == 200 and det.corners == [(0, 0), (10, 0), (10, 20), (0, 20)]
    pose = data.MAP_FN["pose"]({"name": "p", "class": 2, "confidence": 0.6,
                                "box": {"x1": 0, "y1": 0, "x2": 1, "y2": 1},
                                "keypoints": {"x": [1, 2], "y": [3, 4], "visible": [1, 0.5]}})
    assert pose.keypoints == [(1, 3, 1), (2, 4, 0.5)]
    assert sorted(data.MAP_FN) == ["detect", "obb", "pose", "segment"]


class _FakeModule:
    def normalize_axis(self, coord, axis):
        return (coord - (200, 100)[axis] / 2) / 200

    def normalize(self, coord):
        return self.normalize_axis(coord[0], 1), self.normalize_axis(coord[1], 0)

    def post(self, name, img, color_space="BGR"):
        self.posted = (name, img.shape)

    def get_latency(self):
        return 0


class _Tuners(dict):
    def __getitem__(self, k):
        return 0.05


@pytest.mark.parametrize("pkg", list(PKGS))
def test_torpedoes_handler_writes_shm(pkg, monkeypatch):
    _, data, torpedoes, shm = PKGS[pkg]
    name = f"test_torpedoes_{uuid.uuid4().hex[:10]}"
    group = shm.define_group(name, shm.DEFAULT_GROUPS["yolo_torpedoes_board"])
    relay = shm.define_group(name + "_relay", shm.DEFAULT_GROUPS["relay"])
    monkeypatch.setattr(torpedoes, "shm", types.SimpleNamespace(relay=relay))
    try:
        handler = torpedoes.TorpedoesOBB("torpedoes")
        module = _FakeModule()
        module.tuners = _Tuners()
        handler.register(module)
        handler._group = lambda: group
        board = data.OBBData("torpedo_board", 0, 0.9, 50, 20, 150, 20, 150, 80, 50, 80)
        img = np.zeros((100, 200, 3), np.uint8)
        handler.process("forward", img, [board], [], [])
        assert group.board_visible.get() == 1
        assert group.board_confidence.get() == pytest.approx(0.9)
        assert group.board_center_x.get() == pytest.approx(0.0)
        assert group.board_center_y.get() == pytest.approx(0.0)
        assert group.board_area.get() > 0
        assert relay.point_x.get() == pytest.approx(0.0)
        assert module.posted == ("torpedoes handler", (100, 200, 3))
        assert img[20, 100].any()  # the board outline was drawn
        weak = data.OBBData("torpedo_board", 0, 0.01, 0, 0, 1, 0, 1, 1, 0, 1)
        handler.process("forward", img, [weak], [], [])
        assert group.board_visible.get() == 0
    finally:
        shm.delete_group(name)
        shm.delete_group(name + "_relay")


def test_explicit_missing_weight_fails_fast(tmp_path):
    from cuauv_vision_pipeline_tpu_torch.modules import yolo

    with pytest.raises(FileNotFoundError, match="absent.msgpack"):
        yolo.Yolo(["cam"], yolo.TUNERS, yolo.HANDLERS, weight=str(tmp_path / "absent.msgpack"),
                  argv=["--device", "cpu"])


def test_yolo_module_entry_point_on_cpu(unique_direction):
    """In a /dev/shm of its own (``run_private``), where no other test's
    clean-up unlinks the source's block or the status group."""
    run_private(yolo_entry_scenario, unique_direction)


def yolo_entry_scenario(unique_direction: str) -> None:
    namespace = f"test-{uuid.uuid4().hex[:10]}"
    os.environ[tshm.NAMESPACE_ENV] = namespace
    # one torch CPU thread per process (run_private's CHILD_ENV): a thread
    # per core on a loaded host waits at every op's barrier for descheduled
    # threads
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUAUV_YOLO_WEIGHT": str(FIXTURE)}
    status = tshm.yolo_status
    status.set(frames=0, latency_ms=0.0)
    procs = []
    try:
        for args in (["capture_sources.synthetic", unique_direction, "--width", "256",
                      "--height", "144", "--fps", "10"],
                     ["modules.yolo", unique_direction, "--device", "cpu"]):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", f"cuauv_vision_pipeline_tpu_torch.{args[0]}", *args[1:]],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + 45
        while time.monotonic() < deadline and status.frames.get() < 3:
            assert all(p.poll() is None for p in procs), [p.communicate()[0][-2000:] for p in procs]
            time.sleep(0.1)
        first = status.frames.get()
        time.sleep(1.0)
        assert status.frames.get() > first >= 3, "yolo_status.frames did not advance"
        assert status.latency_ms.get() > 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        logs = [p.communicate(timeout=30)[0] for p in procs]
        for path in [*Path(BLOCK_STUB).parent.glob(Path(BLOCK_STUB).name + f"*{unique_direction}*"),
                     *Path(tshm.group_path("*")).parent.glob(Path(tshm.group_path("*")).name)]:
            path.unlink(missing_ok=True)
    module_log = logs[1]
    assert "model type: \tdetect" in module_log and "Device: cpu" in module_log, module_log[-2000:]
    assert '"nms_fixed": 0' in module_log  # CPU tensors take the plain version


def test_inactive_detector_posts_the_same_gray_frame():
    img = np.random.default_rng(4).integers(0, 256, (36, 64, 3), dtype=np.uint8)
    posted = {}
    for pkg in PKGS:
        handler = PKGS[pkg][2].TorpedoesOBB("torpedoes")
        module = _FakeModule()
        module.tuners = _Tuners()
        module.post = lambda name, image, color_space="BGR", pkg=pkg: posted.setdefault(pkg, (name, image))
        handler.register(module)
        handler.post_grayscale(img)
    assert posted["torch"][0] == posted["jax"][0] == "torpedoes handler"
    np.testing.assert_array_equal(posted["torch"][1], posted["jax"][1])

"""The port's recorders and video source against the JAX package's, on the
CPU, where cv2 is installed (skipped without it: both packages record and
replay through cv2's VideoWriter/VideoCapture).

Each package's ``RecordMono`` and ``Record`` (the zed four-plane recorder)
takes the same frames with the same acquisition stamps, in this process,
while a mission group of this test's own says ``active``; turning it off
closes the clips. The port's clips decode to the JAX clips' frames exactly,
with the same header rate (RecordMono's is measured from the stamps), and
the port's ``VideoFile`` replays a clip's frames, in order, to each
direction of its spec. No test here touches the shared ``active_mission``
group or any bus block.
"""

import glob
import os
import shutil
import tempfile
import threading
import types
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.capture_sources import video as jvideo
from cuauv_vision_pipeline_tpu.core import shm as jshm
from cuauv_vision_pipeline_tpu.modules import record as jrecord
from cuauv_vision_pipeline_tpu_torch.capture_sources import video as tvideo
from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import gate_frame
from cuauv_vision_pipeline_tpu_torch.core import shm as tshm
from cuauv_vision_pipeline_tpu_torch.core.capture_source import FpsLimiter
from cuauv_vision_pipeline_tpu_torch.modules import record as trecord

H, W = 144, 256
FPS = 20


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture
def log_dir():
    """A short log directory: the mission group's log_path is a 64-byte
    string field, too short for pytest's tmp_path."""
    path = tempfile.mkdtemp(prefix="rec_")
    yield Path(path)
    shutil.rmtree(path)


@pytest.fixture
def missions(monkeypatch, log_dir):
    """Each package's record module pointed at a mission group of its own,
    active, logging under log_dir/<package>."""
    name = f"test_mission_{uuid.uuid4().hex[:12]}"
    schema = tshm.DEFAULT_GROUPS["active_mission"]
    groups = {"torch": tshm.define_group(name, schema), "jax": jshm.define_group(f"{name}_jax", schema)}
    for pkg, mod in (("torch", trecord), ("jax", jrecord)):
        monkeypatch.setattr(mod, "shm", types.SimpleNamespace(active_mission=groups[pkg]))
        (log_dir / pkg).mkdir()
        groups[pkg].log_path.set(str(log_dir / pkg))
        assert groups[pkg].log_path.get() == str(log_dir / pkg)
        groups[pkg].active.set(True)
    yield groups
    tshm.delete_group(name)
    jshm.delete_group(f"{name}_jax")


def _decode(cv2, path):
    cap = cv2.VideoCapture(path)
    assert cap.isOpened(), path
    fps = cap.get(cv2.CAP_PROP_FPS)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return fps, frames


def _frames(n):
    return [gate_frame((H, W), k / FPS) for k in range(n)]


def _record_mono(module, groups, pkg, frames):
    for k, frame in enumerate(frames):
        module._current_acquisition_time = 1000 + k * 1000 // FPS
        module.process("reccam", frame)
    groups[pkg].active.set(False)
    module.process("reccam", frames[-1])  # mission off: the clip closes
    return module.path


def test_record_mono_clip_equals_jax_and_replays(cv2, missions, log_dir):
    frames = _frames(12)
    port = trecord.RecordMono("reccam", fps=FPS, argv=["--device", "cpu"])
    jax_rec = jrecord.RecordMono("reccam", fps=FPS, argv=[])
    clip = _record_mono(port, missions, "torch", frames)
    jclip = _record_mono(jax_rec, missions, "jax", frames)
    assert os.path.dirname(clip) == str(log_dir / "torch") and clip.endswith(".mp4")
    fps, got = _decode(cv2, clip)
    jfps, want = _decode(cv2, jclip)
    assert fps == jfps == pytest.approx(FPS, rel=0.05)  # the stamps' rate, not a default
    assert len(got) == len(want) == len(frames)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # lossy, but the gate scene and not black
    assert np.abs(got[0].astype(int) - frames[0]).mean() < 10 and got[0].mean() > 10

    registered = []
    source = object.__new__(tvideo.VideoFile)
    source.register_capture_udl = lambda name, udl, args=(): registered.append((name, udl))
    tvideo.VideoFile.__init__(source, f"{clip}:replay_a,replay_b", loop=False)
    [(name, udl)] = registered
    assert name == f"video:{clip}"
    replayed = list(udl(FpsLimiter("test", threading.Event()), ()))
    assert [d for d, _, _ in replayed] == ["replay_a", "replay_b"] * len(frames)
    for k, (_, _, frame) in enumerate(replayed):
        np.testing.assert_array_equal(frame, got[k // 2])


def test_record_mono_stays_idle_without_a_mission(cv2, missions):
    missions["torch"].active.set(False)
    port = trecord.RecordMono("reccam", fps=FPS, argv=["--device", "cpu"])
    port._current_acquisition_time = 1000
    port.process("reccam", _frames(1)[0])
    assert port._writer is None and not port._pending and port.path == ""


def _record_zed(module, groups, pkg, n):
    depth = np.full((H, W, 1), 2.5, np.float32)
    normal = np.full((H, W, 3), 0.25, np.float32)
    for k in range(n):
        left = gate_frame((H, W), k / 10)
        module.handle(left, left[:, ::-1].copy(), depth + k * 0.1, normal)
    groups[pkg].active.set(False)
    module.handle(left, left, depth, normal)
    [out] = glob.glob(os.path.join(groups[pkg].log_path.get(), "record-*"))
    return out


def test_record_zed_planes_equal_jax(cv2, missions):
    port = trecord.Record(["zed"], [], fps=trecord.RECORD_FPS, argv=["--device", "cpu"])
    jax_rec = jrecord.Record(["zed"], [], fps=jrecord.RECORD_FPS, argv=[])
    out = _record_zed(port, missions, "torch", 6)
    jout = _record_zed(jax_rec, missions, "jax", 6)
    for plane in ("left", "right", "depth", "normal"):
        fps, got = _decode(cv2, os.path.join(out, f"{plane}.mp4"))
        jfps, want = _decode(cv2, os.path.join(jout, f"{plane}.mp4"))
        assert fps == jfps == trecord.RECORD_FPS
        assert len(got) == len(want) == 6, plane
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_video_spec_parsing_matches_jax():
    for spec in ("clip.mp4:a", "/x/y:z/clip.mp4:a, b"):
        assert tvideo.parse_spec(spec) == jvideo.parse_spec(spec)
    for bad in ("clip.mp4", "clip.mp4: ,"):
        with pytest.raises(ValueError):
            tvideo.parse_spec(bad)


def test_video_file_raises_on_a_missing_clip(cv2, tmp_path):
    with pytest.raises(FileNotFoundError, match="cannot open video"):
        tvideo.VideoFile(f"{tmp_path / 'none.mp4'}:a", loop=False)

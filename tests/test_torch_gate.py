"""The port's gate pieces against the JAX package's, on the CPU.

* ``gate_frame`` (the synthetic ``gate`` scene) bit-exact at three sizes
  and several times; the source's ``--scene gate`` yields those frames.
* ``_orbit_obb`` (the localize mode's stand-in detections) equal.
* ``GateDetector`` with ``CUAUV_GATE_LOCALIZE=1`` and the module's clock
  pinned: the ``shm.yolo_gate`` fields each package writes through its
  GateOBB handler agree to float32 rounding (1e-6), each in a group of this
  test's own; without the variable the module posts the frame.
* The trained gate checkpoint (``tests/fixtures/gate_pico_detect.msgpack``)
  served by the port on the gate scene at 1280x720 finds a shark and a saw,
  as the gate serving path on the card must.
"""

import threading
import types
import uuid

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.capture_sources import synthetic as jsynthetic
from cuauv_vision_pipeline_tpu.core import shm as jshm
from cuauv_vision_pipeline_tpu.core.base import VideoSourceMetadata as JVideoSourceMetadata
from cuauv_vision_pipeline_tpu.modules import gate as jgate
from cuauv_vision_pipeline_tpu_torch.capture_sources import synthetic as tsynthetic
from cuauv_vision_pipeline_tpu_torch.core import shm as tshm
from cuauv_vision_pipeline_tpu_torch.core.base import VideoSourceMetadata
from cuauv_vision_pipeline_tpu_torch.core.capture_source import FpsLimiter
from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
from cuauv_vision_pipeline_tpu_torch.modules import gate as tgate

GATE_FIXTURE = "tests/fixtures/gate_pico_detect.msgpack"


@pytest.mark.parametrize("shape", [(120, 160), (144, 256), (720, 1280)])
def test_gate_frame_bit_exact(shape):
    for t in (0.0, 0.7, 2.5, 9.1):
        np.testing.assert_array_equal(tsynthetic.gate_frame(shape, t), jsynthetic.gate_frame(shape, t))


def test_gate_scene_source_yields_gate_frames(monkeypatch):
    registered = []
    monkeypatch.setattr(tsynthetic.Synthetic, "register_capture_udl",
                        lambda self, name, udl, args=(): registered.append((name, udl)))
    tsynthetic.Synthetic("gatecam", width=160, height=120, fps=10, scene="gate")
    [(name, udl)] = registered
    assert name == "synthetic:gatecam"
    gen = udl(FpsLimiter("test", threading.Event()), ())
    for k in range(3):
        direction, _, frame = next(gen)
        assert direction == "gatecam"
        np.testing.assert_array_equal(frame, jsynthetic.gate_frame((120, 160), k / 10))
    with pytest.raises(ValueError, match="unknown scene"):
        tsynthetic.Synthetic("x", scene="nope")


@pytest.mark.parametrize("t", [0.0, 1.7, 5.25])
def test_orbit_obb_equal(t):
    for cls, phase in ((0, 0.0), (1, np.pi)):
        got = tgate._orbit_obb("shark", cls, 720, 1280, t, phase)
        want = jgate._orbit_obb("shark", cls, 720, 1280, t, phase)
        assert got.corners == want.corners
        assert (got.name, got.class_id, got.confidence) == (want.name, want.class_id, want.confidence)


def _localizing(pkg, metadata_cls, monkeypatch, group, clock, shape):
    """A localize-mode GateDetector of ``pkg`` writing ``group``, its clock
    pinned at ``clock``, its current direction ``forward`` of ``shape``."""
    monkeypatch.setenv("CUAUV_GATE_LOCALIZE", "1")
    argv = ["--device", "cpu"] if pkg is tgate else []
    module = pkg.GateDetector(argv=argv)
    module.handlers["gate"].shm_group = group
    monkeypatch.setattr(pkg, "time", types.SimpleNamespace(monotonic=lambda: clock))
    img = np.zeros(shape + (3,), np.uint8)
    module._video_metadata["forward"] = metadata_cls()
    module._video_metadata["forward"].update(img, 0)
    module._current_direction = "forward"
    return module, img


@pytest.fixture
def gate_groups():
    name = f"test_gate_{uuid.uuid4().hex[:12]}"
    schema = tshm.DEFAULT_GROUPS["yolo_gate"]
    tshm.define_group(name, schema)
    jshm.define_group(f"{name}_jax", schema)
    yield name, f"{name}_jax"
    tshm.delete_group(name)
    jshm.delete_group(f"{name}_jax")


@pytest.mark.parametrize("clock", [100.0, 1234.5])
@pytest.mark.parametrize("shape", [(720, 1280), (120, 160)])
def test_gate_localize_fields_match_jax(monkeypatch, gate_groups, clock, shape):
    tname, jname = gate_groups
    port, img = _localizing(tgate, VideoSourceMetadata, monkeypatch, tname, clock, shape)
    jax_mod, jimg = _localizing(jgate, JVideoSourceMetadata, monkeypatch, jname, clock, shape)
    port.process("forward", img)
    jax_mod.process("forward", jimg)
    got, want = tshm.group(tname).get(), jshm.group(jname).get()
    fields = list(tshm.DEFAULT_GROUPS["yolo_gate"])
    for key in fields:
        assert getattr(got, key) == pytest.approx(getattr(want, key), abs=1e-6), key
    assert got.shark_visible and got.saw_visible and got.shark_area > 0
    assert abs(got.shark_center_x) < 0.6 and abs(got.shark_center_y) < 0.6
    assert "gate handler" in port._post_queue


def test_gate_without_localize_posts_the_frame(monkeypatch, capsys):
    monkeypatch.delenv("CUAUV_GATE_LOCALIZE", raising=False)
    module = tgate.GateDetector(argv=["--device", "cpu"])
    assert not module._localize
    img = np.full((24, 32, 3), 7, np.uint8)
    module._video_metadata["forward"] = VideoSourceMetadata()
    module._video_metadata["forward"].update(img, 0)
    module._current_direction = "forward"
    module.process("forward", img)
    assert "forward" in module._post_queue
    assert capsys.readouterr().out.strip()


def test_gate_fixture_finds_shark_and_saw_on_the_gate_scene():
    model = YoloModel(GATE_FIXTURE, device="cpu")
    assert model.task == "detect" and model.class_names == ["shark", "saw"] and model.image_size == 128
    for t in (0.0, 1.0, 2.5):
        names = {d["name"] for d in model.predict(tsynthetic.gate_frame((720, 1280), t))}
        assert names == {"shark", "saw"}, (t, names)
    assert model.device == torch.device("cpu")

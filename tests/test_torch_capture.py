"""The port's camera sources and bridges against the JAX package's, on the
CPU: the ZED source under a test double of the ZED SDK
(``tests/fake_sdk/pyzed``, put into ``sys.modules`` per test), its
postprocess bit-exact against JAX's jitted one, ``EmaTimer``, the webcam
source under a stand-in ``cv2.VideoCapture``, the JPEG stream bridge and the
shm bridge, each JAX -> port and port -> JAX (these need ``zmq``).

Port groups live in a namespace of this file's own (``CUAUV_SHM_NAMESPACE``),
JAX groups under unique names, so no other test sees them."""

import importlib.util
import json
import sys
import threading
import time
import types
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.capture_sources import generic_camera as jcam
from cuauv_vision_pipeline_tpu.capture_sources import zed as jzed
from cuauv_vision_pipeline_tpu.core import shm as jshm
from cuauv_vision_pipeline_tpu.engine.executor import EmaTimer as JEmaTimer
from cuauv_vision_pipeline_tpu_torch.capture_sources import generic_camera as tcam
from cuauv_vision_pipeline_tpu_torch.capture_sources import zed as tzed
from cuauv_vision_pipeline_tpu_torch.core import shm as tshm
from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BlockAccessor, ReadStatus
from cuauv_vision_pipeline_tpu_torch.core.capture_source import FpsLimiter
from cuauv_vision_pipeline_tpu_torch.engine.executor import EmaTimer

FAKE_SDK = Path(__file__).resolve().parent / "fake_sdk" / "pyzed"
PLANES = ("forward", "forward2", "depth", "normal")


def _load(name: str, path: Path) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def namespace(monkeypatch):
    ns = f"tcap-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv(tshm.NAMESPACE_ENV, ns)
    yield ns
    for name in tshm.list_groups():
        tshm.delete_group(name)


@pytest.fixture
def fake_zed(monkeypatch):
    """The ZED SDK double as ``pyzed`` / ``pyzed.sl`` for this test only."""
    pkg = _load("pyzed", FAKE_SDK / "__init__.py")
    sl = _load("pyzed.sl", FAKE_SDK / "sl.py")
    pkg.sl = sl
    monkeypatch.setitem(sys.modules, "pyzed", pkg)
    monkeypatch.setitem(sys.modules, "pyzed.sl", sl)
    return sl


def _sdk_inputs(seed: int, h: int = 48, w: int = 64):
    """Seeded SDK arrays with NaN and +-inf in depth and normals."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    right = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    depth = rng.uniform(-2.0, 12.0, (h, w)).astype(np.float32)
    normals = rng.uniform(-1.0, 1.0, (h, w, 4)).astype(np.float32)
    for plane in (depth, normals[..., :3]):
        holes = rng.random(plane.shape)
        plane[holes < 0.05] = np.nan
        plane[(holes >= 0.05) & (holes < 0.08)] = np.inf
        plane[(holes >= 0.08) & (holes < 0.11)] = -np.inf
    return left, right, depth, normals


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_postprocess_bit_exact_against_jax(seed):
    inputs = _sdk_inputs(seed)
    want = [np.asarray(o) for o in jzed._postprocess_fn()(*inputs)]
    got = tzed._postprocess_fn(device="cpu")(*inputs)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the holes really were there, and came out as JAX maps them
    assert np.isnan(inputs[2]).any() and np.isinf(inputs[3]).any()
    assert np.isfinite(got[2]).all() and got[2][np.isinf(inputs[2])[..., None]].max() == 0.0


def _capture(module, direction: str, split: bool, n: int):
    """The first ``n`` yields of ``module.ZedSource``'s capture UDL."""
    source = module.ZedSource(direction, split_directions=split)
    quit_flag = threading.Event()
    gen = source._capture_udl(FpsLimiter("zed", quit_flag), (direction,))
    out = [next(gen) for _ in range(n)]
    gen.close()
    return out, source.zed


@pytest.mark.parametrize("split", [False, True])
def test_zed_capture_matches_jax_under_the_fake_sdk(fake_zed, namespace, monkeypatch, split):
    monkeypatch.setenv("CUAUV_TPU_DEVICE", "cpu")
    direction = f"zed_{uuid.uuid4().hex[:8]}"
    n = 8 if split else 2
    got, camera = _capture(tzed, direction, split, n)
    want, _ = _capture(jzed, direction, split, n)
    assert camera.init.camera_resolution is fake_zed.RESOLUTION.HD720
    assert camera.settings[fake_zed.VIDEO_SETTINGS.AEC_AGC] == 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        if split:
            assert g[0] == w[0]
            np.testing.assert_array_equal(_bits(g[2]), _bits(w[2]))
        else:
            assert g[0] == w[0] == direction and g[3] == w[3] == PLANES
            for gp, wp in zip(g[2], w[2]):
                assert gp.shape == wp.shape and gp.dtype == wp.dtype
                np.testing.assert_array_equal(_bits(gp), _bits(wp))
    if split:
        assert [g[0] for g in got] == list(PLANES) * 2
        planes = [g[2] for g in got[:4]]
    else:
        planes = got[0][2]
    # frame 0: (right, left) eyes as forward, forward2, flipped to RGB
    left, right, depth, normals = fake_zed.frame(0)
    np.testing.assert_array_equal(planes[0], right[..., 2::-1])
    np.testing.assert_array_equal(planes[1], left[..., 2::-1])
    assert planes[2].shape == depth.shape + (1,) and planes[3].shape == normals.shape[:2] + (3,)
    # the metrics group saw the stage EMAs
    metrics = tshm.zed_metrics.get()
    assert metrics.acquisition_sec > 0 and metrics.postprocess_sec > 0 and metrics.start_time_sec > 0


def test_zed_calibration_udl_pushes_shm_settings(fake_zed, namespace):
    source = tzed.ZedSource("zed")
    tshm.zed_calibration.set(zed_exposure=37.0, brightness=6.0)
    quit_flag = threading.Event()
    thread = threading.Thread(
        target=source._calibration_udl, args=(FpsLimiter("calib", quit_flag), ())
    )
    thread.start()
    time.sleep(0.3)
    quit_flag.set()
    thread.join(timeout=10)
    assert not thread.is_alive()
    settings = source.zed.settings
    assert settings[fake_zed.VIDEO_SETTINGS.EXPOSURE] == 37
    assert settings[fake_zed.VIDEO_SETTINGS.BRIGHTNESS] == 6
    assert settings[fake_zed.VIDEO_SETTINGS.WHITEBALANCE_TEMPERATURE] == 4600


def test_zed_without_sdk_exits_with_the_jax_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyzed", None)
    monkeypatch.setitem(sys.modules, "pyzed.sl", None)
    with pytest.raises(SystemExit) as got:
        tzed.ZedSource("zed")
    with pytest.raises(SystemExit) as want:
        jzed.ZedSource("zed")
    assert str(got.value) == str(want.value) and "pyzed" in str(got.value)


def test_ema_timer_matches_jax():
    rng = np.random.default_rng(5)
    ours, theirs = EmaTimer(alpha=0.2, report_every_s=0.0), JEmaTimer(alpha=0.2, report_every_s=0.0)
    for stage, sec in zip(rng.choice(["acquisition", "postprocess"], 40), rng.uniform(0, 0.05, 40)):
        ours.record(str(stage), float(sec))
        theirs.record(str(stage), float(sec))
    assert ours.stages == theirs.stages
    got, want = [], []
    ours.maybe_report(got.append)
    theirs.maybe_report(want.append)
    assert got == want and got[0].startswith("stage timings (EMA a=0.2)")


def _fake_cv2(frames):
    """A cv2 stand-in whose VideoCapture cycles ``frames``."""

    class VideoCapture:
        def __init__(self, index):
            self.index, self.k = index, 0

        def isOpened(self):
            return self.index == 3

        def read(self):
            frame = frames[self.k % len(frames)]
            self.k += 1
            return True, frame.copy()

    return types.SimpleNamespace(VideoCapture=VideoCapture)


@pytest.mark.parametrize("module", [tcam, jcam], ids=["port", "jax"])
def test_generic_camera_with_a_fake_video_capture(monkeypatch, module):
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8) for _ in range(3)]
    monkeypatch.setitem(sys.modules, "cv2", _fake_cv2(frames))
    with pytest.raises(RuntimeError, match="cannot open camera index 0"):
        module.GenericCamera(0, "x")
    direction = f"cam_{uuid.uuid4().hex[:8]}"
    camera = module.GenericCamera(3, direction, fps=50)
    thread = threading.Thread(target=camera.run_event_loop)
    thread.start()
    try:
        got = _read_one(direction)
    finally:
        camera.quit_flag.set()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert any(np.array_equal(got, f) for f in frames)


def _read_one(direction: str, timeout: float = 10.0):
    """The first frame of bus block ``direction`` (waits for the block)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with BlockAccessor(direction) as reader:
                while time.monotonic() < deadline:
                    status, data, _ = reader.read_frame()
                    if status == ReadStatus.SUCCESS:
                        return np.array(data)
                    time.sleep(0.02)
        except (FileNotFoundError, RuntimeError, OSError):
            time.sleep(0.05)
    raise TimeoutError(f"no frame on {direction}")


# --- the JPEG stream bridge -----------------------------------------------------


def _smooth_frame():
    ys, xs = np.mgrid[0:48, 0:64]
    return np.stack([ys * 4, xs * 3, (ys + xs) * 2], axis=-1).astype(np.uint8)


def test_jpeg_codec_matches_jax():
    from cuauv_vision_pipeline_tpu.capture_sources import stream_client as jclient
    from cuauv_vision_pipeline_tpu.capture_sources import stream_server as jserver
    from cuauv_vision_pipeline_tpu_torch.capture_sources import stream_client, stream_server

    frame = _smooth_frame()
    payload = stream_server.encode_jpeg(frame, quality=90)
    assert payload == jserver.encode_jpeg(frame, quality=90)
    np.testing.assert_array_equal(stream_client.decode_jpeg(payload), jclient.decode_jpeg(payload))


@pytest.mark.parametrize("route", ["jax_to_port", "port_to_jax"])
def test_stream_bridge_across_packages(route):
    zmq = pytest.importorskip("zmq")  # noqa: F841
    from cuauv_vision_pipeline_tpu.capture_sources import stream_client as jclient
    from cuauv_vision_pipeline_tpu.capture_sources import stream_server as jserver
    from cuauv_vision_pipeline_tpu_torch.capture_sources import stream_client as tclient
    from cuauv_vision_pipeline_tpu_torch.capture_sources import stream_server as tserver

    server, client = (jserver, tclient) if route == "jax_to_port" else (tserver, jclient)
    direction = f"strm_{uuid.uuid4().hex[:8]}"
    endpoint = f"tcp://127.0.0.1:{20000 + int(uuid.uuid4().hex[:4], 16) % 10000}"
    frame = _smooth_frame()
    with BlockAccessor(direction, max_entry_size_bytes=frame.nbytes + 4096) as writer:
        writer.write_frame(123, frame)
        serving = threading.Thread(target=server.serve, args=(direction, endpoint, 20, 90), daemon=True)
        serving.start()
        receiver = client.StreamClient(endpoint, suffix="_stream")
        receiving = threading.Thread(target=receiver.run_event_loop)
        receiving.start()
        try:
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                writer.write_frame(123, frame)  # the server sends each new frame once
                try:
                    got = _read_one(direction + "_stream", timeout=0.5)
                    break
                except TimeoutError:
                    continue
            else:
                raise AssertionError("no frame crossed the bridge")
        finally:
            receiver.quit_flag.set()
            receiving.join(timeout=10)
    serving.join(timeout=10)  # the source block's deletion ends serve()
    assert not receiving.is_alive() and not serving.is_alive()
    want = tclient.decode_jpeg(tserver.encode_jpeg(frame, 90))
    np.testing.assert_array_equal(got, want)


# --- the shm bridge -------------------------------------------------------------

SCHEMA = {"visible": ["bool", False], "area": ["float", 0.0], "count": ["int", 0], "label": ["string", ""]}


def _bridge(publish, subscribe, endpoint, pub_args, sub_kwargs):
    pub = threading.Thread(target=publish, args=(endpoint, *pub_args), kwargs={"duration_s": 6.0}, daemon=True)
    sub = threading.Thread(target=subscribe, args=(endpoint,), kwargs={**sub_kwargs, "duration_s": 6.0},
                           daemon=True)
    pub.start()
    time.sleep(0.3)
    sub.start()
    return pub, sub


def _wait(read, want, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            got = read()
            if got == want:
                return got
        except KeyError:
            pass
        time.sleep(0.05)
    return read()


def test_shm_bridge_jax_publisher_port_subscriber(namespace):
    pytest.importorskip("zmq")
    from cuauv_vision_pipeline_tpu.misc import shm_bridge as jbridge
    from cuauv_vision_pipeline_tpu_torch.misc import shm_bridge as tbridge

    name = f"bridge_{uuid.uuid4().hex[:8]}"
    group = jshm.define_group(name, SCHEMA)
    endpoint = f"tcp://127.0.0.1:{20000 + int(uuid.uuid4().hex[:4], 16) % 10000}"
    try:
        pub, sub = _bridge(jbridge.publish, tbridge.subscribe, endpoint, ([name], False), {"prefix": "mirror_"})
        time.sleep(0.6)
        group.set(visible=True, area=123.5, count=7, label="buoy")
        got = _wait(lambda: vars(tshm.group("mirror_" + name).get()),
                    {"visible": True, "area": 123.5, "count": 7, "label": "buoy"})
        assert got == {"visible": True, "area": 123.5, "count": 7, "label": "buoy"}
        assert Path(tshm.group_path("mirror_" + name)).name.endswith("@" + namespace)
        pub.join(timeout=15)
        sub.join(timeout=15)
    finally:
        jshm.delete_group(name)


def test_shm_bridge_port_publisher_jax_subscriber(namespace):
    """``--all`` on the port side mirrors this namespace's groups (here
    one) under their plain names."""
    pytest.importorskip("zmq")
    from cuauv_vision_pipeline_tpu.misc import shm_bridge as jbridge
    from cuauv_vision_pipeline_tpu_torch.misc import shm_bridge as tbridge

    name = f"bridge_{uuid.uuid4().hex[:8]}"
    group = tshm.define_group(name, SCHEMA)
    assert tshm.list_groups() == [name]
    prefix = f"m{uuid.uuid4().hex[:6]}_"
    endpoint = f"tcp://127.0.0.1:{20000 + int(uuid.uuid4().hex[:4], 16) % 10000}"
    try:
        pub, sub = _bridge(tbridge.publish, jbridge.subscribe, endpoint, (None, True), {"prefix": prefix})
        time.sleep(0.6)
        group.set(visible=True, area=42.0, count=3, label="gate")
        want = {"visible": True, "area": 42.0, "count": 3, "label": "gate"}
        assert _wait(lambda: vars(jshm.group(prefix + name).get()), want) == want
        pub.join(timeout=15)
        sub.join(timeout=15)
        # the snapshot on the wire is the JAX bridge's JSON
        assert json.loads(json.dumps(tbridge._schema_of(group))) == jbridge._schema_of(jshm.group(prefix + name))
    finally:
        jshm.delete_group(prefix + name)

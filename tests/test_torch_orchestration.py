"""The port's vehicle orchestration against the JAX package's, on the CPU:
the vehicle config, the module toggler (flags, reaping, the flag group's
bytes, the module command line, a real ``modules.red_buoy`` subprocess on
``--device cpu``), the web viewer, ``yolo_shm``, ``resizable_tpool``,
``runner``, ``hypertune`` over the six demo modules beside the JAX modules,
and the torch.profiler hook.

Port groups live in a namespace of each test's own (``CUAUV_SHM_NAMESPACE``)
and JAX groups in a private store (a patched ``SHM_STUB``), so no other
test sees the flags or results these tests write."""

import copy
import http.client
import importlib
import json
import os
import signal
import sys
import threading
import time
import types
import uuid
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.core import config as jconfig
from cuauv_vision_pipeline_tpu.core import shm as jshm
from cuauv_vision_pipeline_tpu.core.module_toggler import ModuleToggler as JModuleToggler
from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import Synthetic
from cuauv_vision_pipeline_tpu_torch.core import config as tconfig
from cuauv_vision_pipeline_tpu_torch.core import shm as tshm
from cuauv_vision_pipeline_tpu_torch.core import trace
from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BLOCK_STUB
from cuauv_vision_pipeline_tpu_torch.core.config import vehicle
from cuauv_vision_pipeline_tpu_torch.core.module_toggler import ModuleToggler
from test_torch_private_shm import run_private

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def namespace(monkeypatch):
    ns = f"torch-orch-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv(tshm.NAMESPACE_ENV, ns)
    yield ns
    for name in tshm.list_groups():
        tshm.delete_group(name)


@pytest.fixture
def jax_store(monkeypatch):
    """A private store for the JAX package's groups during the test."""
    stub = f"{jshm.SHM_STUB}torchorch{uuid.uuid4().hex[:8]}_"
    monkeypatch.setattr(jshm, "SHM_STUB", stub)
    monkeypatch.setattr(jshm, "_group_cache", {})
    yield stub
    root, prefix = os.path.dirname(stub), os.path.basename(stub)
    for entry in os.listdir(root):
        if entry.startswith(prefix):
            os.unlink(os.path.join(root, entry))


def _vehicles():
    return tconfig._Vehicle(), jconfig._Vehicle()


def _same(port, jax_):
    for attr in ("cameras", "vision_modules", "module_devices"):
        assert getattr(port, attr) == getattr(jax_, attr), attr


# --- vehicle config ---------------------------------------------------------------


def test_vehicle_config_defaults_match_jax(monkeypatch):
    monkeypatch.delenv("CUAUV_VEHICLE_CONFIG", raising=False)
    assert tconfig._DEFAULT_CONFIG == jconfig._DEFAULT_CONFIG
    bundled = REPO / "cuauv_vision_pipeline_tpu_torch" / "configs" / "vehicle.yaml"
    assert bundled.read_bytes() == (REPO / "cuauv_vision_pipeline_tpu" / "configs" / "vehicle.yaml").read_bytes()
    port, jax_ = _vehicles()
    _same(port, jax_)
    assert port.vision_modules["poster"] == ["zed"] and port.module_devices == {}


def test_vehicle_config_from_a_yaml_file_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("yaml")
    path = tmp_path / "vehicle.yaml"
    path.write_text(
        "cameras:\n  zed: {type: zed, fps: 10}\n  forward: {type: flir, serial: '12345', width: 1600}\n"
        "vision_modules:\n  red_buoy: [zed, forward]\n  poster: [zed]\n"
        "module_devices:\n  red_buoy: {zed: 0, forward: '1'}\n"
    )
    monkeypatch.setenv("CUAUV_VEHICLE_CONFIG", str(path))
    port, jax_ = _vehicles()
    _same(port, jax_)
    assert port.module_devices == {"red_buoy": {"zed": 0, "forward": 1}}
    assert port.vision_modules["red_buoy"] == ["zed", "forward"]


def test_vehicle_config_without_yaml_uses_the_defaults_like_jax(monkeypatch, capsys):
    monkeypatch.delenv("CUAUV_VEHICLE_CONFIG", raising=False)
    monkeypatch.setitem(sys.modules, "yaml", None)
    port, jax_ = _vehicles()
    _same(port, jax_)
    assert port.vision_modules == tconfig._DEFAULT_CONFIG["vision_modules"]
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all("[config] failed to load" in line and "using defaults" in line for line in out)


# --- the toggler ------------------------------------------------------------------


def test_toggler_flag_lifecycle(tmp_path, monkeypatch, namespace):
    monkeypatch.setenv("CUAUV_LOG", str(tmp_path))
    toggler = ModuleToggler()
    monkeypatch.setattr(
        ModuleToggler, "_module_argv",
        lambda self, m, s: [sys.executable, "-c", "import time; time.sleep(30)"],
    )
    flags = tshm.vision_modules
    flag = toggler._flag_name("red_buoy", "zed")
    assert flag in flags.field_names()
    flags.set_field(flag, True)
    toggler.sync()
    assert "red_buoy_zed" in toggler.running
    process = toggler.running["red_buoy_zed"].process
    assert process.pid > 0
    flags.set_field(flag, False)
    toggler.sync()
    assert "red_buoy_zed" not in toggler.running
    assert process.returncode == -signal.SIGTERM  # stopped by the group's SIGTERM
    log = (tmp_path / "current" / "red_buoy@zed-module.log").read_text()
    assert log.startswith("Starting ")


def test_toggler_reaps_dead(tmp_path, monkeypatch, namespace):
    monkeypatch.setenv("CUAUV_LOG", str(tmp_path))
    toggler = ModuleToggler()
    monkeypatch.setattr(ModuleToggler, "_module_argv", lambda self, m, s: [sys.executable, "-c", "pass"])
    tshm.vision_modules.set_field(toggler._flag_name("gate", "zed"), True)
    toggler.sync()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and "gate_zed" in toggler.running:
        time.sleep(0.1)
        toggler._reap()
    assert "gate_zed" not in toggler.running


def test_toggler_flag_group_is_byte_identical_to_jax(monkeypatch, namespace, jax_store):
    modules = {"red_buoy": ["zed", "down-cam"], "poster": ["zed"], "yolo": ["forward"]}
    monkeypatch.setattr(vehicle, "vision_modules", modules)
    monkeypatch.setattr(jconfig.vehicle, "vision_modules", modules)
    ModuleToggler()
    JModuleToggler()
    port = Path(tshm.group_path("vision_modules")).read_bytes()
    jax_ = Path(jax_store + "vision_modules").read_bytes()
    assert port == jax_
    schema_len = int.from_bytes(port[16:20], "little")
    schema = json.loads(port[20:20 + schema_len])
    assert schema == {
        "red_buoy_on_zed": ["bool", False], "red_buoy_on_down_cam": ["bool", False],
        "poster_on_zed": ["bool", False], "yolo_on_forward": ["bool", False],
    }


def test_module_argv_names_the_port_and_its_device(monkeypatch, namespace):
    monkeypatch.setattr(vehicle, "vision_modules", {"red_buoy": ["zed", "forward"]})
    monkeypatch.setattr(vehicle, "module_devices", {"red_buoy": {"forward": 1}})
    toggler = ModuleToggler()
    prefix = [sys.executable, "-m", "cuauv_vision_pipeline_tpu_torch.modules.red_buoy"]
    assert toggler._module_argv("red_buoy", "zed") == prefix + ["zed"]
    assert toggler._module_argv("red_buoy", "forward") == prefix + ["forward", "--device", "1"]
    # the port's ModuleBase reads that flag as cuda:1
    from cuauv_vision_pipeline_tpu_torch.modules.red_buoy import BuoyLAB

    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        BuoyLAB(["zed"], [], argv=["forward", "--device", "1"])


class _Viewer:
    """The port's web viewer on 127.0.0.1:<free port> in a thread."""

    def __enter__(self):
        from cuauv_vision_pipeline_tpu_torch.misc.web_viewer import Handler

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        return self

    def request(self, method, path):
        conn = http.client.HTTPConnection("127.0.0.1", self.server.server_address[1], timeout=10)
        conn.request(method, path)
        response = conn.getresponse()
        return response.status, response.read()

    def first_jpeg(self, path, timeout=20.0):
        """The first JPEG part of an MJPEG stream."""
        conn = http.client.HTTPConnection("127.0.0.1", self.server.server_address[1], timeout=timeout)
        conn.request("GET", path)
        response = conn.getresponse()
        buf = b""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            buf += response.read1(65536)
            start = buf.find(b"\xff\xd8")
            end = buf.find(b"\xff\xd9", start + 2) if start >= 0 else -1
            if end >= 0:
                conn.close()
                return response.getheader("Content-Type"), buf[start:end + 2]
        conn.close()
        raise TimeoutError(f"no JPEG part from {path}")

    def __exit__(self, *exc):
        from cuauv_vision_pipeline_tpu_torch.misc import web_viewer

        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        for reader in list(web_viewer._readers.values()):
            reader.unblock()
        web_viewer._readers.clear()
        web_viewer._latest.clear()


def test_web_viewer_endpoints(monkeypatch, namespace):
    """As the JAX viewer's test: the index renders, an unknown shm group
    or toggle 404s, a known toggle flips its flag, a result group reads."""
    with _Viewer() as viewer:
        status, body = viewer.request("GET", "/")
        assert status == 200 and b"tpu-vision-pipeline" in body
        assert viewer.request("GET", "/shm/definitely_not_a_group")[0] == 404
        assert viewer.request("POST", "/toggle/nope/nocam?on=true")[0] == 404
        ModuleToggler()  # defines the flag group
        flag = ModuleToggler._flag_name("red_buoy", "zed")
        assert tshm.vision_modules.get_field(flag) is False
        status, body = viewer.request("POST", "/toggle/red_buoy/zed?on=true")
        assert status == 200 and json.loads(body) == {"ok": True, "flag": flag, "on": True}
        assert tshm.vision_modules.get_field(flag) is True
        tshm.red_buoy_results.set(area=23450.0)
        status, body = viewer.request("GET", "/shm/red_buoy_results")
        assert status == 200 and json.loads(body)["area"] == 23450.0
        # the index's toggles and results readout: this namespace's groups
        body = viewer.request("GET", "/")[1].decode()
        assert "red_buoy on zed" in body and "shm_red_buoy_results" in body


def test_toggler_runs_the_real_red_buoy_on_the_cpu(tmp_path):
    """The viewer's toggle starts ``modules.red_buoy`` under the toggler
    (``CUAUV_TPU_DEVICE=cpu``) on a 256x144 synthetic zed source: results
    and the module's MJPEG post come through; the toggle-off stops it. In a
    /dev/shm of its own (``run_private``), where no other test's clean-up
    unlinks the source's block or the results group. The module keeps
    torch's CPU pool to one thread (``run_private`` gives it ``CHILD_ENV``):
    at a thread per core, beside the suite's other workers on every core,
    each of the chain's small ops waits at its thread barrier for
    descheduled threads (``scripts/cpu_pool_under_load.py``: a chain call
    15.5 s, not 0.05 s) and the first result missed the wait."""
    run_private(toggler_scenario, str(tmp_path))


def toggler_scenario(tmp: str) -> None:
    os.environ.update({"CUAUV_LOG": tmp, "CUAUV_TPU_DEVICE": "cpu", "PYTHONPATH": str(REPO),
                       tshm.NAMESPACE_ENV: f"torch-orch-{uuid.uuid4().hex[:8]}"})
    direction = f"torch_orch_{uuid.uuid4().hex[:8]}"
    vehicle.vision_modules, vehicle.module_devices = {"red_buoy": [direction]}, {}
    source = Synthetic(direction, width=256, height=144, fps=20, scene="zed")
    source_thread = threading.Thread(target=source.run_event_loop)
    source_thread.start()
    toggler = ModuleToggler()
    results = tshm.red_buoy_results
    results.set(visible=False, area=0.0)
    log = Path(tmp) / "current" / f"red_buoy@{direction}-module.log"
    try:
        with _Viewer() as viewer:
            assert viewer.request("POST", f"/toggle/red_buoy/{direction}?on=true")[0] == 200
            toggler.sync()
            assert list(toggler.running) == [f"red_buoy_{direction}"]
            process = toggler.running[f"red_buoy_{direction}"].process
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline and not (results.area.get() > 0 and "Device: cpu" in log.read_text()):
                toggler._reap()
                assert toggler.running, f"the module died:\n{log.read_text()[-3000:]}"
                time.sleep(0.2)
            assert results.area.get() == 256 * 144, log.read_text()[-3000:]
            assert "Device: cpu (host CPU)" in log.read_text()
            assert json.loads(viewer.request("GET", "/shm/red_buoy_results")[1])["area"] == 256 * 144
            kind, jpeg = viewer.first_jpeg(f"/stream/BuoyLAB-on-{direction}/contours")
            assert kind == "multipart/x-mixed-replace; boundary=frame" and len(jpeg) > 100
            assert viewer.request("POST", f"/toggle/red_buoy/{direction}?on=false")[0] == 200
            toggler.sync()
        assert not toggler.running and process.returncode == -signal.SIGTERM, process.returncode
    finally:
        for entry in list(toggler.running.values()):
            toggler._stop(entry.name, entry.source)
        source.quit_flag.set()
        source_thread.join(timeout=10)
        # a module stopped by SIGTERM runs no cleanup: unlink its blocks
        for path in Path(BLOCK_STUB).parent.glob(Path(BLOCK_STUB).name + f"*{direction}*"):
            path.unlink(missing_ok=True)
        for name in tshm.list_groups():
            tshm.delete_group(name)


# --- misc tools -------------------------------------------------------------------


def test_yolo_shm_tool_msgpack_sidecar(tmp_path, namespace):
    from cuauv_vision_pipeline_tpu_torch.misc import yolo_shm

    weight = tmp_path / "model.msgpack"
    weight.write_bytes(b"")
    (tmp_path / "model.msgpack.json").write_text(json.dumps({"names": ["buoy", "gate-post"]}))
    yolo_shm.main([str(weight)])
    assert tshm.group("yolo_buoy").visible.get() is False
    tshm.yolo_gate_post.confidence.set(0.5)
    assert tshm.yolo_gate_post.confidence.get() == 0.5
    yolo_shm.main([str(weight), "--delete"])
    assert not os.path.exists(tshm.group_path("yolo_buoy"))


def test_yolo_shm_names_from_a_pt_checkpoint_match_jax(tmp_path):
    from cuauv_vision_pipeline_tpu.misc import yolo_shm as jyolo_shm
    from cuauv_vision_pipeline_tpu_torch.misc import yolo_shm
    from cuauv_vision_pipeline_tpu_torch.models.yolo.model import YOLO
    from cuauv_vision_pipeline_tpu_torch.models.yolo.weights import export_ultralytics_state

    torch.manual_seed(0)
    state = export_ultralytics_state(YOLO(3, "n", "obb"))
    path = str(tmp_path / "w.pt")
    names = {0: "shark", 1: "saw", 2: "gate-post"}
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}, "task": "obb", "names": names}, path)
    assert yolo_shm.class_names_from_weight(path) == ["shark", "saw", "gate-post"]
    assert yolo_shm.class_names_from_weight(path) == jyolo_shm.class_names_from_weight(path)


def test_resizable_tpool():
    from cuauv_vision_pipeline_tpu_torch.misc.resizable_tpool import ResizableThreadPool

    pool = ResizableThreadPool(2)
    assert pool.num_threads == 2
    assert pool.execute(lambda a, b: a + b, 2, 3) == 5
    pool.set_num_threads(4)
    results = [pool.submit(lambda i=i: i * i) for i in range(8)]
    assert sorted(f.result() for f in results) == [i * i for i in range(8)]
    pool.set_num_threads(1)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and pool.num_threads != 1:
        time.sleep(0.01)
    assert pool.num_threads == 1
    assert pool.execute(len, [1, 2]) == 2
    with pytest.raises(ZeroDivisionError):
        pool.execute(lambda: 1 / 0)


def test_runner_spawns_the_port_module(monkeypatch):
    from cuauv_vision_pipeline_tpu.misc import runner as jrunner
    from cuauv_vision_pipeline_tpu_torch.misc import runner

    spawned = []
    monkeypatch.setattr(
        runner.subprocess, "Popen", lambda argv, **kw: spawned.append(argv) or types.SimpleNamespace(pid=0)
    )
    path = runner._module_file("red_buoy")
    assert path == REPO / "cuauv_vision_pipeline_tpu_torch" / "modules" / "red_buoy.py"
    runner._spawn("red_buoy", ["zed", "--device", "cpu"])
    jrunner._spawn("red_buoy", ["zed"])
    assert spawned == [
        [sys.executable, "-m", "cuauv_vision_pipeline_tpu_torch.modules.red_buoy", "zed", "--device", "cpu"],
        [sys.executable, "-m", "cuauv_vision_pipeline_tpu.modules.red_buoy", "zed"],
    ]


# --- the demo modules through hypertune ---------------------------------------------

# module -> (class, tuners attribute or None, tuner values)
DEMOS = {
    "example": ("Example", "module_tuners", {"brightness": 50}),
    "test": ("TestModule", None, {}),
    "lab_test": ("LabTest", None, {}),
    "normal": ("Normal", "module_options", {"x": 10, "y": 20}),
    "normal_relay": ("NormalRelay", None, {}),
    "poster": ("Poster", None, {}),
}


def _probe(cls):
    """``cls`` with its last instance on the class (the running mean)."""

    class Probe(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            Probe.instance = self

    Probe.__name__ = cls.__name__
    return Probe


def _run_demo(package, name, image, device, direction_id, monkeypatch):
    module = importlib.import_module(f"{package}.modules.{name}")
    hyper = importlib.import_module(f"{package}.misc.hypertune")
    monkeypatch.setattr(hyper, "uuid", types.SimpleNamespace(uuid4=lambda: direction_id))
    cls_name, tuners_attr, values = DEMOS[name]
    cls = _probe(getattr(module, cls_name))
    tuners = copy.deepcopy(getattr(module, tuners_attr)) if tuners_attr else []
    kwargs = {"device": device} if device else {}
    posts = hyper.run_module_over_images(cls, [image], tuners, values, fps=10, **kwargs)
    return posts, cls.instance


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_module_through_hypertune_matches_jax(name, monkeypatch, namespace, jax_store):
    image = np.random.default_rng(sorted(DEMOS).index(name)).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    if name == "normal_relay":
        tshm.relay.set(point_x=0.3, point_y=-0.1)
        jshm.relay.set(point_x=0.3, point_y=-0.1)
    direction_id = uuid.uuid4()
    got, port_module = _run_demo("cuauv_vision_pipeline_tpu_torch", name, image, "cpu", direction_id, monkeypatch)
    want, jax_module = _run_demo("cuauv_vision_pipeline_tpu", name, image, None, direction_id, monkeypatch)
    assert port_module.device == torch.device("cpu")
    assert got and sorted(got) == sorted(want)
    for post in got:
        # one frame: every post of a name is that frame's, byte for byte
        first = want[post][0]
        for image_ in got[post] + want[post]:
            assert image_.dtype == np.uint8
            np.testing.assert_array_equal(image_, first, err_msg=post)
    if name == "normal":
        assert port_module.count >= 1 and jax_module.count >= 1
        np.testing.assert_allclose([port_module.x, port_module.y, port_module.z],
                                   [jax_module.x, jax_module.y, jax_module.z], rtol=0, atol=1e-6)
    if name == "normal_relay":
        ours, theirs = tshm.relay.get(), jshm.relay.get()
        for axis in "xyz":
            field = f"normal_{axis}_at_point"
            assert abs(getattr(ours, field) - getattr(theirs, field)) <= 1e-6, field
        assert abs(ours.normal_x_at_point) + abs(ours.normal_y_at_point) > 0
    if name == "poster":
        assert tshm.poster_status.frames_posted.get() == jshm.poster_status.frames_posted.get() >= 1


def test_normal_running_mean_matches_jax():
    from cuauv_vision_pipeline_tpu.modules import normal as jnormal
    from cuauv_vision_pipeline_tpu_torch.modules import normal as tnormal

    def options(package):
        tuners = copy.deepcopy(package.module_options)
        for t in tuners:
            t._current_value = {"x": 7, "y": 11}[t.name]  # as hypertune sets them
        return tuners

    port = tnormal.Normal(["normal"], options(tnormal), argv=["--device", "cpu"])
    jax_ = jnormal.Normal(["normal"], options(jnormal), argv=[])
    rng = np.random.default_rng(3)
    for _ in range(6):
        img = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
        port.process("normal", img.copy())
        jax_.process("normal", img.copy())
        np.testing.assert_allclose([port.x, port.y, port.z], [jax_.x, jax_.y, jax_.z], rtol=0, atol=1e-6)
    assert port.count == jax_.count == 6


# --- the torch.profiler hook -------------------------------------------------------


def _run_module_briefly(direction):
    """``BuoyLAB.__call__`` on --device cpu for about a second in this
    (main) thread, stopped through its own SIGINT handler."""
    from cuauv_vision_pipeline_tpu_torch.modules.red_buoy import BuoyLAB, module_tuners

    assert threading.current_thread() is threading.main_thread()
    original = signal.getsignal(signal.SIGINT)
    module = BuoyLAB([direction], copy.deepcopy(module_tuners), argv=["--device", "cpu"])

    def stop():
        deadline = time.monotonic() + 30
        while signal.getsignal(signal.SIGINT) is original and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(1.0)
        handler = signal.getsignal(signal.SIGINT)
        if handler is not original:
            handler(signal.SIGINT, None)

    stopper = threading.Thread(target=stop)
    stopper.start()
    try:
        module()
    finally:
        stopper.join(timeout=40)
        signal.signal(signal.SIGINT, original)


@pytest.mark.parametrize("enabled", [True, False])
def test_device_profile_hook(tmp_path, enabled):
    """In a /dev/shm of its own (``run_private``), as the toggler test."""
    run_private(profile_scenario, str(tmp_path), enabled)


def profile_scenario(tmp: str, enabled: bool) -> None:
    os.environ[tshm.NAMESPACE_ENV] = f"torch-orch-{uuid.uuid4().hex[:8]}"
    profile_dir = Path(tmp) / "profile"
    if enabled:
        os.environ[trace.PROFILE_DIR_ENV] = str(profile_dir)
    else:
        os.environ.pop(trace.PROFILE_DIR_ENV, None)
    direction = f"torch_prof_{uuid.uuid4().hex[:8]}"
    source = Synthetic(direction, width=128, height=96, fps=30, scene="zed")
    source_thread = threading.Thread(target=source.run_event_loop)
    source_thread.start()
    try:
        _run_module_briefly(direction)
    finally:
        source.quit_flag.set()
        source_thread.join(timeout=10)
    path = trace.stop_device_profile()
    if not enabled:
        assert path is None and not profile_dir.exists()
        return
    assert path is not None and sorted(profile_dir.iterdir()) == [Path(path)]
    events = json.loads(Path(path).read_text())["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    # the module loop's thread ran the chain's torch ops on the CPU
    assert len(ops) > 5 and any(name.startswith("aten::") for name in ops), sorted(ops)[:20]
    assert tshm.red_buoy_results.area.get() > 0
    assert trace.stop_device_profile() is None

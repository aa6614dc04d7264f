"""The port's module path on the CPU: the real synthetic source and the real
BuoyLAB module over the real frame bus (in-process threads, --device cpu);
wire-format compatibility of tuner blocks and shm groups with the JAX
package; and the port's independence from JAX.

Results go to a uniquely named shm group, never the shared
``red_buoy_results`` (other tests write it from other workers), and only
blocks this file created are removed."""

import ast
import os
import subprocess
import sys
import threading
import time
import types
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_cpu_pool import CHILD_ENV  # and torch's CPU pool at one thread

from cuauv_vision_pipeline_tpu.core import shm as jshm
from cuauv_vision_pipeline_tpu.core.base import ModuleManager as JModuleManager
from cuauv_vision_pipeline_tpu.core.tuners import IntTuner as JIntTuner
from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import Synthetic
from cuauv_vision_pipeline_tpu_torch.core import shm as tshm
from cuauv_vision_pipeline_tpu_torch.core.base import ModuleReader, device_fn
from cuauv_vision_pipeline_tpu_torch.core.log import log
from cuauv_vision_pipeline_tpu_torch.engine.chains import red_buoy_fused
from cuauv_vision_pipeline_tpu_torch.modules import red_buoy

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "cuauv_vision_pipeline_tpu_torch"


@pytest.fixture
def private_results(monkeypatch):
    """Point the red_buoy module at a uniquely named results group."""
    name = f"test_red_buoy_{uuid.uuid4().hex[:12]}"
    group = tshm.define_group(name, tshm.DEFAULT_GROUPS["red_buoy_results"])
    monkeypatch.setattr(red_buoy, "shm", types.SimpleNamespace(red_buoy_results=group))
    yield name, group
    tshm.delete_group(name)


def _drive(source, module, delivered) -> None:
    """Run ``source`` and ``module`` in threads until three detections are
    delivered (or 30 s pass), then stop both."""
    src_thread = threading.Thread(target=source.run_event_loop)
    src_thread.start()
    time.sleep(0.3)
    quit_flag = threading.Event()
    try:
        with module._module_manager:
            loop = threading.Thread(target=module._loop, args=(quit_flag, log.t))
            loop.start()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and len(delivered) < 3:
                time.sleep(0.05)
            quit_flag.set()
            loop.join(timeout=10)
            assert not loop.is_alive()
    finally:
        source.quit_flag.set()
        src_thread.join(timeout=10)


def _check_delivered(delivered, results) -> None:
    """The default tuners (0-255) take the whole frame; each detection that
    carries posts (a batched dispatch posts its newest lane only) equals the
    chain on its frame."""
    assert len(delivered) >= 3, "module never delivered detections"
    assert results.visible.get()
    assert results.area.get() == 144 * 256
    assert all(best["area"] == 144 * 256 for best, _ in delivered)
    posted = [(best, posts) for best, posts in delivered if posts]
    assert posted, "no detection carried posts"
    for best, posts in posted:
        frame = torch.from_numpy(np.array(posts["image"]))
        want_t, want_c, want = red_buoy_fused(frame, 0, 255)
        np.testing.assert_array_equal(posts["threshed"], want_t.numpy())
        np.testing.assert_array_equal(posts["threshed_cleaned"], want_c.numpy())
        for key in want:
            np.testing.assert_array_equal(best[key], want[key].numpy(), err_msg=key)


def test_red_buoy_module_product_path(unique_direction, private_results):
    """Port synthetic source -> bus -> port BuoyLAB (device chain on the
    CPU) -> shm; each delivered detection equals the chain on its frame."""
    _, results = private_results
    source = Synthetic(unique_direction, width=256, height=144, fps=60)
    delivered = []

    class Buoy(red_buoy.BuoyLAB):
        # the synthetic buoy scene sends one unnamed plane, addressed by the
        # direction name (the zed scene sends named planes)
        @device_fn(unique_direction)
        def buoy_chain(self, image, *, tuners, want_posts):
            return red_buoy.BuoyLAB.buoy_chain(
                self, image, tuners=tuners, want_posts=want_posts
            )

        def on_device_result(self, best, posts, meta):
            delivered.append((best, posts))
            super().on_device_result(best, posts, meta)

    module = Buoy([unique_direction], red_buoy.module_tuners, fps=30,
                  argv=["--device", "cpu"])
    assert module.device == torch.device("cpu")
    _drive(source, module, delivered)
    _check_delivered(delivered, results)


def test_red_buoy_module_on_zed_planes_of_any_direction(unique_direction, private_results):
    """The unmodified module's ``zed[forward]`` chain binds the forward plane
    of a zed-scene camera whatever its direction is named, so a run can use
    a direction of its own (as chip_smoke.py does)."""
    _, results = private_results
    source = Synthetic(unique_direction, width=256, height=144, fps=60, scene="zed")
    delivered = []

    class Buoy(red_buoy.BuoyLAB):
        def on_device_result(self, best, posts, meta):
            delivered.append((best, posts))
            super().on_device_result(best, posts, meta)

    module = Buoy([unique_direction], red_buoy.module_tuners, fps=30,
                  argv=["--device", "cpu"])
    _drive(source, module, delivered)
    _check_delivered(delivered, results)


def test_module_refuses_to_start_without_cuda(monkeypatch, private_results):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        red_buoy.BuoyLAB(["zed"], red_buoy.module_tuners, argv=[])


def test_tuner_written_by_port_reader_decodes_in_jax():
    """Same tuner block bytes: a JAX module's tuner, edited from the port's
    ModuleReader, reads back through the JAX tuner decoder."""
    name = f"TunerProbe-on-{uuid.uuid4().hex[:10]}"
    manager = JModuleManager(name, [], [JIntTuner("thresh_min", 0, 0, 255)])
    with manager:
        reader = ModuleReader(name)
        reader.run_forever(fps=100)
        try:
            reader.update_tuner_value("thresh_min", 140)
        finally:
            reader.unblock()
        manager.read_messages()
        assert manager["thresh_min"] == 140


def test_shm_group_bytes_shared_with_jax():
    name = f"test_group_{uuid.uuid4().hex[:12]}"
    group = tshm.define_group(name, tshm.DEFAULT_GROUPS["red_buoy_results"])
    try:
        group.set(visible=True, area=23450.0, center_x=-0.25, latency_ms=3.5)
        got = jshm.group(name).get()
        assert got.visible is True and got.area == 23450.0
        assert got.center_x == -0.25 and got.latency_ms == 3.5
    finally:
        tshm.delete_group(name)
        jshm.delete_group(name)


def test_shm_namespace_keeps_groups_apart(monkeypatch):
    """``CUAUV_SHM_NAMESPACE`` gives a run its own group file, laid out as
    the shared one: the JAX reader decodes it under the suffixed name."""
    name = f"test_group_{uuid.uuid4().hex[:12]}"
    namespace = uuid.uuid4().hex[:8]
    shared = tshm.define_group(name, tshm.DEFAULT_GROUPS["red_buoy_results"])
    monkeypatch.setenv(tshm.NAMESPACE_ENV, namespace)
    own = tshm.define_group(name, tshm.DEFAULT_GROUPS["red_buoy_results"])
    try:
        assert own is not shared
        assert Path(tshm.group_path(name)).name == f"auv_shm_{name}@{namespace}"
        shared.set(visible=False, area=1.0)
        own.set(visible=True, area=23450.0, latency_ms=3.5)
        assert shared.area.get() == 1.0 and not shared.visible.get()
        got = jshm.group(f"{name}@{namespace}").get()
        assert got.visible is True and got.area == 23450.0 and got.latency_ms == 3.5
    finally:
        jshm.delete_group(f"{name}@{namespace}")
        tshm.delete_group(name)
        monkeypatch.delenv(tshm.NAMESPACE_ENV)
        tshm.delete_group(name)
    assert not Path(tshm.group_path(name)).exists()


def test_port_imports_no_jax_in_a_fresh_process():
    modules = sorted(
        "cuauv_vision_pipeline_tpu_torch."
        + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'cuauv_vision_pipeline_tpu'"
        " or m.startswith('cuauv_vision_pipeline_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(REPO), **CHILD_ENV},
    )
    assert proc.returncode == 0, proc.stderr


def test_no_port_source_names_jax_in_an_import():
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "cuauv_vision_pipeline_tpu"), (
                    f"{path}: imports {n}"
                )

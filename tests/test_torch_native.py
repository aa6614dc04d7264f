"""The port's native capture binaries against the JAX package's, on the CPU.

* ``stubcheck``: the SDK-gated ``zed_capture`` and ``flir_capture`` sources
  compile and link (g++ alone, no make) against the inert headers of the
  port's ``test_stubs/``.
* ``framebus_test`` (the bus's own C++ tests) passes, in a /dev/shm of its
  own: its blocks (``nativetest_*``) are the ones the JAX package's
  ``make test`` (``tests/test_frame_bus.py``) writes on another worker.
* ``flir_capture_stub --parse-only`` on the port's ``configs/flir.conf``
  prints what the JAX package's binary prints on its own.
* The carried-over sources, headers, stubs and configs equal the JAX
  package's, comments aside (the port's comments name its own build
  command).

The zed stub's capture loop writes the fixed direction ``zed``, which the
JAX package's stub test uses too, so no test here runs it;
``chip_smoke.py``'s ``native`` phase does, in its turn on the machine.
"""

import re
import subprocess
from pathlib import Path

import pytest
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch import native
from test_torch_private_shm import namespace_prefix

REPO = Path(__file__).resolve().parents[1]
JAX_NATIVE = REPO / "cuauv_vision_pipeline_tpu" / "native"
PORT_NATIVE = REPO / "cuauv_vision_pipeline_tpu_torch" / "native"
CARRIED = ["src/zed_capture.cpp", "src/flir_capture.cpp", "src/framebus_test.cpp",
           "include/capture_harness.hpp", "include/shm_store.hpp",
           "test_stubs/zed/sl/Camera.hpp", "test_stubs/spinnaker/Spinnaker.h",
           "test_stubs/spinnaker/SpinGenApi/SpinnakerGenApi.h"]


def strip_comments(text: str) -> str:
    """C++ source without // and /* */ comments (none sits in a string of
    these files) and without trailing blanks."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    return "\n".join(line.rstrip() for line in text.splitlines())


def test_stubcheck_builds_with_gpp_alone():
    for name in native.STUBCHECK:
        path = native.build_binary(name)
        assert path.exists() and path.parent == PORT_NATIVE / "build"


def test_framebus_test_passes():
    proc = subprocess.run([*namespace_prefix(), str(native.build_binary("framebus_test"))],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all native tests passed" in proc.stdout


def test_flir_stub_parse_only_prints_what_jax_prints(tmp_path):
    # the JAX binary as its Makefile's target builds it, into this test's
    # own directory (the JAX tests build theirs in the package)
    jax_stub = tmp_path / "flir_capture_stub"
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-o", str(jax_stub),
                    str(JAX_NATIVE / "src" / "flir_capture.cpp")], check=True, capture_output=True, timeout=300)
    jax_conf = REPO / "cuauv_vision_pipeline_tpu" / "configs" / "flir.conf"
    port_conf = REPO / "cuauv_vision_pipeline_tpu_torch" / "configs" / "flir.conf"
    want = subprocess.run([str(jax_stub), "--parse-only", str(jax_conf)],
                          capture_output=True, text=True, timeout=30)
    got = subprocess.run([str(native.build_binary("flir_capture_stub")), "--parse-only", str(port_conf)],
                         capture_output=True, text=True, timeout=30)
    assert got.returncode == want.returncode == 0, got.stderr
    assert got.stdout == want.stdout and "serial=" in got.stdout


def test_sdk_targets_need_their_sdk(monkeypatch):
    monkeypatch.delenv("ZED_SDK_ROOT", raising=False)
    monkeypatch.delenv("SPINNAKER_ROOT", raising=False)
    assert "zed_capture" not in native.buildable() and "flir_capture" not in native.buildable()
    with pytest.raises(RuntimeError, match="ZED_SDK_ROOT"):
        native.build_binary("zed_capture")


@pytest.mark.parametrize("name", CARRIED)
def test_carried_over_source_equals_jax(name):
    ours, theirs = (PORT_NATIVE / name).read_text(), (JAX_NATIVE / name).read_text()
    assert strip_comments(ours) == strip_comments(theirs)


@pytest.mark.parametrize("name", ["flir.conf", "example_camera_matrix_params.yaml"])
def test_configs_equal_jax(name):
    ours = (REPO / "cuauv_vision_pipeline_tpu_torch" / "configs" / name).read_bytes()
    assert ours == (REPO / "cuauv_vision_pipeline_tpu" / "configs" / name).read_bytes()

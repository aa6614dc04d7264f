"""Native (C++) components: the shared-memory frame bus and the capture
binaries.

``libframebus.so`` is the host-side lock-free frame bus (see
include/framebus.hpp for the design). Its sources are byte-for-byte those of
the JAX package, so the bus wire format is shared and a capture source of one
package feeds a module of the other. It is built at first use by one direct
``g++`` call into ``native/build/`` (git-ignored), under a file lock so that
processes started together build it once.

The capture binaries are the JAX package's too (``src/zed_capture.cpp``,
``src/flir_capture.cpp``, ``src/framebus_test.cpp``, ``include/
capture_harness.hpp``, ``include/shm_store.hpp``, ``test_stubs/``; equal to
its sources but for comments). :func:`build_binary` builds each with one
``g++`` call, as the JAX package's ``native/Makefile`` targets do:

* ``zed_capture`` / ``flir_capture``: the vehicle's sources, only with
  ``ZED_SDK_ROOT`` / ``SPINNAKER_ROOT`` set (the vendor SDKs);
* ``flir_capture_stub``: the SDK-less flir binary (``--parse-only CONF``);
* ``zed_capture_stubcheck`` / ``flir_capture_stubcheck`` (``stubcheck``):
  the SDK-gated sources compiled and linked against the inert headers of
  ``test_stubs/``, whose cameras make deterministic frames;
* ``framebus_test``: the bus's own C++ tests (``test`` builds and runs it).

    python -m cuauv_vision_pipeline_tpu_torch.native [all|stubcheck|test|TARGET ...]
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_NATIVE_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _NATIVE_DIR / "build"
_LIB_PATH = _BUILD_DIR / "libframebus.so"
_SOURCES = ("framebus.cpp", "framebus_c.cpp", "imgeom.cpp")
_CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")
_INCLUDE = f"-I{_NATIVE_DIR / 'include'}"
_ZED_STUB = _NATIVE_DIR / "test_stubs" / "zed"
_SPIN_STUB = _NATIVE_DIR / "test_stubs" / "spinnaker"

# target -> (sources under src/, flags, the SDK root's environment variable
# or None); flags may name the SDK root as {root}
BINARIES: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...], Optional[str]]] = {
    "zed_capture": (("zed_capture.cpp", "framebus.cpp"),
                    (_INCLUDE, "-DHAVE_ZED_SDK", "-I{root}/include", "-L{root}/lib", "-lsl_zed"), "ZED_SDK_ROOT"),
    "flir_capture": (("flir_capture.cpp", "framebus.cpp"),
                     (_INCLUDE, "-DHAVE_SPINNAKER", "-I{root}/include", "-L{root}/lib", "-lSpinnaker"),
                     "SPINNAKER_ROOT"),
    "flir_capture_stub": (("flir_capture.cpp",), (), None),
    "framebus_test": (("framebus_test.cpp", "framebus.cpp"), (_INCLUDE,), None),
    "zed_capture_stubcheck": (("zed_capture.cpp", "framebus.cpp"),
                              (_INCLUDE, "-DHAVE_ZED_SDK", f"-I{_ZED_STUB}"), None),
    "flir_capture_stubcheck": (("flir_capture.cpp", "framebus.cpp"),
                               (_INCLUDE, "-DHAVE_SPINNAKER", f"-I{_SPIN_STUB}"), None),
}
STUBCHECK = ("zed_capture_stubcheck", "flir_capture_stubcheck")


def _is_stale(target: Path, inputs: List[Path]) -> bool:
    try:
        mtime = target.stat().st_mtime
    except FileNotFoundError:
        return True
    return any(p.stat().st_mtime > mtime for p in inputs)


def _compile(target: Path, args: List[str], what: str) -> None:
    """One g++ call writing ``target`` atomically."""
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", str(tmp), *args]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {what} failed:\n{proc.stderr}")
    os.replace(tmp, target)


def _locked_build(target: Path, inputs: List[Path], args: List[str], rebuild: bool) -> Path:
    if rebuild or _is_stale(target, inputs):
        _BUILD_DIR.mkdir(exist_ok=True)
        # one lock per target: processes started together build it once,
        # and different targets build side by side
        with open(_BUILD_DIR / f".{target.name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if rebuild or _is_stale(target, inputs):
                _compile(target, args, target.name)
    return target


def library_path(rebuild: bool = False) -> str:
    """Path to libframebus.so, built on demand (cached in native/build/)."""
    sources = [_NATIVE_DIR / "src" / s for s in _SOURCES]
    inputs = sources + sorted((_NATIVE_DIR / "include").glob("*.hpp"))
    return str(_locked_build(_LIB_PATH, inputs, ["-shared", _INCLUDE, *map(str, sources)], rebuild))


def buildable() -> List[str]:
    """The binaries this machine can build: every stub target, and each SDK
    target whose SDK root is set."""
    return [name for name, (_, _, env) in BINARIES.items() if env is None or os.environ.get(env)]


def build_binary(name: str, rebuild: bool = False) -> Path:
    """Build one capture binary (a :data:`BINARIES` target) into
    ``native/build/`` (cached; rebuilt when a source is newer) and return
    its path. An SDK target without its SDK root set raises."""
    sources, flags, env = BINARIES[name]
    root = os.environ.get(env) if env else None
    if env and not root:
        raise RuntimeError(f"{name} needs the vendor SDK: set {env}")
    paths = [_NATIVE_DIR / "src" / s for s in sources]
    inputs = paths + sorted((_NATIVE_DIR / "include").glob("*.hpp")) + sorted(
        p for p in (_NATIVE_DIR / "test_stubs").rglob("*") if p.is_file())
    # the sources come before the libraries they link
    args = [f for f in flags if not f.startswith(("-L", "-l"))] + [str(p) for p in paths] + [
        f for f in flags if f.startswith(("-L", "-l"))]
    return _locked_build(_BUILD_DIR / name, inputs, [a.format(root=root) for a in args], rebuild)


def run_test() -> subprocess.CompletedProcess:
    """Build and run ``framebus_test`` (the bus's C++ tests)."""
    return subprocess.run([str(build_binary("framebus_test"))], capture_output=True, text=True, timeout=120)


def main(argv: Optional[List[str]] = None) -> int:
    targets = list(sys.argv[1:] if argv is None else argv)
    if not targets:
        print(library_path(rebuild=True))
        return 0
    for target in targets:
        if target == "all":
            print(library_path())
            for name in buildable():
                print(build_binary(name))
        elif target == "stubcheck":
            for name in STUBCHECK:
                print(build_binary(name))
        elif target == "test":
            proc = run_test()
            print(proc.stdout, end="")
            if proc.returncode:
                print(proc.stderr, end="", file=sys.stderr)
                return proc.returncode
        else:
            print(build_binary(target))
    return 0

"""Native (C++) components: the shared-memory frame bus.

``libframebus.so`` is the host-side lock-free frame bus (see
include/framebus.hpp for the design). Its sources are byte-for-byte those of
the JAX package, so the bus wire format is shared and a capture source of one
package feeds a module of the other. It is built at first use by one direct
``g++`` call into ``native/build/`` (git-ignored), under a file lock so that
processes started together build it once.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _NATIVE_DIR / "build"
_LIB_PATH = _BUILD_DIR / "libframebus.so"
_SOURCES = ("framebus.cpp", "framebus_c.cpp", "imgeom.cpp")


def _inputs() -> list:
    return [_NATIVE_DIR / "src" / s for s in _SOURCES] + sorted(
        (_NATIVE_DIR / "include").glob("*.hpp")
    )


def _is_stale() -> bool:
    try:
        lib_mtime = _LIB_PATH.stat().st_mtime
    except FileNotFoundError:
        return True
    return any(p.stat().st_mtime > lib_mtime for p in _inputs())


def build() -> None:
    """Compile libframebus.so (one g++ call; written atomically)."""
    tmp = _BUILD_DIR / f"libframebus.so.{os.getpid()}.tmp"
    cmd = [
        os.environ.get("CXX", "g++"), "-O2", "-std=c++17", "-fPIC", "-shared",
        "-pthread", f"-I{_NATIVE_DIR / 'include'}", "-o", str(tmp),
        *(str(_NATIVE_DIR / "src" / s) for s in _SOURCES),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building libframebus.so failed:\n{proc.stderr}")
    os.replace(tmp, _LIB_PATH)


def library_path(rebuild: bool = False) -> str:
    """Path to libframebus.so, built on demand (cached in native/build/)."""
    if rebuild or _is_stale():
        _BUILD_DIR.mkdir(exist_ok=True)
        with open(_BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if rebuild or _is_stale():
                build()
    return str(_LIB_PATH)


if __name__ == "__main__":
    print(library_path(rebuild=True))

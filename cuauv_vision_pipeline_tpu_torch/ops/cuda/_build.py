"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ctypes (no
PyTorch headers, so a build takes seconds). Libraries land in the package's
git-ignored ``build/`` directory, named by a hash of the source and flags, so
an edited source rebuilds and an unchanged one is reused. A file lock
serialises builders: a module process and ``chip_smoke.py`` may both trigger
the first build. All missing libraries are built together, one ``nvcc`` per
source, started at once.

The CCL and morphology kernels are integer-only, so ``--fmad`` does not
change their results. A float kernel that must match its plain version bit
for bit gets ``--fmad=false`` in ``EXTRA_FLAGS`` (``nms.cu``: without it nvcc
contracts ProbIoU's products into FMAs and an IoU near the threshold can flip
a pick). A source's extra flags enter its library's hash; a source without
any hashes as before.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# per-source nvcc flags after NVCC_FLAGS
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {"nms": ("--fmad=false",)}

_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def flags(name: str) -> Tuple[str, ...]:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    if name in EXTRA_FLAGS:
        digest.update(" ".join(EXTRA_FLAGS[name]).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[List[str]] = None) -> float:
    """Compile every missing library among ``names`` (default: all), in
    parallel; returns the wall seconds spent. ptxas' register and
    shared-memory report for each lands beside it as ``.log``."""
    names = kernel_names() if names is None else names
    t0 = time.monotonic()
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return time.monotonic() - t0
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            out = library_path(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
                out,
            )
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.monotonic() - t0


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built first if needed, with
    ``restype``/``argtypes`` set from ``{fn: (restype, argtypes)}``."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib


def check_tensor(name: str, t, dtype, shape: Tuple[int, ...], device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's C entry point takes as a bare pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(lib: ctypes.CDLL, prefix: str, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

#!/usr/bin/env python3
"""Hot-reload module runner (the reference's auv-vision-runner).

Parity target: reference runner.sh:66-92 — run a module, watch its source
file for modifications, restart on edit. The bash original shells out to
inotifywait; this version watches mtimes directly (inotify without the
external binary) and restarts the module's process group.

Port of ``cuauv_vision_pipeline_tpu.misc.runner``: a module name runs as
``python -m cuauv_vision_pipeline_tpu_torch.modules.<name>``.

    python -m cuauv_vision_pipeline_tpu_torch.misc.runner red_buoy zed
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from pathlib import Path


def _module_file(module: str) -> Path:
    if module.endswith(".py") and os.path.exists(module):
        return Path(module)
    pkg_dir = Path(__file__).resolve().parent.parent / "modules"
    return pkg_dir / f"{module.removesuffix('.py')}.py"


def _spawn(module: str, args) -> subprocess.Popen:
    path = _module_file(module)
    if path.exists() and "cuauv_vision_pipeline_tpu_torch" in str(path):
        argv = [
            sys.executable,
            "-m",
            f"cuauv_vision_pipeline_tpu_torch.modules.{path.stem}",
            *args,
        ]
    else:
        argv = [sys.executable, str(path), *args]
    return subprocess.Popen(argv, preexec_fn=os.setsid)


def _stop(proc: subprocess.Popen) -> None:
    try:
        pgid = os.getpgid(proc.pid)
        os.killpg(pgid, signal.SIGINT)
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            os.killpg(pgid, signal.SIGKILL)
            proc.wait(timeout=2)
    except ProcessLookupError:
        pass


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="run a vision module, restarting it when its source changes"
    )
    parser.add_argument("module", help="module name (e.g. red_buoy) or path")
    parser.add_argument("args", nargs="*", help="arguments passed to the module")
    parser.add_argument("--poll", type=float, default=0.5, help="mtime poll (s)")
    ns = parser.parse_args(argv)

    path = _module_file(ns.module)
    if not path.exists():
        print(f"module file not found: {path}", file=sys.stderr)
        sys.exit(1)

    print(f"[runner] watching {path}")
    proc = _spawn(ns.module, ns.args)
    last_mtime = path.stat().st_mtime
    try:
        while True:
            time.sleep(ns.poll)
            if proc.poll() is not None:
                print(f"[runner] module exited rc={proc.returncode}; waiting for edit")
            mtime = path.stat().st_mtime
            if mtime != last_mtime:
                last_mtime = mtime
                print("[runner] source changed; restarting")
                _stop(proc)
                proc = _spawn(ns.module, ns.args)
    except KeyboardInterrupt:
        _stop(proc)


if __name__ == "__main__":
    main()

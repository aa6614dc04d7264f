"""Quickstart: the whole pipeline in one script.

The twin of the repo's ``examples/quickstart.py`` on the port: launches a
synthetic ZED-layout camera, the red_buoy detection module (on ``cuda:0``
unless ``--device cpu``) and the web viewer as separate OS processes (the
production topology), tunes the threshold live, prints detections, then
shuts everything down:

    python -m cuauv_vision_pipeline_tpu_torch.examples.quickstart [--seconds 30] [--port 8080]
    python -m cuauv_vision_pipeline_tpu_torch.examples.quickstart --device cpu --width 480 --height 270

Open http://localhost:<port> while it runs to watch the debug posts.
"""

from __future__ import annotations

import argparse
import signal
import subprocess
import sys
import time
from typing import List, Optional

PACKAGE = "cuauv_vision_pipeline_tpu_torch"


def spawn(module: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", f"{PACKAGE}.{module}", *args])


def main(argv: Optional[List[str]] = None) -> int:
    from ..core import shm
    from ..core.base import ModuleReader

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--device", default=None, help="the module's device: N (default 0) or cpu")
    args = parser.parse_args(argv)

    module_args = ["zed"] + (["--device", args.device] if args.device else [])
    procs = [
        spawn("capture_sources.synthetic", "zed", "--scene", "zed", "--fps", "10",
              "--width", str(args.width), "--height", str(args.height)),
        spawn("modules.red_buoy", *module_args),
        spawn("misc.web_viewer", "--port", str(args.port)),
    ]
    print(f"pipeline up; GUI at http://localhost:{args.port}")
    try:
        tuned = False
        deadline = time.monotonic() + args.seconds
        while time.monotonic() < deadline:
            time.sleep(2)
            results = shm.red_buoy_results.get()
            print(f"red_buoy: visible={results.visible} area={results.area:.0f} "
                  f"center=({results.center_x:+.3f}, {results.center_y:+.3f})")
            if not tuned and results.visible:
                # live-tune the threshold so only the red disc passes
                reader = None
                try:
                    reader = ModuleReader("BuoyLAB-on-zed")
                    reader.run_forever()
                    reader.update_tuner_value("thresh_min", 140)
                    tuned = True
                    print(">> tuned thresh_min=140 (isolating the buoy)")
                except (RuntimeError, KeyError) as e:
                    # a stale visible=True from an earlier run can come
                    # before this module's blocks exist: say so, try again
                    print(f">> tuner attempt failed ({e!r}); will retry")
                finally:
                    if reader is not None and reader._thread is not None:
                        reader.unblock()
    finally:
        for proc in procs:
            proc.send_signal(signal.SIGINT)
        for proc in procs:
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        print("clean shutdown")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

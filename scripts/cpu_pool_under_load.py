#!/usr/bin/env python3
"""Time the red_buoy chain on the CPU at torch's default thread pool and at
one thread, beside busy processes pinned one per core.

A module started on the CPU runs torch's intra-op pool at one thread per
core. When other processes keep every core busy, each small op of the
chain waits at its thread barrier for threads that are not scheduled; one
thread does not wait. This shows the gap on the test-sized frame:

    python scripts/cpu_pool_under_load.py [--height 144 --width 256 --calls 3]

Each setting runs in a fresh process (the pool's size is fixed at its first
parallel op). Prints one JSON line per setting: ms per chain call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
_TIMED = r"""
import json, sys, time, torch
from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
from cuauv_vision_pipeline_tpu_torch.engine.chains import red_buoy_fused
threads, height, width, calls = map(int, sys.argv[1:5])
if threads:
    torch.set_num_threads(threads)
image = torch.from_numpy(buoy_frame((height, width), 0.0))
ms = []
for _ in range(calls):
    t0 = time.perf_counter()
    red_buoy_fused(image, 0, 255)  # the default tuners: the whole frame
    ms.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"threads": torch.get_num_threads(), "ms_per_call": ms}))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--height", type=int, default=144)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--timeout", type=float, default=300.0, help="seconds per setting")
    args = parser.parse_args()
    cores = sorted(os.sched_getaffinity(0))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    busy = [subprocess.Popen(["taskset", "-c", str(core), sys.executable, "-c", "while True: pass"])
            for core in cores]
    try:
        for threads in (0, 1):  # 0: torch's default pool
            proc = subprocess.run([sys.executable, "-c", _TIMED, str(threads), str(args.height), str(args.width),
                                   str(args.calls)], cwd=REPO, env=env, capture_output=True, text=True,
                                  timeout=args.timeout)
            if proc.returncode != 0:
                print(proc.stderr[-2000:], file=sys.stderr)
                return 1
            result = json.loads(proc.stdout.splitlines()[-1])
            print(json.dumps({**result, "busy_processes": len(busy), "cores": len(cores)}), flush=True)
    finally:
        for p in busy:
            p.kill()
            p.wait()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

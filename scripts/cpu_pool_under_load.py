#!/usr/bin/env python3
"""Time work on the CPU beside busy processes pinned one per core.

A module started on the CPU runs torch's intra-op pool at one thread per
core. When other processes keep the cores busy, each small op waits at its
thread barrier for threads that are not scheduled; one thread does not
wait. Three modes:

* The red_buoy chain on the test-sized frame at torch's default pool and
  at one thread, beside a busy loop on every core (default), or on the
  first ``--busy N`` cores:

      python scripts/cpu_pool_under_load.py [--height 144 --width 256 --calls 3]

  Each setting runs in a fresh process (the pool's size is fixed at its
  first parallel op). Prints one JSON line per setting: ms per chain call.

* Any command beside ``--busy N`` loops (the tier-1 pytest command, for a
  load anyone can repeat), run in ``--cwd`` (default: the repo):

      python scripts/cpu_pool_under_load.py --busy 4 -- bash -c "python -m pytest tests/ ..."

  Prints one JSON line: the command's exit code and its seconds. ``--busy
  0`` times it on an idle machine. Exits with the command's code.

* Seconds per test file from pytest ``--junitxml`` files, summed over each
  file's tests (setup and teardown included), port files
  (``tests/test_torch_*.py``) first, then the JAX files; one column per file:

      python scripts/cpu_pool_under_load.py --junit parent.xml change.xml
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List

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


def start_busy(cores: List[int]) -> List[subprocess.Popen]:
    return [subprocess.Popen(["taskset", "-c", str(core), sys.executable, "-c", "while True: pass"])
            for core in cores]


def chain(args, cores: List[int]) -> int:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for threads in (0, 1):  # 0: torch's default pool
        proc = subprocess.run([sys.executable, "-c", _TIMED, str(threads), str(args.height), str(args.width),
                               str(args.calls)], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=args.timeout)
        if proc.returncode != 0:
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        result = json.loads(proc.stdout.splitlines()[-1])
        print(json.dumps({**result, "busy_processes": len(cores), "cores": len(os.sched_getaffinity(0))}),
              flush=True)
    return 0


def command(args, cores: List[int]) -> int:
    t0 = time.monotonic()
    rc = subprocess.run(args.command, cwd=args.cwd).returncode
    seconds = time.monotonic() - t0
    print(json.dumps({"rc": rc, "seconds": seconds, "busy_cores": cores,
                      "cores": len(os.sched_getaffinity(0)), "cwd": str(args.cwd)}), flush=True)
    return rc


def file_seconds(path: Path) -> Dict[str, float]:
    """Test file -> seconds summed over its test cases in a junit XML."""
    out: Dict[str, float] = collections.defaultdict(float)
    for case in ET.parse(path).iter("testcase"):
        parts = case.get("classname", "").split(".")
        mods = [i for i, p in enumerate(parts) if p.startswith("test_")]
        name = "/".join(parts[:mods[0] + 1]) + ".py" if mods else (case.get("classname") or "(collection)")
        out[name] += float(case.get("time") or 0.0)
    return out


def junit_table(paths: List[Path]) -> int:
    tables = [file_seconds(p) for p in paths]
    files = sorted(set().union(*tables))
    header = "| file | " + " | ".join(p.name for p in paths) + " |"
    print(header + "\n|---|" + "---|" * len(paths))
    for port in (True, False):
        group = [f for f in files if Path(f).name.startswith("test_torch_") == port]
        for f in sorted(group, key=lambda f: -tables[0].get(f, 0.0)):
            print(f"| {f} | " + " | ".join(f"{t[f]:.3f}" if f in t else "-" for t in tables) + " |")
        label = "port files (tests/test_torch_*.py)" if port else "JAX files"
        print(f"| **sum, {label}** | " + " | ".join(f"{sum(t.get(f, 0.0) for f in group):.3f}"
                                                    for t in tables) + " |")
    print("| **sum, all** | " + " | ".join(f"{sum(t.values()):.3f}" for t in tables) + " |")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--height", type=int, default=144)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--timeout", type=float, default=300.0, help="seconds per chain setting")
    parser.add_argument("--busy", type=int, default=None,
                        help="busy loops, pinned to the first N cores (default: every core)")
    parser.add_argument("--cwd", type=Path, default=REPO, help="where the command runs")
    parser.add_argument("--junit", type=Path, nargs="+", help="tabulate seconds per test file of these XMLs")
    parser.add_argument("command", nargs=argparse.REMAINDER, help="-- COMMAND to time beside the loops")
    args = parser.parse_args()
    if args.junit:
        return junit_table(args.junit)
    if args.command[:1] == ["--"]:
        args.command = args.command[1:]
    affinity = sorted(os.sched_getaffinity(0))
    cores = affinity[:len(affinity) if args.busy is None else args.busy]
    busy = start_busy(cores)
    try:
        return command(args, cores) if args.command else chain(args, cores)
    finally:
        for p in busy:
            p.kill()
            p.wait()


if __name__ == "__main__":
    raise SystemExit(main())

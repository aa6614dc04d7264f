#!/usr/bin/env python3
"""Read the two ends of each compared number of a cell over many seeds, in
one process: the program as the cell runs it (the lower reading) and the
control (the upper one), each through the same window and check.

    python3 benchmark/control.py --workload red_buoy_1080p.stream --seeds 1,2,3 --seconds 3

The control is the adapter's ``control_wrap``: the reference computed in
the precision below the configuration's, put in the chain's place. Prints one JSON line per
seed and side, and the largest sound and least control reading of each
number; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

import harness

EVERY = "[bench] every number of the comparison: "


def readings(workload, seeds, seconds, device, out=print):
    bench = harness.load_json(harness.REPO / "BENCHMARK.json")
    cell, cfg, *_ = harness.find_cell(bench, workload)
    adapter = harness.load_file(harness.BENCH / "systems" / f"{cfg['system']}.py")
    reference = harness.load_file(harness.BENCH / "configs" / f"{cfg['reference']}.py")
    wrap = adapter.control_wrap(cfg, reference)
    sides = {"sound": [], "control": []}
    for seed in seeds:
        for side, kw in (("sound", {}), ("control", {"wrap_chain": wrap})):
            lines = []
            r = harness.run_cell(workload, seed, seconds, False, device, time.monotonic(), bench=bench,
                                 log=lines.append, **kw)
            every = next(x for x in lines if x.startswith(EVERY))
            nums = json.loads(every[len(EVERY):])
            sides[side].append(nums)
            out(json.dumps({"workload": workload, "seed": seed, "side": side, "correct": r["correct"],
                            "frames": r["attempted"], "numbers": nums}))
    keys = sides["sound"][0]
    summary = {"workload": workload, "seeds": len(seeds),
               "lower": {k: max(s[k] for s in sides["sound"]) for k in keys},
               "upper": {k: min(s[k] for s in sides["control"]) for k in keys}}
    out(json.dumps(summary))
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())

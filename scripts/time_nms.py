#!/usr/bin/env python3
"""Time a checkout's ``nms_fixed`` kernel on the YOLO path's pool and the
timing shapes of ``tests/nms_cases.py`` (card).

The serving pool is what decode hands the kernel for one 1080p ZED frame of
the synthetic camera: YOLOv8n-obb, 15 classes, 640, bf16, seeded random
init (as ``chip_smoke.py``'s YOLO phase), 512 candidates, ProbIoU. The other
pools come from this script's own tree, so two checkouts get the same
inputs. Prints one JSON line: the checkout, the card, and per pool its
shape, the picks' equality with the checkout's plain version (or the error
of a launch the checkout's kernel refuses), the device ms
per recorded launch (torch.profiler over 100 calls; a trace may drop
launches) and the event-timed ms (median of 100 calls).

Two checkouts are compared on one card by running each in its own process,
in turn (a, b, b, a), on one machine in one run:

    python3 scripts/time_nms.py [--root CHECKOUT]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

TREE = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(TREE), help="checkout whose package is timed (default: this one)")
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    sys.path.insert(1, str(TREE / "tests"))
    import numpy as np
    import torch
    from nms_cases import timing_pools
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
    from cuauv_vision_pipeline_tpu_torch.models.yolo import decode as decode_mod
    from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
    from cuauv_vision_pipeline_tpu_torch.ops.cuda.nms_kernel import nms_fixed_cuda, nms_fixed_plain

    if not torch.cuda.is_available():
        print("time_nms: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    serve = YoloModel(None, task="obb", device=dev)
    pools = []
    real = decode_mod.nms_fixed_cuda
    decode_mod.nms_fixed_cuda = lambda *a: pools.append(a) or real(*a)
    try:
        serve.device_decode(torch.from_numpy(buoy_frame((1080, 1920), 0.0)).to(dev))
    finally:
        decode_mod.nms_fixed_cuda = real
    inputs = {"serving_frame_b1_p512_probiou": pools[0]}
    for name, arrays in timing_pools().items():
        inputs[name] = tuple(torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a for a in arrays)

    out = {}
    for name, pool in inputs.items():
        boxes, scores, classes, angles, iou, max_det = pool
        want = nms_fixed_plain(boxes, scores, classes, iou, max_det, True, angles)
        try:
            got = nms_fixed_cuda(*pool)
        except RuntimeError as err:  # a launch the checkout's kernel refuses
            out[name] = {"B": scores.shape[0], "P": scores.shape[1], "error": str(err)}
            continue
        equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for _ in range(10):
            nms_fixed_cuda(*pool)
        torch.cuda.synchronize()
        times = []
        for _ in range(100):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            nms_fixed_cuda(*pool)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(100):
                nms_fixed_cuda(*pool)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
        recorded = sum(e.count for e in events)
        out[name] = {"B": scores.shape[0], "P": scores.shape[1], "picks": int(want[1].sum()),
                     "equal_to_plain": equal, "launches_recorded": recorded,
                     "device_ms": sum(e.self_device_time_total for e in events) / 1e3 / max(recorded, 1),
                     "ms": statistics.median(times)}
    print(json.dumps({"root": args.root, "card": smi, "pools": out}), flush=True)
    return 0 if all(v.get("equal_to_plain") for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

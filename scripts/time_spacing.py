#!/usr/bin/env python3
"""Time a checkout's ``spacing_select`` kernel on the bins path's input (card).

The input is what the bins chain hands the kernel: the top-K candidates of
the synthetic 720p bins scene at t = 1.0 (``detect_candidates``, K = 512 by
default), min distance 8. Prints one JSON line: the checkout, K, the kept
set's equality with the plain version, the device ms per call (torch.profiler;
per kernel name, the time per recorded launch, since a trace may drop
launches) and the event-timed ms (median of 100 calls).

Two checkouts are compared on one card by running each in its own process,
in turn (a, b, b, a), in one machine session:

    python3 scripts/time_spacing.py [--root CHECKOUT] [--k 512]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="checkout whose package is timed (default: this one)")
    parser.add_argument("--k", type=int, default=512)
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import bins_frame
    from cuauv_vision_pipeline_tpu_torch.ops.color_np import bgr_to_gray_np
    from cuauv_vision_pipeline_tpu_torch.ops.cuda.spacing_kernel import spacing_select, spacing_select_plain
    from cuauv_vision_pipeline_tpu_torch.ops.feature import detect_candidates

    if not torch.cuda.is_available():
        print("time_spacing: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gray = torch.from_numpy(bgr_to_gray_np(bins_frame((720, 1280), 1.0))).to(dev)
    ys, xs, cand = detect_candidates(gray, max_keypoints=args.k)

    def run():
        return spacing_select(ys, xs, cand, 8)

    equal = torch.equal(run(), spacing_select_plain(ys, xs, cand, 8))
    for _ in range(10):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(100):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    n = 100
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    kernels = {e.key[:60]: {"recorded": e.count, "device_ms_per_launch": e.self_device_time_total / 1e3 / e.count}
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count}
    print(json.dumps({
        "root": args.root, "K": args.k, "candidates": int(cand.sum()), "equal_to_plain": equal,
        "calls_traced": n, "device_ms": sum(k["device_ms_per_launch"] for k in kernels.values()),
        "kernels": kernels, "ms": statistics.median(times),
    }), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())

"""Multi-card module fan-out: N cameras -> N ranks, one camera each.

The twin of the repo's ``examples/multichip_fanout.py`` on
``torch.distributed``: each rank (``parallel/mesh.py``) runs the whole
red_buoy chain (LAB -> inRange -> ``fused_morph`` -> ``label_cuda`` -> blob
stats) on its own camera's frame, with no collective (the work is
embarrassingly parallel), at the JAX example's defaults: 1080 rows at
16:9, one red disc per camera, 100 timed rounds. Each rank prints its blob
and its ms per round (CUDA events around the rounds):

    python -m cuauv_vision_pipeline_tpu_torch.examples.multichip_fanout            # nccl, one card per camera
    python -m cuauv_vision_pipeline_tpu_torch.examples.multichip_fanout --cameras 2 --backend gloo   # both on cuda:0
    python -m cuauv_vision_pipeline_tpu_torch.examples.multichip_fanout --cameras 4 --size 72 --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np


def camera_frames(n: int, size: int) -> np.ndarray:
    """The JAX example's frames: random u8 noise (seed 0), ``size`` rows at
    16:9, one red disc per camera at a spot of its own."""
    H, W = size, size * 16 // 9
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (n, H, W, 3), dtype=np.uint8)
    r = max(6, min(H, W) // 12)
    yy, xx = np.mgrid[0:H, 0:W]
    for cam in range(n):
        y = r + 2 + (cam * 7 * r) % (H - 2 * r - 4)
        x = r + 2 + (cam * 13 * r) % (W - 2 * r - 4)
        frames[cam][(yy - y) ** 2 + (xx - x) ** 2 < r ** 2] = (40, 40, 220)
    return frames


def _rank(device, n: int, size: int, rounds: int) -> dict:
    """One camera's chain on this rank: warm, then ``rounds`` timed rounds."""
    import torch
    import torch.distributed as dist

    from ..ops.cuda import launch_counts, reset_launch_counts
    from ..parallel.fanout import chain_one

    rank = dist.get_rank()
    assert dist.get_world_size() == n, f"{n} cameras on {dist.get_world_size()} ranks"
    frame = torch.from_numpy(camera_frames(n, size)[rank]).to(device)
    out = chain_one(frame, 140, 255)  # builds and loads the kernels
    reset_launch_counts()
    cuda = frame.is_cuda
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
    t0 = time.perf_counter()
    for _ in range(rounds):
        out = chain_one(frame, 140, 255)
    if cuda:
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / rounds
    else:
        ms = (time.perf_counter() - t0) * 1e3 / rounds
    blob = {k: v.cpu().numpy() for k, v in out.items()}
    cy, cx = blob["centroid"]
    print(f"cam{rank} on {device}: area={int(blob['area']):6d} centroid=({cy:7.1f},{cx:7.1f}) "
          f"bbox={blob['bbox'].tolist()}  {ms:.3f} ms/round", flush=True)
    return {"blob": blob, "ms_per_round": ms, "launches": launch_counts()}


def run(argv: Optional[List[str]] = None) -> dict:
    """Launch the ranks as the command line asks; returns the per-rank
    results (blob, ms per round, launch counts over the timed rounds) and
    the rounds' aggregate frames per second."""
    import torch

    from ..parallel.mesh import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cameras", type=int, default=None, help="ranks (default: the CUDA device count)")
    ap.add_argument("--size", type=int, default=1080, help="frame rows (16:9)")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="nccl: rank r on cuda:r; gloo: every rank on --device")
    ap.add_argument("--device", default=None, help="gloo's device: cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    n = args.cameras or torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("no CUDA device: pass --cameras N --backend gloo --device cpu")
    ranks = launch(_rank, n, args.backend, args.device, args=(n, args.size, args.rounds))
    slowest = max(r["ms_per_round"] for r in ranks)
    print(f"{n} cameras / ranks ({args.backend}): slowest rank {slowest:.3f} ms/round = "
          f"{n * 1e3 / slowest:,.0f} aggregate fps", flush=True)
    return {"ranks": ranks, "aggregate_fps": n * 1e3 / slowest}


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

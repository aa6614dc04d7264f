#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py [--morph-variant NAME=SOURCE.cu ...]

Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

1. env     — the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build   — builds the frame bus (g++) and every kernel of ``csrc/`` (nvcc,
             one per source, in parallel) from this checkout.
3. kernels — each CUDA kernel against its plain PyTorch version on the same
             card tensors, exact equality required, CCL cases launched twice
             (equal reruns), among them components across the kernel's
             32x32 tile seams; the morphology on graded u8 values, ragged
             widths and heights, an odd address, B=8 stacks whose images
             differ at their seams, and against four ``max_pool2d`` calls;
             then kernel, plain and library times at the main path's 1080p
             shapes.
4. chain   — the red_buoy chain (RedBuoyPipeline, fused morphology) at 1080p
             on the card vs the plain chain on the CPU, per-frame and
             batched-8, and the composed ``red_buoy_chain`` likewise;
             per-frame and batched fps over repeated windows of a few
             seconds (median, min, max) at the disc threshold for both
             chains in turn and at the default tuners' whole frame, with
             the kernel wrapper calls per frame and a device profile.
5. nms     — the greedy-NMS kernel against its plain version on card
             tensors (the pools of tests/nms_cases.py: 1 to 8400
             candidates, exact ties, none above the threshold, fewer than
             max_det, rotated poles, a NaN, -inf and negative scores,
             decode-sorted pools, ties across the walk's chunks, picks deep
             in the order, the merge's padded pool, max_det > P; B=1 and
             B=8), ProbIoU and AABB class-aware and ProbIoU any-class, each
             launched twice; picked and valid exact. Then the kernel at
             the timing shapes of tests/nms_cases.py (B=1 and B=2 at 512,
             the merge's 64 AABB, 8400, 20000 and 58112 sorted, 8400
             unsorted): event-timed ms, device ms per launch, plain ms,
             bound, and the block barriers of its launch beside those of a
             round-per-pick design.
6. spacing — the greedy spacing kernel against its plain version on card
             tensors (tests/spacing_cases.py: K = 1 to 4096, every K the
             fixpoint's block shape changes at, no candidate, dense 3-px
             grids, exact-tie plateaus, repeated points, other
             min_distances; the top-512 candidates of four 720p bins scenes
             and of the pose template, and a scene's top-2048 and
             top-4096), each launched twice, kept sets exact;
             detect_describe at 2048 keypoints keeps the CPU's keypoints;
             event-timed and plain ms at the main path's input (K = 512)
             and at K = 2048 and 4096.
7. yolo    — the YOLO-OBB serving path (YoloModel: YOLOv8n-obb, 15 classes,
             640, bf16, seeded random init) on 1080p ZED frames: (a) float32
             on the card (TF32 off) against float32 on the CPU: head outputs
             within a few times their measured difference and decoded valid,
             also decoded cls for the trained detect fixture; the card's
             head maps decoded on both devices: DFL, boxes and scores
             within a few ulps, then pool, gathers and NMS on the card's
             own candidates with valid, cls, picked, scores and boxes
             equal; TF32 on must fail the head tolerance; (b)
             the trained fixture in bf16 on the card over 24 synthetic scenes
             (recall and precision >= 0.75); (c) event-timed ms per frame and
             per-frame fps over five 2 s windows.
8. bins    — the bins + pose path (BinDetector, BASELINE config 3: HSV mask,
             ``fused_morph`` open, detect/describe with the spacing kernel,
             2-NN against the builtin template) at 720p on the card against
             the same chain on the CPU, four frames: cleaned mask and
             overlay exact, keypoints and n_valid equal, descriptor rows
             past 1e-5 counted, the pose quad within 1 px and matches and
             inliers within 2; the host leg's shm.bins_pose visible with >= 8
             inliers within 12 px of the pasted plate; wall ms, fps over five
             2 s windows and the host leg's ms. TF32 must be off again after
             the YOLO phase's control.
9. stereo  — the stereo red_buoy chain (BuoyStereo.stereo_chain: both ZED
             eyes as one [2, H, W] batch) on two 1080p planes at the disc
             threshold and the whole frame, card against CPU: masks and
             cleaned masks exact, found and area exact, centroid within
             1e-3; one label_cuda_batched and one fused_morph launch per
             call; no host sync; wall ms and fps.
10. multicam — config 5's two cameras (zed 1280x720, flir 800x600) through
             YoloModel.device_decode_multi (one conv stack at batch 2, one
             NMS launch): float32 head maps against the CPU's per camera,
             each camera's picks against that camera decoded alone (the
             trained fixture on scenes it knows, and the seeded
             YOLOv8n-obb); the bf16 serving model's dispatch, its
             cross-camera merge on the card against the CPU's; wall ms and
             fps.
11. correction — BASELINE config 4's device work, which runs no hand
             kernel (none may launch): ``ops/balance.balance`` with the
             default config on four 720p buoy frames and one 1080p frame
             and each non-default one at 720p (RGB contrast, HSV contrast,
             adaptive taper, blocks 4x3), card against CPU within 1 count
             but for pixels at an HSI sector edge (at most 1e-4 of a
             frame); no host sync inside ``balance``; the preprocessor's
             stage stack card against CPU, exact (every stage but balance
             and the noise); balance's wall ms and fps at 720p and 1080p.
12. module — the real entry points as subprocesses: the synthetic camera
             (``--scene zed``, the ZED's four planes) and
             ``modules.red_buoy``, both on a direction named for this run
             and with ``CUAUV_SHM_NAMESPACE`` set to this run's own
             namespace, so another run on the machine shares no bus block,
             tuner block or shm group with this one; checks
             ``shm.red_buoy_results`` under default tuners (whole frame) and
             after ``thresh_min=140`` (the red disc) set through the
             ModuleReader, reads ``latency_ms`` and the module's CCL launch
             count; beside it ``modules.yolo`` (no weight: seeded random
             init) on the same camera, until ``shm.yolo_status.frames``
             advances, with its ``latency_ms``, its posts and its
             ``nms_fixed`` launches; and a synthetic ``bins`` camera at 720p
             (one frame, cycled) with ``modules.bins`` and the builtin pose
             template, until ``shm.bins_pose.seq_frames`` advances with a
             visible pose on the plate, with its ``latency_ms``, its post
             and its ``fused_morph`` and ``spacing_select`` launches. Then,
             each on cameras of its own: ``modules.red_buoy_stereo`` on a
             zed camera (both eyes' fields, at the default tuners and the
             disc threshold, ``latency_ms``, its ``label_cuda_batched``
             launches); ``modules.yolo_multicam`` on a zed 1280x720 camera
             at 15 fps and a flir 800x600 camera at 10 fps (frames advance,
             ``latency_ms``, the posts image_forward and image_downward,
             ``nms_fixed`` launches); ``modules.red_buoy`` on one buoy frame
             from the synthetic source and then from a directory holding
             that frame as a .bmp (``capture_sources.image_directory``):
             the same ``shm.red_buoy_results``; ``modules.yolo`` serving
             the trained gate checkpoint on the synthetic gate scene
             (``shm.yolo_gate`` reports shark and saw); ``modules.gate``
             with ``CUAUV_GATE_LOCALIZE=1``; beside it BASELINE config 4: a
             1280x720 synthetic camera (8 precomputed frames, 30 fps)
             feeding ``modules.preprocessor``, ``modules.color_balance`` and
             ``modules.auto_calibrate``, until the ModuleReader has three
             ``preprocessed``, ``original``, ``balanced`` and ``calibration
             view`` posts each and ``shm.camera_calibration.exposure`` has
             left 50.0; each module exits 0 on SIGINT. Then it removes the
             blocks and groups this run made.

Launch counts are set to 0 just before each path (the chain phase, the
YOLO phase, the bins phase, the stereo phase, the multicam phase, the
correction phase, whose path has no hand kernel) and read
just after it; with the module processes' own logged counts they are the
main path's launches, and each kernel of a path must have launched in that
path's run. Then the CCL kernels', the morphology's, the YOLO path's
(preamble, conv stack, decode, NMS), the bins path's (per stage), the
stereo chain's, the two-camera dispatch's and the correction chain's (per
stage, and the preprocessor's stack) device time (torch.profiler)
beside their event-timed wall time, a ``{"kernels": [...]}`` line and,
last, the ``{"ok": true, "device": ...}`` line.

``--morph-variant NAME=SOURCE.cu`` (repeatable) builds another source with
the C entry point of ``csrc/morph.cu`` (an earlier version, a design
variant) into the git-ignored ``local/``, holds it against the plain
morphology and times it beside ``csrc/morph.cu`` in the device phase, with
the SASS opcode counts of both.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import uuid
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
H, W = 1080, 1920
FPS_WINDOW_S = 2.0  # one throughput window
FPS_REPEATS = 5
# device-memory rates by card (bytes/s): NVIDIA data sheets
_MEM_RATE = {"PCIe": 2.0e12, "HBM3": 3.35e12, "SXM": 3.35e12}
# the kernels' operations are 32-bit integer ones; a Hopper SM issues INT32
# on 64 of its 128 FP32 lanes per clock, so its INT32 peak is half the
# data sheet's 67 T/s float32 rate outside the tensor cores (SXM)
_OPS_RATE = 67e12 / 2
# float32 outside the tensor cores (SXM data sheet): the NMS kernel's rate
_F32_RATE = 67e12
# float operations of one ProbIoU of a candidate against the round's best
# (nms_kernel._probiou_rows: 33 adds, multiplies and divisions, log, exp,
# sqrt, the clamp) and its threshold compare
NMS_OPS_PER_IOU = 38
MORPH_OPS = ("open_close", "open", "close")
# csrc/nms.cu: candidates ordered and walked at a time (kBatch)
NMS_BATCH = 1024
# CUDA launches behind one wrapper call (csrc/ccl.cu: local, border, final)
CUDA_LAUNCHES_PER_CALL = {"label_cuda": 3, "label_cuda_batched": 3, "fused_morph": 1, "nms_fixed": 1,
                          "spacing_select": 2}
YOLO_FIXTURE = REPO / "tests" / "fixtures" / "synth_pico_detect.msgpack"
# the bins path: the ZED's HD720 frames, the scenes' times, card-vs-CPU limits
BINS_H, BINS_W = 720, 1280
BINS_TS = (0.0, 1.0, 2.5, 4.0)
BINS_DES_ATOL = 1e-5  # a descriptor row within this of the CPU's counts as equal
BINS_QUAD_PX = 1  # pose quad corners, card against CPU
BINS_MATCH_SLACK = 2  # ratio-test matches and RANSAC inliers, card against CPU
BINS_PLATE_PX = 12  # pose quad against the pasted plate (the JAX test's limit)
# integer operations of one distance test (dy, dx, two products, their sum,
# the compare)
SPACING_OPS_PER_TEST = 6
# large K (detect_describe takes any max_keypoints)
SPACING_LARGE_K = (2048, 4096)


_T0 = time.monotonic()


def emit(phase: str, **fields) -> None:
    """One JSON line per phase, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "t_s": round(time.monotonic() - _T0, 1), **fields}), flush=True)


def mem_rate(name: str) -> float:
    for key, rate in _MEM_RATE.items():
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate known for {name!r}")


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median ms of one call, timed with CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n: int = 20):
    """The CUDA kernels' own device time per call of ``fn`` (torch.profiler,
    kernel events summed), and its split by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then holds no kernel event: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        by_name = {e.key[:60]: e.self_device_time_total / 1e3 / n
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        if sum(by_name.values()) > 0:
            return sum(by_name.values()), by_name
    raise RuntimeError("torch.profiler recorded no kernel time in three traces")


def seam_lines(shape, axis: int, dev):
    """One-pixel lines across the image on the CCL kernel's 32x32 tile
    seams, alternately on a tile's first and last row (axis 0) or column."""
    at = [k * 32 - (k % 2 == 0) for k in range(1, shape[axis] // 32 + 1)]
    mask = torch.zeros(shape, dtype=torch.uint8, device=dev)
    return mask.index_fill_(axis, torch.tensor([i for i in at if i < shape[axis]], device=dev), 255)


def test_masks(dev):
    """The kernel checks' masks, on the card."""
    g = torch.Generator(device=dev).manual_seed(1)
    noise = torch.rand((1, 1, H, W), generator=g, device=dev)
    blurred = torch.nn.functional.avg_pool2d(noise, 15, stride=1, padding=7)
    blob = (blurred[0, 0] > 0.53).to(torch.uint8) * 255
    spiral = torch.zeros((64, 64), dtype=torch.uint8)
    x0, x1, y0, y1 = 0, 63, 0, 63
    while x0 < x1:
        spiral[y0, x0 : x1 + 1] = 255
        spiral[y0 : y1 + 1, x1] = 255
        spiral[y1, x0 : x1 + 1] = 255
        spiral[y0 + 2 : y1 + 1, x0] = 255
        x0, x1, y0, y1 = x0 + 4, x1 - 4, y0 + 4, y1 - 4
    checker = torch.zeros((24, 24), dtype=torch.uint8)
    checker[::2, ::2] = 255
    checker[1::2, 1::2] = 255
    ragged = (torch.rand((33, 130), generator=g, device=dev) < 0.4).to(torch.uint8)
    # 8-connected only through up-right links: tile corners, right columns
    anti_diagonal = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    ys = torch.arange(H, device=dev)
    anti_diagonal[ys, W - 1 - ys] = 255
    odd = (1079, 1917)  # ragged tiles; W % 4 != 0 takes the byte loads
    return {
        "blobs_1080p": (blob, 8),
        "all_fg_1080p": (torch.full((H, W), 255, dtype=torch.uint8, device=dev), 8),
        "noise45_1080p": ((torch.rand((H, W), generator=g, device=dev) < 0.45).to(torch.uint8), 8),
        "spiral": (spiral.to(dev), 8),
        "checker_8": (checker.to(dev), 8),
        "checker_4": (checker.to(dev), 4),
        "ragged_33x130": (ragged, 8),
        "anti_diagonal_1080p": (anti_diagonal, 8),
        "row_seams_1080p": (seam_lines((H, W), 0, dev), 8),
        "column_seams_1080p": (seam_lines((H, W), 1, dev), 8),
        "seam_grid_1080p_4": (seam_lines((H, W), 0, dev) | seam_lines((H, W), 1, dev), 4),
        "seam_grid_1079x1917": (seam_lines(odd, 0, dev) | seam_lines(odd, 1, dev), 8),
        "noise50_1079x1917": ((torch.rand(odd, generator=g, device=dev) < 0.5).to(torch.uint8), 8),
    }


def morph_masks(dev, buoy):
    """The morphology checks' inputs on the card: graded u8 values (uniform
    noise, a smooth ramp), ragged widths and heights, a view at an odd
    address, B=8 stacks whose neighbouring images differ at the seam rows
    (even images end bright, odd ones start dark: a row read across the
    seam shows in the next erode or dilate), and the buoy masks."""
    g = torch.Generator(device=dev).manual_seed(2)

    def graded(shape):
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)

    def seams(shape):
        stack = graded((8, *shape))
        stack[0::2, -3:] = 255
        stack[1::2, :3] = 0
        return stack

    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    out = {
        "randint_1080p": graded((H, W)),
        "ramp_1080p": ((3 * ys + 2 * xs) // 16 % 256).to(torch.uint8),
        "binary_1080p": (graded((H, W)) < 128).to(torch.uint8) * 255,
    }
    for h in (1, 1079):
        for w in (1, 3, 5, 129, 1917):
            out[f"randint_{h}x{w}"] = graded((h, w))
    odd = graded((H * W + 1,))[1:].view(H, W)
    assert odd.data_ptr() % 4 and odd.is_contiguous()
    out["odd_address_1080p"] = odd
    out["seams_b8_1080p"] = seams((H, W))
    out["seams_b8_1079x1917"] = seams((1079, 1917))
    out["buoy"] = buoy[0]
    out["buoy_b8"] = buoy
    return out


def ccl_edges(mask, connectivity: int) -> int:
    """Foreground neighbour pairs the union-find merges (data-dependent ops)."""
    fg = mask != 0
    n = (fg[..., :, 1:] & fg[..., :, :-1]).sum() + (fg[..., 1:, :] & fg[..., :-1, :]).sum()
    if connectivity == 8:
        n += (fg[..., 1:, 1:] & fg[..., :-1, :-1]).sum() + (fg[..., 1:, :-1] & fg[..., :-1, 1:]).sum()
    return int(n)


def phase_kernels(dev, frames, rate):
    from cuauv_vision_pipeline_tpu_torch.engine.chains import red_buoy_fused
    from cuauv_vision_pipeline_tpu_torch.ops.ccl import label
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import label_cuda, label_cuda_batched
    from cuauv_vision_pipeline_tpu_torch.ops.cuda.morph_kernel import (
        fused_morph,
        fused_morph_plain,
    )

    err = {"label_cuda": 0, "label_cuda_batched": 0, "fused_morph": 0}
    checks = []

    def compare(name, got, want, case):
        """Exact equality required; records the max |difference| (0)."""
        diff = (got.long() - want.long()).abs().max().item()
        if diff or got.shape != want.shape:
            raise AssertionError(f"{name} differs from its plain version on {case} (max |d| {diff})")
        err[name] = max(err[name], diff)
        checks.append(f"{name}:{case}")

    for case, (mask, conn) in test_masks(dev).items():
        a = label_cuda(mask, conn)
        b = label_cuda(mask, conn)  # atomics land in another order
        torch.cuda.synchronize()
        compare("label_cuda", a, label(mask, conn), case)
        compare("label_cuda", b, a, case + "_rerun")

    # the main path's masks (threshed buoy frames at 1080p), and stacks
    # whose images touch: each image's last and the next one's first row
    # are foreground, joined by a column, so each image is one component
    # with root 0
    masks = torch.stack([red_buoy_fused(f, 140, 255)[0] for f in frames])
    full8 = torch.full((8, H, W), 255, dtype=torch.uint8, device=dev)
    touching = torch.zeros((8, H, W), dtype=torch.uint8, device=dev)
    touching[:, 0] = touching[:, -1] = touching[:, :, W // 2] = 255
    batched = {
        "buoy_b8": masks,
        "noise45_b8": (torch.rand((8, H, W), device=dev) < 0.45).to(torch.uint8),
        "all_fg_b8": full8,
        "image_seams_b8": touching,
    }
    for case, stack in batched.items():
        a = label_cuda_batched(stack)
        b = label_cuda_batched(stack)
        torch.cuda.synchronize()
        compare("label_cuda_batched", a, label(stack), case)
        compare("label_cuda_batched", b, a, case + "_rerun")
        if case in ("all_fg_b8", "image_seams_b8") and not (a[stack != 0] == 0).all():
            raise AssertionError(f"label_cuda_batched: {case} is not one component with root 0 per image")

    for case, m in morph_masks(dev, masks).items():
        for op in MORPH_OPS:
            got = fused_morph(m, op)
            compare("fused_morph", got, fused_morph_plain(m, op), f"{op}_{case}")
            if m.ndim == 3:  # a stack in one launch equals each image alone
                alone = torch.stack([fused_morph(image, op) for image in m])
                compare("fused_morph", got, alone, f"{op}_{case}_per_image")

    # times at the main path's shapes and inputs
    mask = masks[0].contiguous()
    F = torch.nn.functional

    def library_morph():  # four composed max_pool2d calls, identity borders
        x = mask.to(torch.float32).view(1, 1, H, W)
        x = -F.max_pool2d(-x, 5, stride=1, padding=2)
        x = F.max_pool2d(x, 5, stride=1, padding=2)
        x = F.max_pool2d(x, 5, stride=1, padding=2)
        return -F.max_pool2d(-x, 5, stride=1, padding=2)

    compare("fused_morph", library_morph().to(torch.uint8)[0, 0], fused_morph(mask), "library")
    hw = H * W
    full = torch.full((H, W), 255, dtype=torch.uint8, device=dev)
    rows = {
        "label_cuda": dict(
            source="cuauv_vision_pipeline_tpu_torch/csrc/ccl.cu",
            replaces="cuauv_vision_pipeline_tpu/ops/pallas/ccl_kernel.py:143",
            ms=cuda_ms(lambda: label_cuda(mask), 100),
            plain_ms=cuda_ms(lambda: label(mask), 10, warmup=1),
            bytes=hw * (1 + 4), ops=2 * hw + ccl_edges(mask, 8), library_ms=None,
        ),
        "label_cuda_batched": dict(
            source="cuauv_vision_pipeline_tpu_torch/csrc/ccl.cu",
            replaces="cuauv_vision_pipeline_tpu/ops/pallas/ccl_kernel.py:235",
            ms=cuda_ms(lambda: label_cuda_batched(masks), 50),
            plain_ms=cuda_ms(lambda: label(masks), 5, warmup=1),
            bytes=8 * hw * (1 + 4), ops=2 * 8 * hw + ccl_edges(masks, 8), library_ms=None,
        ),
        "fused_morph": dict(
            source="cuauv_vision_pipeline_tpu_torch/csrc/morph.cu",
            replaces="cuauv_vision_pipeline_tpu/ops/pallas/morph_kernel.py:101",
            ms=cuda_ms(lambda: fused_morph(mask), 100),
            plain_ms=cuda_ms(lambda: fused_morph_plain(mask), 50),
            # the least work: a 5-tap min/max of packed pixels is one op per
            # pixel (2 three-input DPX ops per u16x2 word of 2 pixels, or 4
            # SIMD ops per u8x4 word of 4), x 2 passes x 4 stages
            bytes=hw * 2, ops=8 * hw, library_ms=cuda_ms(library_morph, 50),
        ),
    }
    for name, r in rows.items():
        t_bytes = r.pop("bytes") / rate * 1e3
        t_ops = r.pop("ops") / _OPS_RATE * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["max_abs_err"] = err[name]
    # CCL wall time per call (events around the Python call: checks,
    # allocation, ctypes, launches) on the disc and the whole frame; the
    # kernels' own device time comes after the main path (phase_ccl_device)
    ccl_inputs = {
        "label_cuda_disc": lambda: label_cuda(mask),
        "label_cuda_all_fg": lambda: label_cuda(full),
        "label_cuda_batched_disc_b8": lambda: label_cuda_batched(masks),
        "label_cuda_batched_all_fg_b8": lambda: label_cuda_batched(full8),
    }
    ccl_ms = {key: cuda_ms(fn, 100) for key, fn in ccl_inputs.items()}
    extra = {
        "label_cuda_all_fg_plain_ms": cuda_ms(lambda: label(full), 5, warmup=1),
        "label_cuda_batched_all_fg_b8_plain_ms": cuda_ms(lambda: label(full8), 3, warmup=1),
    }
    emit("kernels", checks=len(checks), cases=checks,
         **{n: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")} for n, r in rows.items()},
         ccl_ms=ccl_ms, **extra)
    return rows, ccl_inputs, masks


def phase_ccl_device(ccl_inputs):
    """The CCL kernels' own device time per call (torch.profiler) beside the
    event-timed wall time. Run after the main path: once the profiler has
    traced the process, every later launch costs the host more, which the
    launch-bound per-frame lane would read as a slower chain."""
    out = {}
    for key, fn in ccl_inputs.items():
        dev_ms, by_kernel = device_ms(fn)
        out[key] = {"ms": cuda_ms(fn, 100), "device_ms": dev_ms, "device_ms_by_kernel": by_kernel}
    emit("ccl_device", **out)


def start_variant_builds(variants):
    """One nvcc per ``--morph-variant`` source, all started now, into the
    git-ignored ``local/`` with the flags of ``csrc/``."""
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import _build

    out_dir = REPO / "local"
    out_dir.mkdir(exist_ok=True)
    builds = {}
    for name, source in variants.items():
        lib = out_dir / f"libmorph_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(source)]
        builds[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return builds


def morph_runner(lib):
    """``fn(mask, op)`` over a library with ``csrc/morph.cu``'s C entry point."""
    from cuauv_vision_pipeline_tpu_torch.ops.cuda.morph_kernel import _SIGNATURES, STAGES

    for fn, (restype, argtypes) in _SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes

    def run(mask, op="open_close"):
        stages = STAGES[op]
        out = torch.empty_like(mask)
        bits = sum(1 << i for i, is_erode in enumerate(stages) if is_erode)
        err = lib.morph_fused(mask.data_ptr(), out.data_ptr(), mask.shape[0] if mask.ndim == 3 else 1,
                              mask.shape[-2], mask.shape[-1], bits, len(stages), 0,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"morph_fused: CUDA error {err} ({lib.morph_error_string(err).decode()})")
        return out

    return run


def sass_opcodes(lib) -> dict:
    """Opcode counts of the open_close kernel on aligned rows in a built
    library (the only kernel where a library has one), from cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    functions: dict = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            functions[name] = {}
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)", line)
        if name and op:
            functions[name][op.group(1)] = functions[name].get(op.group(1), 0) + 1
    chosen = [n for n in functions if "ILj9ELi4ELb1E" in n] or list(functions)
    counts = functions[chosen[0]]
    return {"function": chosen[0], "instructions": sum(counts.values()),
            "opcodes": dict(sorted(counts.items(), key=lambda kv: -kv[1]))}


def phase_morph_device(masks, builds):
    """The morphology's own device time per call (torch.profiler) and its
    event-timed wall time, at 1080p and on the B=8 buoy stack, beside each
    ``--morph-variant`` built from another source (held exactly against the
    plain version first); two rounds in turn. Run after the main path, as
    the CCL's device phase."""
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import _build
    from cuauv_vision_pipeline_tpu_torch.ops.cuda.morph_kernel import fused_morph, fused_morph_plain

    libs = {"morph": _build.library_path("morph")}
    runners = {"morph": fused_morph}
    ptxas = {}
    g = torch.Generator(device=masks.device).manual_seed(3)
    graded = torch.randint(0, 256, (3, 1079, 1917), generator=g, device=masks.device, dtype=torch.uint8)
    for name, (proc, lib) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for --morph-variant {name}:\n{log}")
        ptxas[name] = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        run = morph_runner(ctypes.CDLL(str(lib)))
        for m in (masks[0], masks, graded):
            for op in MORPH_OPS:
                want = fused_morph_plain(m, op)
                got = run(m, op)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"--morph-variant {name} differs from the plain version ({op})")
        libs[name] = lib
        runners[name] = run
    inputs = {"buoy_1080p": masks[0].contiguous(), "buoy_b8": masks}
    rounds = []
    for _ in range(2):
        rounds.append({
            name: {key: dict(zip(("device_ms", "device_ms_by_kernel"), device_ms(lambda: run(m))),
                             ms=cuda_ms(lambda: run(m), 100))
                   for key, m in inputs.items()}
            for name, run in runners.items()})
    emit("morph_device", rounds=rounds, variants_ptxas=ptxas,
         sass={name: sass_opcodes(lib) for name, lib in libs.items()})


def phase_chain(dev, frames):
    from cuauv_vision_pipeline_tpu_torch.engine.chains import (
        RedBuoyPipeline,
        red_buoy_chain,
        red_buoy_fused,
    )
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import launch_counts

    pipe = RedBuoyPipeline(device=dev)
    host = [f.cpu() for f in frames]
    stack = torch.stack(frames)
    out = {}
    # the production chain (fused morphology kernel) and the composed one
    # (four max_pool2d passes and their casts), the same stats
    chains = {"fused": pipe.run_async,
              "composed": lambda image, tmin, tmax: red_buoy_chain(image, tmin, tmax, max_components=8)}

    def check(got, want, what):
        gt, gc, gb = got
        wt, wc, wb = want
        assert torch.equal(gt.cpu(), wt), f"{what}: threshed differs"
        assert torch.equal(gc.cpu(), wc), f"{what}: cleaned differs"
        for key in ("found", "area", "bbox"):
            assert torch.equal(gb[key].cpu(), wb[key]), f"{what}: best[{key}] differs"
        assert torch.allclose(gb["centroid"].cpu(), wb["centroid"], rtol=1e-5, atol=1e-3), what

    for chain, run in chains.items():
        before = launch_counts()["fused_morph"]
        for tmin, tmax in ((140, 255), (0, 255)):
            for i in (0, 3):
                check(run(frames[i], tmin, tmax),
                      red_buoy_fused(host[i], tmin, tmax), f"frame{i} {tmin}-{tmax} {chain}")
            batched = run(stack, tmin, tmax)
            for i in (0, 5):
                want = red_buoy_fused(host[i], tmin, tmax)
                lane = (batched[0][i], batched[1][i], {k: v[i] for k, v in batched[2].items()})
                check(lane, want, f"lane{i} {tmin}-{tmax} {chain}")
        grew = launch_counts()["fused_morph"] - before
        assert (grew > 0) == (chain == "fused"), f"fused_morph launches grew by {grew} in the {chain} chain"

    # throughput: the fused and composed chains alternate within each
    # repeat, so drift of the card or the host hits both alike; the default
    # tuners' whole frame (threshold 0) runs the fused chain only
    lanes = {"per_frame": (lambda run, k, tmin: run(frames[k % 8], tmin, 255), 1),
             "batched8": (lambda run, k, tmin: run(stack, tmin, 255), 8)}
    settings = {"fused": ("fused", 140), "composed": ("composed", 140), "thresh0": ("fused", 0)}
    fps: dict = {}
    calls: dict = {}
    for _ in range(FPS_REPEATS):
        for setting, (chain, tmin) in settings.items():
            for lane, (step, per_step) in lanes.items():
                key = f"{lane}_{setting}"
                run = chains[chain]
                rate, calls[key] = fps_window(lambda k: step(run, k, tmin), per_step, FPS_WINDOW_S)
                fps.setdefault(key, []).append(rate)
    out["fps"] = {k: {"median": statistics.median(v), "min": min(v), "max": max(v), "windows": v}
                  for k, v in fps.items()}
    out["fps_window_s"] = FPS_WINDOW_S
    # fused / composed chain, repeat by repeat
    out["fused_over_composed"] = {
        lane: [b / a for a, b in zip(fps[f"{lane}_composed"], fps[f"{lane}_fused"])] for lane in lanes}
    out["wrapper_calls_per_frame"] = calls
    out["cuda_launches_per_frame"] = {
        key: {k: n * CUDA_LAUNCHES_PER_CALL[k] for k, n in c.items()} for key, c in calls.items()}
    # the red disc and the default tuners' whole frame; the composed chain
    for name, chain, tmin in (("thresh_min_140", "fused", 140), ("thresh_min_0", "fused", 0),
                              ("thresh_min_140_composed", "composed", 140)):
        run = chains[chain]
        wall_ms = cuda_ms(lambda: run(frames[0], tmin, 255), 50)
        out[f"profile_{name}"] = profile_chain(run, frames, tmin, wall_ms)
    emit("chain", **out)
    return out


def fps_window(step, frames_per_step: int, seconds: float):
    """Frames/s of ``step(k)`` called back to back for ``seconds`` (the card
    synchronised at both ends), and the kernel wrapper calls per frame."""
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import launch_counts

    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        step(n)
        n += 1
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    after = launch_counts()
    frames = n * frames_per_step
    return frames / elapsed, {k: (after[k] - before[k]) / frames for k in after}


def profile_chain(run, frames, tmin, wall_ms, n=20):
    """Where a per-frame dispatch's device time goes (torch.profiler, CUDA
    kernel events only); the idle share is against ``wall_ms``, the
    unprofiled per-frame time, since the profiler slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(n):
            run(frames[k % len(frames)], tmin, 255)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    by_name: dict = {}  # kernel names cut to 60 characters, summed
    for e in events:
        by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + e.self_device_time_total / 1e3 / n
    return {
        "wall_ms_per_frame": wall_ms,
        "wall_ms_per_frame_profiled": profiled_ms,
        "device_ms_per_frame": device_ms,
        "device_idle_share": 1 - device_ms / wall_ms,
        "kernels_per_frame": sum(e.count for e in events) / n,
        "top_device_ms_per_frame": sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
    }


def phase_nms(dev, rate):
    """The NMS kernel against its plain version (torch ops) on the same card
    tensors: every pool of tests/nms_cases.py, ProbIoU and AABB class-aware
    and ProbIoU any-class, each kernel launch twice; picked and valid
    exact. Then :func:`nms_timing` at each timing shape."""
    sys.path.insert(0, str(REPO / "tests"))
    from nms_cases import cases, timing_pools

    from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda
    from cuauv_vision_pipeline_tpu_torch.ops.cuda.nms_kernel import nms_fixed_plain

    checks = []
    for case, arrays in cases().items():
        boxes, scores, classes, angles = (torch.from_numpy(a).to(dev) for a in arrays[:4])
        max_det = arrays[4]
        for rotated, class_aware in ((True, True), (False, True), (True, False)):
            ang = angles if rotated else None
            name = f"{case}_{'probiou' if rotated else 'aabb'}{'' if class_aware else '_any_class'}"
            want = nms_fixed_plain(boxes, scores, classes, 0.45, max_det, class_aware, ang)
            for rep in range(2):
                got = nms_fixed_cuda(boxes, scores, classes, ang, 0.45, max_det, class_aware)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"nms_fixed differs from its plain version on {name} (launch {rep})")
            checks.append(name)
    shapes = {}
    for name, arrays in timing_pools().items():
        pool = tuple(a if not isinstance(a, np.ndarray) else torch.from_numpy(a).to(dev) for a in arrays)
        shapes[name] = nms_timing(pool, rate, plain_reps=5)
    emit("nms", checks=len(checks), cases=checks, shapes=shapes)


def bitonic_barriers(n: int) -> int:
    """Block barriers of csrc/nms.cu's bitonic_desc on n keys (a step and
    the next with strides <= 32 share a warp barrier)."""
    count, k = 0, 2
    while k <= n:
        j = k // 2
        while j:
            nxt = j // 2 if j > 1 else k
            count += not (j <= 32 and nxt <= 32 and not (j == 1 and k == n))
            j //= 2
        k *= 2
    return count


def nms_barriers(scores, picked, valid, max_det) -> dict:
    """The longest chain of block barriers over a pool's rows (each row is
    a block of its own), read from the code: csrc/nms.cu's (one after the
    first pass; per batch of NMS_BATCH, for a pool not in walk order, a
    radix select's 18 when more remain, the gather's, the sort's and the
    terms'; for a sorted pool one per batch after the first; one per
    32-candidate chunk walked, up to the chunk of the last pick) and a
    round-per-pick design's (one, three per round and two for a round that
    finds no pick); and the chunks walked."""
    out = {"barriers": 0, "barriers_round_per_pick": 0, "chunks": 0}
    for s, p, v in zip(scores.cpu().numpy(), picked.cpu().numpy(), valid.cpu().numpy()):
        n_picks = int(v.sum())
        pos = s > 0
        n_pos = 0 if np.isnan(s).any() else int(pos.sum())
        ordered = bool((~pos[1:] | (s[:-1] >= s[1:])).all())
        last = n_pos - 1
        if n_picks == max_det:  # the last pick's place in the walk order
            i = p[n_picks - 1]
            last = int((pos & ((s > s[i]) | ((s == s[i]) & (np.arange(len(s)) < i)))).sum())
        barriers, chunks, taken = 1, 0, 0
        while taken < n_pos and taken <= last:
            nb = min(NMS_BATCH, n_pos - taken)
            if ordered:
                barriers += taken > 0
            else:
                select = 18 if n_pos - taken > NMS_BATCH else 0
                barriers += select + 2 + bitonic_barriers(1 << (nb - 1).bit_length())
            walked = -(-min(nb, last - taken + 1) // 32)
            chunks, barriers, taken = chunks + walked, barriers + walked, taken + nb
        out["barriers"] = max(out["barriers"], barriers)
        out["chunks"] = max(out["chunks"], chunks)
        rounds = 1 + 3 * n_picks + (2 if n_picks < max_det else 0)
        out["barriers_round_per_pick"] = max(out["barriers_round_per_pick"], rounds)
    return out


def nms_timing(pool, rate, plain_reps: int = 10) -> dict:
    """The NMS kernel on one pool ``(boxes, scores, classes, angles,
    iou_thresh, max_det)`` (class-aware, as decode and the merge call it):
    held against its plain version, then its event-timed ms (median of
    100), device ms per recorded launch (torch.profiler), the plain
    version's ms, the bound (the pool read once and the picks written, or
    the float operations :func:`nms_work` counts, over the card's rates)
    and :func:`nms_barriers`."""
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda
    from cuauv_vision_pipeline_tpu_torch.ops.cuda.nms_kernel import nms_fixed_plain

    boxes, scores, classes, angles, iou, max_det = pool
    want = nms_fixed_plain(boxes, scores, classes, iou, max_det, True, angles)
    got = nms_fixed_cuda(*pool)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"nms_fixed differs from its plain version on a {tuple(scores.shape)} pool")
    B, P = scores.shape
    rounds, scanned, ious = nms_work(boxes, scores, classes, angles, iou, max_det)
    t_bytes = (B * P * (16 + 4 + 4 + (4 if angles is not None else 0)) + B * max_det * 5) / rate * 1e3
    t_ops = (2 * scanned + NMS_OPS_PER_IOU * ious) / _F32_RATE * 1e3
    prof = profile_fn(lambda: nms_fixed_cuda(*pool))
    return {"B": B, "P": P, "picks": int(want[1].sum()), "rounds": rounds, "scanned": scanned, "ious": ious,
            "ms": cuda_ms(lambda: nms_fixed_cuda(*pool), 100),
            "device_ms": prof["device_ms"] / prof["kernels"], "launches_traced_per_call": prof["kernels"],
            "plain_ms": cuda_ms(lambda: nms_fixed_plain(boxes, scores, classes, iou, max_det, True, angles),
                                plain_reps),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **nms_barriers(scores, *want, max_det)}


def spacing_work(kept: torch.Tensor, cand: torch.Tensor) -> int:
    """Distance tests the sequential greedy selection needs on these
    candidates: each candidate against the kept stronger ones."""
    kept_before = torch.cumsum(kept.long(), 0) - kept.long()
    return int(kept_before[cand].sum())


def bins_grays():
    """The bins path's 720p scenes and the pose template, as u8 gray (numpy)."""
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import bin_texture, bins_frame
    from cuauv_vision_pipeline_tpu_torch.ops.color_np import bgr_to_gray_np

    grays = {f"bins_720p_t{t}": bgr_to_gray_np(bins_frame((BINS_H, BINS_W), t)) for t in BINS_TS}
    grays["template"] = bgr_to_gray_np(np.asarray(bin_texture()))
    return grays


def phase_spacing(dev, rate):
    """The spacing kernel against its plain version (torch ops) on the same
    card tensors: the cases of tests/spacing_cases.py (also against the
    sequential greedy in numpy) and the top-512 candidates of each bins
    scene and of the template, each launched twice; kept sets exact. Then
    the kernel's event-timed ms, the plain version's and the bound at the
    main path's input (frame t=1.0's candidates); its device ms comes after
    the main path (phase_bins_device)."""
    sys.path.insert(0, str(REPO / "tests"))
    from spacing_cases import cases, greedy

    from cuauv_vision_pipeline_tpu_torch.ops.cuda import spacing_select
    from cuauv_vision_pipeline_tpu_torch.ops.cuda.spacing_kernel import spacing_select_plain
    from cuauv_vision_pipeline_tpu_torch.ops.feature import detect_candidates, detect_describe

    inputs = {case: (*(torch.from_numpy(a).to(dev) for a in arrays[:3]), arrays[3])
              for case, arrays in cases().items()}
    for name, gray in bins_grays().items():
        inputs[f"candidates_{name}"] = (*detect_candidates(torch.from_numpy(gray).to(dev)), 8)
    checks = []
    for case, (ys, xs, cand, md) in inputs.items():
        want = spacing_select_plain(ys, xs, cand, md)
        if not case.startswith("candidates_"):
            np.testing.assert_array_equal(want.cpu().numpy(),
                                          greedy(ys.cpu().numpy(), xs.cpu().numpy(), cand.cpu().numpy(), md))
        for rep in range(2):
            got = spacing_select(ys, xs, cand, md)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"spacing_select differs from its plain version on {case} (launch {rep})")
        checks.append(case)
    # large K: a 720p scene's top-2048 and top-4096
    # candidates, and detect_describe at 2048 keypoints keeping the CPU's
    gray = torch.from_numpy(bins_grays()["bins_720p_t1.0"]).to(dev)
    for K in SPACING_LARGE_K:
        inputs[f"candidates_bins_720p_t1.0_k{K}"] = (*detect_candidates(gray, max_keypoints=K), 8)
        ys, xs, cand, md = inputs[f"candidates_bins_720p_t1.0_k{K}"]
        want = spacing_select_plain(ys, xs, cand, md)
        for rep in range(2):
            if not torch.equal(spacing_select(ys, xs, cand, md), want):
                raise AssertionError(f"spacing_select differs from its plain version on the top-{K} (launch {rep})")
        checks.append(f"candidates_bins_720p_t1.0_k{K}")
    kp, _, n = detect_describe(gray, max_keypoints=2048)
    kp_cpu, _, n_cpu = detect_describe(gray.cpu(), max_keypoints=2048)
    describe_2048 = {"n_valid": [int(n), int(n_cpu)], "kp_equal": torch.equal(kp.cpu(), kp_cpu)}
    if not (describe_2048["kp_equal"] and int(n) == int(n_cpu) > 512):
        raise AssertionError(f"detect_describe(max_keypoints=2048) on the card against the CPU: {describe_2048}")

    def timing(key, reps):
        """Event-timed and plain ms and the bound at one input."""
        ys, xs, cand, md = inputs[key]
        kept = spacing_select_plain(ys, xs, cand, md)
        K = cand.numel()
        tests = spacing_work(kept, cand)
        # ys, xs and cand read once, kept written once
        t_bytes = K * (4 + 4 + 1 + 1) / rate * 1e3
        t_ops = tests * SPACING_OPS_PER_TEST / _OPS_RATE * 1e3
        return dict(
            K=K, candidates=int(cand.sum()), kept=int(kept.sum()), distance_tests=tests,
            ms=cuda_ms(lambda: spacing_select(ys, xs, cand, md), reps),
            plain_ms=cuda_ms(lambda: spacing_select_plain(ys, xs, cand, md), 20 if K <= 512 else 5, warmup=2),
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        )

    main = timing("candidates_bins_720p_t1.0", 100)
    large = {K: timing(f"candidates_bins_720p_t1.0_k{K}", 50) for K in SPACING_LARGE_K}
    row = dict(source="cuauv_vision_pipeline_tpu_torch/csrc/spacing.cu",
               replaces="cuauv_vision_pipeline_tpu/ops/feature.py:618",
               library_ms=None, max_abs_err=0, **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    emit("spacing", checks=len(checks), cases=checks, detect_describe_2048=describe_2048, **main,
         large_k={str(K): v for K, v in large.items()})
    return (row, inputs["candidates_bins_720p_t1.0"],
            {K: inputs[f"candidates_bins_720p_t1.0_k{K}"] for K in SPACING_LARGE_K})


def zed_frames(n: int):
    """1080p ZED forward planes of the synthetic camera (numpy BGR u8)."""
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame

    return [buoy_frame((H, W), 0.4 * i) for i in range(n)]


def heads_err(got, want) -> float:
    """Max |difference| of per-scale head maps (card against CPU)."""
    return max((g.cpu() - w).abs().max().item() for key in want for g, w in zip(got[key], want[key]))


@contextlib.contextmanager
def recording_nms(calls: list):
    """Record each NMS call of ``decode`` (its arguments and picks)."""
    from cuauv_vision_pipeline_tpu_torch.models.yolo import decode as decode_mod

    real = decode_mod.nms_fixed_cuda

    def record(*args):
        result = real(*args)
        calls.append((args, result))
        return result

    decode_mod.nms_fixed_cuda = record
    try:
        yield
    finally:
        decode_mod.nms_fixed_cuda = real


@contextlib.contextmanager
def tf32_allowed():
    """The f32 mode's forward with TF32 left on (the negative control of
    the card-vs-CPU check)."""
    from cuauv_vision_pipeline_tpu_torch.models.yolo import predictor

    real = predictor.full_f32
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    predictor.full_f32 = contextlib.nullcontext
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        predictor.full_f32 = real
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def decode_card_and_cpu(model, heads):
    """The card's f32 head maps decoded on the card and on the CPU, in
    decode's two halves. The elementwise half (DFL, boxes, sigmoid) rounds
    differently on the two devices: its largest differences. The selection
    half (stable-sort pool, gathers, NMS) given the card's own candidates:
    whether valid, cls, picked, score and xyxy are equal. And whether the
    whole decode on the CPU picks as the card does."""
    from cuauv_vision_pipeline_tpu_torch.models.yolo.decode import candidates, select
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda

    def cpu(xs):
        return [None if x is None else x.cpu() for x in xs]

    kw = dict(iou_thresh=0.45, max_det=model.max_det, nms_pool=model.nms_pool)
    before = nms_fixed_cuda.launches  # a comparison, not the main path's launch
    calls: list = []
    with torch.inference_mode(), recording_nms(calls):
        card = candidates(heads, model.model.reg_max, model.conf_thresh)
        host = candidates({k: cpu(v) for k, v in heads.items()}, model.model.reg_max, model.conf_thresh)
        got = select(*card, model.image_size, **kw)
        want = select(*cpu(card), model.image_size, **kw)
        whole = select(*host, model.image_size, **kw)
    nms_fixed_cuda.launches = before
    (_, got_picks), (_, want_picks), (_, whole_picks) = calls
    out = {
        "score_max_abs_err": (card[2].cpu() - host[2]).abs().max().item(),
        "box_max_abs_err": (card[0].cpu() - host[0]).abs().max().item(),
        "angle_max_abs_err": 0.0 if card[1] is None else (card[1].cpu() - host[1]).abs().max().item(),
        "picked": torch.equal(got_picks[0].cpu(), want_picks[0]),
        **{key: torch.equal(got[key].cpu(), want[key]) for key in got},
        "whole_decode_picked": torch.equal(got_picks[0].cpu(), whole_picks[0]),
    }
    return out


# card-vs-CPU float32 head maps: a few times this card's measured
# differences (random init's values are ~1e-3, the fixture's logits ~1-10);
# TF32 left on moves them past both, as the control in phase_yolo shows
HEADS_ATOL = {"random_init": 1e-7, "fixture": 5e-5}
# decode's elementwise half on the card against the CPU, from the same maps:
# a few float32 ulps of a score near 0.5, of a coordinate near 640 px and
# of an angle
CANDIDATE_ATOL = {"score_max_abs_err": 1e-6, "box_max_abs_err": 1e-3, "angle_max_abs_err": 1e-6}


def phase_yolo(dev):
    """The YOLO-OBB serving path at full width. (a) float32 on the card
    (TF32 off) against the port's float32 CPU path on the same seeded
    weights: head maps within HEADS_ATOL, decoded valid equal (random
    init's pool scores lie within rounding of each other, so its picks are
    held below on the card's own maps); the trained fixture's head maps
    and decoded valid/cls likewise; each model's card head maps decoded on
    the card and on the CPU: decode's elementwise half within
    CANDIDATE_ATOL, its selection half (pool, gathers, NMS) on the card's
    own candidates with valid, cls, picked, score and boxes equal, and for
    the fixture the whole CPU decode picking the same; and the control:
    the same maps with TF32 on must fail HEADS_ATOL. (b) The
    trained detect fixture served in bf16 on the card: recall and precision
    >= 0.75 over 24 scenes (seed 77). (c) The serving model's event-timed
    ms per 1080p frame, per-frame fps over five windows, wrapper calls per
    frame; and the NMS pool of one real frame, kept for the kernel's timing
    after the main path."""
    from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
    from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import (
        match_detections,
        render_obb_scene,
        render_scene,
    )

    out = {}
    rng = np.random.default_rng(5)
    frames = {"zed_1080p": zed_frames(1)[0],
              **{f"obb_scene_{i}": render_obb_scene(rng, size=640)[0] for i in range(2)}}
    rng = np.random.default_rng(77)
    scenes = {f"fixture_scene_{i}": render_scene(rng, size=128, max_objects=3)[0] for i in range(4)}
    fixture = dict(image_size=128, max_det=8, conf_thresh=0.25)
    agree, failures = {}, []
    for kind, weight, kw, inputs in (
        ("random_init", None, dict(task="obb"), frames),
        ("fixture", str(YOLO_FIXTURE), fixture, scenes),
    ):
        card = YoloModel(weight, half_precision=False, device=dev, **kw)
        host = YoloModel(weight, half_precision=False, device="cpu", **kw)
        for name, frame in inputs.items():
            image = torch.from_numpy(frame)
            want_heads = host.head_outputs(image[None])
            card_heads = card.head_outputs(image.to(dev)[None])
            got, want = card.device_decode(frame), host.device_decode(frame)
            row = {"heads_max_abs_err": heads_err(card_heads, want_heads),
                   "valid": int(want["valid"].sum()),
                   "decoded_valid_equal": torch.equal(got["valid"].cpu(), want["valid"]),
                   "decoded_cls_equal": torch.equal(got["cls"].cpu(), want["cls"]),
                   "card_maps_decoded_on_cpu": decode_card_and_cpu(card, card_heads)}
            if name in ("zed_1080p", "fixture_scene_0"):
                with tf32_allowed():
                    row["tf32_on_heads_max_abs_err"] = heads_err(card.head_outputs(image.to(dev)[None]),
                                                                 want_heads)
                if not row["tf32_on_heads_max_abs_err"] > HEADS_ATOL[kind]:
                    failures.append(f"{name}: TF32 on stays within {HEADS_ATOL[kind]}")
            if not row["heads_max_abs_err"] <= HEADS_ATOL[kind]:
                failures.append(f"{name}: head maps differ past {HEADS_ATOL[kind]}")
            checked = ("decoded_valid_equal", "decoded_cls_equal") if kind == "fixture" else ("decoded_valid_equal",)
            failures += [f"{name}: {key} is false" for key in checked if not row[key]]
            both = row["card_maps_decoded_on_cpu"]
            failures += [f"{name}: card candidates selected on the CPU: {key} differs"
                         for key in ("valid", "cls", "picked", "score", "xyxy", "angle") if not both.get(key, True)]
            failures += [f"{name}: card maps: {key} {both[key]} past {limit}"
                         for key, limit in CANDIDATE_ATOL.items() if not both[key] <= limit]
            if kind == "fixture" and not both["whole_decode_picked"]:
                failures.append(f"{name}: card maps decoded on the CPU pick otherwise")
            agree[name] = row
    out["f32_card_vs_cpu"] = agree
    if failures:
        emit("yolo_f32", heads_atol=HEADS_ATOL, **agree)
        raise AssertionError("f32 card vs CPU: " + "; ".join(failures))

    model = YoloModel(str(YOLO_FIXTURE), device=dev, **fixture)
    rng = np.random.default_rng(77)
    tp = n_gt = n_pred = 0
    for _ in range(24):
        img, boxes, cls = render_scene(rng, size=128, max_objects=3)
        decoded = {k: v.cpu().numpy() for k, v in model.device_decode(img).items()}
        t, g, p_ = match_detections(decoded, boxes, cls)
        tp, n_gt, n_pred = tp + t, n_gt + g, n_pred + p_
    out["fixture_bf16"] = {"recall": tp / max(n_gt, 1), "precision": tp / max(n_pred, 1),
                           "tp": tp, "n_gt": n_gt, "n_pred": n_pred}
    if not (tp / max(n_gt, 1) >= 0.75 and tp / max(n_pred, 1) >= 0.75):
        raise AssertionError(f"trained fixture in bf16 on the card: {out['fixture_bf16']}")

    serve = YoloModel(None, task="obb", device=dev)
    images = [torch.from_numpy(f).to(dev) for f in zed_frames(4)]
    calls: list = []
    with recording_nms(calls):
        decoded = serve.device_decode(images[0])
    pools = [args for args, _ in calls]
    out["serving"] = {"model": "YOLOv8n-obb, 15 classes, 640, bf16, seeded random init",
                      "parameters": sum(p.numel() for p in serve.model.parameters()),
                      "valid": int(decoded["valid"].sum()),
                      "above_threshold": int((pools[0][1] > 0).sum())}
    out["device_decode_ms"] = cuda_ms(lambda: serve.device_decode(images[0]), 50)
    rates, calls = [], None
    for _ in range(FPS_REPEATS):
        rate, calls = fps_window(lambda k: serve.device_decode(images[k % 4]), 1, FPS_WINDOW_S)
        rates.append(rate)
    out["fps_per_frame"] = {"median": statistics.median(rates), "min": min(rates), "max": max(rates),
                            "windows": rates}
    out["wrapper_calls_per_frame"] = calls
    emit("yolo", **out)
    return serve, images[0], pools[0]


def profile_fn(fn, n: int = 20) -> dict:
    """Device ms and CUDA kernels per call of ``fn`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then holds no kernel event: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if events:
            break
    else:
        raise RuntimeError("torch.profiler recorded no kernel event in three traces")
    by_name: dict = {}
    for e in events:
        by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + e.self_device_time_total / 1e3 / n
    return {"device_ms": sum(by_name.values()), "kernels": sum(e.count for e in events) / n,
            "top_device_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


def nms_work(boxes, scores, classes, angles, iou_thresh, max_det):
    """What greedy NMS must compute on this pool, counted on its plain
    version's rounds: (rounds run, alive candidates scanned, IoUs). Each
    round scans the alive candidates for the best score and their classes,
    and needs the IoU of the alive candidates of the best one's class."""
    from cuauv_vision_pipeline_tpu_torch.ops.cuda.nms_kernel import (
        _aabb_rows,
        _nms_geometry,
        _probiou_rows,
    )

    g = _nms_geometry(boxes, angles)
    rows = _probiou_rows if angles is not None else _aabb_rows
    lanes = torch.arange(scores.shape[0], device=scores.device)
    alive = scores.clone()
    rounds = scanned = ious = 0
    for _ in range(max_det):
        best = torch.argmax(alive, dim=1)
        ok = alive[lanes, best] > 0.0
        live = (alive > 0.0) & ok[:, None]
        if not ok.any():
            break
        same = live & (classes == classes[lanes, best][:, None])
        rounds, scanned, ious = rounds + 1, scanned + int(live.sum()), ious + int(same.sum() - ok.sum())
        suppress = (rows(g, best) >= iou_thresh) & (classes == classes[lanes, best][:, None])
        suppress[lanes, best] = True
        alive = torch.where(suppress & ok[:, None], 0.0, alive)
    return rounds, scanned, ious


def phase_yolo_device(serve, image, pool, rate):
    """Where a 1080p frame's device time goes on the YOLO path (profiled
    after the main path): the letterbox, +conv stack, the whole
    device_decode, and the NMS kernel alone on the frame's own pool
    (:func:`nms_timing`, held against its plain version there too) for the
    kernels line."""
    from cuauv_vision_pipeline_tpu_torch.models.yolo.model import preprocess_fused
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda

    timing = nms_timing(pool, rate, plain_reps=20)
    wall = cuda_ms(lambda: serve.device_decode(image), 50)
    stages = {
        "preprocess": profile_fn(lambda: preprocess_fused(image[None], serve.image_size)),
        "preprocess_and_convs": profile_fn(lambda: serve.head_outputs(image[None])),
        "device_decode": profile_fn(lambda: serve.device_decode(image)),
        "nms_fixed": profile_fn(lambda: nms_fixed_cuda(*pool)),
        # max_det 1: the first pass and the first chunk, the rest is the
        # walk to the last pick
        "nms_fixed_one_round": profile_fn(lambda: nms_fixed_cuda(*pool[:5], 1)),
    }
    whole = stages["device_decode"]["device_ms"]
    split = {
        "preprocess": stages["preprocess"]["device_ms"],
        "conv_stack": stages["preprocess_and_convs"]["device_ms"] - stages["preprocess"]["device_ms"],
        "nms_fixed": stages["nms_fixed"]["device_ms"],
    }
    split["decode"] = whole - stages["preprocess_and_convs"]["device_ms"] - split["nms_fixed"]
    row = dict(
        source="cuauv_vision_pipeline_tpu_torch/csrc/nms.cu",
        replaces="cuauv_vision_pipeline_tpu/models/yolo/decode.py:150",
        ms=timing["ms"], plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=None, max_abs_err=0,
    )
    # per launch: a trace may hold fewer kernel events than calls
    per_launch = {k: stages[k]["device_ms"] / stages[k]["kernels"] for k in ("nms_fixed", "nms_fixed_one_round")}
    extra_us = (per_launch["nms_fixed"] - per_launch["nms_fixed_one_round"]) / max(timing["picks"] - 1, 1) * 1e3
    emit("yolo_device", wall_ms_per_frame=wall, device_ms_per_frame=whole,
         device_idle_share=1 - whole / wall, kernels_per_frame=stages["device_decode"]["kernels"],
         split_device_ms=split, stages=stages, nms=timing,
         nms_device_ms_per_launch=per_launch, nms_us_per_pick_after_the_first=extra_us)
    return row


def bins_plate(t: float):
    """Top-left corner (x0, y0) and size (w, h) of the plate in bins_frame."""
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import bin_texture

    th, tw = bin_texture().shape[:2]
    y0 = int((BINS_H - th) * (0.5 + 0.35 * np.sin(t * 0.5)))
    x0 = int((BINS_W - tw) * (0.5 + 0.35 * np.cos(t * 0.7)))
    return x0, y0, tw, th


def plate_error(g, t: float) -> float:
    """Largest distance (px) of the pose quad's first and third corners from
    the plate's (the JAX test's check), from a bins_pose reading."""
    x0, y0, tw, th = bins_plate(t)
    return max(abs(g.quad_x1 - x0), abs(g.quad_y1 - y0), abs(g.quad_x3 - (x0 + tw)), abs(g.quad_y3 - (y0 + th)))


def bin_detectors(dev):
    """BinDetector with the builtin pose template on the card and on the
    CPU (the template described on each device)."""
    from cuauv_vision_pipeline_tpu_torch.modules.bins import BinDetector

    os.environ["CUAUV_BINS_POSE_TEMPLATE"] = "builtin"
    try:
        card = BinDetector(video_sources=["forward"], tuners=[], argv=["--device", str(dev.index or 0)])
        host = BinDetector(video_sources=["forward"], tuners=[], argv=["--device", "cpu"])
    finally:
        del os.environ["CUAUV_BINS_POSE_TEMPLATE"]
    return card, host


def valid_rects(cleaned):
    """The host leg's rectangles (BinDetector.on_device_result's filter)."""
    from cuauv_vision_pipeline_tpu_torch.utils.feature import min_enclosing_rect, outer_contours

    out = []
    for contour in outer_contours(cleaned):
        (_, (w, h), _) = rect = min_enclosing_rect(contour)
        if w * h >= 500 and min(w, h) > 0 and 1.0 <= max(w, h) / min(w, h) <= 3.0:
            out.append(rect)
    return out


def host_syncs(fn) -> list:
    """The synchronising CUDA calls torch reports during ``fn()`` (its sync
    debug mode; setting the mode itself warns that it is a prototype)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message)[:200] for w in caught if "called a synchronizing" in str(w.message)]


def host_ms(fn, reps: int = 20) -> float:
    """Median host-clock ms of ``fn()``."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_bins(dev):
    """The bins + pose path (BASELINE config 3) at full width: BinDetector's
    device chain on the card against the same chain on the CPU on four 720p
    bins scenes: cleaned mask and overlay exact, n_valid and keypoints
    equal, the Shi-Tomasi response's difference reported (its last four
    operations round on each device), descriptor rows past BINS_DES_ATOL
    counted (an atan2 ulp can flip
    a dominant-orientation bin), the pose quad within BINS_QUAD_PX and
    matches/inliers within BINS_MATCH_SLACK; the host leg on the card's
    fetch writes shm.bins_pose visible with >= 8 inliers within
    BINS_PLATE_PX of the plate; the chain on the card synchronises nowhere
    (torch's sync debug mode). Then the chain's event-timed wall ms, fps
    over five 2 s windows, wrapper calls per frame, and the host leg's ms
    (contours + rectangles; ratio test + RANSAC)."""
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import bins_frame
    from cuauv_vision_pipeline_tpu_torch.core import shm
    from cuauv_vision_pipeline_tpu_torch.core.base import DeviceResultMeta
    from cuauv_vision_pipeline_tpu_torch.ops.color import bgr_to_gray
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import spacing_select
    from cuauv_vision_pipeline_tpu_torch.ops.feature import detect_describe, min_eigenvalue_map

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for matrix products before the bins phase")
    card, host = bin_detectors(dev)
    card.post = lambda name, image, color_space="BGR": None
    nq = card._pose_sift.sources["bin"]["des_prep"][1]
    frames = {t: bins_frame((BINS_H, BINS_W), t) for t in BINS_TS}
    images = [torch.from_numpy(f).to(dev) for f in frames.values()]
    out = {"template_keypoints": nq,
           "template_kp_equal": bool(np.array_equal(card._pose_sift.sources["bin"]["kp"],
                                                    host._pose_sift.sources["bin"]["kp"]))}
    failures = [] if out["template_kp_equal"] else ["template keypoints differ card vs CPU"]
    rows = {}
    for (t, frame), img in zip(frames.items(), images):
        r, p = card.bins_chain(img, tuners={}, want_posts=True)
        r = {k: v.cpu().numpy() for k, v in r.items()}
        p = {k: v.cpu().numpy() for k, v in p.items()}
        hr, hp = host.bins_chain(torch.from_numpy(frame), tuners={}, want_posts=True)
        hr = {k: v.numpy() for k, v in hr.items()}
        hp = {k: v.numpy() for k, v in hp.items()}
        # descriptors, from the chain's own detect_describe on each device (a
        # comparison: its spacing launch is not the main path's)
        before = spacing_select.launches
        gray = bgr_to_gray(img)
        _, des_c, n_c = detect_describe(gray)
        _, des_h, n_h = detect_describe(gray.cpu())
        spacing_select.launches = before
        row_err = (des_c.cpu() - des_h).abs().max(dim=1).values
        resp_err = (min_eigenvalue_map(gray).cpu() - min_eigenvalue_map(gray.cpu())).abs()
        got = card._pose_sift.match_device_topk("bin", r["pose_d2"], r["pose_idx"], r["kp"], min_match=8)
        want = host._pose_sift.match_device_topk("bin", hr["pose_d2"], hr["pose_idx"], hr["kp"], min_match=8)
        meta = DeviceResultMeta(aliases=("forward",), acquisition_time=int(time.monotonic() * 1000),
                                submit_time=time.monotonic())
        card.on_device_result(r, {k: v.copy() for k, v in p.items()}, meta)  # it draws on the overlay
        pose = shm.bins_pose.get()
        row = {
            "cleaned_equal": bool(np.array_equal(r["cleaned"], hr["cleaned"])),
            "overlay_pixels_differing": int((p["overlay"] != hp["overlay"]).sum()),
            "n_valid": [int(n_c), int(n_h)],
            "kp_equal": bool(np.array_equal(r["kp"], hr["kp"])),
            "resp_max_abs_err": float(resp_err.max()),
            "resp_pixels_differing": int((resp_err > 0).sum()),
            "des_max_abs_err": float(row_err.max()),
            "des_rows_past_atol": int((row_err > BINS_DES_ATOL).sum()),
            "pose_idx_differing": int((r["pose_idx"][:nq] != hr["pose_idx"][:nq]).sum()),
            "pose_d2_max_abs_err": float(np.abs(r["pose_d2"][:nq] - hr["pose_d2"][:nq]).max()),
            "quad": got[0]["quad"].tolist() if got else None,
            "cpu_quad": want[0]["quad"].tolist() if want else None,
            "matches": [got[0]["matches"] if got else 0, want[0]["matches"] if want else 0],
            "inliers": [got[0]["inliers"] if got else 0, want[0]["inliers"] if want else 0],
            "shm_visible": bool(pose.visible), "shm_inliers": int(pose.inliers),
            "shm_plate_err_px": plate_error(pose, t),
        }
        name = f"t{t}"
        failures += [f"{name}: {key} is false" for key in ("cleaned_equal", "kp_equal") if not row[key]]
        if row["overlay_pixels_differing"]:
            failures.append(f"{name}: overlay differs in {row['overlay_pixels_differing']} pixels")
        if row["n_valid"][0] != row["n_valid"][1]:
            failures.append(f"{name}: n_valid {row['n_valid']}")
        if row["des_rows_past_atol"] > 0.1 * row["n_valid"][1]:
            failures.append(f"{name}: {row['des_rows_past_atol']} descriptor rows past {BINS_DES_ATOL}")
        if not (got and want):
            failures.append(f"{name}: no pose (card {len(got)}, CPU {len(want)})")
        else:
            if np.abs(np.asarray(row["quad"]) - np.asarray(row["cpu_quad"])).max() > BINS_QUAD_PX:
                failures.append(f"{name}: quad {row['quad']} against the CPU's {row['cpu_quad']}")
            for key in ("matches", "inliers"):
                if abs(row[key][0] - row[key][1]) > BINS_MATCH_SLACK:
                    failures.append(f"{name}: {key} {row[key]}")
        if not (row["shm_visible"] and row["shm_inliers"] >= 8 and row["shm_plate_err_px"] < BINS_PLATE_PX):
            failures.append(f"{name}: shm.bins_pose {row['shm_visible']}, {row['shm_inliers']} inliers, "
                            f"{row['shm_plate_err_px']} px from the plate")
        rows[name] = row
    out["card_vs_cpu"] = rows
    # the chain on the card waits for the host nowhere (the spacing selection
    # included): torch warns at every call that synchronises; a read of one
    # value is the control that the warning comes
    syncs = host_syncs(lambda: card.bins_chain(images[1], tuners={}, want_posts=True))
    out["chain_host_syncs"] = len(syncs)
    out["control_host_syncs"] = len(host_syncs(lambda: images[1].sum().item()))
    if syncs or not out["control_host_syncs"]:
        failures.append(f"the chain synchronised {len(syncs)} times: {syncs} "
                        f"(the control: {out['control_host_syncs']})")
    if failures:
        emit("bins_checks", **out)
        raise AssertionError("bins path: " + "; ".join(failures))

    def chain(k):
        return card.bins_chain(images[k % len(images)], tuners={}, want_posts=True)

    out["wall_ms_per_frame"] = cuda_ms(lambda: chain(1), 50)
    rates, calls = [], None
    for _ in range(FPS_REPEATS):
        rate, calls = fps_window(chain, 1, FPS_WINDOW_S)
        rates.append(rate)
    out["fps_per_frame"] = {"median": statistics.median(rates), "min": min(rates), "max": max(rates),
                            "windows": rates}
    out["wrapper_calls_per_frame"] = calls
    r, _ = chain(1)
    fetched = {k: v.cpu().numpy() for k, v in r.items()}
    out["host_ms"] = {
        "contours_and_rects": host_ms(lambda: valid_rects(fetched["cleaned"])),
        "ratio_test_and_ransac": host_ms(lambda: card._pose_sift.match_device_topk(
            "bin", fetched["pose_d2"], fetched["pose_idx"], fetched["kp"], min_match=8)),
    }
    emit("bins", **out)
    return card, images[1], out["wall_ms_per_frame"]


def phase_bins_device(card, img, wall_ms, spacing_input, spacing_large):
    """Where a 720p frame's device time goes on the bins path (profiled
    after the main path), stage by stage on the chain's own intermediates,
    and the whole chain: device ms, CUDA kernels per frame, idle share
    against the unprofiled event-timed wall ms; the spacing kernel's device
    ms at the main path's input and at the scene's top-2048 and top-4096
    (two launches per call: the conflict fill and the fixpoint)."""
    from cuauv_vision_pipeline_tpu_torch.modules.bins import _beige_bounds
    from cuauv_vision_pipeline_tpu_torch.ops.color import bgr_to_gray, bgr_to_hsv
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import fused_morph, spacing_select
    from cuauv_vision_pipeline_tpu_torch.ops.feature import (
        describe_at,
        detect_candidates,
        detect_describe,
        min_eigenvalue_map,
    )
    from cuauv_vision_pipeline_tpu_torch.ops.threshold import in_range
    from cuauv_vision_pipeline_tpu_torch.utils.sift import device_match_topk

    F = torch.nn.functional
    bounds = _beige_bounds(img.device)
    mask = in_range(bgr_to_hsv(img), *bounds)
    gray = bgr_to_gray(img)
    resp = min_eigenvalue_map(gray)
    ys, xs, cand = detect_candidates(gray)
    _, des, n = detect_describe(gray)
    prep = card._pose_sift.sources["bin"]["des_prep"]

    def window_nms():
        mx = F.max_pool2d(resp[None, None], (17, 1), stride=1, padding=(8, 0))
        return F.max_pool2d(mx, (1, 17), stride=1, padding=(0, 8))

    stages = {
        "hsv_inrange": profile_fn(lambda: in_range(bgr_to_hsv(img), *bounds)),
        "fused_morph_open": profile_fn(lambda: fused_morph(mask, "open")),
        "gray_sobel_response": profile_fn(lambda: min_eigenvalue_map(bgr_to_gray(img))),
        "response": profile_fn(lambda: min_eigenvalue_map(gray)),
        "window_nms": profile_fn(window_nms),
        "candidates": profile_fn(lambda: detect_candidates(gray)),
        "spacing": profile_fn(lambda: spacing_select(ys, xs, cand, 8)),
        "describe_at": profile_fn(lambda: describe_at(gray, ys, xs, oriented=True)),
        "match_2nn": profile_fn(lambda: device_match_topk(prep, des, n)),
        "overlay": profile_fn(lambda: (img.float() * 0.7 + mask[..., None].float() * 0.3).to(torch.uint8)),
        "chain": profile_fn(lambda: card.bins_chain(img, tuners={}, want_posts=True)),
    }
    split = {key: stages[key]["device_ms"] for key in
             ("hsv_inrange", "fused_morph_open", "gray_sobel_response", "window_nms", "spacing",
              "describe_at", "match_2nn", "overlay")}
    split["peaks_and_topk"] = (stages["candidates"]["device_ms"] - stages["response"]["device_ms"]
                               - stages["window_nms"]["device_ms"])
    whole = stages["chain"]["device_ms"]
    sp_ys, sp_xs, sp_cand, sp_md = spacing_input
    spacing_dev, spacing_by_kernel = device_ms(lambda: spacing_select(sp_ys, sp_xs, sp_cand, sp_md))
    spacing_large_dev = {str(K): profile_fn(lambda args=args: spacing_select(*args))
                         for K, args in spacing_large.items()}
    emit("bins_device", wall_ms_per_frame=wall_ms, device_ms_per_frame=whole,
         device_idle_share=1 - whole / wall_ms, kernels_per_frame=stages["chain"]["kernels"],
         split_device_ms=split, stages=stages, spacing_device_ms=spacing_dev,
         spacing_device_ms_by_kernel=spacing_by_kernel, spacing_large_k_device=spacing_large_dev)


STEREO_TS = (0.4, 1.2)  # the two eyes' frames (buoy scene times)
STEREO_THRESHOLDS = ((140, 255), (0, 255))
# config 5's cameras: the ZED's HD720 forward eye and the FLIR
MULTICAM_HW = ((720, 1280), (600, 800))
MULTICAM_TS = (0.4, 1.0)
# a camera's lane of the batch-2 dispatch against that camera decoded alone,
# both float32 on the card (TF32 off): cuDNN may pick another algorithm at
# batch 2, moving head maps by float32 rounding; picks must not move
MULTI_ALONE_ATOL = {"score": 1e-4, "xyxy": 1e-2}


def stereo_tuners(tmin: int, tmax: int) -> dict:
    return {"thresh_min": np.int32(tmin), "thresh_max": np.int32(tmax)}


def phase_stereo(dev):
    """The stereo red_buoy path (BuoyStereo.stereo_chain, both ZED eyes in
    one dispatch) on two 1080p planes at the disc threshold and the whole
    frame: card against CPU, masks and cleaned masks exact, found and area
    exact, centroid within 1e-3 px; one label_cuda_batched and one
    fused_morph launch per call; no host sync in the chain (torch's sync
    debug mode, with a one-value read as the control). Then event-timed
    wall ms per call and fps (frames = 2 per call) over five 2 s windows;
    the device profile comes after the main path (phase_stereo_device)."""
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
    from cuauv_vision_pipeline_tpu_torch.modules.red_buoy_stereo import BuoyStereo
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import launch_counts

    eyes = [buoy_frame((H, W), t) for t in STEREO_TS]
    card_in = [torch.from_numpy(f).to(dev) for f in eyes]
    host_in = [torch.from_numpy(f) for f in eyes]

    def chain(frames, tmin=140, tmax=255, posts=True):
        return BuoyStereo.stereo_chain(None, *frames, tuners=stereo_tuners(tmin, tmax), want_posts=posts)

    out, failures = {}, []
    for tmin, tmax in STEREO_THRESHOLDS:
        before = launch_counts()
        got, got_posts = chain(card_in, tmin, tmax)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        want, want_posts = chain(host_in, tmin, tmax)
        row = {"launches": launched,
               **{f"{key}_equal": torch.equal(got_posts[key].cpu(), want_posts[key]) for key in want_posts},
               "found": got["found"].cpu().tolist(), "cpu_found": want["found"].tolist(),
               "area": got["area"].cpu().tolist(), "cpu_area": want["area"].tolist(),
               "centroid_max_abs_err": float((got["centroid"].cpu() - want["centroid"]).abs().max())}
        name = f"thresh_{tmin}_{tmax}"
        failures += [f"{name}: {key} is false" for key in row if key.endswith("_equal") and not row[key]]
        if row["found"] != row["cpu_found"] or row["area"] != row["cpu_area"]:
            failures.append(f"{name}: found/area {row['found']}/{row['area']} against {row['cpu_found']}/{row['cpu_area']}")
        if not row["centroid_max_abs_err"] <= 1e-3:
            failures.append(f"{name}: centroid off by {row['centroid_max_abs_err']}")
        if launched != {"label_cuda_batched": 1, "fused_morph": 1}:
            failures.append(f"{name}: launches per call {launched}")
        if not all(row["found"]):
            failures.append(f"{name}: an eye found nothing")
        out[name] = row
    syncs = host_syncs(lambda: chain(card_in))
    out["chain_host_syncs"] = len(syncs)
    out["control_host_syncs"] = len(host_syncs(lambda: card_in[0].sum().item()))
    if syncs or not out["control_host_syncs"]:
        failures.append(f"the chain synchronised {len(syncs)} times: {syncs} (the control: {out['control_host_syncs']})")
    if failures:
        emit("stereo_checks", **out)
        raise AssertionError("stereo path: " + "; ".join(failures))
    out["wall_ms_per_call"] = cuda_ms(lambda: chain(card_in), 50)
    rates, calls = [], None
    for _ in range(FPS_REPEATS):
        rate, calls = fps_window(lambda k: chain(card_in), 2, FPS_WINDOW_S)
        rates.append(rate)
    out["fps_frames"] = {"median": statistics.median(rates), "min": min(rates), "max": max(rates), "windows": rates}
    out["wrapper_calls_per_frame"] = calls
    emit("stereo", **out)
    return card_in, out["wall_ms_per_call"]


def phase_stereo_device(card_in, wall_ms):
    """After the main path: the stereo kernels on the chain's own [2, H, W]
    masks held exactly against their plain versions, and where a call's
    device time goes
    (torch.profiler): the whole chain, label_cuda_batched and fused_morph
    alone; idle share against the unprofiled wall ms."""
    from cuauv_vision_pipeline_tpu_torch.engine.chains import red_buoy_fused
    from cuauv_vision_pipeline_tpu_torch.modules.red_buoy_stereo import BuoyStereo
    from cuauv_vision_pipeline_tpu_torch.ops.ccl import label
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import label_cuda_batched
    from cuauv_vision_pipeline_tpu_torch.ops.cuda.morph_kernel import fused_morph, fused_morph_plain

    masks = red_buoy_fused(torch.stack(card_in), 140, 255)[0]
    exact = {"label_cuda_batched": torch.equal(label_cuda_batched(masks), label(masks)),
             "fused_morph": torch.equal(fused_morph(masks, "open_close"), fused_morph_plain(masks, "open_close"))}
    if not all(exact.values()):
        raise AssertionError(f"stereo masks [2, H, W]: kernel against plain {exact}")
    stages = {
        "chain": profile_fn(lambda: BuoyStereo.stereo_chain(None, *card_in, tuners=stereo_tuners(140, 255),
                                                            want_posts=True)),
        "label_cuda_batched_b2": profile_fn(lambda: label_cuda_batched(masks)),
        "fused_morph_b2": profile_fn(lambda: fused_morph(masks, "open_close")),
    }
    whole = stages["chain"]["device_ms"]
    emit("stereo_device", wall_ms_per_call=wall_ms, device_ms_per_call=whole, device_idle_share=1 - whole / wall_ms,
         kernels_per_call=stages["chain"]["kernels"], exact_against_plain=exact, stages=stages,
         label_cuda_batched_b2_ms=cuda_ms(lambda: label_cuda_batched(masks), 100),
         fused_morph_b2_ms=cuda_ms(lambda: fused_morph(masks, "open_close"), 100))


def fixture_camera(rng, hw):
    """A scene the trained detect fixture knows (render_scene at the
    camera's height), widened with its edge columns to the camera's size."""
    from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import render_scene

    h, w = hw
    scene = render_scene(rng, size=h, max_objects=3)[0]
    pad = (w - h) // 2
    return np.pad(scene, ((0, 0), (pad, w - h - pad), (0, 0)), mode="edge")


def per_camera(heads, i):
    """Camera i's slice of batched head maps."""
    return {k: [m[i:i + 1] for m in v] for k, v in heads.items()}


def phase_multicam(dev):
    """Config 5's two cameras (zed 1280x720 + flir 800x600) through
    YoloModel.device_decode_multi: one letterbox per camera, one conv stack
    at batch 2, one decode, one NMS launch. (a) float32 (TF32 off), the
    trained detect fixture on scenes it knows and the seeded YOLOv8n-obb on
    the buoy scene: the batch-2 head maps against each camera's CPU head
    maps within HEADS_ATOL; each camera's lane against that camera decoded
    alone: for the fixture valid and cls equal, score and boxes within
    MULTI_ALONE_ATOL, for random init (pool scores within rounding of each
    other) valid equal. (b) The serving model (bf16): exactly one nms_fixed
    launch per dispatch, at B = 2; the cross-camera merge of its [2, 32, 6]
    detections on the card equal to the merge on the CPU (the plain NMS);
    event-timed ms per dispatch of two cameras, fps over five 2 s windows,
    and the merge's ms."""
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
    from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
    from cuauv_vision_pipeline_tpu_torch.modules.yolo_multicam import _camera_dets
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda
    from cuauv_vision_pipeline_tpu_torch.parallel.crosscam import cross_camera_nms

    rng = np.random.default_rng(31)
    scenes = {"fixture": [fixture_camera(rng, hw) for hw in MULTICAM_HW],
              "random_init": [buoy_frame(hw, t) for hw, t in zip(MULTICAM_HW, MULTICAM_TS)]}
    fixture = dict(image_size=128, max_det=8, conf_thresh=0.25)
    out, failures = {}, []
    for kind, weight, kw in (("fixture", str(YOLO_FIXTURE), fixture), ("random_init", None, dict(task="obb"))):
        card = YoloModel(weight, half_precision=False, device=dev, **kw)
        host = YoloModel(weight, half_precision=False, device="cpu", **kw)
        cams = [torch.from_numpy(c).to(dev) for c in scenes[kind]]
        heads = card.head_outputs_multi(cams)
        err = max(heads_err(per_camera(heads, i), host.head_outputs(torch.from_numpy(c)[None]))
                  for i, c in enumerate(scenes[kind]))
        before = nms_fixed_cuda.launches
        multi = card.device_decode_multi(cams)
        nms = nms_fixed_cuda.launches - before
        row = {"heads_max_abs_err": err, "nms_launches_per_dispatch": nms,
               "valid": multi["valid"].sum(1).tolist()}
        for i, cam in enumerate(cams):
            alone = card.device_decode(cam)
            row[f"cam{i}_valid_equal"] = torch.equal(multi["valid"][i], alone["valid"])
            row[f"cam{i}_cls_equal"] = torch.equal(multi["cls"][i], alone["cls"])
            for key in MULTI_ALONE_ATOL:
                row[f"cam{i}_{key}_max_abs_err"] = float((multi[key][i] - alone[key]).abs().max())
            checked = ("valid", "cls") if kind == "fixture" else ("valid",)
            failures += [f"{kind} cam{i}: {k} differs from the camera alone" for k in checked
                         if not row[f"cam{i}_{k}_equal"]]
            if kind == "fixture":
                failures += [f"{kind} cam{i}: {k} off by {row[f'cam{i}_{k}_max_abs_err']}"
                             for k, limit in MULTI_ALONE_ATOL.items() if not row[f"cam{i}_{k}_max_abs_err"] <= limit]
        if not err <= HEADS_ATOL[kind]:
            failures.append(f"{kind}: batch-2 head maps differ from the CPU's past {HEADS_ATOL[kind]}")
        if nms != 1:
            failures.append(f"{kind}: {nms} nms_fixed launches per dispatch")
        if kind == "fixture" and not min(row["valid"]) > 0:
            failures.append(f"fixture: a camera has no detection {row['valid']}")
        out[f"f32_{kind}"] = row
    if failures:
        emit("multicam_checks", heads_atol=HEADS_ATOL, **out)
        raise AssertionError("multicam path: " + "; ".join(failures))

    serve = YoloModel(None, task="obb", device=dev)
    cams = [torch.from_numpy(c).to(dev) for c in scenes["random_init"]]
    calls: list = []
    with recording_nms(calls):
        decoded = serve.device_decode_multi(cams)
    if len(calls) != 1 or calls[0][0][1].shape[0] != 2:
        raise AssertionError(f"serving dispatch: {len(calls)} NMS calls, pools {[c[0][1].shape for c in calls]}")
    pool = calls[0][0]
    dets = _camera_dets(decoded, MULTICAM_HW, serve.image_size)
    merged = cross_camera_nms(dets)
    want = cross_camera_nms(dets.cpu())
    out["merge"] = {"input": list(dets.shape), "kept": int((want[:, 4] > 0).sum()),
                    "equal_to_cpu": torch.equal(merged.cpu(), want)}
    if not out["merge"]["equal_to_cpu"]:
        raise AssertionError("cross_camera_nms on the card differs from its plain version on the CPU")
    out["serving"] = {"model": "YOLOv8n-obb, 15 classes, 640, bf16, seeded random init",
                      "cameras": [list(hw) for hw in MULTICAM_HW],
                      "valid": decoded["valid"].sum(1).tolist(),
                      "above_threshold": (pool[1] > 0).sum(1).tolist()}
    out["wall_ms_per_dispatch"] = cuda_ms(lambda: serve.device_decode_multi(cams), 50)
    out["merge_ms"] = cuda_ms(lambda: cross_camera_nms(dets), 100)
    rates, calls = [], None
    for _ in range(FPS_REPEATS):
        rate, calls = fps_window(lambda k: serve.device_decode_multi(cams), 2, FPS_WINDOW_S)
        rates.append(rate)
    out["fps_frames"] = {"median": statistics.median(rates), "min": min(rates), "max": max(rates), "windows": rates}
    out["wrapper_calls_per_frame"] = calls
    emit("multicam", **out)
    return serve, cams, pool, dets, out["wall_ms_per_dispatch"]


def phase_multicam_device(serve, cams, pool, dets, wall_ms, rate):
    """After the main path: where a two-camera dispatch's device time goes
    (the letterboxes, + the batch-2 conv stack, the whole dispatch), the NMS
    kernel at B = 2 on the dispatch's own pool and the cross-camera merge
    (B = 1, 64 candidates, AABB), each against its plain version, with their
    event-timed ms and bounds (:func:`nms_timing`)."""
    from cuauv_vision_pipeline_tpu_torch.parallel.crosscam import cross_camera_nms

    flat = dets.reshape(-1, 6)
    merge_pool = (flat[None, :, :4].contiguous(), flat[None, :, 4].contiguous(), flat[None, :, 5].to(torch.int32),
                  None, 0.55, 32)
    nms = {name: nms_timing(p, rate) for name, p in (("b2", pool), ("merge", merge_pool))}
    stages = {
        "letterboxes": profile_fn(lambda: [serve._letterbox(c[None]) for c in cams]),
        "letterboxes_and_convs": profile_fn(lambda: serve.head_outputs_multi(cams)),
        "dispatch": profile_fn(lambda: serve.device_decode_multi(cams)),
        "merge": profile_fn(lambda: cross_camera_nms(dets)),
    }
    whole = stages["dispatch"]["device_ms"]
    emit("multicam_device", wall_ms_per_dispatch=wall_ms, device_ms_per_dispatch=whole,
         device_idle_share=1 - whole / wall_ms, kernels_per_dispatch=stages["dispatch"]["kernels"],
         split_device_ms={"letterboxes": stages["letterboxes"]["device_ms"],
                          "conv_stack": stages["letterboxes_and_convs"]["device_ms"] - stages["letterboxes"]["device_ms"],
                          "decode_and_nms": whole - stages["letterboxes_and_convs"]["device_ms"]},
         stages=stages, nms=nms)


GATE_FIXTURE = REPO / "tests" / "fixtures" / "gate_pico_detect.msgpack"
DISC_AREA = (20000, 27000)  # the 1080p buoy disc's pixels at thresh_min 140


# BASELINE config 4: the correction chain at the ZED's HD720 and at 1080p
CORRECTION_TS = (0.3, 1.1, 1.9, 2.7)  # four 720p frames of the buoy scene
CORRECTION_FPS_WINDOW_S = 1.0  # the correction phase's throughput windows
# card against CPU: 1 count, except pixels whose hue lies this close to an
# HSI sector edge (the sector then swaps two channels), at most this share
CORRECTION_EDGE_RAD = 1e-5
CORRECTION_EDGE_SHARE = 1e-4
# what config 4's modules post: preprocessor, color_balance (a pair per
# frame), auto_calibrate
CONFIG4_POSTS = ("preprocessed", "original", "balanced", "calibration view")


def correction_configs():
    from cuauv_vision_pipeline_tpu_torch.ops.balance import BalanceConfig

    return {"rgb_contrast_correct": BalanceConfig(rgb_contrast_correct=True),
            "hsv_contrast_correct": BalanceConfig(hsv_contrast_correct=True),
            "adaptive_cast_correction": BalanceConfig(adaptive_cast_correction=True),
            "blocks_4x3": BalanceConfig(horizontal_blocks=4, vertical_blocks=3)}


def balance_against_cpu(card_out, frame, cfg) -> dict:
    """A balanced frame from the card against ``balance`` on the CPU: the
    largest difference, the pixels off by one count, the pixels off by more
    and those of them farther than CORRECTION_EDGE_RAD from a sector edge
    (the port's hue on the CPU before the HSI stretch)."""
    import math

    from cuauv_vision_pipeline_tpu_torch.ops import balance as B

    host = torch.from_numpy(frame)
    d = (card_out.cpu().to(torch.int32) - B.balance(host, cfg).to(torch.int32)).abs().amax(-1)
    bad = d > 1
    far = bad
    if cfg.hsi_contrast_correct and bool(bad.any()):
        h = B._rgb_to_hsi(*B.corrected_rgb(host, cfg))[0].double()
        h = torch.where(h < 0, h + 2 * math.pi, h)
        third = 2 * math.pi / 3
        far = bad & ((h - torch.round(h / third) * third).abs() >= CORRECTION_EDGE_RAD)
    return {"max_abs_err": int(d.max()), "pixels_off_by_1": int((d == 1).sum()),
            "pixels_off_by_more": int(bad.sum()), "off_by_more_away_from_sector_edges": int(far.sum()),
            "share_off_by_more": float(bad.float().mean())}


def correction_stack(device):
    """The preprocessor (``modules.preprocessor``) with every stage on
    (noise off when ``noise`` is false) on ``device``, a fixed noise seed."""
    import copy

    from cuauv_vision_pipeline_tpu_torch.modules import preprocessor as P

    module = P.Preprocessor(["forward"], copy.deepcopy(P.module_tuners), argv=["--device", str(device)], seed=0)
    values = dict(balance=True, channel_split=8, grayscale=True, bias_r=40, bias_g=-30, bias_b=20,
                  contrast=1.37, brightness=-20, blur_kernel=7, noise_stddev=6.0, erode_kernel=2,
                  dilate_kernel=3, rotate_deg=23.5, resize_factor=0.63, translate_x=7, translate_y=-4)
    for key, value in values.items():
        module._module_manager._tuner_sources[key]._current_value = value
    return module


def phase_correction(dev):
    """BASELINE config 4's device work (``ops/balance.balance``, then the
    preprocessor's stage stack): no hand kernel lies on this path, so none
    may launch. The default config on four 720p buoy frames and one 1080p
    frame, each non-default one once at 720p (RGB contrast, HSV contrast,
    adaptive taper, blocks 4x3), card against CPU within 1 count but for
    sector-edge pixels (at most CORRECTION_EDGE_SHARE); balance never
    synchronises the host (torch's sync debug mode, a one-value read the
    control); the preprocessor's stack with every stage but balance and the
    noise card against CPU, exact. Then balance's event-timed wall ms and fps per
    frame (five windows of CORRECTION_FPS_WINDOW_S) at 720p and 1080p; the
    device profile comes after the main path (phase_correction_device)."""
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
    from cuauv_vision_pipeline_tpu_torch.ops.balance import BalanceConfig, balance
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import launch_counts

    before = launch_counts()
    frames = {"720p": [buoy_frame((BINS_H, BINS_W), t) for t in CORRECTION_TS], "1080p": [buoy_frame((H, W), 0.7)]}
    card = {size: [torch.from_numpy(f).to(dev) for f in fs] for size, fs in frames.items()}
    out, failures = {"checks": {}}, []
    cases = [(f"default_{size}_{i}", BalanceConfig(), f, card[size][i])
             for size, fs in frames.items() for i, f in enumerate(fs)]
    cases += [(f"{name}_720p", cfg, frames["720p"][0], card["720p"][0]) for name, cfg in correction_configs().items()]
    for name, cfg, frame, img in cases:
        row = balance_against_cpu(balance(img, cfg), frame, cfg)
        out["checks"][name] = row
        if row["off_by_more_away_from_sector_edges"] or row["share_off_by_more"] > CORRECTION_EDGE_SHARE:
            failures.append(f"{name}: {row}")
    syncs = host_syncs(lambda: [balance(card["720p"][0], cfg) for cfg in (BalanceConfig(),
                                                                         *correction_configs().values())])
    out["balance_host_syncs"] = len(syncs)
    out["control_host_syncs"] = len(host_syncs(lambda: card["720p"][0].sum().item()))
    if syncs or not out["control_host_syncs"]:
        failures.append(f"balance synchronised {len(syncs)} times: {syncs} (the control: {out['control_host_syncs']})")
    # the stack card against CPU without its two stages whose card and CPU
    # results may differ: balance (checked above) and the noise (another
    # generator on each device)
    stack_card, stack_cpu = correction_stack(dev), correction_stack("cpu")
    for m in (stack_card, stack_cpu):
        for key in ("balance", "noise_stddev"):
            m._module_manager._tuner_sources[key]._current_value = type(m.tuners[key])(0)
    got = stack_card.stages(card["720p"][0]).cpu()
    want = stack_cpu.stages(torch.from_numpy(frames["720p"][0]))
    out["preprocessor_stack"] = {"shape": list(got.shape), "equal": bool(torch.equal(got, want)),
                                 "max_abs_err": int((got.int() - want.int()).abs().max())}
    if not out["preprocessor_stack"]["equal"]:
        failures.append(f"preprocessor stack: {out['preprocessor_stack']}")
    launched = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    out["hand_kernel_launches"] = launched
    if launched:
        failures.append(f"hand kernels launched on a path that has none: {launched}")
    if failures:
        emit("correction_checks", **out)
        raise AssertionError("correction path: " + "; ".join(failures))
    for size, imgs in card.items():
        row = {"wall_ms_per_frame": cuda_ms(lambda: balance(imgs[0]), 50)}
        rates = [fps_window(lambda k: balance(imgs[k % len(imgs)]), 1, CORRECTION_FPS_WINDOW_S)[0]
                 for _ in range(FPS_REPEATS)]
        row["fps_per_frame"] = {"median": statistics.median(rates), "min": min(rates), "max": max(rates),
                                "windows": rates}
        out[f"balance_{size}"] = row
    stack_card = correction_stack(dev)
    out["preprocessor_stack"]["wall_ms_every_stage"] = cuda_ms(lambda: stack_card.stages(card["720p"][0]), 20)
    out["path_kernels"] = "none: BASELINE config 4 runs no hand kernel (no TPU kernel lies on its path)"
    emit("correction", **out)
    return card, stack_card, {size: out[f"balance_{size}"]["wall_ms_per_frame"] for size in card}


def phase_correction_device(card, stack, wall_ms):
    """After the main path: where balance's device time goes (torch.profiler)
    per stage on its own intermediates — float planes, extrema clipping,
    equalization, HSI contrast — and whole, at 720p and 1080p: device ms,
    CUDA kernels per frame, idle share against the unprofiled wall ms; the
    preprocessor's stack with every stage on at 720p."""
    from cuauv_vision_pipeline_tpu_torch.ops import balance as B

    cfg = B.BalanceConfig()
    out = {}
    for size, imgs in card.items():
        img = imgs[0]

        def planes():
            return [img.to(torch.float32)[..., c] for c in (2, 1, 0)]

        r, g, b = planes()

        def clip():
            return [torch.clamp(c, *B._u8_percentiles(c, 0.002, 0.998)) for c in (r, g, b)]

        rc, gc, bc = clip()
        re, ge, be = B._equalize_rgb(rc, gc, bc, cfg)
        stages = {"float_planes": profile_fn(planes), "extrema_clipping": profile_fn(clip),
                  "equalize": profile_fn(lambda: B._equalize_rgb(rc, gc, bc, cfg)),
                  "hsi_contrast": profile_fn(lambda: B._hsi_contrast(re, ge, be)),
                  "whole": profile_fn(lambda: B.balance(img, cfg))}
        whole = stages["whole"]["device_ms"]
        out[size] = {"device_ms_per_frame": whole, "kernels_per_frame": stages["whole"]["kernels"],
                     "wall_ms_per_frame": wall_ms[size], "device_idle_share": 1 - whole / wall_ms[size],
                     "stages": stages}
    out["preprocessor_stack_720p"] = profile_fn(lambda: stack.stages(card["720p"][0]))
    emit("correction_device", **out)


def phase_module(run_id: str):
    # this run's own names: the cameras' directions (so the bus blocks and
    # the modules' post and tuner blocks) and the shm namespace of its
    # groups (set in main)
    direction = f"smoke_{run_id}"
    bins_direction = f"{direction}_bins"
    dirs = {name: f"{direction}_{name}" for name in ("buoy", "imgdir", "stereo", "mczed", "mcflir", "gate", "precam")}
    import cv2

    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
    from cuauv_vision_pipeline_tpu_torch.core import shm
    from cuauv_vision_pipeline_tpu_torch.core.base import ModuleReader
    from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BLOCK_STUB
    from cuauv_vision_pipeline_tpu_torch.modules.red_buoy_stereo import RESULTS_SCHEMA

    logs = REPO / "smoke_logs"
    logs.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    results = shm.red_buoy_results
    results.set(visible=False, area=0.0, latency_ms=0.0)
    status = shm.yolo_status
    status.set(frames=0, latency_ms=0.0)
    pose = shm.bins_pose
    pose.set(visible=False, seq_frames=0, latency_ms=0.0)
    stereo = shm.define_group("red_buoy_stereo_results", RESULTS_SCHEMA)
    gate = shm.yolo_gate
    calib = shm.camera_calibration
    module_name = f"BuoyLAB-on-{direction}"
    procs = []
    stopped = set()  # names of processes stopped on purpose
    image_dir = Path(tempfile.mkdtemp(prefix="smoke_images_"))

    def start(args, name, **extra_env):
        log = open(logs / f"{name}.log", "w")
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env={**env, **extra_env},
                             stdout=log, stderr=subprocess.STDOUT)
        procs.append((p, log, name))
        return p

    def synthetic(direction_, scene, name, *extra):
        return start(["cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic", direction_,
                      "--scene", scene, *extra], name)

    def wait_for(cond, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for p, _, name in procs:
                if name not in stopped and p.poll() is not None:
                    raise RuntimeError(f"{name} exited ({p.returncode}) while waiting for {what}")
            if cond():
                return
            time.sleep(0.05)
        raise TimeoutError(f"timed out waiting for {what}")

    def stop(modules, sources):
        """SIGINT the named modules and sources; each module must exit 0
        having logged its kernel launch counts, which are returned."""
        stopped.update((*modules, *sources))
        for p, _, name in procs:
            if name in (*modules, *sources) and p.poll() is None:
                p.send_signal(signal.SIGINT)
        launches = {}
        for p, _, name in procs:
            if name in sources:
                p.wait(timeout=20)
            elif name in modules:
                p.wait(timeout=60)
                assert p.returncode == 0, f"{name} exited with {p.returncode}"
                found = re.findall(r"kernel launches: (\{.*\})", (logs / f"{name}.log").read_text())
                assert found, f"{name} logged no kernel launch counts"
                launches[name] = json.loads(found[-1])
        return launches

    def samples(counter, read, seconds=4.0, least=5, what="results"):
        """``read()`` at each advance of ``counter()`` for ``seconds``."""
        seen, got = counter(), []
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            if counter() != seen:
                seen = counter()
                got.append(read())
            time.sleep(0.01)
        assert len(got) >= least, f"{what} advanced {len(got)} times in {seconds} s"
        return seen, got

    def spread(values):
        return {"median": statistics.median(values), "min": min(values), "max": max(values), "samples": len(values)}

    def posts_of(module):
        return sorted(p.name.split("%")[-1].split("#")[0] for p in Path(BLOCK_STUB).parent.glob(
            Path(BLOCK_STUB).name + f"module_{module}_post%*"))

    def at_disc_threshold(name, area, ready, timeout=30):
        """Set thresh_min=140 on module ``name`` through the ModuleReader
        and wait until ``area()`` is the disc's and ``ready()`` holds."""
        wait_for(lambda: name in ModuleReader.get_active_modules(), 30, f"{name}'s tuner blocks")
        reader = ModuleReader(name)
        reader.run_forever(fps=30)
        try:
            reader.update_tuner_value("thresh_min", 140)
            wait_for(lambda: DISC_AREA[0] < area() < DISC_AREA[1] and ready(), timeout, f"{name}: the disc's area")
            time.sleep(1.0)  # a few more frames at the new threshold
        finally:
            reader.unblock()

    def buoy_reading():
        g = results.get()
        return {k: getattr(g, k) for k in ("visible", "center_x", "center_y", "area")}

    out = {}
    try:
        # wave 1: the zed scene sends the ZED's planes (forward, forward2,
        # depth, normal) under any direction; red_buoy's chain binds
        # "forward", YOLO's the first plane; the bins camera at the ZED's
        # HD720 size, one frame (t = 0) cycled, so the plate stays where the
        # pose check expects it
        synthetic(direction, "zed", "source", "--fps", "30")
        start(["cuauv_vision_pipeline_tpu_torch.modules.red_buoy", direction], "module")
        start(["cuauv_vision_pipeline_tpu_torch.modules.yolo", direction], "yolo")
        synthetic(bins_direction, "bins", "bins_source", "--width", str(BINS_W), "--height", str(BINS_H),
                  "--fps", "30", "--precompute", "1")
        start(["cuauv_vision_pipeline_tpu_torch.modules.bins", bins_direction], "bins",
              CUAUV_BINS_POSE_TEMPLATE="builtin")
        wait_for(lambda: results.visible.get(), 180, "the first detection")
        wait_for(lambda: results.area.get() == H * W, 10, "a whole-frame area")
        out["area_default_tuners"] = results.area.get()
        at_disc_threshold(module_name, results.area.get, lambda: True)
        out["area_thresh_min_140"] = results.area.get()
        assert DISC_AREA[0] < out["area_thresh_min_140"] < DISC_AREA[1], out
        out["latency_ms"] = results.latency_ms.get()
        out["latency_newest_ms"] = results.latency_newest_ms.get()
        # the YOLO module on the same camera: frames advance, each with a
        # camera-to-result latency; its seven posts (the frame and one per
        # handler) appear
        wait_for(lambda: status.frames.get() >= 3, 180, "YOLO results")
        out["yolo_frames"], latencies = samples(status.frames.get, status.latency_ms.get, what="yolo_status.frames")
        out["yolo_latency_ms"] = spread(latencies)
        out["yolo_posts"] = posts_of(f"Yolo-on-{direction}")
        assert len(out["yolo_posts"]) >= 7, out["yolo_posts"]
        # the bins module: pose results advance, visible on the plate, each
        # with a camera-to-result latency; its post appears
        wait_for(lambda: pose.seq_frames.get() >= 3, 180, "bins pose results")
        out["bins_frames"], readings = samples(
            pose.seq_frames.get, lambda: (lambda g: (g.latency_ms, g.visible, g.inliers, plate_error(g, 0.0)))(
                pose.get()), what="bins_pose.seq_frames")
        out["bins_latency_ms"] = spread([r[0] for r in readings])
        out["bins_pose"] = {"visible": sum(r[1] for r in readings), "samples": len(readings),
                            "inliers_min": min(r[2] for r in readings),
                            "plate_err_px_max": max(r[3] for r in readings)}
        assert all(v and i >= 8 and e < BINS_PLATE_PX for _, v, i, e in readings), out["bins_pose"]
        out["bins_posts"] = posts_of(f"BinDetector-on-{bins_direction}")
        assert out["bins_posts"] == ["bins"], out["bins_posts"]
        launches = stop(("module", "yolo", "bins"), ("source", "bins_source"))
        out.update({f"{name}_launches": launches[name] for name in ("module", "yolo", "bins")})
        assert out["module_launches"]["label_cuda"] > 0, out
        assert out["module_launches"]["fused_morph"] > 0, out
        assert out["yolo_launches"]["nms_fixed"] > 0, out
        assert out["bins_launches"]["fused_morph"] > 0, out
        assert out["bins_launches"]["spacing_select"] > 0, out

        # wave 2: the stereo module on a zed camera of its own; the
        # multi-camera YOLO on zed 1280x720 at 15 fps + flir 800x600 at 10
        # fps (config 5's cameras); red_buoy on a buoy camera of one frame
        # (t = 0, cycled), the reference for the image directory below
        stereo.set(visible_left=False, visible_right=False, area_left=0.0, area_right=0.0)
        status.set(frames=0, latency_ms=0.0)
        results.set(visible=False, area=0.0)
        synthetic(dirs["stereo"], "zed", "stereo_source", "--fps", "30")
        start(["cuauv_vision_pipeline_tpu_torch.modules.red_buoy_stereo", dirs["stereo"]], "stereo")
        synthetic(dirs["mczed"], "zed", "mczed_source", "--width", "1280", "--height", "720", "--fps", "15")
        synthetic(dirs["mcflir"], "buoy", "mcflir_source", "--width", "800", "--height", "600", "--fps", "10")
        start(["cuauv_vision_pipeline_tpu_torch.modules.yolo_multicam", dirs["mczed"], dirs["mcflir"]], "multicam")
        synthetic(dirs["buoy"], "buoy", "buoy_source", "--fps", "30", "--precompute", "1")
        start(["cuauv_vision_pipeline_tpu_torch.modules.red_buoy", f"{dirs['buoy']}[forward]"], "buoy")
        wait_for(lambda: stereo.visible_left.get() and stereo.visible_right.get(), 180, "stereo detections")
        wait_for(lambda: stereo.area_left.get() == stereo.area_right.get() == H * W, 10, "whole-frame stereo areas")
        at_disc_threshold(f"BuoyStereo-on-{dirs['stereo']}", stereo.area_left.get,
                          lambda: stereo.area_right.get() == stereo.area_left.get())
        g = stereo.get()
        out["stereo_results"] = {k: getattr(g, k) for k in RESULTS_SCHEMA}
        # the zed scene sends one frame to both eyes: both sides agree
        assert g.visible_left and g.visible_right and g.area_left == g.area_right, out["stereo_results"]
        assert (g.center_x_left, g.center_y_left) == (g.center_x_right, g.center_y_right), out["stereo_results"]
        _, latencies = samples(lambda: stereo.seq, stereo.latency_ms.get, what="red_buoy_stereo_results")
        out["stereo_latency_ms"] = spread(latencies)
        out["stereo_posts"] = posts_of(f"BuoyStereo-on-{dirs['stereo']}")
        wait_for(lambda: results.visible.get(), 120, "the buoy camera's detection")
        at_disc_threshold(f"BuoyLAB-on-{dirs['buoy']}", results.area.get, lambda: True)
        out["buoy_synthetic_reading"] = buoy_reading()
        wait_for(lambda: status.frames.get() >= 3, 180, "multi-camera YOLO results")
        out["multicam_frames"], latencies = samples(status.frames.get, status.latency_ms.get,
                                                    what="multicam yolo_status.frames")
        out["multicam_latency_ms"] = spread(latencies)
        out["multicam_posts"] = posts_of(f"YoloMulticam-on-{dirs['mczed']}-{dirs['mcflir']}")
        assert {"image_forward", "image_downward"} <= set(out["multicam_posts"]), out["multicam_posts"]
        launches = stop(("stereo", "multicam", "buoy"),
                        ("stereo_source", "mczed_source", "mcflir_source", "buoy_source"))
        out.update({f"{name}_launches": launches[name] for name in ("stereo", "multicam", "buoy")})
        assert out["stereo_launches"]["label_cuda_batched"] > 0, out["stereo_launches"]
        assert out["stereo_launches"]["fused_morph"] > 0, out["stereo_launches"]
        assert out["multicam_launches"]["nms_fixed"] > 0, out["multicam_launches"]

        # wave 3: the same buoy frame as a .bmp in a directory (config 1's
        # image_directory source) -> red_buoy; the gate scene -> the YOLO
        # module serving the trained gate checkpoint -> GateOBB ->
        # shm.yolo_gate
        if not cv2.imwrite(str(image_dir / "frame_0000.bmp"), buoy_frame((H, W), 0.0)):
            raise RuntimeError("cv2.imwrite failed for the image directory's frame")
        results.set(visible=False, area=0.0)
        status.set(frames=0, latency_ms=0.0)
        gate.set(shark_visible=0, saw_visible=0)
        start(["cuauv_vision_pipeline_tpu_torch.capture_sources.image_directory", str(image_dir), dirs["imgdir"],
               "--fps", "30"], "imgdir_source")
        start(["cuauv_vision_pipeline_tpu_torch.modules.red_buoy", f"{dirs['imgdir']}[forward]"], "imgdir")
        synthetic(dirs["gate"], "gate", "gate_source", "--width", "1280", "--height", "720", "--fps", "30")
        start(["cuauv_vision_pipeline_tpu_torch.modules.yolo", dirs["gate"]], "gate_yolo",
              CUAUV_YOLO_WEIGHT=str(GATE_FIXTURE))
        wait_for(lambda: results.visible.get(), 120, "the image directory's detection")
        at_disc_threshold(f"BuoyLAB-on-{dirs['imgdir']}", results.area.get, lambda: True)
        out["buoy_image_directory_reading"] = buoy_reading()
        # the same frame through either source: the same detection
        assert out["buoy_image_directory_reading"] == out["buoy_synthetic_reading"], out
        wait_for(lambda: gate.shark_visible.get() and gate.saw_visible.get(), 180, "shark and saw in shm.yolo_gate")
        out["gate_frames"], readings = samples(
            status.frames.get, lambda: (status.latency_ms.get(), gate.get()), what="gate yolo_status.frames")
        out["gate_latency_ms"] = spread([lat for lat, _ in readings])
        out["gate_yolo_gate"] = {
            "shark_visible": sum(bool(g.shark_visible) for _, g in readings),
            "saw_visible": sum(bool(g.saw_visible) for _, g in readings), "samples": len(readings),
            "shark_confidence_median": statistics.median(g.shark_confidence for _, g in readings),
            "saw_confidence_median": statistics.median(g.saw_confidence for _, g in readings)}
        assert out["gate_yolo_gate"]["shark_visible"] and out["gate_yolo_gate"]["saw_visible"], out["gate_yolo_gate"]
        launches = stop(("imgdir", "gate_yolo"), ("imgdir_source",))
        out.update({f"{name}_launches": launches[name] for name in ("imgdir", "gate_yolo")})
        assert out["imgdir_launches"]["label_cuda"] > 0 and out["gate_yolo_launches"]["nms_fixed"] > 0, out

        # wave 4: the gate module in localize mode on the same gate camera
        # (host only: stand-in shark and saw OBBs through GateOBB); beside
        # it BASELINE config 4 as the JAX bench runs it (bench.py:2055-2105):
        # a 1280x720 camera of 8 precomputed frames at 30 fps feeding the
        # preprocessor, color_balance and auto_calibrate
        gate.set(shark_visible=0, saw_visible=0, shark_area=0.0, saw_area=0.0)
        calib.set(exposure=50.0)
        start(["cuauv_vision_pipeline_tpu_torch.modules.gate", dirs["gate"]], "gate_module", CUAUV_GATE_LOCALIZE="1")
        synthetic(dirs["precam"], "buoy", "precam_source", "--width", "1280", "--height", "720", "--fps", "30",
                  "--precompute", "8")
        config4 = {"preprocessor": "Preprocessor", "color_balance": "ColorBalance", "auto_calibrate": "AutoCalibrate"}
        for name in config4:
            start([f"cuauv_vision_pipeline_tpu_torch.modules.{name}", dirs["precam"]], name)
        wait_for(lambda: gate.shark_visible.get() and gate.saw_visible.get() and gate.shark_area.get() > 0, 120,
                 "the gate module's shm.yolo_gate")
        g = gate.get()
        out["gate_module_yolo_gate"] = {k: getattr(g, k) for k in ("shark_visible", "shark_center_x", "shark_center_y",
                                                                   "shark_area", "saw_visible", "saw_area")}
        out["gate_module_posts"] = posts_of(f"GateDetector-on-{dirs['gate']}")
        assert "gate handler" in out["gate_module_posts"], out["gate_module_posts"]
        # config 4: each module's posts through the ModuleReader, three or
        # more of each; auto_calibrate moves the exposure off its default
        seen, readers = {}, []
        try:
            for cls in config4.values():
                module = f"{cls}-on-{dirs['precam']}"
                wait_for(lambda m=module: m in ModuleReader.get_active_modules(), 60, f"{module}'s blocks")
                reader = ModuleReader(module)
                reader.register_post_udl(lambda m, n, i, img, cs: seen.setdefault(n, []).append(tuple(img.shape)))
                reader.run_forever(fps=30)
                readers.append(reader)
            wait_for(lambda: all(len(seen.get(n, ())) >= 3 for n in CONFIG4_POSTS), 120, "config 4's posts")
            wait_for(lambda: calib.exposure.get() != 50.0, 30, "auto_calibrate to move shm.camera_calibration")
        finally:
            for reader in readers:
                reader.unblock()
        out["config4_posts"] = {n: {"count": len(v), "shapes": sorted(set(v))} for n, v in seen.items()}
        assert all(set(seen[n]) == {(BINS_H, BINS_W, 3)} for n in CONFIG4_POSTS), out["config4_posts"]
        g = calib.get()
        out["config4_camera_calibration"] = {k: getattr(g, k) for k in ("exposure", "red_gain", "green_gain",
                                                                          "blue_gain")}
        launches = stop(("gate_module", *config4), ("gate_source", "precam_source"))
        out["gate_module_launches"] = launches["gate_module"]
        out["config4_launch_counts"] = {name: launches[name] for name in config4}
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
                try:
                    p.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            log.close()
        shutil.rmtree(image_dir, ignore_errors=True)
        # what a process left behind, and the groups: all named for this run
        left = [*Path(BLOCK_STUB).parent.glob(Path(BLOCK_STUB).name + f"*{direction}*"),
                *Path(shm.group_path("*")).parent.glob(Path(shm.group_path("*")).name)]
        for path in left:
            path.unlink(missing_ok=True)
        out["removed"] = sorted(p.name for p in left)
    emit("module", **out)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--morph-variant", action="append", default=[], metavar="NAME=SOURCE.cu",
                        help="time another morph source beside csrc/morph.cu (repeatable)")
    variants = dict(v.split("=", 1) for v in parser.parse_args().morph_variant)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from cuauv_vision_pipeline_tpu_torch import native
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("env", nvidia_smi=smi, device=kind, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    rate = mem_rate(kind)

    t0 = time.monotonic()
    builds = start_variant_builds(variants)
    holder = {}
    bus = threading.Thread(target=lambda: holder.setdefault("lib", native.library_path()))
    bus.start()
    kernels_s = _build.build()
    bus.join()
    if "lib" not in holder:
        raise RuntimeError("building libframebus.so failed")
    ptxas = [
        line.strip()
        for log in sorted(_build.BUILD_DIR.glob("*.log"))
        for line in log.read_text().splitlines()
        if "registers" in line or "spill" in line
    ]
    emit("build", seconds=time.monotonic() - t0, kernels_seconds=kernels_s, ptxas=ptxas)

    dev = torch.device("cuda", 0)
    # this run's own shm namespace: every group it writes, in this process
    # and in the module processes, is auv_shm_<group>@smoke-<run_id>
    run_id = uuid.uuid4().hex[:12]
    os.environ["CUAUV_SHM_NAMESPACE"] = f"smoke-{run_id}"
    frames = [torch.from_numpy(buoy_frame((H, W), 0.4 * i)).to(dev) for i in range(8)]
    rows, ccl_inputs, masks = phase_kernels(dev, frames, rate)

    phase_nms(dev, rate)
    spacing_row, spacing_input, spacing_large = phase_spacing(dev, rate)

    # the main path, path by path: the counts set to 0 just before each path
    # and read just after it; every kernel of a path must have launched
    path_kernels = {"red_buoy": ("label_cuda", "label_cuda_batched", "fused_morph"),
                    "yolo": ("nms_fixed",), "bins": ("fused_morph", "spacing_select"),
                    "stereo": ("label_cuda_batched", "fused_morph"), "multicam": ("nms_fixed",),
                    "correction": ()}
    counts = dict.fromkeys(launch_counts(), 0)

    def run_path(path, drive):
        reset_launch_counts()
        result = drive()
        got = launch_counts()
        for name in path_kernels[path]:
            assert got[name] > 0, f"{name} was not launched on the {path} path"
        for name, n in got.items():
            counts[name] += n
        return result

    run_path("red_buoy", lambda: phase_chain(dev, frames))
    serve, image, pool = run_path("yolo", lambda: phase_yolo(dev))
    card, bins_image, bins_wall_ms = run_path("bins", lambda: phase_bins(dev))
    stereo_in, stereo_wall_ms = run_path("stereo", lambda: phase_stereo(dev))
    multicam = run_path("multicam", lambda: phase_multicam(dev))
    correction = run_path("correction", lambda: phase_correction(dev))
    module = phase_module(run_id)
    for key, launched in module.items():
        if key.endswith("_launches"):
            for name, n in launched.items():
                counts[name] += n
    for name, n in counts.items():
        assert n > 0, f"{name} was not launched on the main path"
    phase_ccl_device(ccl_inputs)
    phase_morph_device(masks, builds)
    rows["nms_fixed"] = phase_yolo_device(serve, image, pool, rate)
    rows["spacing_select"] = spacing_row
    phase_bins_device(card, bins_image, bins_wall_ms, spacing_input, spacing_large)
    phase_stereo_device(stereo_in, stereo_wall_ms)
    phase_multicam_device(*multicam, rate)
    phase_correction_device(*correction)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in rows.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

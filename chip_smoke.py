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
             32x32 tile seams and Canny's candidate masks of 1080p frames
             (one, and a [4, H, W] stack); the morphology on graded u8 values, ragged
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
             per-frame fps over three 2 s windows.
8. yolo_tasks — the rest of YOLO serving at full width: (a) YOLOv8n-seg
             (15 classes, 32 masks, 160x160 prototypes) and YOLOv8n-pose
             (17 keypoints) at 640, float32 on the card against the CPU on
             a 1080p ZED frame, and the trained segment fixture on four
             scenes: head maps (prototypes too) within HEADS_ATOL, TF32 on
             failing it, selection exact on the card's candidates,
             keypoints within 1e-3, masks equal but within 1e-5 of 0.5; (b)
             the segment fixture in bf16 over 16 scenes (recall >= 0.7,
             precision >= 0.55, mask IoU >= 0.7); (c) int8 and w8a8: every
             int8 convolution of one w8a8 forward (YOLOv8n-seg, -obb) equal
             to its plain version, the fixtures' accuracy within the JAX
             package's budgets of bf16; (d) YOLOv8n-cls (1000 classes, 224)
             float32 probabilities within 1e-7 of the CPU's, top 5 equal;
             (e) per serving model (seg, pose, cls in bf16; obb int8 and
             w8a8) event-timed ms, fps, device ms, kernels and idle share
             per 1080p frame, nms_fixed launches and the packed fetch's
             bytes (the masks').
9. bins    — the bins + pose path (BinDetector, BASELINE config 3: HSV mask,
             ``fused_morph`` open, detect/describe with the spacing kernel,
             2-NN against the builtin template) at 720p on the card against
             the same chain on the CPU, four frames: cleaned mask and
             overlay exact, keypoints and n_valid equal, descriptor rows
             past 1e-5 counted, the pose quad within 1 px and matches and
             inliers within 2; the host leg's shm.bins_pose visible with >= 8
             inliers within 12 px of the pasted plate; wall ms, fps over three
             2 s windows and the host leg's ms. TF32 must be off again after
             the YOLO phase's control.
10. stereo — the stereo red_buoy chain (BuoyStereo.stereo_chain: both ZED
             eyes as one [2, H, W] batch) on two 1080p planes at the disc
             threshold and the whole frame, card against CPU: masks and
             cleaned masks exact, found and area exact, centroid within
             1e-3; one label_cuda_batched and one fused_morph launch per
             call; no host sync; wall ms and fps.
11. multicam — config 5's two cameras (zed 1280x720, flir 800x600) through
             YoloModel.device_decode_multi (one conv stack at batch 2, one
             NMS launch): float32 head maps against the CPU's per camera,
             each camera's picks against that camera decoded alone (the
             trained fixture on scenes it knows, and the seeded
             YOLOv8n-obb); the bf16 serving model's dispatch, its
             cross-camera merge on the card against the CPU's; wall ms and
             fps.
12. correction — BASELINE config 4's device work, which runs no hand
             kernel (none may launch): ``ops/balance.balance`` with the
             default config on four 720p buoy frames and one 1080p frame
             and each non-default one at 720p (RGB contrast, HSV contrast,
             adaptive taper, blocks 4x3), card against CPU within 1 count
             but for pixels at an HSI sector edge (at most 1e-4 of a
             frame); no host sync inside ``balance``; the preprocessor's
             stage stack card against CPU, exact (every stage but balance
             and the noise); balance's wall ms and fps at 720p and 1080p.
13. train  — YOLO training (``models/yolo/train.py``): (a) one train step of
             YOLOv8n detect (8 classes) and YOLOv8n-obb (15 classes, with
             angles) at batch 16, 320 px (bench.py's train-step inputs), on
             the card with TF32 off against the CPU from the same weights:
             loss, every parameter gradient and the BatchNorm running
             statistics within stated tolerances, two card runs' spread
             beside them; (b) the step timed on a device-resident batch
             with TF32 off and on: ms per step (median of 30 dependence-
             chained steps), images/s, device ms, kernels, idle share, peak
             memory, conv FLOPs (forward x 3) and their share of the
             card's peak, no host sync inside a step; (c)
             ``examples.train_synthetic`` at its defaults but 2000 steps on
             detect (recall and precision >= 0.75 on its held-out scenes,
             through decode and ``nms_fixed``), then its checkpoint served
             by ``YoloModel`` in bf16 in the same band.
14. module — the real entry points as subprocesses: the synthetic camera
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
             left 50.0; beside them ``modules.record --mono`` on the gate
             camera with the mission active (config 2's record leg, into a
             directory of this run under ``smoke_logs/``), and
             ``modules.yolo`` serving the trained segment fixture on a zed
             camera of its own (frames advance, its posts, its ``nms_fixed``
             launches). Then config 2's replay leg: ``capture_sources.video``
             loops the recorded mp4 into ``modules.yolo`` with the gate
             checkpoint until ``shm.yolo_gate`` reports shark and saw. Each
             module exits 0 on SIGINT. Then it removes the blocks, groups
             and recording this run made.

15. library — the feature, threshold and colour library on one 1080p ZED
             frame, card against CPU: Canny L1 and L2 (and a [2, H, W]
             stack), its Hough votes and ``find_lines``,
             ``HsvMaskPipeline.run_sync`` (masks and stats), the
             cv2.threshold modes, ``histogram_u8``, ``otsu``, the 11x11
             adaptive thresholds and the color-distance threshold exact;
             ``kmeans`` (k=4, 10 iterations) labels exact, centres within
             1e-4, compactness within 1e-5; ``white_balance_bgr`` and
             ``undistort`` within 1 count on at most 1e-4 of the frame; no
             host sync inside ``canny``; per function wall ms, device ms,
             kernels per call and idle share.
16. orchestration — the vehicle's orchestration path (run after
             ``module``): ``capture_sources.zed`` as a subprocess under the
             ZED SDK's test double (``tests/fake_sdk``: HD720 buoy frames,
             depth and normals with NaN and +-inf holes), its postprocess on
             cuda:0 and equal bit for bit to the CPU's on the double's
             frames; a ``ModuleToggler`` and the web viewer in this process,
             the viewer's toggles starting ``modules.red_buoy`` and
             ``modules.poster`` pinned to device 0 (``Device: cuda:0`` in
             both logs), ``shm.red_buoy_results`` at the whole frame (and
             through ``GET /shm/red_buoy_results``), a JPEG part from each
             module's MJPEG stream, ``shm.poster_status`` advancing with a
             latency; red_buoy stopped on SIGINT to its group and reaped
             (its logged ``label_cuda`` and ``fused_morph`` launches, the
             kernel records of ``csrc/ccl.cu`` and ``csrc/morph.cu`` in its
             ``$CUAUV_TORCH_PROFILE_DIR`` trace), poster stopped by the
             toggle-off's SIGTERM within ``STOP_GRACE_S``, the blocks each
             left listed; ms from toggle-on to the first result (with its
             legs) and from toggle-off to the exit, red_buoy's
             ``latency_ms`` and the source's postprocess EMA per frame with
             its bytes each way.

17. mesh  — the (data, model) mesh (``parallel/mesh.py``) on
             ``torch.distributed``: ``entry.dryrun_multichip(1)`` on NCCL
             (rank 0 on cuda:0), ``dryrun_multichip(2)`` with both ranks
             on cuda:0 over gloo (dp 1 x tp 2) and ``dryrun_multichip(4)``
             with all four there (dp 2 x tp 2), each rank passing the JAX
             dry run's assertions; the two- and four-rank train steps
             against the one-process card step on the global batch (TF32
             off) within TRAIN_LOSS_RTOL and TRAIN_GRAD_TOL; every rank's camera
             (``chain_one``) and merged list (``all_gather`` +
             ``cross_camera_nms``) exactly as the one-card forms give them;
             ``fused_morph``, ``label_cuda``, ``spacing_select`` and
             ``nms_fixed`` launched in every rank; ``examples.multichip_fanout``
             with two ranks at 1080p (ms per round); the dp 1 x tp 2 step at
             bench.py's train cell (YOLOv8n detect, b16@320), ms per step
             beside the one-process step's. Ranks sharing one card over
             gloo: a rehearsal that says nothing of four cards.
18. native — the port's C++ capture binaries built with g++ alone
             (``stubcheck``, ``flir_capture_stub``, ``framebus_test``);
             ``framebus_test`` passes, ``--parse-only`` reads the port's
             ``flir.conf``; the zed stub's capture loop for about a second,
             its 4-plane frame read through the port's ``BlockAccessor``
             (plane names, dtypes, view markers, scrubbed NaNs). The loop
             writes the fixed direction ``zed`` and the group
             ``zed_calibration`` and ``framebus_test`` its ``nativetest_*``
             blocks (no namespace in the C++), so each run on the machine
             takes its turn at both under one ``flock``, leaves a
             ``zed`` block that another process maps alone (and fails), and
             removes only the files it made.
19. soak  — tests/test_soak.py's topology on cuda:0 (run after ``module``,
             tests/soak_topology.py), on a direction of this run's own: the
             synthetic ZED source at 320x180, 15 fps, four precomputed
             frames, with ``CUAUV_BUS_FAULTS`` (drops, corrupted payloads,
             write stalls), ``modules.red_buoy`` and ``modules.yolo`` (the
             pico detect fixture) at 30 ticks/s with ``--device 0``; after
             the warm-up (both result groups advance three times) 30 s of
             soak, the source stopped by SIGINT at 40 % and restarted 3 s
             later: both modules recover (``recovery_s``), neither goes
             STALL_LIMIT_S without progress outside the outage, RSS stays
             below warm x 1.5 + 200 MB, the two modules' GPU memory
             (the card's ``nvidia-smi`` memory.used) below its reading after
             the warm-up + 2 x SOAK_GPU_GROWTH_MIB, each module's caching
             allocator peak logged at its exit, every process exits on
             SIGINT (the modules with 0, logging ``label_cuda`` and
             ``fused_morph``, and ``nms_fixed``, launches), no module block
             is left; ``Device: cuda:0`` in both logs.
20. report — this run's numbers as metric objects in bench.py's schema
             (the red_buoy chain's per-frame and batched-8 fps, YOLO-OBB's
             event-timed ms per frame, each module's ``latency_ms``, the
             soak's counters; each with the card's name and power limit)
             in ``smoke_logs/bench_results.json``, rendered by
             ``python -m cuauv_vision_pipeline_tpu_torch.misc.bench_report``
             in a fresh process into ``smoke_logs/bench_report.md``: it
             exits 0, its "All metrics" table has a row per object, and its
             Targets rows are printed.

Launch counts are set to 0 just before each path (the chain phase, the
YOLO phase, the yolo_tasks phase, the bins phase, the stereo phase, the multicam phase, the
correction phase, whose path has no hand kernel, the train phase, the
library phase) and read
just after it; with the module processes' own logged counts (the module,
soak and orchestration phases) and the mesh's rank processes' counts they are
the main path's launches, and each kernel of a path must have launched in
that path's run. Then the CCL kernels', the morphology's, the YOLO path's
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
import fcntl
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
H, W = 1080, 1920
FPS_WINDOW_S = 2.0  # one throughput window
FPS_REPEATS = 3  # windows per lane; more would push the script past its time budget
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


# device_ms's split when CUPTI gave it no kernel record (see profile_fn)
NO_KERNEL_RECORD = "cuda_events: torch.profiler recorded no kernel event in three traces"


def device_ms(fn, n: int = 20):
    """The CUDA kernels' own device time per call of ``fn`` (torch.profiler,
    kernel events summed), and its split by kernel name. After three traces
    with no kernel record, as ``profile_fn``: the CUDA-event span of one
    call (an upper bound), split as ``{NO_KERNEL_RECORD: ms}``."""
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
    ms = cuda_ms(fn, n, warmup=0)
    return ms, {NO_KERNEL_RECORD: ms}


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
    # Canny's hysteresis input: the candidate masks (thin 8-connected
    # chains, many of them long) of 1080p frames, one and a stack
    from cuauv_vision_pipeline_tpu_torch.ops.color import bgr_to_gray
    from cuauv_vision_pipeline_tpu_torch.ops.feature import _canny_masks

    cand = torch.stack([_canny_masks(bgr_to_gray(f), *LIB_CANNY)[0] for f in frames[:4]])
    a = label_cuda(cand[0])
    b = label_cuda(cand[0])
    torch.cuda.synchronize()
    compare("label_cuda", a, label(cand[0]), "canny_candidates_1080p")
    compare("label_cuda", b, a, "canny_candidates_1080p_rerun")
    batched["canny_candidates_b4"] = cand
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
            "device_ms": prof["device_ms"] / prof["kernels"] if prof["kernels"] else None,
            "launches_traced_per_call": prof["kernels"],
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


def head_maps(heads: dict, key: str) -> list:
    """One output's maps: per scale, or segment's single prototype map."""
    return heads[key] if isinstance(heads[key], list) else [heads[key]]


def heads_err(got, want) -> float:
    """Max |difference| of per-scale head maps (card against CPU)."""
    return max((g.cpu() - w).abs().max().item()
               for key in want for g, w in zip(head_maps(got, key), head_maps(want, key)))


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


def to_cpu(x):
    """A tensor, a list of them or a dict of them, on the CPU."""
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_cpu(v) for v in x]
    return None if x is None else x.cpu()


def decode_card_and_cpu(model, heads):
    """The card's f32 head maps decoded on the card and on the CPU, in
    decode's two halves. The elementwise half (DFL, boxes, sigmoid) rounds
    differently on the two devices: its largest differences. The selection
    half (stable-sort pool, gathers, NMS, then the winners' keypoints and
    masks) given the card's own candidates: whether valid, cls, picked,
    score and xyxy are equal; the keypoints' largest difference; the mask
    pixels that differ where the CPU's probability is not within MASK_EDGE
    of 0.5. And whether the whole decode on the CPU picks as the card
    does."""
    from cuauv_vision_pipeline_tpu_torch.models.yolo.decode import candidates, select
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda

    kw = dict(iou_thresh=0.45, max_det=model.max_det, nms_pool=model.nms_pool)
    before = nms_fixed_cuda.launches  # a comparison, not the main path's launch
    calls: list = []
    probs: list = []
    with torch.inference_mode(), recording_nms(calls), recording_masks(probs):
        card = candidates(heads, model.model.reg_max, model.conf_thresh)
        host = candidates(to_cpu(heads), model.model.reg_max, model.conf_thresh)
        got = select(*card, model.image_size, **kw)
        want = select(*to_cpu(card), model.image_size, **kw)
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
        "n_valid": int(got["valid"].sum()),
    }
    if "kpts" in got:
        out["kpts_max_abs_err"] = (got["kpts"].cpu() - want["kpts"]).abs().max().item()
    if "mask" in got:
        edge = (probs[1] - 0.5).abs() <= MASK_EDGE  # the CPU select's probabilities
        out["mask_pixels_near_the_edge"] = int(edge.sum())
        out["mask_pixels_differing_off_the_edge"] = int(((got["mask"].cpu() != want["mask"]) & ~edge).sum())
        out["mask_pixels_set"] = int(want["mask"].sum())
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
    ms per 1080p frame, per-frame fps over three windows, wrapper calls per
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
    return serve, images[0], pools[0], out


def profile_fn(fn, n: int = 20) -> dict:
    """Device ms and CUDA kernels per call of ``fn`` (torch.profiler).

    CUPTI now and then delivers no kernel record for a trace, and once in a
    while for every later trace of the process. After three empty traces the
    device ms is the CUDA-event span of one call instead (an upper bound of
    the kernels' busy time, so the idle share it gives is a lower bound),
    and the kernel count is not measured (None); ``timed_by`` says which."""
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
        return {"device_ms": cuda_ms(fn, n, warmup=0), "kernels": None, "top_device_ms": [],
                "timed_by": NO_KERNEL_RECORD}
    by_name: dict = {}
    for e in events:
        by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + e.self_device_time_total / 1e3 / n
    return {"device_ms": sum(by_name.values()), "kernels": sum(e.count for e in events) / n,
            "top_device_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:8], "timed_by": "torch.profiler"}


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
    per_launch = {k: stages[k]["device_ms"] / stages[k]["kernels"] if stages[k]["kernels"] else None
                  for k in ("nms_fixed", "nms_fixed_one_round")}
    extra_us = (None if None in per_launch.values() else
                (per_launch["nms_fixed"] - per_launch["nms_fixed_one_round"]) / max(timing["picks"] - 1, 1) * 1e3)
    emit("yolo_device", wall_ms_per_frame=wall, device_ms_per_frame=whole,
         device_idle_share=1 - whole / wall, kernels_per_frame=stages["device_decode"]["kernels"],
         split_device_ms=split, stages=stages, nms=timing,
         nms_device_ms_per_launch=per_launch, nms_us_per_pick_after_the_first=extra_us)
    return row


SEG_FIXTURE = REPO / "tests" / "fixtures" / "synth_pico_segment.msgpack"
# the yolo_tasks phase's serving configurations, full width (size n), seeded
# random init: YOLOv8n-seg (15 classes, 32 masks, 160x160 prototypes) and
# YOLOv8n-pose (17 keypoints, 15 classes) at 640, YOLOv8n-cls (1000 classes)
# at 224, as ultralytics publishes it
CLASSIFY_NAMES = [f"class_{i}" for i in range(1000)]
TASK_CONFIGS = {"segment": dict(task="segment"), "pose": dict(task="pose"),
                "classify": dict(task="classify", image_size=224, class_names=CLASSIFY_NAMES)}
# selection on the card's candidates: keypoints (model pixels, visibility)
# decoded on the card against the CPU, a few float32 ulps of a coordinate
# near 640 px; masks equal but where the CPU's probability lies within
# MASK_EDGE of 0.5
KPTS_ATOL = 1e-3
MASK_EDGE = 1e-5
# classify, float32 card against CPU: probabilities of ~1e-3 each (random
# init, 1000 classes), within this
PROBS_ATOL = 1e-7
# the fixtures' quantization budgets (tests/test_yolo_synth.py:100-175)
DETECT_QUANT_BUDGET = 0.1  # recall and precision, of bf16
SEG_QUANT_BUDGET = {"recall": 0.12, "mask_iou": 0.1}
TASK_FPS_WINDOWS = (2, 1.0)  # windows, seconds each


@contextlib.contextmanager
def recording_masks(probs: list):
    """Record the mask probabilities of each ``compose_masks`` call of
    ``select``."""
    from cuauv_vision_pipeline_tpu_torch.models.yolo import decode as decode_mod

    real = decode_mod.compose_masks

    def record(*args):
        result = real(*args)
        probs.append(result)
        return result

    decode_mod.compose_masks = record
    try:
        yield
    finally:
        decode_mod.compose_masks = real


@contextlib.contextmanager
def recording_int8_convs(calls: list):
    """Record each int8 convolution of a w8a8 forward: (int8 input, the
    Int8Conv, int32 result)."""
    from cuauv_vision_pipeline_tpu_torch.models.yolo import quant

    real = quant.int8_conv

    def record(xq, conv):
        acc = real(xq, conv)
        calls.append((xq, conv, acc))
        return acc

    quant.int8_conv = record
    try:
        yield
    finally:
        quant.int8_conv = real


def fixture_scores(model, seed: int = 77, n: int = 24, masks: bool = False) -> dict:
    """Recall, precision (and mean mask IoU) of a fixture model over ``n``
    synthetic 128 px scenes, as the JAX package's tests score them."""
    from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import mask_iou, match_detections, render_scene

    rng = np.random.default_rng(seed)
    tp = n_gt = n_pred = 0
    ious = []
    for _ in range(n):
        img, boxes, cls, *gt_masks = render_scene(rng, size=128, max_objects=3, with_masks=masks)
        decoded = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
                   for k, v in model.device_decode(img).items()}
        t, g, p_, pairs = match_detections(decoded, boxes, cls, return_pairs=True)
        tp, n_gt, n_pred = tp + t, n_gt + g, n_pred + p_
        if masks:
            ious += [mask_iou(decoded["mask"][pi], gt_masks[0][gi]) for pi, gi in pairs]
    out = {"recall": tp / max(n_gt, 1), "precision": tp / max(n_pred, 1), "tp": tp, "n_gt": n_gt,
           "n_pred": n_pred}
    if masks:
        out["mask_iou"] = float(np.mean(ious)) if ious else 0.0
    return out


def serving_timing(serve, image) -> dict:
    """One serving model on one 1080p frame: event-timed ms per frame, fps
    over a few windows, device ms (whole, and the letterbox + conv stack
    alone), kernels per frame, idle share, nms_fixed launches per frame and
    the bytes of the decode dict's one packed fetch (and of its masks)."""
    from cuauv_vision_pipeline_tpu_torch.engine.executor import pack_result
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda

    decoded = serve.device_decode(image)
    before = nms_fixed_cuda.launches
    serve.device_decode(image)
    nms = nms_fixed_cuda.launches - before
    wall = cuda_ms(lambda: serve.device_decode(image), 20)
    whole = profile_fn(lambda: serve.device_decode(image), n=5)
    heads = profile_fn(lambda: serve.head_outputs(image[None]), n=5)
    windows, seconds = TASK_FPS_WINDOWS
    rates = [fps_window(lambda k: serve.device_decode(image), 1, seconds)[0] for _ in range(windows)]
    return {"ms": wall, "fps": {"median": statistics.median(rates), "min": min(rates), "max": max(rates)},
            "device_ms": whole["device_ms"], "device_ms_letterbox_and_convs": heads["device_ms"],
            "device_idle_share": 1 - whole["device_ms"] / wall, "kernels_per_frame": whole["kernels"],
            "nms_fixed_launches_per_frame": nms, "fetch_bytes": int(pack_result(decoded)[0].numel()),
            "mask_bytes": int(decoded["mask"].numel()) if "mask" in decoded else 0,
            "top_device_ms": whole["top_device_ms"]}


def entry_card_vs_cpu():
    """The port's ``entry()`` as a user calls it, on cuda:0 (TF32 off)
    against ``entry("cpu")``: whether valid and cls are equal, the largest
    xyxy and score differences, and its nms_fixed launches on the card."""
    from cuauv_vision_pipeline_tpu_torch.core.device import full_f32
    from cuauv_vision_pipeline_tpu_torch.entry import entry
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda

    fn, args = entry()
    before = nms_fixed_cuda.launches
    with full_f32():
        got = to_cpu(fn(*args))
    launches = nms_fixed_cuda.launches - before
    host_fn, host_args = entry("cpu")
    want = host_fn(*host_args)
    return {"device": str(args[1].device), "nms_fixed_launches": launches,
            "valid": torch.equal(got["valid"], want["valid"]), "cls": torch.equal(got["cls"], want["cls"]),
            "xyxy_max_abs_err": (got["xyxy"] - want["xyxy"]).abs().max().item(),
            "score_max_abs_err": (got["score"] - want["score"]).abs().max().item(),
            "n_valid": int(want["valid"].sum())}


def phase_yolo_tasks(dev):
    """The rest of YOLO serving at full width on 1080p ZED frames. (a)
    YOLOv8n-seg and YOLOv8n-pose in float32 on the card (TF32 off) against
    the CPU: head maps (the prototypes too) within HEADS_ATOL, TF32 on
    failing it; the card's maps decoded on both devices, selection exact on
    the card's candidates, keypoints within KPTS_ATOL, masks equal but
    within MASK_EDGE of 0.5. (b) The trained segment fixture in bf16 on the
    card over 16 scenes: recall >= 0.7, precision >= 0.55, mask IoU >= 0.7.
    (c) int8 and w8a8: every int8 convolution of one w8a8 forward of
    YOLOv8n-seg and YOLOv8n-obb exact against its plain version (on the
    CPU); the detect fixture's recall and precision within 0.1 of bf16, the
    segment fixture's recall within 0.12 and mask IoU within 0.1. (d)
    YOLOv8n-cls in float32, card against CPU: probabilities within
    PROBS_ATOL, the top 5 equal; ``entry()`` on cuda:0 against
    ``entry("cpu")`` (:func:`entry_card_vs_cpu`): valid and cls equal, xyxy
    and score within CANDIDATE_ATOL, one nms_fixed launch. (e) Per serving
    model (bf16: seg, pose, cls; YOLOv8n-obb int8 and w8a8):
    :func:`serving_timing`."""
    from cuauv_vision_pipeline_tpu_torch.models.yolo import quant
    from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda

    from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import render_scene

    out, failures, seconds = {}, [], {}
    t0 = time.monotonic()
    frame = zed_frames(1)[0]
    card_image = torch.from_numpy(frame).to(dev)
    seg_kw = dict(image_size=128, max_det=8, conf_thresh=0.25)
    rng = np.random.default_rng(77)
    seg_scenes = {f"scene_{i}": render_scene(rng, size=128, max_objects=3)[0] for i in range(4)}
    # random init's mask logits are ~0 (every set pixel lies within
    # MASK_EDGE of 0.5), so the trained fixture holds the masks
    for name, weight, kw, kind, inputs in (
        ("segment", None, TASK_CONFIGS["segment"], "random_init", {"zed_1080p": frame}),
        ("pose", None, TASK_CONFIGS["pose"], "random_init", {"zed_1080p": frame}),
        ("segment_fixture", str(SEG_FIXTURE), seg_kw, "fixture", seg_scenes),
    ):
        card = YoloModel(weight, half_precision=False, device=dev, **kw)
        host = YoloModel(weight, half_precision=False, device="cpu", **kw)
        for input_name, img in inputs.items():
            case = f"{name}_{input_name}"
            image = torch.from_numpy(img)
            want_heads = host.head_outputs(image[None])
            card_heads = card.head_outputs(image.to(dev)[None])
            row = {"heads_max_abs_err": heads_err(card_heads, want_heads)}
            if input_name in ("zed_1080p", "scene_0"):
                with tf32_allowed():
                    row["tf32_on_heads_max_abs_err"] = heads_err(card.head_outputs(image.to(dev)[None]), want_heads)
                if not row["tf32_on_heads_max_abs_err"] > HEADS_ATOL[kind]:
                    failures.append(f"{case}: TF32 on stays within {HEADS_ATOL[kind]}")
            both = row["card_maps_decoded_on_cpu"] = decode_card_and_cpu(card, card_heads)
            if not row["heads_max_abs_err"] <= HEADS_ATOL[kind]:
                failures.append(f"{case}: head maps differ past {HEADS_ATOL[kind]}")
            failures += [f"{case}: card candidates selected on the CPU: {key} differs"
                         for key in ("valid", "cls", "picked", "score", "xyxy") if not both[key]]
            failures += [f"{case}: card maps: {key} {both[key]} past {limit}"
                         for key, limit in CANDIDATE_ATOL.items() if not both[key] <= limit]
            if "kpts_max_abs_err" in both and not both["kpts_max_abs_err"] <= KPTS_ATOL:
                failures.append(f"{case}: keypoints differ by {both['kpts_max_abs_err']} past {KPTS_ATOL}")
            if both.get("mask_pixels_differing_off_the_edge"):
                failures.append(f"{case}: {both['mask_pixels_differing_off_the_edge']} mask pixels differ")
            if kind == "fixture" and not both["whole_decode_picked"]:
                failures.append(f"{case}: card maps decoded on the CPU pick otherwise")
            out[f"f32_card_vs_cpu_{case}"] = row
        if not any(out[f"f32_card_vs_cpu_{name}_{i}"]["card_maps_decoded_on_cpu"]["n_valid"] for i in inputs):
            failures.append(f"{name}: nothing decoded")
    if not sum(out[f"f32_card_vs_cpu_segment_fixture_{i}"]["card_maps_decoded_on_cpu"]["mask_pixels_set"]
               for i in seg_scenes):
        failures.append("segment fixture: no mask pixel set")

    card = YoloModel(None, half_precision=False, device=dev, **TASK_CONFIGS["classify"])
    host = YoloModel(None, half_precision=False, device="cpu", **TASK_CONFIGS["classify"])
    got, want = card.device_decode(card_image)["probs"].cpu(), host.device_decode(frame)["probs"]
    top5 = [e["class"] for e in card.summarize_decoded({"probs": got.numpy()}, frame.shape[:2])]
    out["f32_card_vs_cpu_classify"] = {
        "probs_max_abs_err": (got - want).abs().max().item(), "top5": top5,
        "top5_equal": top5 == [e["class"] for e in host.summarize_decoded({"probs": want.numpy()}, frame.shape[:2])],
        "top1_prob": got.max().item(), "probs_sum": got.sum().item()}
    if not (out["f32_card_vs_cpu_classify"]["probs_max_abs_err"] <= PROBS_ATOL
            and out["f32_card_vs_cpu_classify"]["top5_equal"]):
        failures.append(f"classify card vs CPU: {out['f32_card_vs_cpu_classify']}")
    row = out["entry_card_vs_cpu"] = entry_card_vs_cpu()
    if not (row["valid"] and row["cls"] and row["nms_fixed_launches"] == 1 and row["n_valid"]
            and row["xyxy_max_abs_err"] <= CANDIDATE_ATOL["box_max_abs_err"]
            and row["score_max_abs_err"] <= CANDIDATE_ATOL["score_max_abs_err"]):
        failures.append(f"entry() card vs CPU: {row}")
    if failures:
        emit("yolo_tasks_f32", **out)
        raise AssertionError("yolo_tasks f32 card vs CPU: " + "; ".join(failures))

    seconds["f32_card_vs_cpu"] = time.monotonic() - t0
    # (b) + (c): the fixtures in bf16 and the quantized modes
    fixtures = {}
    for mode in (None, "int8", "w8a8"):
        fixtures[f"segment_{mode or 'bf16'}"] = fixture_scores(
            YoloModel(str(SEG_FIXTURE), quantize=mode, device=dev, **seg_kw), n=16, masks=True)
        fixtures[f"detect_{mode or 'bf16'}"] = fixture_scores(
            YoloModel(str(YOLO_FIXTURE), quantize=mode, device=dev, **seg_kw))
    out["fixtures"] = fixtures
    seg, det = fixtures["segment_bf16"], fixtures["detect_bf16"]
    if not (seg["recall"] >= 0.7 and seg["precision"] >= 0.55 and seg["mask_iou"] >= 0.7):
        failures.append(f"segment fixture in bf16: {seg}")
    for mode in ("int8", "w8a8"):
        q = fixtures[f"detect_{mode}"]
        if not (q["recall"] >= det["recall"] - DETECT_QUANT_BUDGET
                and q["precision"] >= det["precision"] - DETECT_QUANT_BUDGET):
            failures.append(f"detect fixture {mode}: {q} against bf16 {det}")
        q = fixtures[f"segment_{mode}"]
        if not (q["recall"] >= seg["recall"] - SEG_QUANT_BUDGET["recall"]
                and q["mask_iou"] >= seg["mask_iou"] - SEG_QUANT_BUDGET["mask_iou"]):
            failures.append(f"segment fixture {mode}: {q} against bf16 {seg}")

    seconds["fixtures"] = time.monotonic() - t0 - sum(seconds.values())
    exact = {}
    for task in ("segment", "obb"):
        model = YoloModel(None, task=task, quantize="w8a8", device=dev)
        calls: list = []
        with recording_int8_convs(calls):
            model.device_decode(card_image)
        torch.cuda.synchronize()
        equal = [torch.equal(acc.cpu(), quant.int8_conv_plain(xq.cpu(), conv.wq.cpu(), conv.stride, conv.padding))
                 for xq, conv, acc in calls]
        n_conv = sum(isinstance(m, torch.nn.Conv2d) for m in model.model.modules())
        exact[task] = {"int8_convs": len(calls), "convs_in_model": n_conv, "exact": sum(equal),
                       "k_padded": sum(c.wmat.shape[1] != c.wq[0].numel() for _, c, _ in calls),
                       "n_padded": sum(c.wmat.shape[0] != c.wq.shape[0] for _, c, _ in calls)}
        if not (len(calls) == n_conv and all(equal)):
            failures.append(f"w8a8 {task}: {exact[task]}")
    out["w8a8_convs_exact_against_plain"] = exact
    seconds["w8a8_exact"] = time.monotonic() - t0 - sum(seconds.values())
    if failures:
        emit("yolo_tasks_quant", **out)
        raise AssertionError("yolo_tasks: " + "; ".join(failures))

    # (e) the serving models' times per 1080p frame, and nms_fixed on the
    # pose and segment paths
    timing = {}
    for name, kw in (("segment_bf16", TASK_CONFIGS["segment"]), ("pose_bf16", TASK_CONFIGS["pose"]),
                     ("classify_bf16", TASK_CONFIGS["classify"]), ("obb_int8", dict(task="obb", quantize="int8")),
                     ("obb_w8a8", dict(task="obb", quantize="w8a8"))):
        before = nms_fixed_cuda.launches
        timing[name] = serving_timing(YoloModel(None, device=dev, **kw), card_image)
        timing[name]["nms_fixed_launches"] = nms_fixed_cuda.launches - before
    out["serving"] = timing
    seconds["serving"] = time.monotonic() - t0 - sum(seconds.values())
    out["seconds"] = seconds
    for name in ("segment_bf16", "pose_bf16"):
        if not timing[name]["nms_fixed_launches"] > 0:
            raise AssertionError(f"nms_fixed was not launched on the {name} path")
    emit("yolo_tasks", **out)


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
    over three 2 s windows, wrapper calls per frame, and the host leg's ms
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
    wall ms per call and fps (frames = 2 per call) over three 2 s windows;
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
    event-timed ms per dispatch of two cameras, fps over three 2 s windows,
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
    frame (three windows of CORRECTION_FPS_WINDOW_S) at 720p and 1080p; the
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


# the library phase: Canny's thresholds, the adaptive window, k-means, the
# undistort camera (a ZED-like 1080p lens); white balance and undistort
# card against CPU within 1 count on at most this share of a frame
LIB_CANNY = (30, 90)
LIB_ADAPTIVE_K, LIB_ADAPTIVE_BIAS = 11, 2.0
LIB_KMEANS_K, LIB_KMEANS_ITERS = 4, 10
LIB_HSV = ((0, 100, 100), (10, 255, 255))  # the red disc
LIB_CAMERA = {"camera_matrix": {"fx": 1400.0, "fy": 1400.0, "cx": 960.0, "cy": 540.0},
              "distortion": {"k1": -0.2, "k2": 0.05, "p1": 0.001, "p2": -0.001},
              "image_size": {"width": W, "height": H}}
LIB_U8_SHARE = 1e-4
LIB_KMEANS_ATOL, LIB_KMEANS_RTOL = 1e-4, 1e-5  # centres, compactness


def phase_library(dev, smi: str):
    """The feature, threshold and colour library (``ops/feature``,
    ``ops/threshold``, ``utils/color``, ``utils/undistort``,
    ``engine/chains.HsvMaskPipeline``) on one 1080p ZED frame, card
    against the same calls on the CPU: Canny L1 and L2 (and a [2, H, W]
    stack through ``label_cuda_batched``), the Hough votes and
    ``find_lines`` on its edges, ``HsvMaskPipeline.run_sync`` (masks and
    every stat), the threshold family, ``otsu`` and the adaptive thresholds
    exact; ``kmeans`` labels exact, centres within LIB_KMEANS_ATOL,
    compactness within LIB_KMEANS_RTOL; ``white_balance_bgr`` and
    ``undistort`` within 1 count on at most LIB_U8_SHARE of the frame; no
    host sync inside ``canny``. Then per function the event-timed wall ms
    (around the call as a user makes it: the numpy entry points include
    their copies to and from the card), device ms, CUDA kernels per call
    and the idle share (torch.profiler), beside the card's name and power
    limit."""
    from cuauv_vision_pipeline_tpu_torch.engine.chains import HsvMaskPipeline
    from cuauv_vision_pipeline_tpu_torch.ops import color as C
    from cuauv_vision_pipeline_tpu_torch.ops import feature as F
    from cuauv_vision_pipeline_tpu_torch.ops import threshold as T
    from cuauv_vision_pipeline_tpu_torch.utils import color as UC
    from cuauv_vision_pipeline_tpu_torch.utils import undistort as U

    frames = zed_frames(2)
    frame = frames[0]
    gray_cpu = C.bgr_to_gray(torch.from_numpy(frame))
    gray = gray_cpu.to(dev)
    stack = torch.stack([C.bgr_to_gray(torch.from_numpy(f)) for f in frames]).to(dev)
    bgr = torch.from_numpy(frame).to(dev)
    map_x, map_y = U.init_undistort_map(LIB_CAMERA)
    hsv_card, hsv_cpu = HsvMaskPipeline(*LIB_HSV, device=dev), HsvMaskPipeline(*LIB_HSV, device="cpu")
    lo, hi = LIB_CANNY
    failures, checks = [], {}

    def exact(name, got, want):
        got, want = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in (got, want))
        same = got.shape == want.shape and np.array_equal(got, want)
        checks[name] = "exact" if same else "DIFFERS"
        if not same:
            failures.append(name)

    def u8_close(name, got, want):
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        checks[name] = {"max_abs_err": int(d.max()), "share_off": float((d > 0).mean())}
        if d.max() > 1 or (d > 0).mean() > LIB_U8_SHARE:
            failures.append(name)

    edges, edges_cpu = {}, {}
    for name, l2 in (("canny_l1", False), ("canny_l2", True)):
        edges[name] = F.canny(gray, lo, hi, l2)
        edges_cpu[name] = F.canny(gray_cpu, lo, hi, l2)
        exact(name, edges[name], edges_cpu[name])
    # the stack's first image is ``gray``: only the second needs the CPU
    exact("canny_b2", F.canny(stack, lo, hi),
          torch.stack([edges_cpu["canny_l1"], F.canny(stack[1].cpu(), lo, hi)]))
    syncs = host_syncs(lambda: F.canny(gray, lo, hi))
    checks["canny_host_syncs"] = len(syncs)
    if syncs:
        failures.append(f"canny synchronised: {syncs}")
    edges_np = edges["canny_l1"].cpu().numpy()
    for got, want, what in zip(F.hough_lines_accumulator(edges["canny_l1"]),
                               F.hough_lines_accumulator(torch.from_numpy(edges_np)), ("votes", "thetas", "rhos")):
        exact(f"hough_{what}", got, want)
    exact("find_lines", F.find_lines(edges_np, device=dev), F.find_lines(edges_np, device="cpu"))
    got, want = hsv_card.run_sync(frame), hsv_cpu.run_sync(frame)
    exact("hsv_mask", got[0], want[0])
    exact("hsv_cleaned", got[1], want[1])
    for key in want[2]:
        exact(f"hsv_stats_{key}", got[2][key], want[2][key])
    checks["hsv_components"] = int(got[2]["count"])
    ops = {
        "binary": lambda t: T.binary(t, 100), "binary_inv": lambda t: T.binary_inv(t, 100),
        "truncate": lambda t: T.truncate(t, 100), "to_zero": lambda t: T.to_zero(t, 100),
        "to_zero_inv": lambda t: T.to_zero_inv(t, 100), "histogram_u8": T.histogram_u8,
        "otsu_t": lambda t: T.otsu(t)[0], "otsu_mask": lambda t: T.otsu(t)[1],
        "adaptive_mean": lambda t: T.adaptive_mean(t, LIB_ADAPTIVE_K, LIB_ADAPTIVE_BIAS),
        "adaptive_gaussian": lambda t: T.adaptive_gaussian(t, LIB_ADAPTIVE_K, LIB_ADAPTIVE_BIAS),
    }
    for name, fn in ops.items():
        exact(name, fn(gray), fn(gray_cpu))
    exact("thresh_color_distance", torch.stack(T.thresh_color_distance(bgr, (20, 30, 200), 80.0, 10.0)),
          torch.stack(T.thresh_color_distance(bgr.cpu(), (20, 30, 200), 80.0, 10.0)))
    km_card = UC.kmeans(frame, LIB_KMEANS_K, LIB_KMEANS_ITERS, device=dev)
    km_cpu = UC.kmeans(frame, LIB_KMEANS_K, LIB_KMEANS_ITERS, device="cpu")
    exact("kmeans_labels", km_card[1], km_cpu[1])
    centre_err = float(np.abs(km_card[2] - km_cpu[2]).max())
    compact_err = abs(km_card[0] - km_cpu[0]) / abs(km_cpu[0])
    checks["kmeans"] = {"centres_max_abs_err": centre_err, "compactness_rel_err": compact_err}
    if centre_err > LIB_KMEANS_ATOL or compact_err > LIB_KMEANS_RTOL:
        failures.append("kmeans")
    for blur in (0, 5):
        u8_close(f"white_balance_blur{blur}", UC.white_balance_bgr(frame, blur, device=dev),
                 UC.white_balance_bgr(frame, blur, device="cpu"))
    u8_close("undistort", U.undistort(frame, map_x, map_y, device=dev),
             U.undistort(frame, map_x, map_y, device="cpu"))
    if failures:
        emit("library_checks", checks=checks)
        raise AssertionError(f"library: card differs from the CPU in {failures}")

    timed = {
        "canny_l1": (lambda: F.canny(gray, lo, hi), 20),
        "canny_l2": (lambda: F.canny(gray, lo, hi, True), 20),
        "find_lines": (lambda: F.find_lines(edges_np, device=dev), 5),
        "hsv_mask_pipeline_run_sync": (lambda: hsv_card.run_sync(frame), 10),
        "adaptive_mean_11": (lambda: T.adaptive_mean(gray, LIB_ADAPTIVE_K, LIB_ADAPTIVE_BIAS), 20),
        "adaptive_gaussian_11": (lambda: T.adaptive_gaussian(gray, LIB_ADAPTIVE_K, LIB_ADAPTIVE_BIAS), 10),
        "otsu": (lambda: T.otsu(gray), 20),
        "undistort_bgr": (lambda: U.undistort(frame, map_x, map_y, device=dev), 10),
        "kmeans_k4_10it": (lambda: UC.kmeans(frame, LIB_KMEANS_K, LIB_KMEANS_ITERS, device=dev), 3),
        "white_balance_bgr": (lambda: UC.white_balance_bgr(frame, device=dev), 10),
    }
    times = {}
    for name, (fn, reps) in timed.items():
        wall = cuda_ms(fn, reps, warmup=1)
        prof = profile_fn(fn, n=reps)
        times[name] = {"wall_ms": wall, "device_ms": prof["device_ms"], "kernels": prof["kernels"],
                       "device_idle_share": 1 - prof["device_ms"] / wall, "top_device_ms": prof["top_device_ms"][:4]}
    emit("library", card=smi, frame=f"{W}x{H} zed forward plane", canny_edges=int((edges_np > 0).sum()),
         checks=checks, times=times)


# the train phase: bench.py's train step cell (YOLOv8n, batch 16, 320 px,
# 6 gts per image) for detect (8 classes) and obb (15 classes)
TRAIN_SIZE, TRAIN_BATCH, TRAIN_GTS = 320, 16, 6
TRAIN_MODELS = {"detect": 8, "obb": 15}
TRAIN_TIMED_STEPS = 30
# the example's run: 2000 steps, not the README's 3000, keep the script
# near half its time limit (PERF.md §6 has the band against steps)
TRAIN_CONVERGE_STEPS = 2000
TRAIN_BAND = 0.75  # recall and precision (the JAX fixture test's band)
# one step card (TF32 off) against the CPU
TRAIN_LOSS_RTOL = 1e-5
# of each parameter gradient's norm: card against CPU measured 3.9e-5 at
# this size, two card runs (cuDNN's backward-weight kernels) 1.1e-6
TRAIN_GRAD_TOL = 2e-4
TRAIN_STATS_RTOL, TRAIN_STATS_ATOL = 1e-5, 1e-6  # |card - cpu| <= atol + rtol * |cpu|
_TF32_RATE = 495e12  # TF32 tensor-core peak (SXM data sheet, dense)


def train_inputs(task: str, size: int = TRAIN_SIZE, batch: int = TRAIN_BATCH) -> tuple:
    """bench.py's train-step inputs (seed 0: images, boxes, classes), and
    obb's angles in its decodable range."""
    rng = np.random.default_rng(0)
    images = rng.random((batch, size, size, 3), np.float32).astype(np.float32)
    t_xyxy = rng.random((batch, TRAIN_GTS, 4)).astype(np.float32) * size
    t_cls = rng.integers(0, TRAIN_MODELS[task], (batch, TRAIN_GTS)).astype(np.int32)
    if task == "obb":
        return images, t_xyxy, t_cls, rng.uniform(-np.pi / 4, 3 * np.pi / 4, (batch, TRAIN_GTS)).astype(np.float32)
    return images, t_xyxy, t_cls


def train_once(model, dev, inputs):
    """One train step of a copy of ``model`` on ``dev`` with TF32 off: (loss,
    gradients and running statistics on the CPU)."""
    import copy

    from cuauv_vision_pipeline_tpu_torch.core.device import full_f32
    from cuauv_vision_pipeline_tpu_torch.models.yolo.train import create_train_state, make_train_step

    m = copy.deepcopy(model).to(dev)
    step = make_train_step(create_train_state(m))
    with full_f32():
        loss = float(step(*(torch.from_numpy(a).to(dev) for a in inputs)))
    grads = {n: p.grad.cpu() for n, p in m.named_parameters()}
    stats = {k: v.cpu() for k, v in m.state_dict().items() if "running" in k}
    return loss, grads, stats


def train_diff(a, b) -> dict:
    """How far one step's (loss, grads, stats) ``a`` lies from ``b``."""
    grad = {n: ((a[1][n] - g).abs().max() / g.norm().clamp_min(1e-30)).item() for n, g in b[1].items()}
    # each running statistic's error as a share of its allowance atol + rtol * |cpu|
    stats = {k: ((a[2][k] - v).abs() / (TRAIN_STATS_ATOL + TRAIN_STATS_RTOL * v.abs())).max().item()
             for k, v in b[2].items()}
    worst_g, worst_s = max(grad, key=grad.get), max(stats, key=stats.get)
    return {"loss_rel_err": abs(a[0] - b[0]) / abs(b[0]), "grad_err_of_norm": grad[worst_g], "grad_worst": worst_g,
            "stats_share_of_tol": stats[worst_s], "stats_worst": worst_s,
            "stats_max_abs_err": max((a[2][k] - v).abs().max().item() for k, v in b[2].items())}


def conv_flops(model, x) -> int:
    """Multiply-adds x 2 of every conv, ConvTranspose and Linear of one
    forward of ``model`` on ``x`` (NCHW), counted from their shapes."""
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.ConvTranspose2d):
            total[0] += 2 * inp[0].numel() * mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]
        elif isinstance(mod, torch.nn.Conv2d):
            total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * mod.kernel_size[0] * mod.kernel_size[1]
        elif isinstance(mod, torch.nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def train_timing(model, dev, inputs, tf32: bool) -> dict:
    """The train step of a copy of ``model`` on the device-resident batch:
    ms per step (median of TRAIN_TIMED_STEPS dependence-chained steps, CUDA
    events around each), images/s, device ms and kernels per step
    (torch.profiler), idle share, peak memory, and the conv FLOPs (forward
    x 3) with their share of the card's float32 (and TF32) peak."""
    import copy

    from cuauv_vision_pipeline_tpu_torch.models.yolo.train import create_train_state, make_train_step

    m = copy.deepcopy(model).to(dev)
    step = make_train_step(create_train_state(m))
    batch = [torch.from_numpy(a).to(dev) for a in inputs]
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for _ in range(3):
            step(*batch)
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(TRAIN_TIMED_STEPS)]
        t0 = time.perf_counter()
        for start, end in events:
            start.record()
            loss = step(*batch)
            end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS * 1e3
        ms = statistics.median(s.elapsed_time(e) for s, e in events)
        prof = profile_fn(lambda: step(*batch), n=5)
        torch.cuda.reset_peak_memory_stats(dev)
        step(*batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        syncs = host_syncs(lambda: step(*batch))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    flops = 3 * conv_flops(m, batch[0].permute(0, 3, 1, 2))
    out = {"tf32": tf32, "ms_per_step": ms, "wall_ms_per_step": wall, "images_per_s": len(inputs[0]) * 1e3 / ms,
           "device_ms_per_step": prof["device_ms"], "kernels_per_step": prof["kernels"],
           "device_idle_share": 1 - prof["device_ms"] / ms, "peak_memory_bytes": peak,
           "conv_flops_per_step": flops, "f32_peak_share": flops / (ms / 1e3) / _F32_RATE,
           "host_syncs_in_step": syncs, "last_loss": float(loss), "top_device_ms": prof["top_device_ms"]}
    if tf32:
        out["tf32_peak_share"] = flops / (ms / 1e3) / _TF32_RATE
    return out


def phase_train(dev, run_id: str):
    """YOLO training on the card. (a) One train step of YOLOv8n detect (8
    classes) and YOLOv8n-obb (15 classes, angles) at batch 16, 320 px, on
    the card with TF32 off against the CPU from the same weights: loss
    within TRAIN_LOSS_RTOL, every parameter gradient within TRAIN_GRAD_TOL
    of its norm, the BatchNorm running statistics within
    TRAIN_STATS_ATOL + TRAIN_STATS_RTOL x |cpu|; two card runs' spread beside
    it. (b) The step timed
    on the device-resident batch, TF32 off and on (:func:`train_timing`),
    with no host sync inside it. (c) The example trainer
    (``examples.train_synthetic``) at its defaults but TRAIN_CONVERGE_STEPS
    steps on detect: recall and precision >= TRAIN_BAND on its held-out
    scenes, then the written checkpoint served by ``YoloModel`` in bf16 on
    the card (:func:`fixture_scores`) in the same band."""
    from cuauv_vision_pipeline_tpu_torch.examples import train_synthetic
    from cuauv_vision_pipeline_tpu_torch.models.yolo.model import create_model
    from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda

    out, failures = {}, []
    t0 = time.monotonic()
    for task, nc in TRAIN_MODELS.items():
        model = create_model(nc, "n", task, seed=0).train()
        inputs = train_inputs(task)
        want = train_once(model, "cpu", inputs)
        card = train_once(model, dev, inputs)
        again = train_once(model, dev, inputs)
        row = out[f"card_vs_cpu_{task}"] = {**train_diff(card, want), "loss": card[0], "cpu_loss": want[0],
                                           "card_spread": train_diff(again, card)}
        if not (row["loss_rel_err"] <= TRAIN_LOSS_RTOL and row["grad_err_of_norm"] <= TRAIN_GRAD_TOL
                and row["stats_share_of_tol"] <= 1):
            failures.append(f"{task} one step, card against CPU: {row}")
        out[f"timing_{task}"] = [train_timing(model, dev, inputs, tf32) for tf32 in (False, True)]
        for timing in out[f"timing_{task}"]:
            if timing["host_syncs_in_step"] or not np.isfinite(timing["last_loss"]):
                failures.append(f"{task} timed step: {timing}")
    out["seconds_parity_and_timing"] = time.monotonic() - t0
    if failures:
        emit("train", **out)
        raise AssertionError("train: " + "; ".join(failures))

    logs = REPO / "smoke_logs"
    logs.mkdir(parents=True, exist_ok=True)
    ckpt = str(logs / f"train_{run_id[:8]}.msgpack")
    before = nms_fixed_cuda.launches
    run = out["converge_detect"] = train_synthetic.run(
        ["--task", "detect", "--steps", str(TRAIN_CONVERGE_STEPS), "--out", ckpt, "--device", str(dev)])
    served = out["served_bf16"] = fixture_scores(YoloModel(ckpt, device=dev))
    out["nms_fixed_launches"] = nms_fixed_cuda.launches - before
    for name, r in (("trained", run), ("served in bf16", served)):
        if not (r["recall"] >= TRAIN_BAND and r["precision"] >= TRAIN_BAND):
            failures.append(f"{name}: recall {r['recall']}, precision {r['precision']} under {TRAIN_BAND}")
    out["seconds"] = time.monotonic() - t0
    emit("train", **out)
    if failures:
        raise AssertionError("train: " + "; ".join(failures))


def phase_module(run_id: str):
    # this run's own names: the cameras' directions (so the bus blocks and
    # the modules' post and tuner blocks) and the shm namespace of its
    # groups (set in main)
    direction = f"smoke_{run_id}"
    bins_direction = f"{direction}_bins"
    dirs = {name: f"{direction}_{name}"
            for name in ("buoy", "imgdir", "stereo", "mczed", "mcflir", "gate", "precam", "segcam", "replay")}
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
    mission = shm.active_mission
    # the recorder's directory, relative to the checkout (the modules' cwd):
    # the mission group's log_path is a 64-byte string field
    record_dir = f"smoke_logs/rec_{run_id[:8]}"
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
                text = (logs / f"{name}.log").read_text()
                found = re.findall(r"kernel launches: (\{.*\})", text)
                assert found, f"{name} logged no kernel launch counts"
                launches[name] = json.loads(found[-1])
                # a module with a @device_fn logs how its dispatches ran
                graphs = re.findall(r"graph calls: (\{.*\})", text)
                if graphs:
                    emit("graph_calls", module=name, counts=json.loads(graphs[-1]))
                copies = re.findall(r"h2d copies: (\{.*\})", text)
                if copies:
                    emit("h2d_copies", module=name, counts=json.loads(copies[-1]))
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
        # (host only: stand-in shark and saw OBBs through GateOBB), and
        # config 2's record leg on it (bench.py:1869-1990): modules.record
        # --mono, mission active, writes an mp4 of the gate scene; the
        # segment fixture through modules.yolo on a camera of its own; beside
        # them BASELINE config 4 as the JAX bench runs it (bench.py:2055-2105):
        # a 1280x720 camera of 8 precomputed frames at 30 fps feeding the
        # preprocessor, color_balance and auto_calibrate
        gate.set(shark_visible=0, saw_visible=0, shark_area=0.0, saw_area=0.0)
        calib.set(exposure=50.0)
        status.set(frames=0, latency_ms=0.0)
        mission.log_path.set(record_dir)
        mission.active.set(True)
        start(["cuauv_vision_pipeline_tpu_torch.modules.gate", dirs["gate"]], "gate_module", CUAUV_GATE_LOCALIZE="1")
        start(["cuauv_vision_pipeline_tpu_torch.modules.record", "--mono", dirs["gate"], "--fps", "30"], "record")
        synthetic(dirs["segcam"], "zed", "segcam_source", "--width", "1280", "--height", "720", "--fps", "30")
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
        # the handler writes shm.yolo_gate inside process(); its post block
        # appears only when the frame's posts are drained after it
        gate_posts = lambda: posts_of(f"GateDetector-on-{dirs['gate']}")  # noqa: E731
        wait_for(lambda: "gate handler" in gate_posts(), 30, "the gate module's 'gate handler' post")
        out["gate_module_posts"] = gate_posts()
        # now that shm.yolo_gate is read: its GateOBB handler writes that group too
        start(["cuauv_vision_pipeline_tpu_torch.modules.yolo", dirs["segcam"]], "seg_yolo",
              CUAUV_YOLO_WEIGHT=str(SEG_FIXTURE))
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
        # the segment checkpoint served by modules.yolo: frames advance, its posts appear
        wait_for(lambda: status.frames.get() >= 3, 180, "the segment module's results")
        out["seg_yolo_frames"], latencies = samples(status.frames.get, status.latency_ms.get,
                                                    what="segment yolo_status.frames")
        out["seg_yolo_latency_ms"] = spread(latencies)
        out["seg_yolo_posts"] = posts_of(f"Yolo-on-{dirs['segcam']}")
        assert len(out["seg_yolo_posts"]) >= 7, out["seg_yolo_posts"]
        # the recording: mission off once the clip has grown, so the
        # recorder closes the file before it is replayed
        clips = lambda: sorted((REPO / record_dir).glob("record-mono-*.mp4"))  # noqa: E731
        wait_for(lambda: clips() and clips()[0].stat().st_size > 200_000, 90, "the recorded gate clip")
        mission.active.set(False)
        time.sleep(2.0)  # the recorder closes the file at its next frame
        launches = stop(("gate_module", "record", "seg_yolo", *config4), ("gate_source", "precam_source",
                                                                         "segcam_source"))
        out["gate_module_launches"] = launches["gate_module"]
        out["config4_launch_counts"] = {name: launches[name] for name in config4}
        out["seg_yolo_launches"] = launches["seg_yolo"]
        assert out["seg_yolo_launches"]["nms_fixed"] > 0, out["seg_yolo_launches"]
        clip = clips()[0]
        out["recorded_clip"] = {"bytes": clip.stat().st_size, "frames": int(cv2.VideoCapture(str(clip)).get(
            cv2.CAP_PROP_FRAME_COUNT))}

        # wave 5: config 2's replay leg: capture_sources.video replays the
        # clip -> modules.yolo with the gate checkpoint -> GateOBB ->
        # shm.yolo_gate reports shark and saw
        gate.set(shark_visible=0, saw_visible=0)
        status.set(frames=0, latency_ms=0.0)
        start(["cuauv_vision_pipeline_tpu_torch.capture_sources.video", f"{clip}:{dirs['replay']}", "--loop"],
              "replay_source")
        start(["cuauv_vision_pipeline_tpu_torch.modules.yolo", dirs["replay"]], "replay_yolo",
              CUAUV_YOLO_WEIGHT=str(GATE_FIXTURE))
        wait_for(lambda: gate.shark_visible.get() and gate.saw_visible.get(), 180,
                 "shark and saw in shm.yolo_gate from the replayed clip")
        out["replay_frames"], readings = samples(
            status.frames.get, lambda: (status.latency_ms.get(), gate.get()), what="replay yolo_status.frames")
        out["replay_latency_ms"] = spread([lat for lat, _ in readings])
        out["replay_yolo_gate"] = {
            "shark_visible": sum(bool(g.shark_visible) for _, g in readings),
            "saw_visible": sum(bool(g.saw_visible) for _, g in readings), "samples": len(readings),
            "shark_confidence_median": statistics.median(g.shark_confidence for _, g in readings),
            "saw_confidence_median": statistics.median(g.saw_confidence for _, g in readings)}
        assert out["replay_yolo_gate"]["shark_visible"] and out["replay_yolo_gate"]["saw_visible"], out
        launches = stop(("replay_yolo",), ("replay_source",))
        out["replay_yolo_launches"] = launches["replay_yolo"]
        assert out["replay_yolo_launches"]["nms_fixed"] > 0, out["replay_yolo_launches"]
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
        shutil.rmtree(REPO / record_dir, ignore_errors=True)
        # what a process left behind, and the groups: all named for this run
        left = [*Path(BLOCK_STUB).parent.glob(Path(BLOCK_STUB).name + f"*{direction}*"),
                *Path(shm.group_path("*")).parent.glob(Path(shm.group_path("*")).name)]
        for path in left:
            path.unlink(missing_ok=True)
        out["removed"] = sorted(p.name for p in left)
    emit("module", **out)
    return out


# the orchestration phase: the ZED source under the SDK's test double, the
# toggler flipped through the web viewer, red_buoy and poster pinned to cuda:0
FAKE_ZED = REPO / "tests" / "fake_sdk"
CCL_KERNELS = re.compile(r"\b(local|border|final)_kernel\b")  # csrc/ccl.cu
MORPH_KERNELS = re.compile(r"\bmorph_kernel\b")  # csrc/morph.cu
ORCH_SAMPLE_S = 4.0  # red_buoy latency_ms samples under the toggler


def trace_kernels(path: Path) -> dict:
    """Kernel records of a torch.profiler Chrome trace: all, and those of
    csrc/ccl.cu and csrc/morph.cu."""
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"kernels": len(names), "ccl_cu": sum(bool(CCL_KERNELS.search(n)) for n in names),
            "morph_cu": sum(bool(MORPH_KERNELS.search(n)) for n in names), "bytes": path.stat().st_size}


def phase_orchestration(run_id: str, smi: str) -> dict:
    """The vehicle's orchestration path on the card: ``capture_sources.zed``
    as a subprocess under the ZED SDK's test double (``tests/fake_sdk``,
    HD720 buoy frames, depth and normals with holes), its postprocess on
    cuda:0; in this process a ``ModuleToggler`` with red_buoy and poster on
    that camera, both pinned to device 0, and the web viewer on
    127.0.0.1; the viewer's toggles start both modules as subprocesses.
    Checks: each module's log says ``Device: cuda:0``;
    ``shm.red_buoy_results`` has the whole frame's area (default tuners),
    as ``GET /shm/red_buoy_results`` does; the viewer's MJPEG streams give
    a JPEG part of each module; ``shm.poster_status.frames_posted`` advances
    with ``latency_ema_sec > 0``; ``_postprocess_fn`` on the card equals
    the CPU's bit for bit on the double's frames. Then red_buoy stops on
    SIGINT to its group (the toggler reaps it; its log's launch counts hold
    ``label_cuda`` and ``fused_morph``; its ``$CUAUV_TORCH_PROFILE_DIR``
    trace is counted), the toggle-off stops poster by the toggler's SIGTERM
    within ``STOP_GRACE_S``, and the blocks each module left are listed.
    Prints ms from toggle-on to the first result, from toggle-off to the
    exit, red_buoy's ``latency_ms`` (median, min, max) and the source's
    postprocess EMA per HD720 frame with its bytes each way."""
    import http.client
    import importlib.util
    from http.server import ThreadingHTTPServer

    from cuauv_vision_pipeline_tpu_torch.capture_sources.zed import _postprocess_fn
    from cuauv_vision_pipeline_tpu_torch.core import shm
    from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BLOCK_STUB
    from cuauv_vision_pipeline_tpu_torch.core.config import vehicle
    from cuauv_vision_pipeline_tpu_torch.core.module_toggler import ModuleToggler
    from cuauv_vision_pipeline_tpu_torch.misc import web_viewer

    direction = f"smoke_{run_id}_zed"
    logs = REPO / "smoke_logs" / f"orch_{run_id}"
    profile_dir = logs / "profile"
    logs.mkdir(parents=True, exist_ok=True)
    for name in ("red_buoy_results", "poster_status", "zed_metrics", "vision_modules"):
        shm.delete_group(name)  # fresh groups in this run's namespace
    results, poster, metrics = shm.red_buoy_results, shm.poster_status, shm.zed_metrics
    results.set(visible=False, area=0.0, latency_ms=0.0)
    poster.set(frames_posted=0, latency_ema_sec=0.0)
    metrics.set(postprocess_sec=0.0, start_time_sec=0.0)
    spec = importlib.util.spec_from_file_location("fake_pyzed_sl", FAKE_ZED / "pyzed" / "sl.py")
    sl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sl)

    saved_env = {k: os.environ.get(k) for k in ("CUAUV_LOG", "CUAUV_TORCH_PROFILE_DIR", "PYTHONPATH")}
    saved_vehicle = (vehicle.vision_modules, vehicle.module_devices)
    source_log = open(logs / "zed_source.log", "w")
    source = subprocess.Popen(
        [sys.executable, "-m", "cuauv_vision_pipeline_tpu_torch.capture_sources.zed", direction], cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), str(FAKE_ZED)])},
        stdout=source_log, stderr=subprocess.STDOUT)
    toggler = server = None
    out = {"nvidia_smi": smi}

    def wait_for(cond, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if source.poll() is not None:
                raise RuntimeError(f"the zed source exited ({source.returncode}) while waiting for {what}")
            if toggler is not None:
                for entry in toggler.running.values():
                    if entry.process.poll() is not None:
                        raise RuntimeError(f"{entry.name} exited ({entry.process.returncode}) waiting for {what}")
            if cond():
                return
            time.sleep(0.01)
        raise TimeoutError(f"timed out waiting for {what}")

    def request(method, path):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=30)
        conn.request(method, path)
        response = conn.getresponse()
        body = response.read()
        conn.close()
        assert response.status == 200, (method, path, response.status)
        return body

    def first_jpeg(path):
        """The first JPEG part of the viewer's MJPEG stream ``path``."""
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=30)
        conn.request("GET", path)
        response = conn.getresponse()
        buf, deadline = b"", time.monotonic() + 30
        while time.monotonic() < deadline:
            buf += response.read1(1 << 16)
            start = buf.find(b"\xff\xd8")
            end = buf.find(b"\xff\xd9", start + 2) if start >= 0 else -1
            if end >= 0:
                conn.close()
                return len(buf[start:end + 2])
        conn.close()
        raise TimeoutError(f"no JPEG part from {path}")

    def module_log(module):
        return (logs / "current" / f"{module}@{direction}-module.log").read_text()

    try:
        # the card's postprocess against the CPU's while the source starts
        card, cpu = _postprocess_fn("cuda:0"), _postprocess_fn("cpu")
        for k in range(sl.CYCLE):
            frame = sl.frame(k)
            for got, want in zip(card(*frame), cpu(*frame)):
                assert got.dtype == want.dtype and got.shape == want.shape
                assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), f"postprocess frame {k}"
        out["postprocess_card_equals_cpu"] = {"frames": sl.CYCLE, "planes": 4}
        out["postprocess_bytes_up"] = sum(a.nbytes for a in sl.frame(0))
        out["postprocess_bytes_down"] = sum(a.nbytes for a in cpu(*sl.frame(0)))

        os.environ.update(CUAUV_LOG=str(logs), CUAUV_TORCH_PROFILE_DIR=str(profile_dir), PYTHONPATH=str(REPO))
        vehicle.vision_modules = {"red_buoy": [direction], "poster": [direction]}
        vehicle.module_devices = {"red_buoy": {direction: 0}, "poster": {direction: 0}}
        toggler = ModuleToggler()
        server = ThreadingHTTPServer(("127.0.0.1", 0), web_viewer.Handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        wait_for(lambda: metrics.start_time_sec.get() > 0, 120, "the zed source's first frame")

        t_on = time.monotonic()
        for module in ("red_buoy", "poster"):
            assert json.loads(request("POST", f"/toggle/{module}/{direction}?on=true"))["on"] is True
        toggler.sync()
        assert sorted(toggler.running) == [f"poster_{direction}", f"red_buoy_{direction}"], toggler.running
        # the cold start's legs, from red_buoy's log as it grows: the
        # interpreter, torch and the module up to its Device line, the
        # profiler's start, then the first frame through the chain
        legs = {}
        for leg, line in (("device_line", "Device: "), ("profiler_started", "torch.profiler trace")):
            wait_for(lambda: line in module_log("red_buoy"), 120, f"red_buoy's '{line}' line")
            legs[leg] = (time.monotonic() - t_on) * 1e3
        wait_for(lambda: results.area.get() > 0, 120, "red_buoy's first result")
        out["toggle_on_to_first_result_ms"] = (time.monotonic() - t_on) * 1e3
        out["toggle_on_legs_ms"] = legs
        wait_for(lambda: poster.frames_posted.get() >= 3, 60, "poster's frames")
        for module in ("red_buoy", "poster"):
            device_line = re.search(r"Device: (\S+) \((.*)\)", module_log(module))
            assert device_line and device_line.group(1) == "cuda:0", module_log(module)[-2000:]
            out[f"{module}_device"] = device_line.group(0)
        out["area_default_tuners"] = results.area.get()
        assert out["area_default_tuners"] == sl.HEIGHT * sl.WIDTH, out
        assert json.loads(request("GET", "/shm/red_buoy_results"))["area"] == out["area_default_tuners"]
        out["jpeg_bytes"] = {post: first_jpeg(f"/stream/{post}")
                             for post in (f"BuoyLAB-on-{direction}/contours", f"Poster-on-{direction}/forward")}
        seen, latencies = results.seq, []
        deadline = time.monotonic() + ORCH_SAMPLE_S
        while time.monotonic() < deadline:
            if results.seq != seen:
                seen = results.seq
                latencies.append(results.latency_ms.get())
            time.sleep(0.005)
        assert len(latencies) >= 5, latencies
        out["red_buoy_latency_ms"] = {"median": statistics.median(latencies), "min": min(latencies),
                                      "max": max(latencies), "samples": len(latencies)}
        status = poster.get()
        assert status.frames_posted > 3 and status.latency_ema_sec > 0, status
        out["poster"] = {"frames_posted": status.frames_posted, "latency_ema_ms": status.latency_ema_sec * 1e3}
        zed = metrics.get()
        out["zed_metrics"] = {"fps": zed.fps, "acquisition_ms": zed.acquisition_sec * 1e3,
                              "postprocess_ms": zed.postprocess_sec * 1e3,
                              "postprocess_percent": zed.postprocess_percent}
        assert zed.postprocess_sec > 0, zed

        # red_buoy: SIGINT to its group, a clean exit the toggler reaps
        buoy = toggler.running[f"red_buoy_{direction}"].process
        os.killpg(os.getpgid(buoy.pid), signal.SIGINT)
        buoy.wait(timeout=60)
        toggler._reap()
        assert f"red_buoy_{direction}" not in toggler.running and buoy.returncode == 0, buoy.returncode
        found = re.findall(r"kernel launches: (\{.*\})", module_log("red_buoy"))
        assert found, "red_buoy logged no kernel launch counts"
        out["red_buoy_launches"] = json.loads(found[-1])
        for name in ("label_cuda", "fused_morph"):
            assert out["red_buoy_launches"][name] > 0, out["red_buoy_launches"]
        traces = sorted(profile_dir.glob("torch-profile-*.json"))
        assert len(traces) == 1, traces  # red_buoy's; poster ends by SIGTERM and writes none
        out["red_buoy_trace"] = trace_kernels(traces[0])
        if not out["red_buoy_trace"]["kernels"]:
            out["red_buoy_trace"]["note"] = "CUPTI gave no kernel record (PERF.md §7)"

        # poster: the toggle-off, the toggler's SIGTERM to its group
        post = toggler.running[f"poster_{direction}"].process
        t_off = time.monotonic()
        for module in ("red_buoy", "poster"):
            assert json.loads(request("POST", f"/toggle/{module}/{direction}?on=false"))["on"] is False
        toggler.sync()
        out["toggle_off_to_exit_ms"] = (time.monotonic() - t_off) * 1e3
        assert not toggler.running and post.returncode == -signal.SIGTERM, post.returncode
        assert out["toggle_off_to_exit_ms"] < ModuleToggler.STOP_GRACE_S * 1e3, out
        for p in (buoy, post):
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, 0)
                raise AssertionError(f"process group {p.pid} still alive")
        out["left_behind"] = {
            module: sorted(p.name for p in Path(BLOCK_STUB).parent.glob(
                Path(BLOCK_STUB).name + f"module_{module}-on-{direction}*"))
            for module in ("BuoyLAB", "Poster")}
        assert not out["left_behind"]["BuoyLAB"], out["left_behind"]
    finally:
        if toggler is not None:
            for entry in list(toggler.running.values()):
                toggler._stop(entry.name, entry.source)
        if server is not None:
            server.shutdown()
            server.server_close()
        for reader in list(web_viewer._readers.values()):
            reader.unblock()
        web_viewer._readers.clear()
        web_viewer._latest.clear()
        if source.poll() is None:
            source.send_signal(signal.SIGINT)
            try:
                source.wait(timeout=20)
            except subprocess.TimeoutExpired:
                source.kill()
                source.wait()
        source_log.close()
        vehicle.vision_modules, vehicle.module_devices = saved_vehicle
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        for path in Path(BLOCK_STUB).parent.glob(Path(BLOCK_STUB).name + f"*{direction}*"):
            path.unlink(missing_ok=True)
        for name in ("red_buoy_results", "poster_status", "zed_metrics", "vision_modules"):
            shm.delete_group(name)
    emit("orchestration", **out)
    return out


# the soak phase: tests/test_soak.py's topology on cuda:0 (tests/soak_topology.py)
# soaked seconds after the warm-up: 30 (the JAX soak's default is 90),
# so that the script stays near 800 s of its 1200 s limit
SOAK_S = 30.0
SOAK_POLL_S = 1.0  # progress, RSS and GPU memory sampled this often
SOAK_WARM_TIMEOUT_S = 120.0
# GPU memory of the soak's two module processes together: nvidia-smi's
# memory.used of the card, less its reading before they start (this
# process's own context and cache, idle during the soak). The card's
# machine attributes no memory to a process: ``--query-compute-apps`` lists
# each as pid 1 with the card's whole use. Each module's caching allocator
# reports its own peak at exit (``device memory:``). The bound: after the
# warm-up the two may grow by twice SOAK_GPU_GROWTH_MIB. Both see one frame
# size and at most four lanes a dispatch, so once both have run the
# allocator stops growing; a leak of one 320x180 BGR frame per tick (30
# ticks/s) in one module would add 155 MB in 30 s
SOAK_GPU_GROWTH_MIB = 64.0
SOAK_KERNELS = {"buoy": ("label_cuda", "fused_morph"), "yolo": ("nms_fixed",)}


def gpu_memory_mib() -> dict:
    """MiB in use on card 0 (``nvidia-smi --query-gpu=memory.used``)."""
    used = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits", "-i", "0"],
                          capture_output=True, text=True, check=True, timeout=30).stdout
    return {"card": float(used.split()[0])}


def phase_soak(run_id: str, smi: str) -> dict:
    """The topology soak on cuda:0: a faulty synthetic ZED source, red_buoy
    and YOLO (pico fixture) at 30 ticks/s, the source stopped and restarted
    at 40 %; the JAX soak's bounds plus each module's GPU memory."""
    sys.path.insert(0, str(REPO / "tests"))
    from soak_topology import run_soak

    from cuauv_vision_pipeline_tpu_torch.core import shm
    from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BLOCK_STUB

    direction = f"smoke_{run_id}_soak"
    logs = REPO / "smoke_logs" / f"soak_{run_id}"
    t0 = time.monotonic()
    try:
        out = run_soak(SOAK_S, "0", logs, direction, poll_s=SOAK_POLL_S, warm_timeout=SOAK_WARM_TIMEOUT_S,
                       gpu_memory=gpu_memory_mib)
    finally:
        for path in Path(BLOCK_STUB).parent.glob(Path(BLOCK_STUB).name + f"*{direction}*"):
            path.unlink(missing_ok=True)
        for name in shm.list_groups():
            shm.delete_group(name)
    out["seconds"] = time.monotonic() - t0
    out["nvidia_smi"] = smi
    for k in ("buoy", "yolo"):
        log = (logs / f"soak_{k}.log").read_text(errors="replace")
        assert "Device: cuda:0" in log, f"soak {k} did not run on cuda:0"
        assert out["launches"][k] is not None, f"soak {k} logged no kernel launch counts"
        assert out["allocator"][k] is not None, f"soak {k} logged no device memory"
        for name in SOAK_KERNELS[k]:
            assert out["launches"][k][name] > 0, f"soak {k} never launched {name}: {out['launches'][k]}"
    assert out["clean_exits"][:2] == [0, 0], f"a module's SIGINT exit: {out['clean_exits']}"
    warm, peak = out["gpu_after_warm_mb"]["card"], out["gpu_peak_mb"]["card"]
    out["gpu_modules_mib"] = {"after_warm": warm - out["gpu_before_mb"]["card"],
                              "peak": peak - out["gpu_before_mb"]["card"]}
    out["gpu_growth_bound_mib"] = 2 * SOAK_GPU_GROWTH_MIB
    assert peak <= warm + out["gpu_growth_bound_mib"], f"soak: GPU memory grew {warm} -> {peak} MiB"
    emit("soak", **out)
    return out


BENCH_RESULTS = REPO / "smoke_logs" / "bench_results.json"


def phase_report(smi: str, chain: dict, yolo: dict, module: dict, soak: dict) -> list:
    """This run's numbers as metric objects in bench.py's schema (each with
    the card's name and power limit), written to ``BENCH_RESULTS`` and
    rendered by the port's ``misc.bench_report`` in a fresh process."""
    card, power_limit = (s.strip() for s in smi.rsplit(",", 1))

    def metric(name, value, unit, note, **context):
        return {"metric": name, "value": value, "unit": unit, **context, "card": card, "power_limit": power_limit,
                "note": note}

    def spread(key, name, what):
        s = module[key]
        return metric(name, s["median"], "ms", f"median latency_ms of {what} over the module phase's results: "
                      "camera stamp to result written, the module's tick wait (10 ticks/s) included",
                      min=s["min"], max=s["max"], samples=s["samples"])

    fps = chain["fps"]
    results = [
        metric("red_buoy_1080p_device_chain_fps_per_chip", fps["batched8_fused"]["median"], "frames/sec",
               "the production chain on device-resident [8, 1080, 1920, 3] stacks at the disc threshold; "
               f"median of {FPS_REPEATS} windows of {FPS_WINDOW_S} s", min=fps["batched8_fused"]["min"],
               max=fps["batched8_fused"]["max"], lane="batched_8"),
        metric("red_buoy_1080p_per_frame_fps", fps["per_frame_fused"]["median"], "frames/sec",
               "the production chain on one device-resident 1080p frame a call at the disc threshold; "
               f"median of {FPS_REPEATS} windows of {FPS_WINDOW_S} s", min=fps["per_frame_fused"]["min"],
               max=fps["per_frame_fused"]["max"], lane="per_frame"),
        metric("yolo_obb_1080p_event_ms_per_frame", yolo["device_decode_ms"], "ms",
               "YoloModel.device_decode (YOLOv8n-obb, 640, bf16, seeded random init) on a device-resident "
               "1080p ZED frame: median of 50 calls between CUDA events"),
        metric("red_buoy_module_latency_ms", module["latency_ms"], "ms",
               "one latency_ms reading of shm.red_buoy_results at the disc threshold: camera stamp to result "
               "written, the module's tick wait (10 ticks/s) included"),
        spread("yolo_latency_ms", "yolo_p50_camera_to_detection_ms", "shm.yolo_status (modules.yolo, 1080p zed "
               "camera, seeded random init)"),
        spread("bins_latency_ms", "bins_module_latency_ms", "shm.bins_pose (720p)"),
        spread("stereo_latency_ms", "red_buoy_stereo_module_latency_ms", "shm.red_buoy_stereo_results"),
        spread("multicam_latency_ms", "yolo_multicam_module_latency_ms", "shm.yolo_status (zed 720p + flir)"),
        spread("gate_latency_ms", "yolo_gate_module_latency_ms", "shm.yolo_status (gate checkpoint, 720p)"),
        metric("soak_recovery_s", soak["recovery_s"], "s", "source restart to both modules' next result, "
               f"the soak of {SOAK_S} s ({soak['faults']})"),
        metric("soak_warm_s", soak["warm_s"], "s", "soak start to both modules' third result (cold processes)"),
        metric("soak_unwind_s", soak["unwind_s"], "s", "SIGINT to all three processes exited"),
    ]
    for k, name in (("buoy", "red_buoy"), ("yolo", "yolo")):
        results += [
            metric(f"soak_{name}_results", soak["frames"][k], "group writes",
                   f"seq advances of its result group over the soak of {SOAK_S} s"),
            metric(f"soak_{name}_max_gap_s", soak["max_gap_s"].get(k), "s",
                   f"longest time without a result write, sampled every {SOAK_POLL_S} s, outside the outage "
                   "(no finer than the poller's longest interval)", longest_poll_s=soak["max_poll_s"]),
            metric(f"soak_{name}_rss_peak_mb", soak["rss_peak_mb"][k], "MB", "peak RSS over the soak",
                   after_warm=soak["rss_after_warm_mb"][k]),
            metric(f"soak_{name}_allocator_peak_mib", soak["allocator"][k]["max_reserved_mib"], "MiB",
                   "the module's caching allocator at its peak over its run (its CUDA context not in it)",
                   max_allocated=soak["allocator"][k]["max_allocated_mib"]),
        ]
    results.append(metric("soak_modules_gpu_peak_mib", soak["gpu_modules_mib"]["peak"], "MiB",
                          "nvidia-smi memory.used of the card over the soak less its use before the modules started: "
                          "both module processes, CUDA contexts included", after_warm=soak["gpu_modules_mib"]["after_warm"]))
    BENCH_RESULTS.parent.mkdir(parents=True, exist_ok=True)
    BENCH_RESULTS.write_text(json.dumps(results, indent=1))
    proc = subprocess.run([sys.executable, "-m", "cuauv_vision_pipeline_tpu_torch.misc.bench_report",
                           str(BENCH_RESULTS)], cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, f"bench_report exited {proc.returncode}: {proc.stderr[-2000:]}"
    BENCH_RESULTS.with_name("bench_report.md").write_text(proc.stdout)
    head, _, table = proc.stdout.partition("## All metrics")
    rows = [line for line in table.splitlines() if line.startswith("| ") and not line.startswith("| metric |")]
    assert len(rows) == len(results), f"the report's All metrics table has {len(rows)} rows for {len(results)}"
    targets = [line for line in head.splitlines() if line.startswith("| ") and not line.startswith("| metric |")]
    emit("report", path=str(BENCH_RESULTS.relative_to(REPO)), metrics=len(results), targets=targets)
    return results


MESH_KERNELS = ("fused_morph", "label_cuda", "spacing_select", "nms_fixed")
MESH_FANOUT_ROUNDS = 50
MESH_TIMED_STEPS = 5


def mesh_train_diff(ranks, grid, want_loss, want_grads) -> dict:
    """The ranks' step (loss, gradients joined from the slices of the data
    row ``grid[0]``) against the one-process card step's."""
    from cuauv_vision_pipeline_tpu_torch.parallel.mesh import gather_params

    grads = gather_params([r["grads"] for r in ranks], grid, ranks[0]["shardings"])
    err = {n: ((grads[n] - g).abs().max() / g.norm().clamp_min(1e-30)).item() for n, g in want_grads.items()}
    worst = max(err, key=err.get)
    return {"loss": ranks[0]["loss"], "one_process_loss": want_loss,
            "loss_rel_err": abs(ranks[0]["loss"] - want_loss) / abs(want_loss),
            "grad_err_of_norm": err[worst], "grad_worst": worst,
            "split_params": sum("model" in s for s in ranks[0]["shardings"].values())}


def mesh_cameras_and_merge(result, dev) -> list:
    """Each rank's camera against the one-card ``chain_one`` on its frame,
    and each rank's merged list against ``cross_camera_nms`` on the stacked
    lists, in this process on ``dev``: the failures (exact equality)."""
    from cuauv_vision_pipeline_tpu_torch.entry import DRYRUN_MAX_DET
    from cuauv_vision_pipeline_tpu_torch.parallel.crosscam import cross_camera_nms
    from cuauv_vision_pipeline_tpu_torch.parallel.fanout import chain_one

    data, failures = result["data"], []
    for cam, r in enumerate(result["ranks"]):
        want = chain_one(torch.from_numpy(data["frames"][cam]).to(dev), 140, 255)
        for key, value in want.items():
            if not np.array_equal(r["fan"][key], value.cpu().numpy()):
                failures.append(f"rank {cam} camera {key}: {r['fan'][key]} != {value.cpu().numpy()}")
    merged = cross_camera_nms(torch.from_numpy(data["dets"]).to(dev), max_det=DRYRUN_MAX_DET).cpu().numpy()
    failures += [f"rank {i} merged list differs" for i, r in enumerate(result["ranks"])
                 if not np.array_equal(r["merged"], merged)]
    return failures


def phase_mesh(dev, smi: str) -> dict:
    """The (data, model) mesh on the card (``parallel/mesh.py``): (a)
    ``dryrun_multichip(1)`` on NCCL, rank 0 on cuda:0, and beside it (b)
    ``dryrun_multichip(2)`` with both ranks on cuda:0 over gloo (dp 1 x tp
    2) and ``dryrun_multichip(4)`` with four (dp 2 x tp 2: the data
    group's BatchNorm sums, normalisers and gradient sums on card
    tensors): each train step against the one-process card step on the
    global batch (TF32 off) at TRAIN_LOSS_RTOL and TRAIN_GRAD_TOL; (a), (b):
    every rank's camera and merged list exactly as the one-card forms give
    them here, and each rank's launches of MESH_KERNELS; (c)
    ``examples.multichip_fanout`` with 2 ranks on cuda:0 at 1080p, ms per
    round per rank; (d) the dp 1 x tp 2 step at bench.py's train cell
    (YOLOv8n detect, 8 classes, b16@320) on two ranks sharing cuda:0, ms
    per step (wall, synchronized) beside the one-process step's. (b)-(d)
    are ranks sharing one card over gloo: a rehearsal that says nothing of
    four cards.
    Returns the ranks' launch counts summed (``mesh_launches``)."""
    from cuauv_vision_pipeline_tpu_torch import entry
    from cuauv_vision_pipeline_tpu_torch.core.device import full_f32
    from cuauv_vision_pipeline_tpu_torch.examples import multichip_fanout
    from cuauv_vision_pipeline_tpu_torch.models.yolo.model import create_model
    from cuauv_vision_pipeline_tpu_torch.models.yolo.train import create_train_state, make_train_step
    from cuauv_vision_pipeline_tpu_torch.parallel.fanout import chain_one
    from cuauv_vision_pipeline_tpu_torch.parallel.mesh import launch

    start = time.monotonic()
    out, failures = {"nvidia_smi": smi, "rehearsal": "ranks sharing one card over gloo; says nothing of four cards"}, []
    launched = {}

    def count(ranks, what, kernels=MESH_KERNELS):
        for i, r in enumerate(ranks):
            for name, n in r["launches"].items():
                launched[name] = launched.get(name, 0) + n
            missing = [k for k in kernels if not r["launches"][k]]
            if missing:
                failures.append(f"{what} rank {i} launched no {missing}")
        return [r["launches"] for r in ranks]

    def dryrun(n, backend, device):
        t0 = time.monotonic()
        return entry.dryrun_multichip(n, backend=backend, device=device), time.monotonic() - t0

    # the three dry runs side by side (their numbers do not depend on it)
    with ThreadPoolExecutor(3) as pool:
        runs = {key: pool.submit(dryrun, *args) for key, args in
                (("nccl_1", (1, "nccl", None)), ("gloo_2", (2, "gloo", "cuda:0")),
                 ("gloo_4", (4, "gloo", "cuda:0")))}
    for key, run in runs.items():
        result, seconds = run.result()
        n = len(result["ranks"])
        row = out[key] = {"seconds": seconds, "dp": result["dp"], "tp": result["tp"],
                          "loss": result["loss"], "launches": count(result["ranks"], key)}
        failures += [f"{key}: {f}" for f in mesh_cameras_and_merge(result, dev)]
        if n > 1:
            data = result["data"]
            model = create_model(entry.DRYRUN_CLASSES, "n", "detect").to(dev)
            step = make_train_step(create_train_state(model))
            with full_f32():
                loss = float(step(*(torch.from_numpy(data[k]).to(dev) for k in ("images", "t_xyxy", "t_cls"))))
            grid = np.arange(n).reshape(result["dp"], result["tp"])
            row.update(mesh_train_diff(result["ranks"], grid, loss,
                                       {name: p.grad.cpu() for name, p in model.named_parameters()}))
            if not (row["loss_rel_err"] <= TRAIN_LOSS_RTOL and row["grad_err_of_norm"] <= TRAIN_GRAD_TOL):
                failures.append(f"{key} step against the one-process step: {row}")

    t0 = time.monotonic()
    fan = multichip_fanout.run(["--cameras", "2", "--backend", "gloo", "--rounds", str(MESH_FANOUT_ROUNDS)])
    frames = multichip_fanout.camera_frames(2, 1080)
    for cam, r in enumerate(fan["ranks"]):
        want = chain_one(torch.from_numpy(frames[cam]).to(dev), 140, 255)
        if not (r["blob"]["area"] > 0 and all(np.array_equal(r["blob"][k], v.cpu().numpy()) for k, v in want.items())):
            failures.append(f"multichip_fanout rank {cam}: {r['blob']} != the one-card chain_one")
    out["fanout_1080p"] = {"seconds": time.monotonic() - t0, "ms_per_round": [r["ms_per_round"] for r in fan["ranks"]],
                           "aggregate_fps": fan["aggregate_fps"],
                           "launches": count(fan["ranks"], "fanout", ("fused_morph", "label_cuda"))}

    t0 = time.monotonic()
    inputs = train_inputs("detect")
    ranks = launch(entry.mesh_train_rank, 2, "gloo", "cuda:0",
                   args=(1, 2, inputs, None, None, MESH_TIMED_STEPS + 1, TRAIN_MODELS["detect"]))
    model = create_model(TRAIN_MODELS["detect"], "n", "detect").to(dev)
    step = make_train_step(create_train_state(model))
    batch = [torch.from_numpy(a).to(dev) for a in inputs]
    one = []
    with full_f32():
        for _ in range(MESH_TIMED_STEPS + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            float(step(*batch))
            torch.cuda.synchronize()
            one.append((time.perf_counter() - t1) * 1e3)
    out["dp1_tp2_b16_320"] = {
        "seconds": time.monotonic() - t0, "steps": MESH_TIMED_STEPS, "first_step_ms": ranks[0]["ms_per_step"][0],
        "ms_per_step": statistics.median(ranks[0]["ms_per_step"][1:]), "rank_ms": [r["ms_per_step"] for r in ranks],
        "one_process_ms_per_step": statistics.median(one[1:]), "loss": ranks[0]["loss"],
        "split_params": sum("model" in s for s in ranks[0]["shardings"].values())}
    if not np.isfinite(ranks[0]["loss"]):
        failures.append(f"dp1 x tp2 b16@320: loss {ranks[0]['loss']}")
    out["seconds"] = time.monotonic() - start
    out["mesh_launches"] = launched
    emit("mesh", **out)
    if failures:
        raise AssertionError("mesh: " + "; ".join(failures))
    return out


NATIVE_ZED_S = 1.0  # the zed stub's capture loop runs about this long
# every run on the machine takes its turn at framebus_test and the zed stub
# loop through this lock (its name matches no bus or group prefix, so no
# clean-up removes it)
NATIVE_LOCK = "/dev/shm/cuauv_native_binaries.lock"
NATIVE_TURN_WAIT_S = 120.0  # another run's turn lasts a few seconds


@contextlib.contextmanager
def machine_turn(path: str, wait_s: float):
    """Hold an exclusive ``flock`` on ``path`` (created if absent, never
    removed: removing a lock file lets two holders lock two files) for the
    ``with`` block; wait up to ``wait_s`` for another holder to let go."""
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o666)
    try:
        deadline = time.monotonic() + wait_s
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"another process held {path} for {wait_s} s") from None
                time.sleep(0.1)
        yield
    finally:
        os.close(fd)


def mapped_by(path: str) -> list:
    """The pids, other than this one, that map ``path`` (``/proc/*/maps``;
    a mapping of an unlinked file of that name ends in " (deleted)" and does
    not count)."""
    pids = []
    for entry in os.scandir("/proc"):
        if not entry.name.isdigit() or int(entry.name) == os.getpid():
            continue
        try:
            with open(os.path.join(entry.path, "maps")) as maps:
                if any(line.rstrip("\n").endswith(" " + path) for line in maps):
                    pids.append(int(entry.name))
        except OSError:
            continue
    return pids


def zed_stub_frame(block: str, t0: float, failures: list) -> dict:
    """Read the zed stub's frames on ``block`` through the port's
    ``BlockAccessor`` for about NATIVE_ZED_S after ``t0`` and check the last
    one as the JAX package's stub test does; the checks by name."""
    from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BlockAccessor, ReadStatus

    deadline = time.monotonic() + 20
    while not os.path.exists(block) and time.monotonic() < deadline:
        time.sleep(0.02)
    frames = 0
    with BlockAccessor("zed") as acc:
        while time.monotonic() - t0 < NATIVE_ZED_S or not frames:
            status, data, _ = acc.read_frame()
            if status == ReadStatus.SUCCESS:
                frames += 1
                planes, last = acc.last_plane_names(), data
            elif time.monotonic() > deadline:
                break
            time.sleep(0.05)
    if not frames:
        failures.append("no frame from the zed stub's capture loop")
        return {}
    fwd, fwd2, depth, normal = last
    checks = {
        "frames_read": frames,
        "planes": planes == ("forward", "forward2", "depth", "normal"),
        "forward": fwd.shape == (180, 320, 3) and fwd.dtype == np.uint8 and fwd[0, 5, 2] == 200,
        "forward2": fwd2[0, 5, 2] == 100,
        "depth": depth.dtype == np.float32 and depth[0, 0, 0] == 0.0 and depth[10, 10, 0] == 2.5,
        "normal": (normal.dtype == np.float32 and abs(normal[10, 10, 0] - 1.0) < 1e-6
                   and abs(normal[10, 10, 1]) < 1e-6 and abs(normal[10, 10, 2] - 0.5) < 1e-6
                   and abs(normal[0, 0, 0] - 0.5) < 1e-6),
    }
    checks = {k: v if k == "frames_read" else bool(v) for k, v in checks.items()}
    failures += [f"zed stub frame: {k}" for k, ok in checks.items() if ok is False]
    return checks


def phase_native() -> dict:
    """The port's C++ capture binaries, built here with g++ alone
    (``native.build_binary``): ``stubcheck``'s two SDK-gated sources against
    ``test_stubs/``, ``flir_capture_stub`` (``--parse-only`` on the port's
    ``configs/flir.conf``) and ``framebus_test``, which must pass; then the
    zed stub's capture loop for about NATIVE_ZED_S, its aggregated 4-plane
    frame on direction ``zed`` read through the port's ``BlockAccessor``:
    plane names, shapes, dtypes, the view markers and the scrubbed NaNs the
    JAX package's stub test checks. ``framebus_test`` and the loop run in
    this run's turn on the machine (NATIVE_LOCK); the loop does not run
    while another process maps the ``zed`` block."""
    from cuauv_vision_pipeline_tpu_torch import native
    from cuauv_vision_pipeline_tpu_torch.core import shm
    from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BLOCK_STUB

    out, failures = {}, []
    start = t0 = time.monotonic()
    names = (*native.STUBCHECK, "flir_capture_stub", "framebus_test")
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(native.build_binary, names)))
    out["build_seconds"] = time.monotonic() - t0
    parse = subprocess.run([str(paths["flir_capture_stub"]), "--parse-only",
                            str(REPO / "cuauv_vision_pipeline_tpu_torch" / "configs" / "flir.conf")],
                           capture_output=True, text=True, timeout=30)
    out["flir_parse_only"] = parse.stdout.strip()
    if parse.returncode or "serial=" not in parse.stdout:
        failures.append(f"flir_capture_stub --parse-only: {parse.stdout} {parse.stderr}")

    # framebus_test's blocks (nativetest_*) and the stub's direction ``zed``
    # and group zed_calibration are named by the C++ without this run's
    # namespace: every run on the machine takes its turn at them
    # (NATIVE_LOCK), a block that another process maps is left alone (the
    # phase fails), and this run removes only the files it made, before its
    # turn ends
    block, calib = BLOCK_STUB + "zed", shm.SHM_STUB + "zed_calibration"
    t0 = time.monotonic()
    with machine_turn(NATIVE_LOCK, NATIVE_TURN_WAIT_S):
        out["turn_wait_s"] = time.monotonic() - t0
        test = native.run_test()
        out["framebus_test"] = test.stdout.strip().splitlines()[-1:]
        if test.returncode or "all native tests passed" not in test.stdout:
            failures.append(f"framebus_test: {test.stdout[-800:]} {test.stderr[-800:]}")
        users = mapped_by(block)
        if users:
            raise AssertionError(f"native: {block} is mapped by pids {users} (a zed source on this "
                                 f"machine); the zed stub loop writes that direction, so it did not run")
        made_block, made_calib = not os.path.exists(block), not os.path.exists(calib)
        namespace = os.environ.pop("CUAUV_SHM_NAMESPACE", None)
        try:
            shm.group("zed_calibration").get()
        finally:
            if namespace is not None:
                os.environ["CUAUV_SHM_NAMESPACE"] = namespace
        t0 = time.monotonic()
        proc = subprocess.Popen([str(paths["zed_capture_stubcheck"])], cwd=REPO,
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        try:
            out["zed_checks"] = zed_stub_frame(block, t0, failures)
        finally:
            proc.kill()
            proc.wait()
            if made_block and os.path.exists(block):
                os.unlink(block)
            if made_calib and os.path.exists(calib):
                os.unlink(calib)
    out["seconds"] = time.monotonic() - start
    emit("native", **out)
    if failures:
        raise AssertionError("native: " + "; ".join(failures))
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
                    "yolo": ("nms_fixed",), "yolo_tasks": ("nms_fixed",),
                    "bins": ("fused_morph", "spacing_select"),
                    "stereo": ("label_cuda_batched", "fused_morph"), "multicam": ("nms_fixed",),
                    "correction": (), "train": ("nms_fixed",),
                    "library": ("label_cuda", "label_cuda_batched", "fused_morph")}
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

    chain = run_path("red_buoy", lambda: phase_chain(dev, frames))
    serve, image, pool, yolo = run_path("yolo", lambda: phase_yolo(dev))
    run_path("yolo_tasks", lambda: phase_yolo_tasks(dev))
    card, bins_image, bins_wall_ms = run_path("bins", lambda: phase_bins(dev))
    stereo_in, stereo_wall_ms = run_path("stereo", lambda: phase_stereo(dev))
    multicam = run_path("multicam", lambda: phase_multicam(dev))
    correction = run_path("correction", lambda: phase_correction(dev))
    run_path("train", lambda: phase_train(dev, run_id))
    module = phase_module(run_id)
    soak = phase_soak(run_id, smi)
    phase_report(smi, chain, yolo, module, soak)
    orchestration = phase_orchestration(run_id, smi)
    logged = [v for k, v in (*module.items(), *orchestration.items()) if k.endswith("_launches")]
    for launched in (*logged, *soak["launches"].values()):
        for name, n in launched.items():
            counts[name] += n
    run_path("library", lambda: phase_library(dev, smi))
    # the mesh's rank processes count their own launches
    for name, n in phase_mesh(dev, smi)["mesh_launches"].items():
        counts[name] += n
    phase_native()
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

    emit("total", seconds=time.monotonic() - _T0)
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

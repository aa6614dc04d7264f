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
5. module  — the real entry points as subprocesses: the synthetic camera
             (``--scene zed``, the ZED's four planes) and
             ``modules.red_buoy``, both on a direction named for this run
             and with ``CUAUV_SHM_NAMESPACE`` set to this run's own
             namespace, so another run on the machine shares no bus block,
             tuner block or shm group with this one; checks
             ``shm.red_buoy_results`` under default tuners (whole frame) and
             after ``thresh_min=140`` (the red disc) set through the
             ModuleReader, reads ``latency_ms`` and the module's CCL launch
             count, then removes the blocks and groups this run made.

Launch counts are set to 0 just before the chain phase and read after the
module phase (plus the module process's own logged counts): that is the
main path's run. Then the CCL kernels' and the morphology's device time
per call (torch.profiler) beside their event-timed wall time, a
``{"kernels": [...]}`` line and, last, the ``{"ok": true, "device": ...}``
line.

``--morph-variant NAME=SOURCE.cu`` (repeatable) builds another source with
the C entry point of ``csrc/morph.cu`` (an earlier version, a design
variant) into the git-ignored ``local/``, holds it against the plain
morphology and times it beside ``csrc/morph.cu`` in the device phase, with
the SASS opcode counts of both.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

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
MORPH_OPS = ("open_close", "open", "close")
# CUDA launches behind one wrapper call (csrc/ccl.cu: local, border, final)
CUDA_LAUNCHES_PER_CALL = {"label_cuda": 3, "label_cuda_batched": 3, "fused_morph": 1}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def phase_module():
    # this run's own names: the camera's direction (so the bus block and the
    # module's post and tuner blocks) and the shm namespace of its groups
    run_id = uuid.uuid4().hex[:12]
    direction = f"smoke_{run_id}"
    os.environ["CUAUV_SHM_NAMESPACE"] = f"smoke-{run_id}"
    from cuauv_vision_pipeline_tpu_torch.core import shm
    from cuauv_vision_pipeline_tpu_torch.core.base import ModuleReader
    from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BLOCK_STUB

    logs = REPO / "smoke_logs"
    logs.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    results = shm.red_buoy_results
    results.set(visible=False, area=0.0, latency_ms=0.0)
    module_name = f"BuoyLAB-on-{direction}"
    procs = []

    def start(args, name):
        log = open(logs / f"{name}.log", "w")
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env=env,
                             stdout=log, stderr=subprocess.STDOUT)
        procs.append((p, log, name))
        return p

    def wait_for(cond, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for p, _, name in procs:
                if p.poll() is not None:
                    raise RuntimeError(f"{name} exited ({p.returncode}) while waiting for {what}")
            if cond():
                return
            time.sleep(0.05)
        raise TimeoutError(f"timed out waiting for {what}")

    out = {}
    reader = None
    try:
        # the zed scene sends the ZED's planes (forward, forward2, depth,
        # normal) under any direction; the module's chain binds "forward"
        start(["cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic", direction,
               "--scene", "zed", "--fps", "30"], "source")
        module = start(["cuauv_vision_pipeline_tpu_torch.modules.red_buoy", direction], "module")
        wait_for(lambda: results.visible.get(), 180, "the first detection")
        wait_for(lambda: results.area.get() == H * W, 10, "a whole-frame area")
        out["area_default_tuners"] = results.area.get()
        wait_for(lambda: module_name in ModuleReader.get_active_modules(), 30, "tuner blocks")
        reader = ModuleReader(module_name)
        reader.run_forever(fps=30)
        reader.update_tuner_value("thresh_min", 140)
        wait_for(lambda: 20000 < results.area.get() < 27000, 30, "the disc's area")
        time.sleep(1.0)  # a few more frames at the new threshold
        out["area_thresh_min_140"] = results.area.get()
        assert 20000 < out["area_thresh_min_140"] < 27000, out
        out["latency_ms"] = results.latency_ms.get()
        out["latency_newest_ms"] = results.latency_newest_ms.get()
        reader.unblock()
        reader = None
        module.send_signal(signal.SIGINT)
        module.wait(timeout=60)
        assert module.returncode == 0, f"module exited with {module.returncode}"
        text = (logs / "module.log").read_text()
        found = re.findall(r"kernel launches: (\{.*\})", text)
        assert found, "module logged no kernel launch counts"
        out["module_launches"] = json.loads(found[-1])
        assert out["module_launches"]["label_cuda"] > 0, out
        assert out["module_launches"]["fused_morph"] > 0, out
    finally:
        if reader is not None:
            reader.unblock()
        for p, log, _ in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
                try:
                    p.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            log.close()
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
    frames = [torch.from_numpy(buoy_frame((H, W), 0.4 * i)).to(dev) for i in range(8)]
    rows, ccl_inputs, masks = phase_kernels(dev, frames, rate)

    reset_launch_counts()
    phase_chain(dev, frames)
    counts = launch_counts()
    module = phase_module()
    for name, n in module["module_launches"].items():
        counts[name] += n
    for name, n in counts.items():
        assert n > 0, f"{name} was not launched on the main path"
    phase_ccl_device(ccl_inputs)
    phase_morph_device(masks, builds)

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

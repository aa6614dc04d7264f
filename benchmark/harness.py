"""Drive one cell of ``BENCHMARK.json`` once: set-up, a closed-loop window
through the module's device loop, the check against the plain reference,
and the result line.

What a cell runs is found by name: ``configs/<config>.json`` (sizes, the
module's device function, the comparison's limits) with its adapter
``systems/<system>.py`` and its plain reference ``configs/<reference>.py``;
``traffic/<mix>.json`` (frames per dispatch, the ring of scenes, the scene
parameters); ``metrics/<metric>.py`` (one reader per per-layer metric).

The loop is what ``ModuleBase`` runs for a module's ``@device_fn``, in this
process and without the frame bus: ``build_packed_fn`` of the module's chain
-> ``DevicePipeline`` -> ``StreamExecutor`` with the depth and fetch mode the
module declares, fed host u8 frames as the bus hands them over, results
unpacked by ``unpack_result``. It is closed: each dispatch is submitted as
soon as the executor takes it, as when the module has fallen behind its
camera and finds frames queued.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import mmap
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(1, str(REPO))

import guard  # noqa: E402
import scenes  # noqa: E402
import stats  # noqa: E402

FLUSH_S = 60.0  # a result may come this late after the window and still count as come
WARMUP_DISPATCHES = 6


class RunError(RuntimeError):
    """A run that cannot give a result (no card, a forbidden import, a file
    left in /dev/shm, no kernel record in the trace)."""


def load_file(path: Path) -> ModuleType:
    """Import one file of the benchmark by its path."""
    name = "bench_" + path.stem.replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(bench: Dict, workload: str):
    """(cell, config, mix, end-to-end metric entries, per-layer entries)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    cfg = load_json(BENCH / "configs" / f"{cell['config']}.json")
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return cell, cfg, mix, e2e, layer


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read: {exc}"


class Spans:
    """Host spans of the benchmark's own calls into the program (wall clock,
    ns, the profiler's clock): kept in memory, read after the window."""

    def __init__(self):
        self.items: List[tuple] = []

    def wrap(self, name: str, fn: Callable) -> Callable:
        items = self.items

        def timed(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                items.append((name, t0, time.time_ns()))

        return timed


def _device_events(prof) -> Dict[str, List[tuple]]:
    """Kernel, copy and memset records of a torch.profiler trace as
    (name, start ns, end ns), wall clock."""
    out = {"kernel": [], "HtoD": [], "DtoH": [], "other": []}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        rec = (name, e.start_ns(), e.start_ns() + e.duration_ns())
        if name.startswith("Memcpy HtoD"):
            out["HtoD"].append(rec)
        elif name.startswith("Memcpy DtoH"):
            out["DtoH"].append(rec)
        elif name.startswith(("Memcpy", "Memset")):
            out["other"].append(rec)
        else:
            out["kernel"].append(rec)
    return out


def host_ring(frames: torch.Tensor) -> np.ndarray:
    """The ring's frames in shared host memory (an anonymous ``MAP_SHARED``
    mapping, as the frame bus's ring is a shared mapping; no file is made),
    the array the dispatches read."""
    buf = mmap.mmap(-1, frames.numel() * frames.element_size(), flags=mmap.MAP_SHARED)
    ring = np.frombuffer(buf, dtype=np.uint8).reshape(tuple(frames.shape))
    ring[...] = frames.cpu().numpy()
    return ring


def _host_label(spans: List[tuple], t: int) -> str:
    """What the harness's thread was inside at wall time ``t``."""
    inner = [s for s in spans if s[1] <= t < s[2]]
    if not inner:
        return "harness"
    return min(inner, key=lambda s: s[2] - s[1])[0]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_process: float, bench: Optional[Dict] = None,
             overrides: Optional[Dict] = None, wrap_chain: Optional[Callable] = None,
             log=print) -> Dict[str, Any]:
    """One run of ``workload``; returns the result line as a dict.

    ``t_process`` is the monotonic time the process started at. ``bench``
    replaces BENCHMARK.json, and ``overrides`` ({"config": {...}, "traffic":
    {...}}) replace entries of the cell's files (the CPU tests' small
    sizes); ``wrap_chain`` wraps the module's chain (the tests' faults)."""
    shm_before = guard.shm_entries()
    bench = bench or load_json(REPO / "BENCHMARK.json")
    _, cfg, mix, e2e, layer = find_cell(bench, workload)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    mix = {**mix, **overrides.get("traffic", {})}

    with tempfile.TemporaryDirectory(prefix="bench-") as workdir, contextlib.redirect_stdout(sys.stderr):
        result = _run(workload, cfg, mix, e2e, layer, seed, seconds, trace, device,
                      t_process, Path(workdir), wrap_chain, log)

    found = guard.forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package were loaded: {found}")
    left = guard.shm_left(shm_before)
    if left:
        raise RunError(f"the run left files in {guard.SHM_DIR}: {left}")
    return result


def _run(workload, cfg, mix, e2e, layer, seed, seconds, trace, device, t_process,
         workdir: Path, wrap_chain, log) -> Dict[str, Any]:
    from cuauv_vision_pipeline_tpu_torch.core import shm

    # the port's shm groups are files under this stub; a run creates none in /dev/shm
    shm.SHM_STUB = str(workdir / "auv_shm_")
    from cuauv_vision_pipeline_tpu_torch.engine.executor import (
        DevicePipeline,
        StreamExecutor,
        build_packed_fn,
        unpack_result,
    )
    from cuauv_vision_pipeline_tpu_torch.ops.cuda import launch_counts

    if trace and device.type != "cuda":
        raise RunError("no trace slice without a CUDA card: the device metrics read the card's trace")

    # -- the ring of scenes, stacked into each dispatch's shape -----------
    eyes = int(mix["scene"].get("eyes", 1))
    lanes = int(mix["frames_per_dispatch"]) // eyes
    per_dispatch = lanes * eyes
    ring = int(mix["ring_frames"])
    if ring % per_dispatch or (eyes > 1 and lanes != 1):
        raise RunError(f"a ring of {ring} frames does not split into dispatches of {eyes} x {lanes}")
    H, W = cfg["height"], cfg["width"]
    frames_dev = scenes.make_scenes(ring, H, W, mix["scene"], seed, device)
    host = host_ring(frames_dev)
    slots = []
    for s in range(ring // per_dispatch):
        block = host[s * per_dispatch:(s + 1) * per_dispatch]
        if eyes > 1:
            slots.append(tuple(np.ascontiguousarray(block[a]) for a in range(eyes)))
        else:
            slots.append((np.ascontiguousarray(block) if lanes > 1 else np.ascontiguousarray(block[0]),))

    # -- the system under test: the module's device function --------------
    adapter = load_file(BENCH / "systems" / f"{cfg['system']}.py")
    reference = load_file(BENCH / "configs" / f"{cfg['reference']}.py")
    # every adapter gets what a model's would need (weights made on the device from the seed, a checkpoint
    # written under the run's workdir, freed by ``release`` before the reference runs): this file is not
    # edited when a configuration is added
    system = adapter.build(cfg, eyes, device, seed, frames_dev, workdir, reference)
    fn = system.chain
    depth = fn._device_fn_depth
    async_fetch = fn._device_fn_async
    mode = fn._device_fn_batch_mode
    if len(fn._device_fn_aliases) != eyes:
        raise RunError(f"{cfg['name']}'s device function takes {len(fn._device_fn_aliases)} cameras, "
                       f"the mix {eyes}")
    chain = wrap_chain(fn) if wrap_chain else fn
    spans = Spans()
    pipeline = DevicePipeline(spans.wrap("launch", build_packed_fn(chain, lanes, mode)), device)
    pipeline.to_device = spans.wrap("h2d", pipeline.to_device)
    executor = StreamExecutor(pipeline, depth=depth, async_fetch=async_fetch)
    submit = spans.wrap("submit", executor.submit)
    call = dict(tuners=system.tuners, want_posts=system.want_posts)
    log(f"[bench] {workload}: {cfg['name']} {H}x{W}, {per_dispatch} frames per dispatch "
        f"({eyes} camera(s) x {lanes} lane(s), {mode}), depth {depth}, async fetch {async_fetch}, "
        f"ring of {ring} frames ({host.nbytes / 1e6:.1f} MB host), device {device}")
    del frames_dev  # the reference reads the host ring after the window

    results: Dict[int, Dict[bytes, int]] = {}
    spec_of: Dict[int, Any] = {}

    def take(ready, t_end):
        n_in = 0
        for (packed, spec), (slot, t_sub) in ready:
            unpack_result(packed, spec)
            t_done = time.perf_counter_ns()
            key = packed.tobytes()
            bucket = results.setdefault(slot, {})
            bucket[key] = bucket.get(key, 0) + 1
            spec_of[slot] = spec
            if t_end is None or t_done <= t_end:
                latencies.extend([(t_done - t_sub) / 1e6] * per_dispatch)
                done_at.append(t_done)
                n_in += per_dispatch
        return n_in

    latencies: List[float] = []
    done_at: List[int] = []
    take_spans = spans.wrap("unpack", take)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # -- warm-up: every shape this cell uses, then drained ---------------
    for i in range(WARMUP_DISPATCHES):
        take(executor.submit(slots[i % len(slots)], meta=(i % len(slots), time.perf_counter_ns()), **call),
             None)
    take(executor.flush(), None)
    if trace:  # CUPTI's first start takes seconds: pay it here, not in the window
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)
    sync()
    results.clear()
    latencies.clear()
    done_at.clear()
    spans.items.clear()
    launches0 = launch_counts()

    # -- the window --------------------------------------------------------
    trace_s = min(float(mix.get("trace_seconds", 1.0)), seconds / 2)
    lead_ns = int(min(1.0, seconds / 4) * 1e9)
    prof = None
    traced = None  # (t_lo, t_hi wall ns, dispatches, device records) of the profiled slice
    attempts = 0
    t_start = time.perf_counter_ns()
    setup_s = time.monotonic() - t_process
    t_end = t_start + int(seconds * 1e9)
    done = 0
    n = 0
    slice_n0 = 0
    while True:
        now = time.perf_counter_ns()
        if now >= t_end:
            break
        if trace and traced is None:
            if prof is None and now >= t_start + lead_ns and t_end - now >= trace_s * 1e9:
                sync()
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                t_lo, slice_end, slice_n0 = time.time_ns(), time.perf_counter_ns() + int(trace_s * 1e9), n
            elif prof is not None and now >= slice_end:
                sync()
                t_hi = time.time_ns()
                prof.stop()
                attempts += 1
                events = _device_events(prof)
                if events["kernel"]:
                    traced = (t_lo, t_hi, n - slice_n0, events)
                else:
                    log(f"[bench] CUPTI gave no kernel record for trace slice {attempts}; "
                        "no device time is written from it")
                prof = None
        slot = n % len(slots)
        done += take_spans(submit(slots[slot], meta=(slot, time.perf_counter_ns()), **call), t_end)
        n += 1
    if prof is not None:
        prof.stop()
    attempted = n * per_dispatch
    done += take(executor.flush(timeout_s=FLUSH_S), t_end)
    failed = executor.pending * per_dispatch
    window_s = seconds
    launches = {k: v - launches0.get(k, 0) for k, v in launch_counts().items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"[bench] window: {n} dispatches, {attempted} frames attempted, {done} done in the window, "
        f"{failed} never came; kernel launches per frame: "
        + json.dumps({k: v / max(attempted, 1) for k, v in launches.items() if v}))
    executor.close()
    del executor, pipeline, submit, chain, fn
    system.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check against the plain reference -----------------------------
    def answer(key: bytes, slot: int):
        # the result tree of one dispatch, each leaf with a leading frame axis
        tree = unpack_result(np.frombuffer(key, np.uint8), spec_of[slot])[0]
        return tree if per_dispatch > 1 else {k: np.asarray(v)[None] for k, v in tree.items()}

    distinct = {slot: [(answer(k, slot), c) for k, c in bucket.items()]
                for slot, bucket in results.items()}
    t_ref = time.monotonic()
    numbers = adapter.judge(cfg, reference, host, per_dispatch, distinct, system, device)
    log(f"[bench] reference and comparison took {time.monotonic() - t_ref:.2f} s "
        f"over {len(results)} dispatch slots")
    limits = cfg["limits"]
    correct = failed == 0 and bool(results) and all(numbers[k] <= limits[k] for k in limits)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    card = power_limit() if device.type == "cuda" else "no card"
    log(f"[bench] card: {card}")
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        if traced is None:
            raise RunError("no trace slice with a kernel record: no device metric can be read")
        t_lo, t_hi, n_traced, events = traced
        busy_ns, gaps = stats.busy_and_gaps(
            [(s, e) for recs in events.values() for _, s, e in recs], t_lo, t_hi)
        traced_spans = [s for s in spans.items if t_lo <= s[1] < t_hi]
        ctx = SimpleNamespace(
            cfg=cfg, mix=mix, reference=reference, peaks=stats.PEAKS, card=card,
            frames=n_traced * per_dispatch, window_s=(t_hi - t_lo) / 1e9, busy_s=busy_ns / 1e9,
            events=events, launches=launches,
            untraced_spans=[s for s in spans.items if not t_lo <= s[1] < t_hi],
            untraced_frames=(n - n_traced) * per_dispatch)
        metrics = {}
        for m in layer:
            value = load_file(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        by_name: Dict[str, float] = {}
        for name, s, e in events["kernel"] + events["HtoD"] + events["DtoH"] + events["other"]:
            by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s) / 1e9
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        out["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[_host_label(traced_spans, s), (e - s) / 1e9] for s, e in gaps]}
        log(f"[bench] traced slice: {ctx.window_s:.3f} s, {ctx.frames} frames, busy {ctx.busy_s:.4f} s, "
            f"{len(events['kernel'])} kernel records")
    else:
        values = {"frames_per_s": stats.rate(done, window_s),
                  "latency_p95_ms": stats.percentile(latencies, 95) if latencies else math.inf,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
        per_s = [0] * max(1, math.ceil(window_s))
        for t in done_at:
            per_s[min(len(per_s) - 1, (t - t_start) // 1_000_000_000)] += per_dispatch
        log(f"[bench] frames done in each second of the window: {per_s}")
        log(f"[bench] {done} frames in {window_s} s; latency p50 "
            f"{stats.percentile(latencies, 50) if latencies else math.inf:.3f} ms, p95 "
            f"{values['latency_p95_ms']:.3f} ms over {len(latencies)} frames")
    out.update(metrics=metrics, device=dev_info)
    if "breakdown" in out:
        out["breakdown"] = out.pop("breakdown")
    out["checks"] = checks
    log("[bench] every number of the comparison: " + json.dumps(numbers))
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return out

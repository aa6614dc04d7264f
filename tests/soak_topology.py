"""The soak topology of ``tests/test_soak.py`` on the port's entry points.

A synthetic ZED source (320x180, 15 fps, four precomputed frames) writes
through the bus with ``CUAUV_BUS_FAULTS`` (drops, corrupted payloads, write
stalls); ``modules.red_buoy`` and ``modules.yolo`` (the pico detect
fixture) read it at 30 ticks/s. After a warm-up (both result groups advance
three times) the soak runs ``seconds``: at 40 % the source is stopped by
SIGINT and restarted 3 s later, and both modules must recover. Neither may
go ``STALL_LIMIT_S`` without progress outside the outage, RSS must stay
below ``warm x 1.5 + 200`` MB (the JAX test's bounds), every process must
exit on SIGINT within the unwind window, and no module block may be left.

:func:`run_soak` is shared by ``tests/test_torch_soak.py`` (the CPU, opt-in)
and ``chip_smoke.py``'s ``soak`` phase (cuda:0), which adds each module's
card's memory through ``gpu_memory``. The caller sets
``CUAUV_SHM_NAMESPACE`` and picks a direction of its own.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[1]
PORT = "cuauv_vision_pipeline_tpu_torch"
FAULTS = "drop=0.02,corrupt=0.01,stall_every=400,stall_ms=250,seed=11"
FIXTURE = REPO / "tests" / "fixtures" / "synth_pico_detect.msgpack"
# no-progress bound before a stall counts as a deadlock (tests/test_soak.py)
STALL_LIMIT_S = float(os.environ.get("CUAUV_SOAK_STALL_LIMIT_S", "90"))
UNWIND_S = 45.0  # SIGINT -> exit for every process (tests/test_soak.py)
KILL_AT = 0.4  # share of the soak at which the source is stopped
OUTAGE_S = 3.0  # the source's downtime
WARM_ADVANCES = 3
RECOVERY_LIMIT_S = 240.0


def rss_mb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def planned_faults(seconds: float) -> dict:
    """The faults ``FAULTS`` plans for the writes of a source process that
    lived ``seconds`` at 15 frames/s (the plan is deterministic in its
    seed; ``writes`` is an upper count, the process's start included)."""
    from cuauv_vision_pipeline_tpu_torch.core.bindings.fault_injection import FaultPlan

    plan = FaultPlan.parse(FAULTS.replace("stall_ms=250", "stall_ms=0"))
    writes = int(seconds * 15)
    plane = [np.zeros(64, np.uint8)]
    for _ in range(writes):
        plan.apply_write(plane)
    return {"writes": writes, **plan.counters}


def stop(*procs, sig=signal.SIGINT, timeout=15.0) -> List[Optional[int]]:
    """Signal each live process, then wait for all within ``timeout``; a
    process that does not exit is killed and reported as None."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(sig)
    end = time.monotonic() + timeout
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(0.1, end - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rcs.append(None)
    return rcs


def run_soak(seconds: float, device: str, log_dir: Path, direction: str, env: Optional[Dict[str, str]] = None,
             poll_s: float = 5.0, warm_timeout: float = 600.0,
             gpu_memory: Optional[Callable[[], Dict[str, float]]] = None) -> dict:
    """Run the soak; return its counters or raise an AssertionError that
    carries them. ``device`` is each module's ``--device`` (``cpu`` or a
    card index); ``gpu_memory()`` returns MiB by name, sampled before the
    processes start, after the warm-up and at every poll. Each module's
    ``device memory:`` line at its exit (its caching allocator) is kept
    under ``allocator``."""
    from cuauv_vision_pipeline_tpu_torch.core import shm
    from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BLOCK_STUB

    log_dir.mkdir(parents=True, exist_ok=True)
    base_env = {**os.environ, "PYTHONPATH": str(REPO), **(env or {})}
    logs = []

    def spawn(args, tag, **extra):
        log = open(log_dir / f"soak_{tag}.log", "wb")
        logs.append(log)
        return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env={**base_env, **extra},
                                stdout=log, stderr=subprocess.STDOUT)

    for name in ("red_buoy_results", "yolo_status"):
        shm.delete_group(name)  # fresh groups in the caller's namespace
    groups = {"buoy": shm.red_buoy_results, "yolo": shm.yolo_status}
    seq = {k: (lambda g=g: g.seq) for k, g in groups.items()}
    seq0 = {k: read() for k, read in seq.items()}
    src_argv = [f"{PORT}.capture_sources.synthetic", direction, "--scene", "zed", "--width", "320",
                "--height", "180", "--fps", "15", "--precompute", "4"]
    gpu_before = gpu_memory() if gpu_memory is not None else None
    src = spawn(src_argv, "src", CUAUV_BUS_FAULTS=FAULTS)
    src_runs = [[time.monotonic(), None]]  # each source process's start and stop
    procs = {
        "buoy": spawn([f"{PORT}.modules.red_buoy", direction, "--fps", "30", "--device", device], "buoy"),
        "yolo": spawn([f"{PORT}.modules.yolo", direction, "--fps", "30", "--device", device], "yolo",
                      CUAUV_YOLO_WEIGHT=str(FIXTURE)),
    }
    counters = {"duration_s": seconds, "device": device, "faults": FAULTS, "stall_events": 0, "source_kills": 0,
                "recovery_s": None, "warm_s": None, "max_gap_s": {}, "max_poll_s": 0.0, "rss_peak_mb": {}, "rss_after_warm_mb": {}}
    if gpu_memory is not None:
        counters.update(gpu_before_mb=gpu_before, gpu_after_warm_mb={}, gpu_peak_mb={})
    pids = {k: p.pid for k, p in procs.items()}
    t_start = time.monotonic()
    try:
        # warm-up: both modules produce results
        deadline = t_start + warm_timeout
        while time.monotonic() < deadline:
            if all(seq[k]() - seq0[k] >= WARM_ADVANCES for k in procs):
                break
            for k, p in procs.items():
                assert p.poll() is None, f"{k} died during warm-up"
            time.sleep(0.2)
        else:
            raise AssertionError("modules never produced results")
        counters["warm_s"] = time.monotonic() - t_start
        for k, pid in pids.items():
            counters["rss_after_warm_mb"][k] = rss_mb(pid)
        if gpu_memory is not None:
            counters["gpu_after_warm_mb"] = gpu_memory()

        t0 = time.monotonic()
        t_end = t0 + seconds
        last = {k: seq[k]() for k in procs}
        frames0 = dict(last)
        last_advance = {k: t0 for k in procs}
        kill_at = t0 + seconds * KILL_AT
        killed = False
        recovered_at = None
        polled = t0
        while time.monotonic() < t_end:
            time.sleep(poll_s)
            now = time.monotonic()
            # the poller's own longest interval bounds how finely max_gap_s sees
            counters["max_poll_s"] = max(counters["max_poll_s"], now - polled)
            for k in procs:
                cur = seq[k]()
                if cur != last[k]:
                    last[k] = cur
                    counters["max_gap_s"][k] = max(counters["max_gap_s"].get(k, 0.0), now - last_advance[k])
                    last_advance[k] = now
                else:
                    counters["stall_events"] += 1
                # a stall is allowed while the source is down; otherwise
                # STALL_LIMIT_S without progress is a deadlock
                limit = STALL_LIMIT_S + 30 if killed and recovered_at is None else STALL_LIMIT_S
                assert now - last_advance[k] < limit, f"{k}: no progress for {now - last_advance[k]:.0f}s (deadlock)"
                assert procs[k].poll() is None, f"{k} process died mid-soak"
                counters["rss_peak_mb"][k] = max(counters["rss_peak_mb"].get(k, 0.0), rss_mb(pids[k]))
            if gpu_memory is not None:
                for k, mb in gpu_memory().items():
                    counters["gpu_peak_mb"][k] = max(counters["gpu_peak_mb"].get(k, 0.0), mb)

            # mid-soak: stop the source, let the modules ride their retry
            # loop, restart it, require both to recover
            if not killed and now > kill_at:
                counters["source_exit"] = stop(src)[0]
                src_runs[-1][1] = time.monotonic()
                counters["source_kills"] += 1
                killed = True
                time.sleep(OUTAGE_S)
                src = spawn(src_argv, "src2", CUAUV_BUS_FAULTS=FAULTS)
                t_restart = time.monotonic()
                src_runs.append([t_restart, None])
                pre = {k: seq[k]() for k in procs}
                rec_deadline = t_restart + RECOVERY_LIMIT_S
                while time.monotonic() < rec_deadline:
                    if all(seq[k]() > pre[k] for k in procs):
                        recovered_at = time.monotonic()
                        break
                    time.sleep(0.05)
                assert recovered_at is not None, "modules never recovered after source restart"
                counters["recovery_s"] = recovered_at - t_restart
                for k in procs:
                    last[k] = seq[k]()
                    last_advance[k] = time.monotonic()
            polled = time.monotonic()
        assert killed, f"the soak of {seconds} s ended before its source restart"
        counters["soaked_s"] = time.monotonic() - t0
        counters["frames"] = {k: seq[k]() - frames0[k] for k in procs}

        # memory bound: steady-state growth after warm-up must stay small
        for k in procs:
            warm = counters["rss_after_warm_mb"][k]
            peak = counters["rss_peak_mb"].get(k, warm)
            assert peak < warm * 1.5 + 200, f"{k}: RSS grew {warm:.0f} -> {peak:.0f} MB (leak?)"
    finally:
        # a generous unwind window: a module mid-dispatch finishes its device
        # step and a bounded drain before unlinking its blocks
        t_stop = time.monotonic()
        counters["clean_exits"] = stop(procs["yolo"], procs["buoy"], src, timeout=UNWIND_S)
        counters["unwind_s"] = time.monotonic() - t_stop
        src_runs[-1][1] = src_runs[-1][1] or t_stop
        counters["faults_planned"] = [planned_faults(end - start) for start, end in src_runs]
        for log in logs:
            log.close()
        for k in procs:
            text = (log_dir / f"soak_{k}.log").read_text(errors="replace")
            found = re.findall(r"kernel launches: (\{.*\})", text)
            counters.setdefault("launches", {})[k] = json.loads(found[-1]) if found else None
            found = re.findall(r"device memory: (\{.*\})", text)
            counters.setdefault("allocator", {})[k] = json.loads(found[-1]) if found else None
            counters.setdefault("slow_source_warnings", {})[k] = text.count("appears to be slow or dead")
            counters.setdefault("retries", {})[k] = text.count("trying again to access")
        print("SOAK_COUNTERS " + json.dumps(counters), flush=True)

    # clean shutdown: SIGINT unwinds every process (no hang -> rc set)
    assert all(rc is not None for rc in counters["clean_exits"]), f"hung process at shutdown: {counters}"
    leftover = sorted(p.name for p in Path(BLOCK_STUB).parent.glob(Path(BLOCK_STUB).name + "module_*")
                      if direction in p.name)
    assert not leftover, f"module blocks leaked: {leftover}"
    return counters

"""Lightweight tracing: per-stage spans to Chrome trace JSON.

The reference's observability is EMA printouts and shm counters (SURVEY.md
§5: StageBenchmark, zed_metrics, poster latency); this adds what it lacked:
a structured, zero-dependency tracer. Spans record (name, pid/tid, start,
duration) into a ring and dump chrome://tracing-compatible JSON, so a whole
multi-process pipeline session can be laid out on one timeline (each process
writes its own file; the viewer merges by wall clock).

Usage:

    from cuauv_vision_pipeline_tpu_torch.core.trace import tracer

    with tracer.span("read_bus"):
        ...
    with tracer.span("device_chain", frame=frame_id):
        ...
    tracer.dump("/tmp/vision_trace.json")    # or set $CUAUV_TRACE_DIR to
                                             # auto-dump on process exit

Overhead per span: one monotonic clock pair + a deque append (~1 us);
tracing is a no-op unless enabled (`tracer.enable()` or $CUAUV_TRACE_DIR).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, Optional


class Tracer:
    def __init__(self, capacity: int = 100_000):
        self._events: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self._enabled = False
        self._lock = threading.Lock()

        trace_dir = os.environ.get("CUAUV_TRACE_DIR")
        if trace_dir:
            self.enable()
            atexit.register(
                self.dump,
                os.path.join(
                    trace_dir, f"trace-{os.getpid()}-{int(time.time())}.json"
                ),
            )

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    @contextmanager
    def span(self, name: str, **args: Any):
        """Time a block; extra kwargs land in the event's args."""
        if not self._enabled:
            yield
            return
        start = time.monotonic_ns()
        try:
            yield
        finally:
            end = time.monotonic_ns()
            self._events.append(
                {
                    "name": name,
                    "ph": "X",
                    "pid": os.getpid(),
                    "tid": threading.get_ident() & 0xFFFF,
                    "ts": start / 1000.0,  # microseconds
                    "dur": (end - start) / 1000.0,
                    "args": args,
                }
            )

    def instant(self, name: str, **args: Any) -> None:
        """Mark a point event (frame arrival, detection, error)."""
        if not self._enabled:
            return
        self._events.append(
            {
                "name": name,
                "ph": "i",
                "s": "t",
                "pid": os.getpid(),
                "tid": threading.get_ident() & 0xFFFF,
                "ts": time.monotonic_ns() / 1000.0,
                "args": args,
            }
        )

    def counter(self, name: str, **values: float) -> None:
        """Record counter values (fps, queue depth, ...)."""
        if not self._enabled:
            return
        self._events.append(
            {
                "name": name,
                "ph": "C",
                "pid": os.getpid(),
                "ts": time.monotonic_ns() / 1000.0,
                "args": values,
            }
        )

    def dump(self, path: str) -> Optional[str]:
        """Write accumulated events as Chrome trace JSON; returns the path
        (None when nothing was recorded)."""
        with self._lock:
            events = list(self._events)
        if not events:
            return None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"traceEvents": events}, fh)
        return path

    def clear(self) -> None:
        self._events.clear()


tracer = Tracer()


PROFILE_DIR_ENV = "CUAUV_TORCH_PROFILE_DIR"
_profile = None  # (torch.profiler.profile, output dir) while a trace runs


def maybe_start_device_profile(device, logger=None) -> bool:
    """Start a torch.profiler trace when $CUAUV_TORCH_PROFILE_DIR is set:
    CPU activity of every thread, plus CUDA kernels and copies when
    ``device`` is a CUDA device (the level below the host spans above).
    :func:`stop_device_profile` ends it and writes one Chrome trace into
    that directory; it also runs at process exit. Returns whether a trace
    started. The port's twin of the JAX package's jax.profiler hook
    ($CUAUV_JAX_PROFILE_DIR)."""
    global _profile
    profile_dir = os.environ.get(PROFILE_DIR_ENV)
    if not profile_dir or _profile is not None:
        return False
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # a module's loop runs on its own thread: record CPU ops of all threads
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities, experimental_config=config)
    prof.start()
    _profile = (prof, profile_dir)
    atexit.register(stop_device_profile)
    if logger is not None:
        names = "+".join(a.name for a in activities)
        logger(f"torch.profiler trace ({names}) -> {profile_dir}", True)
    return True


def stop_device_profile() -> Optional[str]:
    """End the trace :func:`maybe_start_device_profile` started and write
    it as ``torch-profile-<pid>-<time>.json``; returns the path (None when
    no trace runs)."""
    global _profile
    if _profile is None:
        return None
    prof, profile_dir = _profile
    _profile = None
    prof.stop()
    path = os.path.join(
        profile_dir, f"torch-profile-{os.getpid()}-{int(time.time())}.json"
    )
    prof.export_chrome_trace(path)
    return path

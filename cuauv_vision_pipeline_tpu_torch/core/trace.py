"""Host spans on torch.profiler's clock, to Chrome trace JSON.

The reference's observability is EMA printouts and shm counters (SURVEY.md
§5: StageBenchmark, zed_metrics, poster latency); this adds what it lacked:
a structured, zero-dependency tracer. Each span records its name, the OS
thread id, its start and end on the wall clock (``time.time_ns``, the clock
``torch.profiler`` stamps its CPU ops and CUDA records with), its parent
(the span open around it on the same thread), the ``dispatch`` id of the
executor dispatch it serves (taken from the parent unless given), and
counts as args. Events are kept as tuples in a ring; the ring counts what
it drops.

Usage:

    from cuauv_vision_pipeline_tpu_torch.core.trace import tracer

    with tracer.span("read_bus"):
        ...
    with tracer.span("executor.d2h", dispatch=7) as span:
        out = fetch()
        if span:                        # False while tracing is off
            span.set(bytes=out.nbytes)
    tracer.dump("/tmp/vision_trace.json")    # or set $CUAUV_TRACE_DIR to
                                             # auto-dump on process exit

Overlaying the device trace: run a module with both ``$CUAUV_TRACE_DIR``
(these spans, ``trace-<pid>-<time>.json``) and ``$CUAUV_TORCH_PROFILE_DIR``
(:func:`maybe_start_device_profile`: CPU ops of every thread and the card's
kernels and copies, ``torch-profile-<pid>-<time>.json``) set, stop it with
SIGINT, and open both files in one Perfetto view (ui.perfetto.dev, "Open
trace file" twice, or ``chrome://tracing`` "Load"). ``dump`` writes times
as ``export_chrome_trace`` does: microseconds after ``baseTimeNanoseconds``,
the wall clock floored to 7,889,238 s, and thread ids as the OS numbers
them, so a span and the ops and kernels it launched line up on one thread.

Tracing is off unless enabled (``tracer.enable()`` or $CUAUV_TRACE_DIR);
then ``span`` returns one shared no-op context and reads no clock.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, NamedTuple, Optional

# torch.profiler's export_chrome_trace writes its events' times after a base
# of the wall clock floored to this many seconds (libkineto's
# ChromeTraceBaseTime); ``dump`` uses the same base
TRACE_BASE_S = 7_889_238


def trace_base_ns() -> int:
    """The ``baseTimeNanoseconds`` that torch.profiler's export writes now."""
    return int(time.time()) // TRACE_BASE_S * TRACE_BASE_S * 1_000_000_000


class Span(NamedTuple):
    """One recorded event: a span (``ph`` "X") or an instant ("i", whose
    end is its start). Times are wall-clock ns; ``tid`` the OS thread id;
    ``parent`` the id of the span open around it on its thread."""

    ph: str
    name: str
    tid: int
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    dispatch: Optional[int]
    args: Dict[str, Any]


class _NullSpan:
    """What ``span`` returns while tracing is off: enters, exits, records
    nothing, and is false."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **args: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    __slots__ = ("_tracer", "name", "dispatch", "args", "id", "parent", "_thread", "_t0")

    def __init__(self, tracer: "Tracer", name: str, dispatch: Optional[int], args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.dispatch = dispatch
        self.args = args

    def set(self, **args: Any) -> None:
        """Add counts to the span's args (before it ends)."""
        self.args.update(args)

    def __enter__(self) -> "_LiveSpan":
        tr = self._tracer
        thread = self._thread = tr._thread()
        stack = thread.stack
        if stack:
            outer = stack[-1]
            self.parent = outer.id
            if self.dispatch is None:
                self.dispatch = outer.dispatch
        else:
            self.parent = None
        self.id = next(tr._ids)
        stack.append(self)
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.time_ns()
        thread = self._thread
        thread.stack.pop()
        args = self.args
        self._tracer._record(("X", self.name, thread.tid, self._t0, t1, self.id, self.parent, self.dispatch,
                              tuple(args.items()) if args else ()))
        return False


class _ThreadState:
    __slots__ = ("stack", "tid")

    def __init__(self):
        self.stack: List[_LiveSpan] = []
        self.tid = threading.get_native_id()


# below this many free slots in the ring, ``_record`` takes the lock: each
# thread appends at most once between its check and its append, so with
# fewer threads than this the unlocked appends never push an event out
_LOCK_MARGIN = 64


class Tracer:
    def __init__(self, capacity: int = 100_000):
        self._events: Deque[tuple] = deque(maxlen=capacity)
        self._dropped = 0
        self._enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

        trace_dir = os.environ.get("CUAUV_TRACE_DIR")
        if trace_dir:
            self.enable()
            atexit.register(
                self.dump,
                os.path.join(
                    trace_dir, f"trace-{os.getpid()}-{int(time.time())}.json"
                ),
            )

    def enable(self, capacity: Optional[int] = None) -> None:
        """Start recording; ``capacity`` resizes the ring (its newest
        events kept)."""
        if capacity is not None and capacity != self._events.maxlen:
            with self._lock:
                self._events = deque(self._events, maxlen=capacity)
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def dropped(self) -> int:
        """Events the full ring pushed out since the last ``clear``."""
        return self._dropped

    def _thread(self) -> _ThreadState:
        try:
            return self._local.state
        except AttributeError:
            state = self._local.state = _ThreadState()
            return state

    def _record(self, event: tuple) -> None:
        # an event is a tuple of strings, numbers and a tuple of (key, count)
        # pairs: the garbage collector stops tracking it after its first pass
        events = self._events
        if len(events) < events.maxlen - _LOCK_MARGIN:
            events.append(event)
            return
        with self._lock:
            if len(events) == events.maxlen:
                self._dropped += 1
            events.append(event)

    def span(self, name: str, dispatch: Optional[int] = None, **args: Any):
        """A context that times its block; ``args`` (counts) land in the
        event's args, and ``set`` adds more before it ends."""
        if not self._enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, dispatch, args)

    def annotate(self, **args: Any) -> None:
        """Add counts to the args of the innermost span open on this
        thread, from code that did not open it (nothing while tracing is
        off or no span is open)."""
        if not self._enabled:
            return
        stack = self._thread().stack
        if stack:
            stack[-1].set(**args)

    def instant(self, name: str, **args: Any) -> None:
        """Mark a point event (frame arrival, detection, error)."""
        if not self._enabled:
            return
        thread = self._thread()
        outer = thread.stack[-1] if thread.stack else None
        t = time.time_ns()
        self._record(
            ("i", name, thread.tid, t, t, next(self._ids), outer.id if outer else None,
             outer.dispatch if outer else None, tuple(args.items()))
        )

    def events(self) -> List[Span]:
        """The recorded events, oldest first."""
        with self._lock:
            events = list(self._events)
        return [Span(*e[:8], dict(e[8])) for e in events]

    def dump(self, path: str) -> Optional[str]:
        """Write the recorded events as Chrome trace JSON in
        ``export_chrome_trace``'s time base; returns the path (None when
        nothing was recorded)."""
        events = self.events()
        if not events:
            return None
        base = trace_base_ns()
        pid = os.getpid()
        out = []
        for e in events:
            args = dict(e.args, id=e.id)
            if e.parent is not None:
                args["parent"] = e.parent
            if e.dispatch is not None:
                args["dispatch"] = e.dispatch
            ev = {"name": e.name, "ph": e.ph, "pid": pid, "tid": e.tid,
                  "ts": (e.start_ns - base) / 1000.0, "args": args}
            if e.ph == "X":
                ev["dur"] = (e.end_ns - e.start_ns) / 1000.0
            else:
                ev["s"] = "t"
            out.append(ev)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base,
                       "droppedEvents": self._dropped, "traceEvents": out}, fh)
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0


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

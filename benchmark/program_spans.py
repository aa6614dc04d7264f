#!/usr/bin/env python3
"""Read the port's own spans (``core/trace.py``: the executor's and the
red_buoy chain's) in a cell's traced run, beside the card's trace.

    python3 benchmark/program_spans.py --workload red_buoy_1080p.stream --seed 1 --seconds 45

One run of ``harness.run_cell`` with ``--trace 1`` and the program's tracer
enabled, in this process. The tracer's ring is read after the window: the
warm-up's dispatches are left out, and a window that dropped a span gives no
result. From the profiled slice it also takes each copy's ``cudaMemcpy*``
call (the host side of the profiler's clock) joined to its device record. A
dispatch belongs to the slice when its ``executor.submit`` span starts
inside it; every figure is per frame, over the sum of ``frames`` of the
``executor.submit`` spans it reads. Prints one JSON line: the harness's
result, ``program`` (the five readers named after a metric), ``counters``
(the readers of the spans' other counts), ``program_checks`` (the program's
spans against the harness's and the card's), ``host_spans`` (each span's
self ms a frame outside the slice) and ``idle_gaps_program`` (the harness's
ten longest idle gaps of the card, each labelled with the innermost program
span on the dispatching thread and on the fetch thread). The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
import stats  # noqa: E402

CAPACITY = 1 << 20  # events the ring holds: a 45 s window of either cell records ~100,000


# -- which spans a reader takes ---------------------------------------------

def _slice_dispatches(ctx) -> set:
    return {s.dispatch for s in ctx.program_spans
            if s.name == "executor.submit" and ctx.t_lo <= s.start_ns < ctx.t_hi}


def _part(ctx, traced: bool) -> list:
    inside = _slice_dispatches(ctx)
    return [s for s in ctx.program_spans if (s.dispatch in inside) == traced]


def _frames(spans) -> int:
    return sum(s.args.get("frames", 0) for s in spans if s.name == "executor.submit")


def _self_ns(spans) -> Dict[int, int]:
    """Each span's length less that of the spans directly inside it."""
    own = {s.id: s.end_ns - s.start_ns for s in spans if s.ph == "X"}
    for s in spans:
        if s.ph == "X" and s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def _ms_per_frame(spans, name: str, self_time: bool = False) -> Optional[float]:
    named = [s for s in spans if s.name == name]
    frames = _frames(spans)
    if not named or not frames:
        return None
    own = _self_ns(spans) if self_time else None
    ns = sum(own[s.id] if self_time else s.end_ns - s.start_ns for s in named)
    return ns / 1e6 / frames


def htod_misplaced(ctx) -> int:
    """The slice's HtoD device records that do not start inside the
    ``executor.h2d`` span holding their own ``cudaMemcpyAsync`` call, or have
    no call: 0 where the program's clock and the card's records agree."""
    h2d = [s for s in _part(ctx, traced=True) if s.name == "executor.h2d"]
    out = len(ctx.events["HtoD"]) - len(ctx.copies["HtoD"])
    for call, _, start, _ in ctx.copies["HtoD"]:
        if ctx.t_lo <= call < ctx.t_hi:
            span = next((s for s in h2d if s.start_ns <= call < s.end_ns), None)
            out += span is None or not span.start_ns <= start < span.end_ns
    return out


# -- the readers (one per metric) -------------------------------------------

def h2d_stream_wait_ms_per_frame(ctx) -> Optional[float]:
    """In the slice, each ``executor.h2d`` span's start to the start of the
    first HtoD device record that begins inside it: the pageable copy's wait
    for the stream to drain, then the staging of its first chunk. None if a
    span has no such record, or a record does not start inside its own
    dispatch's span: the clocks would then disagree."""
    spans = _part(ctx, traced=True)
    h2d = [s for s in spans if s.name == "executor.h2d"]
    frames = _frames(spans)
    if not h2d or not frames or htod_misplaced(ctx):
        return None
    waits = []
    for s in h2d:
        starts = [b for _, b, _ in ctx.events["HtoD"] if s.start_ns <= b < s.end_ns]
        if not starts:
            return None
        waits.append(min(starts) - s.start_ns)
    return sum(waits) / 1e6 / frames


def pack_host_ms_per_frame(ctx) -> Optional[float]:
    """``executor.pack`` (lanes stacked, result packed), outside the slice."""
    return _ms_per_frame(_part(ctx, traced=False), "executor.pack")


def backpressure_host_ms_per_frame(ctx) -> Optional[float]:
    """``executor.backpressure``'s own time (``submit`` waiting for a free
    slot, less any fetch it does itself), outside the slice: 0 where the
    executor's spans are there and no dispatch waited."""
    spans = _part(ctx, traced=False)
    if not any(s.name == "executor.backpressure" for s in spans):
        return 0.0 if _frames(spans) else None
    return _ms_per_frame(spans, "executor.backpressure", self_time=True)


def d2h_host_ms_per_frame(ctx) -> Optional[float]:
    """``executor.d2h`` (the result's copy to the host, after
    ``executor.event_wait``), outside the slice."""
    return _ms_per_frame(_part(ctx, traced=False), "executor.d2h")


def _bytes_per_frame(spans, name: str) -> Optional[float]:
    named = [s for s in spans if s.name == name]
    frames = _frames(spans)
    if not named or not frames:
        return None
    return sum(s.args["bytes"] for s in named) / frames


def d2h_bytes_per_frame(ctx) -> Optional[float]:
    """The ``bytes`` of ``executor.d2h`` over the window."""
    return _bytes_per_frame(ctx.program_spans, "executor.d2h")


READERS = (h2d_stream_wait_ms_per_frame, pack_host_ms_per_frame, backpressure_host_ms_per_frame,
           d2h_host_ms_per_frame, d2h_bytes_per_frame)


# -- the readers of the other counts ----------------------------------------

def h2d_host_gb_per_s(ctx) -> Optional[float]:
    """The ``bytes`` of ``executor.h2d`` over the spans' time, outside the
    slice: the pageable copy's rate as the host sees it, drain included."""
    h2d = [s for s in _part(ctx, traced=False) if s.name == "executor.h2d"]
    ns = sum(s.end_ns - s.start_ns for s in h2d)
    return sum(s.args["bytes"] for s in h2d) / ns if ns else None


def inflight_at_submit(ctx) -> Optional[float]:
    """The mean ``inflight`` of ``executor.submit`` over the window: the
    dispatches still on the card when the next one is submitted (the depth
    when the executor runs full)."""
    submits = [s.args["inflight"] for s in ctx.program_spans if s.name == "executor.submit"]
    return sum(submits) / len(submits) if submits else None


COUNTERS = (h2d_host_gb_per_s, inflight_at_submit)


# -- the breakdown ----------------------------------------------------------

def host_spans(ctx) -> List[list]:
    """[name, self ms a frame] of every program span outside the slice,
    largest first."""
    spans = _part(ctx, traced=False)
    frames = _frames(spans)
    if not frames:
        return []
    own = _self_ns(spans)
    total: Dict[str, int] = defaultdict(int)
    for s in spans:
        if s.ph == "X":
            total[s.name] += own[s.id]
    return sorted(([k, v / 1e6 / frames] for k, v in total.items()), key=lambda kv: -kv[1])


def _innermost(spans, tid: Optional[int], t: int) -> str:
    inner = [s for s in spans if s.tid == tid and s.ph == "X" and s.start_ns <= t < s.end_ns]
    return min(inner, key=lambda s: s.end_ns - s.start_ns).name if inner else "-"


def idle_gaps_program(ctx) -> List[list]:
    """The card's ten longest idle gaps in the slice, as the harness's
    ``idle_gaps``, labelled ``<dispatching thread> | <fetch thread>`` by the
    innermost program span at the gap's start."""
    records = [(s, e) for recs in ctx.events.values() for _, s, e in recs]
    _, gaps = stats.busy_and_gaps(records, ctx.t_lo, ctx.t_hi)
    submit_tids = {s.tid for s in ctx.program_spans if s.name == "executor.submit"}
    fetch_tids = {s.tid for s in ctx.program_spans if s.name == "executor.d2h"} - submit_tids
    dispatching = next(iter(submit_tids), None)
    fetching = next(iter(fetch_tids), None)
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        label = f"{_innermost(ctx.program_spans, dispatching, s)} | {_innermost(ctx.program_spans, fetching, s)}"
        out.append([label, (e - s) / 1e9])
    return out


def checks(ctx) -> Dict[str, Optional[float]]:
    """The program's spans held against the harness's and the card's: the
    launch and copy spans a frame outside the slice (beside the harness's
    ``dispatch_host_ms_per_frame`` and ``h2d_host_ms_per_frame``); the
    slice's HtoD records and those not inside their own dispatch's
    ``executor.h2d`` span; and the D2H's wait for the stream (each
    ``executor.d2h`` span's start to its copy's device record) with the share
    of that wait in which the card ran other work, the next dispatch queued
    on the same stream. None where a D2H record lies outside its own call
    (its device time is then wrong)."""
    outside, inside = _part(ctx, traced=False), _part(ctx, traced=True)
    out = {"launch_host_ms_per_frame": _ms_per_frame(outside, "executor.launch"),
           "h2d_span_ms_per_frame": _ms_per_frame(outside, "executor.h2d"),
           "htod_records": len(ctx.events["HtoD"]), "htod_misplaced": htod_misplaced(ctx),
           "d2h_stream_wait_ms_per_frame": None, "d2h_wait_busy_share": None}
    d2h = [s for s in inside if s.name == "executor.d2h"]
    busy = stats.merge_intervals([(s, e) for recs in ctx.events.values() for _, s, e in recs])
    waits, busy_ns = [], 0
    for s in d2h:
        mine = sorted(c for c in ctx.copies["DtoH"] if s.start_ns <= c[0] < s.end_ns)
        if not mine or not mine[0][0] <= mine[0][2] <= mine[0][1]:
            return out
        waits.append(mine[0][2] - s.start_ns)
        busy_ns += sum(e - b for b, e in stats.clip_intervals(busy, s.start_ns, mine[0][2]))
    frames = _frames(inside)
    if waits and frames:
        out["d2h_stream_wait_ms_per_frame"] = sum(waits) / 1e6 / frames
        out["d2h_wait_busy_share"] = busy_ns / sum(waits) if sum(waits) else 0.0
    return out


# -- a run ------------------------------------------------------------------

class _Slices:
    """Catches the harness's profiled slices: each ``torch.profiler``
    session's wall-clock start and stop, and the device records the harness
    read from it."""

    def __init__(self):
        import torch

        self.times: List[list] = []
        self.read: List[tuple] = []
        times = self.times

        class Timed(torch.profiler.profile):
            def start(self):
                super().start()
                times.append([time.time_ns(), None])

            def stop(self):
                times[-1][1] = time.time_ns()
                super().stop()

        self._timed = Timed

    def __enter__(self):
        import torch

        self._profile, self._events = torch.profiler.profile, harness._device_events
        torch.profiler.profile = self._timed

        def device_events(prof):
            events = self._events(prof)
            self.read.append((self.times[-1][0], self.times[-1][1], events, _copies(prof)))
            return events

        harness._device_events = device_events
        return self

    def __exit__(self, *exc):
        import torch

        torch.profiler.profile, harness._device_events = self._profile, self._events
        return False

    def traced(self):
        return next((r for r in self.read if r[2]["kernel"]), None)


def _copies(prof) -> Dict[str, list]:
    """Each copy of a profiled slice: its ``cudaMemcpy*`` call's start and
    end (the host side of the profiler's clock) with its device record's
    start and end, joined by correlation id, by direction."""
    import torch

    calls, records = {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA and name.startswith(("Memcpy HtoD", "Memcpy DtoH")):
            records[e.correlation_id()] = (name[7:11], e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith("cudaMemcpy"):
            calls[e.correlation_id()] = (e.start_ns(), e.start_ns() + e.duration_ns())
    out = {"HtoD": [], "DtoH": []}
    for corr, (kind, start, end) in records.items():
        if corr in calls:
            out[kind].append(calls[corr] + (start, end))
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, program: bool, device, log=None,
        **kw) -> Dict:
    """One run of ``workload`` through the harness (``kw`` goes to
    ``run_cell``), the program's tracer on when ``program``: the window's
    spans are then under ``spans``, and with ``trace`` the line gains the
    readers' values and the slice (``slice``)."""
    from cuauv_vision_pipeline_tpu_torch.core.trace import tracer

    tracer.clear()
    if program:
        tracer.enable(capacity=CAPACITY)
    try:
        with _Slices() as slices:
            result = harness.run_cell(workload, seed, seconds, trace, device, time.monotonic(),
                                      log=log or (lambda line: None), **kw)
    finally:
        tracer.disable()
    if program:
        if tracer.dropped:
            raise harness.RunError(f"the program's tracer dropped {tracer.dropped} events in the window")
        spans = [s for s in tracer.events() if s.dispatch is None or s.dispatch > harness.WARMUP_DISPATCHES]
        tracer.clear()
        result["spans"] = spans
        if trace:
            lo, hi, events, copies = slices.traced()
            ctx = SimpleNamespace(program_spans=spans, events=events, copies=copies, t_lo=lo, t_hi=hi)
            result["program"] = {f.__name__: f(ctx) for f in READERS}
            result["counters"] = {f.__name__: f(ctx) for f in COUNTERS}
            result["program_checks"] = checks(ctx)
            result["host_spans"] = host_spans(ctx)
            result["idle_gaps_program"] = idle_gaps_program(ctx)
            result["slice"] = ctx
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    r = run(args.workload, args.seed, args.seconds, True, True, torch.device("cuda", 0),
            log=lambda line: print(line, file=sys.stderr))
    line = {"workload": args.workload, "seed": args.seed, "card": harness.power_limit(),
            **{k: v for k, v in r.items() if k not in ("slice", "spans")}}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

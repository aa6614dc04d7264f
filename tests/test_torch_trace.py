"""The port's tracer (``core/trace.py``) on torch.profiler's clock, and the
spans the executor and the red_buoy chain record, on the CPU."""

import json
import threading
import time

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)
from torch.profiler import ProfilerActivity, profile

from cuauv_vision_pipeline_tpu_torch.core import trace
from cuauv_vision_pipeline_tpu_torch.core.trace import Tracer
from cuauv_vision_pipeline_tpu_torch.engine import chains
from cuauv_vision_pipeline_tpu_torch.engine import executor as ex_mod
from cuauv_vision_pipeline_tpu_torch.engine.executor import (
    DevicePipeline,
    StreamExecutor,
    build_packed_fn,
    dispatch_frames,
)

CPU = torch.device("cpu")


def _mm_under_span(tr):
    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("op"):
            torch.mm(a, a)
    span = next(e for e in tr.events() if e.name == "op")
    record = next(e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm")
    return prof, span, record


def test_a_span_holds_the_profiler_record_of_its_op():
    tr = Tracer()
    tr.enable()
    _, span, record = _mm_under_span(tr)
    assert span.start_ns <= record.start_ns() <= record.start_ns() + record.duration_ns() <= span.end_ns


def test_tid_is_the_os_thread_id_the_profiler_writes(tmp_path):
    tr = Tracer()
    tr.enable()
    prof, span, _ = _mm_under_span(tr)
    prof.export_chrome_trace(str(tmp_path / "torch.json"))
    events = json.loads((tmp_path / "torch.json").read_text())["traceEvents"]
    op = next(e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X")
    assert span.tid == threading.get_native_id() == op["tid"]

    seen = []
    worker = threading.Thread(target=lambda: (tr.instant("there"), seen.append(threading.get_native_id())))
    worker.start()
    worker.join(10)
    assert not worker.is_alive()
    assert next(e for e in tr.events() if e.name == "there").tid == seen[0] != span.tid


def test_parent_and_dispatch_through_nesting_and_across_threads():
    tr = Tracer()
    tr.enable()
    with tr.span("outer", dispatch=5) as outer:
        with tr.span("inner", n=1) as inner:
            inner.set(bytes=8)
            tr.instant("mark")
        worker = threading.Thread(target=lambda: tr.span("fetch", dispatch=5).__enter__().__exit__())
        worker.start()
        worker.join(10)
    with tr.span("alone"):
        pass
    by = {e.name: e for e in tr.events()}
    assert by["outer"].parent is None and by["outer"].dispatch == 5
    assert by["inner"].parent == outer.id and by["inner"].dispatch == 5
    assert by["inner"].args == {"n": 1, "bytes": 8}
    assert by["mark"].ph == "i" and by["mark"].parent == inner.id and by["mark"].dispatch == 5
    assert by["fetch"].parent is None and by["fetch"].dispatch == 5 and by["fetch"].tid != by["outer"].tid
    assert by["alone"].parent is None and by["alone"].dispatch is None
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["inner"].end_ns <= by["outer"].end_ns


def test_a_full_ring_counts_its_drops():
    tr = Tracer(capacity=3)
    tr.enable()
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    assert [e.name for e in tr.events()] == ["s2", "s3", "s4"] and tr.dropped == 2
    tr.enable(capacity=10)
    assert [e.name for e in tr.events()] == ["s2", "s3", "s4"]
    tr.clear()
    assert tr.events() == [] and tr.dropped == 0


def test_threads_filling_the_ring_count_every_drop():
    tr = Tracer(capacity=300)
    tr.enable()
    n, threads = 2_000, 4

    def fill():
        for _ in range(n):
            with tr.span("s"):
                pass

    workers = [threading.Thread(target=fill) for _ in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(60)
    assert len(tr.events()) == 300 and tr.dropped == n * threads - 300


def test_a_disabled_tracer_records_nothing_and_reads_no_clock(monkeypatch, tmp_path):
    tr = Tracer()

    def no_clock():
        raise AssertionError("the disabled path read the clock")

    monkeypatch.setattr(trace.time, "time_ns", no_clock)
    spans = [tr.span("a"), tr.span("b", dispatch=1, bytes=3)]
    assert spans[0] is spans[1] and not spans[0]
    with spans[0] as s:
        s.set(bytes=1)
    tr.instant("i")
    monkeypatch.undo()
    assert tr.events() == [] and tr.dropped == 0
    assert tr.dump(str(tmp_path / "empty.json")) is None


def test_dump_lines_up_with_export_chrome_trace(tmp_path):
    tr = Tracer()
    tr.enable()
    prof, _, _ = _mm_under_span(tr)
    prof.export_chrome_trace(str(tmp_path / "torch.json"))
    ours = json.loads((tmp_path / "mine.json").read_text()) if tr.dump(str(tmp_path / "mine.json")) else None
    theirs = json.loads((tmp_path / "torch.json").read_text())
    assert ours["baseTimeNanoseconds"] == theirs["baseTimeNanoseconds"] == trace.trace_base_ns()
    span = next(e for e in ours["traceEvents"] if e["name"] == "op")
    op = next(e for e in theirs["traceEvents"] if e.get("name") == "aten::mm" and e.get("ph") == "X")
    assert span["ph"] == "X" and span["tid"] == op["tid"] and span["pid"] == op["pid"]
    assert span["ts"] <= float(op["ts"]) <= float(op["ts"]) + float(op["dur"]) <= span["ts"] + span["dur"]
    assert ours["droppedEvents"] == 0 and span["args"]["id"] >= 1


def test_dispatch_frames_counts_lanes_of_a_batch():
    assert dispatch_frames((np.zeros((4, 2, 3, 3)),)) == 4
    assert dispatch_frames((np.zeros((2, 3, 3)), np.zeros((2, 3, 3)))) == 2
    assert dispatch_frames((np.zeros((2, 3)),)) == 1


@pytest.fixture
def on():
    """The package's tracer, on and empty, for one test."""
    was = trace.tracer.enabled
    trace.tracer.clear()
    trace.tracer.enable()
    try:
        yield trace.tracer
    finally:
        if not was:
            trace.tracer.disable()
        trace.tracer.clear()


FETCH_S = 0.5  # each fetch held this long, so a dispatch past the depth finds no free slot


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("async_fetch", [False, True], ids=["sync", "async"])
def test_the_executor_records_each_span_with_its_dispatch(on, monkeypatch, depth, async_fetch):
    materialize = ex_mod._materialize

    def slow_fetch(result):
        time.sleep(FETCH_S)
        return materialize(result)

    monkeypatch.setattr(ex_mod, "_materialize", slow_fetch)

    def chain(frame, *, tuners, want_posts):
        return {"y": frame.to(torch.int32) * tuners["k"]}

    n, lanes, shape = 4, 2, (3, 5, 3)
    ex = StreamExecutor(DevicePipeline(build_packed_fn(chain, lanes, "map"), CPU), depth=depth,
                        async_fetch=async_fetch)
    out = []
    try:
        for i in range(n):
            out.extend(ex.submit((np.full((lanes,) + shape, i, np.uint8),), meta=i, tuners={"k": 2}, want_posts=False))
        out.extend(ex.flush())
    finally:
        ex.close()
    assert [meta for _, meta in out] == list(range(n))

    events = on.events()
    assert on.dropped == 0

    def named(name):
        return [e for e in events if e.name == name]

    submit = {e.dispatch: e for e in named("executor.submit")}
    assert sorted(submit) == list(range(1, n + 1))
    assert all(e.args["frames"] == lanes for e in submit.values())
    assert [submit[d].args["inflight"] for d in range(1, depth + 1)] == list(range(depth))
    packed_bytes = lanes * int(np.prod(shape)) * 4
    for d, s in submit.items():
        (h2d,) = [e for e in named("executor.h2d") if e.dispatch == d]
        (launch,) = [e for e in named("executor.launch") if e.dispatch == d]
        (pack,) = [e for e in named("executor.pack") if e.dispatch == d]
        (wait,) = [e for e in named("executor.event_wait") if e.dispatch == d]
        (d2h,) = [e for e in named("executor.d2h") if e.dispatch == d]
        assert h2d.parent == s.id and h2d.args == {"bytes": lanes * int(np.prod(shape))}
        assert launch.parent == s.id and pack.parent == launch.id and pack.args == {}
        assert d2h.args == {"bytes": packed_bytes} and wait.end_ns <= d2h.start_ns
        assert s.start_ns <= h2d.start_ns <= h2d.end_ns <= launch.start_ns <= launch.end_ns <= s.end_ns
        assert (d2h.tid != s.tid) == async_fetch
    # a dispatch waits for a free slot only once the depth is exceeded
    held = sorted(e.dispatch for e in named("executor.backpressure"))
    assert held and all(d > depth for d in held)
    assert all(submit[d].args["inflight"] >= depth for d in held)
    if not async_fetch:
        assert held == list(range(depth + 1, n + 1))
        for e in named("executor.backpressure"):
            assert e.parent == submit[e.dispatch].id
            (d2h,) = [x for x in named("executor.d2h") if x.parent == e.id]
            assert d2h.dispatch == e.dispatch - depth  # the oldest result is fetched


def test_the_red_buoy_chain_records_its_stages_once_per_lane(on):
    frames = np.zeros((2, 24, 32, 3), np.uint8)
    frames[:, 8:16, 8:20] = (0, 0, 255)
    fn = build_packed_fn(lambda f, *, tuners, want_posts: chains.red_buoy_fused(f, 140, 255)[2], 2, "map")
    ex = StreamExecutor(DevicePipeline(fn, CPU), depth=1)
    ex.submit((frames,), tuners={}, want_posts=False)
    ex.flush()
    events = on.events()
    (launch,) = [e for e in events if e.name == "executor.launch"]
    stages = [e.name for e in events if e.name.startswith("chain.")]
    assert stages == ["chain.lab_threshold", "chain.morph", "chain.ccl", "chain.stats"] * 2
    assert all(e.parent == launch.id and e.dispatch == 1 for e in events if e.name.startswith("chain."))


def test_annotate_adds_args_to_the_innermost_open_span():
    tr = Tracer()
    tr.annotate(graph="eager")  # off: nothing
    tr.enable()
    tr.annotate(graph="eager")  # no span open: nothing
    with tr.span("outer"):
        with tr.span("inner", a=1):
            tr.annotate(graph="replay")
        tr.annotate(b=2)
    events = {e.name: e for e in tr.events()}
    assert sorted(events) == ["inner", "outer"]
    assert events["inner"].args == {"a": 1, "graph": "replay"}
    assert events["outer"].args == {"b": 2}

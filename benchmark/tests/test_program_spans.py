"""The readers of the port's own spans (``benchmark/program_spans.py``) on
made-up spans and device records, and the harness's loop with the port's
tracer on, on the CPU."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import program_spans as ps  # noqa: E402

from cuauv_vision_pipeline_tpu_torch.core.trace import Span  # noqa: E402

MS = 1_000_000
DISPATCH, FETCH = 101, 202  # thread ids


def _span(name, start_ms, end_ms, id_, parent=None, dispatch=1, tid=DISPATCH, **args):
    return Span("X", name, tid, int(start_ms * MS), int(end_ms * MS), id_, parent, dispatch, args)


def _dispatch(d, t0, frames=4, held=0.0):
    """One dispatch's spans from ``t0`` ms: submit 0-10 (h2d 1-3, launch
    3-9 with pack 8-9, back-pressure 9-9+held), event wait and D2H on the
    fetch thread at 12-13 and 13-14."""
    base = d * 100
    out = [_span("executor.submit", t0, t0 + 10 + held, base, None, d, frames=frames, inflight=2),
           _span("executor.h2d", t0 + 1, t0 + 3, base + 1, base, d, bytes=frames * 6_220_800),
           _span("executor.launch", t0 + 3, t0 + 9, base + 2, base, d),
           _span("executor.pack", t0 + 8, t0 + 9, base + 3, base + 2, d, bytes=64),
           _span("executor.event_wait", t0 + 12, t0 + 13, base + 5, None, d, tid=FETCH),
           _span("executor.d2h", t0 + 13, t0 + 14, base + 6, None, d, tid=FETCH, bytes=64)]
    if held:
        out.append(_span("executor.backpressure", t0 + 9, t0 + 9 + held, base + 4, base, d))
    return out


def _ctx(spans, htod=(), dtoh=(), kernels=(), lo_ms=0, hi_ms=0):
    """``htod``/``dtoh``: copies as (call start, call end, device start,
    device end), ms."""
    def ns(*ms):
        return tuple(int(v * MS) for v in ms)

    events = {"kernel": [("k",) + ns(s, e) for s, e in kernels],
              "HtoD": [("Memcpy HtoD (Pageable -> Device)",) + ns(s, e) for _, _, s, e in htod],
              "DtoH": [("Memcpy DtoH (Device -> Pageable)",) + ns(s, e) for _, _, s, e in dtoh],
              "other": []}
    copies = {"HtoD": [ns(*c) for c in htod], "DtoH": [ns(*c) for c in dtoh]}
    return SimpleNamespace(program_spans=spans, events=events, copies=copies, t_lo=int(lo_ms * MS),
                           t_hi=int(hi_ms * MS))


def test_h2d_stream_wait_reads_span_start_to_its_copy_s_device_record():
    # dispatches 1 and 2 inside the slice [0, 50), dispatch 3 outside it
    spans = _dispatch(1, 0) + _dispatch(2, 20) + _dispatch(3, 60)
    # dispatch 1's copy is called 0.1 ms into its span and starts on the card 1.5 ms in; dispatch 2's 0.5 ms in
    copies = [(1.1, 2.9, 2.5, 2.9), (21.1, 22.9, 21.5, 22.5)]
    ctx = _ctx(spans, htod=copies, lo_ms=0, hi_ms=50)
    assert ps.h2d_stream_wait_ms_per_frame(ctx) == pytest.approx((1.5 + 0.5) / 8)
    assert ps.htod_misplaced(ctx) == 0
    got = ps.checks(ctx)
    assert got["htod_records"] == 2 and got["htod_misplaced"] == 0
    # a record stamped before its span or after it: the clocks disagree, no value
    for wrong in [(1.1, 2.9, 0.9, 1.3), (1.1, 2.9, 3.5, 3.9), (1.1, 2.9, 21.2, 21.4)]:
        ctx = _ctx(spans, htod=[wrong] + copies[1:], lo_ms=0, hi_ms=50)
        assert ps.htod_misplaced(ctx) == 1
        assert ps.h2d_stream_wait_ms_per_frame(ctx) is None
    # a span with no record (CUPTI dropped it), or a record with no call: no value
    assert ps.h2d_stream_wait_ms_per_frame(_ctx(spans, htod=copies[1:], lo_ms=0, hi_ms=50)) is None
    orphan = _ctx(spans, htod=copies, lo_ms=0, hi_ms=50)
    orphan.copies["HtoD"].pop()
    assert ps.htod_misplaced(orphan) == 1 and ps.h2d_stream_wait_ms_per_frame(orphan) is None
    # a copy called outside every h2d span
    late = [(3.5, 3.9, 3.6, 4.0)] + copies[1:]
    assert ps.htod_misplaced(_ctx(spans, htod=late, lo_ms=0, hi_ms=50)) == 1
    assert ps.h2d_stream_wait_ms_per_frame(_ctx(spans, htod=late, lo_ms=0, hi_ms=50)) is None
    assert ps.h2d_stream_wait_ms_per_frame(_ctx(spans, lo_ms=500, hi_ms=600)) is None  # no span in the slice


def test_pack_and_d2h_read_the_spans_outside_the_slice():
    spans = _dispatch(1, 0, frames=4) + _dispatch(2, 20, frames=2) + _dispatch(3, 60, frames=2)
    ctx = _ctx(spans, lo_ms=0, hi_ms=10)  # dispatch 1 is the slice
    assert ps.pack_host_ms_per_frame(ctx) == pytest.approx(2 / 4)
    assert ps.d2h_host_ms_per_frame(ctx) == pytest.approx(2 / 4)  # event waits left out
    assert ps.d2h_bytes_per_frame(ctx) == pytest.approx(3 * 64 / 8)  # the whole window
    empty = _ctx([s for s in spans if s.name not in ("executor.pack", "executor.d2h")], lo_ms=0, hi_ms=10)
    assert ps.pack_host_ms_per_frame(empty) is None
    assert ps.d2h_host_ms_per_frame(empty) is None
    assert ps.d2h_bytes_per_frame(empty) is None


def test_backpressure_reads_its_own_time_outside_the_slice():
    spans = _dispatch(1, 0) + _dispatch(2, 20, held=3.0) + _dispatch(3, 60, held=1.0)
    # a fetch done inside a back-pressure span (sync fetch) is not its own time
    spans.append(_span("executor.d2h", 69.2, 69.7, 999, 304, 3, bytes=64))
    ctx = _ctx(spans, lo_ms=0, hi_ms=10)
    assert ps.backpressure_host_ms_per_frame(ctx) == pytest.approx((3.0 + 0.5) / 8)
    # the executor's spans and no wait: none; no executor spans at all: nothing to read
    assert ps.backpressure_host_ms_per_frame(_ctx(_dispatch(1, 0) + _dispatch(2, 20), lo_ms=0, hi_ms=10)) == 0.0
    assert ps.backpressure_host_ms_per_frame(_ctx([], lo_ms=0, hi_ms=10)) is None


def test_host_spans_give_self_time_and_gaps_are_labelled_on_both_threads():
    spans = _dispatch(1, 0) + _dispatch(2, 20)
    ctx = _ctx(spans, lo_ms=100, hi_ms=200)  # no dispatch in the slice: all outside
    table = dict(ps.host_spans(ctx))
    assert table["executor.submit"] == pytest.approx(2 * (10 - 2 - 6) / 8)
    assert table["executor.launch"] == pytest.approx(2 * 5 / 8)
    assert table["executor.h2d"] == pytest.approx(2 * 2 / 8)
    assert ps.host_spans(_ctx([], lo_ms=0, hi_ms=1)) == []
    # the card busy 0-4 and 12.5-20 of the slice [0, 20): gaps 4-12.5 and nothing at the end
    gaps = ps.idle_gaps_program(_ctx(spans, kernels=[(0, 4), (12.5, 20)], lo_ms=0, hi_ms=20))
    assert gaps == [["executor.launch | -", pytest.approx(0.0085)]]
    gaps = ps.idle_gaps_program(_ctx(spans, kernels=[(0, 13.5)], lo_ms=0, hi_ms=20))
    assert gaps == [["- | executor.d2h", pytest.approx(0.0065)]]


def test_the_d2h_wait_is_read_against_the_card_s_work():
    spans = _dispatch(1, 0) + _dispatch(2, 20)
    # dispatch 1's D2H span opens at 13 ms, its copy is called at 13.05 and runs at 13.6; the card works
    # 13.0-13.4; dispatch 2's at 33, called at 33.05, runs at 33.2 with the card idle
    dtoh = [(13.05, 13.75, 13.6, 13.7), (33.05, 33.75, 33.2, 33.3)]
    got = ps.checks(_ctx(spans, dtoh=dtoh, kernels=[(13.0, 13.4)], lo_ms=0, hi_ms=50))
    assert got["d2h_stream_wait_ms_per_frame"] == pytest.approx((0.6 + 0.2) / 8)
    assert got["d2h_wait_busy_share"] == pytest.approx(0.4 / 0.8)
    assert got["launch_host_ms_per_frame"] is None and got["h2d_span_ms_per_frame"] is None  # all in the slice
    # a record stamped before its own call has a wrong device time: no value
    wrong = _ctx(spans, dtoh=[dtoh[0], (33.05, 33.75, 32.9, 33.0)], kernels=[(13.0, 13.4)], lo_ms=0, hi_ms=50)
    assert ps.checks(wrong)["d2h_stream_wait_ms_per_frame"] is None


def test_the_counter_readers_read_h2d_bytes_and_inflight():
    spans = _dispatch(1, 0, frames=4) + _dispatch(2, 20, frames=2)
    ctx = _ctx(spans, lo_ms=0, hi_ms=10)  # dispatch 1 is the slice
    assert ps.h2d_host_gb_per_s(ctx) == pytest.approx(2 * 6_220_800 / 2e6)  # bytes over the 2 ms span
    assert ps.inflight_at_submit(ctx) == 2.0
    spans[6] = spans[6]._replace(args={"frames": 2, "inflight": 1})
    assert ps.inflight_at_submit(_ctx(spans, lo_ms=0, hi_ms=10)) == 1.5
    empty = _ctx([s for s in spans if s.name not in ("executor.submit", "executor.h2d")], lo_ms=0, hi_ms=10)
    assert ps.h2d_host_gb_per_s(empty) is None and ps.inflight_at_submit(empty) is None


def test_the_harness_loop_records_the_program_s_spans_on_the_cpu():
    import torch

    small = {"config": {"height": 48, "width": 64}, "traffic": {"ring_frames": 8}}
    r = ps.run("red_buoy_1080p.stream", 2**31 + 5, 0.5, False, True, torch.device("cpu"), overrides=small)
    assert r["correct"] is True
    spans = r["spans"]
    submits = [s for s in spans if s.name == "executor.submit"]
    assert sum(s.args["frames"] for s in submits) == r["attempted"] > 0
    assert min(s.dispatch for s in submits) == ps.harness.WARMUP_DISPATCHES + 1
    names = {s.name for s in spans}
    assert names >= {"executor.submit", "executor.h2d", "executor.launch", "executor.pack", "executor.event_wait",
                     "executor.d2h", "chain.lab_threshold", "chain.morph", "chain.ccl", "chain.stats"}
    table = dict(ps.host_spans(SimpleNamespace(program_spans=spans, t_lo=0, t_hi=0)))
    assert table["chain.ccl"] > 0 and table["executor.h2d"] > 0
    from cuauv_vision_pipeline_tpu_torch.core.trace import tracer

    assert not tracer.enabled and tracer.events() == []
    off = ps.run("red_buoy_1080p.stream", 7, 0.2, False, False, torch.device("cpu"), overrides=small)
    assert "spans" not in off and off["correct"] is True and tracer.events() == []

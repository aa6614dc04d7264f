"""The driving loop at a tiny size on the CPU, called as a function (the
command itself refuses to run without a card), and the faults that a cell
can have, planted under the timed path: each must read as not correct."""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402

CPU = torch.device("cpu")
SMALL = {"config": {"height": 72, "width": 120}, "traffic": {"ring_frames": 8}}
CELLS = {"red_buoy_1080p.stream": SMALL, "red_buoy_1080p.stereo": SMALL}

def run(workload, seed=9, wrap_chain=None, overrides=None, trace=False):
    return harness.run_cell(workload, seed, 0.4, trace, CPU, time.monotonic(),
                            overrides=overrides or CELLS[workload], wrap_chain=wrap_chain, log=lambda *a: None)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_sound_run_is_correct_and_reports_every_key(workload):
    r = run(workload)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    _, _, _, e2e, _ = harness.find_cell(harness.load_json(BENCH.parent / "BENCHMARK.json"), workload)
    assert set(r["metrics"]) == {m["name"] for m in e2e} >= {"frames_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["device"]["count"] == 1
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_a_traced_run_without_a_kernel_record_gives_no_result():
    with pytest.raises(harness.RunError, match="no trace slice"):
        run("red_buoy_1080p.stream", trace=True)


def _alter_area(fn):
    def chain(*frames, tuners, want_posts):
        best, posts = fn(*frames, tuners=tuners, want_posts=want_posts)
        return dict(best, area=best["area"] + 1), posts
    return chain


def _every_other_call_repeats(fn):
    """Half of a map dispatch's lanes left out: each second frame gets the
    answer of the frame before it."""
    last = {}

    def chain(*frames, tuners, want_posts):
        if last.get("n", 0) % 2 and "out" in last:
            out = last["out"]
        else:
            out = fn(*frames, tuners=tuners, want_posts=want_posts)
        last["n"] = last.get("n", 0) + 1
        last["out"] = out
        return out
    return chain


def _left_eye_twice(fn):
    def chain(forward, forward2, *, tuners, want_posts):
        return fn(forward, forward, tuners=tuners, want_posts=want_posts)
    return chain


@pytest.mark.parametrize("workload,fault", [
    ("red_buoy_1080p.stream", _alter_area),
    ("red_buoy_1080p.stream", _every_other_call_repeats),
    ("red_buoy_1080p.stereo", _alter_area),
    ("red_buoy_1080p.stereo", _left_eye_twice),
], ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_fault_under_the_timed_path_reads_as_not_correct(workload, fault):
    r = run(workload, wrap_chain=fault)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_red_buoy_control_reads_as_not_correct():
    """The reference with its centroid in bfloat16, in the chain's place."""
    cfg = harness.load_json(BENCH / "configs" / "red_buoy_1080p.json")
    adapter = harness.load_file(BENCH / "systems" / "red_buoy.py")
    reference = harness.load_file(BENCH / "configs" / "red_buoy_1080p_ref.py")
    for workload in ("red_buoy_1080p.stream", "red_buoy_1080p.stereo"):
        r = run(workload, wrap_chain=adapter.control_wrap(cfg, reference))
        assert r["correct"] is False
        assert r["checks"]["centroid_gap_px"]["value"] > r["checks"]["centroid_gap_px"]["limit"]
        assert r["checks"]["mismatched_frames"]["value"] == 0


def test_the_ring_stacks_frames_as_the_dispatch_takes_them():
    """Frame (s * F + a * L + l) of the ring is lane l of camera a in
    dispatch slot s: the answers judged against frame i come from frame i."""
    seen = []

    def spy(fn):
        def chain(*frames, tuners, want_posts):
            seen.append(tuple(int(f.float().sum()) for f in frames))
            return fn(*frames, tuners=tuners, want_posts=want_posts)
        return chain

    run("red_buoy_1080p.stereo", wrap_chain=spy)
    import scenes

    mix = harness.load_json(BENCH / "traffic" / "stereo.json")
    frames = scenes.make_scenes(8, 72, 120, mix["scene"], 9, CPU)
    sums = [int(f.float().sum()) for f in frames]
    assert seen[0] == (sums[0], sums[1]) and seen[1] == (sums[2], sums[3])
    assert np.all(np.asarray(sums) > 0)

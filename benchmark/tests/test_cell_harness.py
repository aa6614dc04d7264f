"""The harness's bookkeeping on the CPU: cells found by name, the window
arithmetic, the trace reduction and the import guard."""

import json
import math
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import guard  # noqa: E402
import harness  # noqa: E402
import stats  # noqa: E402

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_files_by_name(cell):
    _, cfg, mix, e2e, layer = harness.find_cell(SPEC, cell["name"])
    assert cfg["name"] == cell["config"]
    assert (BENCH / "systems" / f"{cfg['system']}.py").is_file()
    assert (BENCH / "configs" / f"{cfg['reference']}.py").is_file()
    assert mix["frames_per_dispatch"] >= 1 and mix["ring_frames"] % mix["frames_per_dispatch"] == 0
    assert {m["name"] for m in e2e} >= {"frames_per_s", "setup_s"}  # set-up and one more, in every cell
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        reader = harness.load_file(BENCH / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


def test_benchmark_json_keeps_to_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in SPEC["configs"]:
        assert Path(BENCH.parent / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers <= {"executor", "h2d", "chain / model", "kernels", "device"}
    assert all(m["moves"] == "frames_per_s" for m in SPEC["per_layer"])
    assert 1 <= SPEC["run_seconds"] <= 51


def test_unknown_workload_is_refused():
    with pytest.raises(harness.RunError):
        harness.find_cell(SPEC, "no_such.cell")


def test_rate_takes_every_frame_over_the_whole_window():
    assert stats.rate(1500, 10.0) == 150.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_is_nearest_rank_over_all_values():
    values = list(range(1, 101))  # 1..100
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 50) == 50
    assert stats.percentile([7.0], 95) == 7.0
    # every frame counts: a dispatch of 4 frames adds its latency 4 times
    assert stats.percentile([1.0] * 4 * 19 + [9.0] * 4, 95) == 1.0
    assert stats.percentile([1.0] * 4 * 18 + [9.0] * 8, 95) == 9.0


def test_busy_time_is_the_union_of_intervals_inside_the_window():
    # kernels and a copy overlapping, one record outside the window
    intervals = [(0, 10), (5, 20), (30, 40), (38, 45), (90, 120), (200, 210)]
    busy, gaps = stats.busy_and_gaps(intervals, 0, 100)
    assert busy == 20 + 15 + 10
    assert gaps == [(20, 30), (45, 90)]
    busy, gaps = stats.busy_and_gaps([], 0, 100)
    assert busy == 0 and gaps == [(0, 100)]


def _ctx(**kw):
    cfg = {"height": 1080, "width": 1920, "image_size": 640}
    base = dict(cfg=cfg, peaks=stats.PEAKS, frames=2, window_s=1.0, busy_s=0.5,
                events={"kernel": [], "HtoD": [], "DtoH": [], "other": []},
                untraced_spans=[], untraced_frames=0)
    base.update(kw)
    return SimpleNamespace(**base)


def test_ccl_roofline_counts_a_u8_mask_in_and_int32_labels_out():
    reader = harness.load_file(BENCH / "metrics" / "ccl_roofline_pct.py")
    # 2 frames: 2 x 1080 x 1920 x 5 B = 20.736 MB; at 3.35 TB/s 6.19 us
    names = ["(anonymous namespace)::local_kernel(unsigned char const*, int*, int, int, int, int)",
             "(anonymous namespace)::border_kernel(unsigned char const*, int*, int, int, int)",
             "(anonymous namespace)::final_kernel(unsigned char const*, int*, int, int)",
             "void at::native::vectorized_elementwise_kernel<4>(int)"]
    events = {"kernel": [(n, 0, 20_000) for n in names], "HtoD": [], "DtoH": [], "other": []}
    value = reader.read(_ctx(events=events))
    least = 2 * 1080 * 1920 * 5 / 3.35e12
    assert value == pytest.approx(100 * least / 60e-6)
    assert reader.read(_ctx()) is None  # nothing to read: no value, never 0


def test_idle_share_and_per_frame_device_times():
    events = {"kernel": [("k", 0, 300_000_000)], "HtoD": [("Memcpy HtoD (Pageable -> Device)", 0, 100_000_000)],
              "DtoH": [], "other": []}
    ctx = _ctx(events=events, frames=100, busy_s=0.3)
    idle = harness.load_file(BENCH / "metrics" / "device_idle_pct.py").read(ctx)
    assert idle == pytest.approx(70.0)
    chain = harness.load_file(BENCH / "metrics" / "chain_device_ms_per_frame.py").read(ctx)
    assert chain == pytest.approx(3.0)
    h2d = harness.load_file(BENCH / "metrics" / "h2d_ms_per_frame.py").read(ctx)
    assert h2d == pytest.approx(1.0)
    spans = [("h2d", 0, 2_000_000), ("launch", 2_000_000, 5_000_000), ("submit", 0, 9_000_000)]
    host = harness.load_file(BENCH / "metrics" / "dispatch_host_ms_per_frame.py")
    assert host.read(_ctx(untraced_spans=spans, untraced_frames=4)) == pytest.approx(0.75)  # launches alone
    hold = harness.load_file(BENCH / "metrics" / "h2d_host_ms_per_frame.py")
    assert hold.read(_ctx(untraced_spans=spans, untraced_frames=4)) == pytest.approx(0.5)
    assert host.read(_ctx(untraced_spans=[], untraced_frames=4)) is None


def test_the_guard_compares_whole_top_level_names():
    loaded = ["jax.numpy", "jaxlib", "flax.linen", "cuauv_vision_pipeline_tpu.ops.color",
              "cuauv_vision_pipeline_tpu_torch.ops.color", "jaxtyping", "flaxx", "numpy"]
    assert guard.forbidden_modules(loaded) == [
        "cuauv_vision_pipeline_tpu.ops.color", "flax.linen", "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax_and_leaves_nothing_in_dev_shm():
    code = f"""
import sys, time, json
sys.path.insert(0, {str(BENCH)!r})
import torch, harness, guard
small = {{"config": {{"height": 64, "width": 96}}, "traffic": {{"ring_frames": 4}}}}
r = harness.run_cell("red_buoy_1080p.stereo", 3, 0.3, False, torch.device("cpu"), time.monotonic(),
                     overrides=small, log=lambda *a: None)
print(json.dumps({{"forbidden": guard.forbidden_modules(), "correct": r["correct"]}}))
"""
    before = guard.shm_entries()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"forbidden": [], "correct": True}
    assert guard.shm_left(before) == []


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "red_buoy_1080p.stream",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_seeds_past_32_bits_are_taken():
    import scenes
    import torch

    scene = harness.load_json(BENCH / "traffic" / "stream.json")["scene"]
    a = scenes.make_scenes(2, 32, 48, scene, 2**31 + 12345, torch.device("cpu"))
    b = scenes.make_scenes(2, 32, 48, scene, 2**31 + 12345, torch.device("cpu"))
    c = scenes.make_scenes(2, 32, 48, scene, 2**31 + 12346, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert math.isfinite(float(a.float().mean()))

"""On the card: the port's spans and the card's trace share one clock. Skips
without a card (decided inside each test, never at import).

    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests/test_program_spans_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_every_htod_copy_of_the_slice_starts_inside_its_dispatch_s_h2d_span():
    _card()
    # a process of its own, as each of the benchmark's runs
    out = subprocess.run([sys.executable, str(BENCH / "program_spans.py"), "--workload", "red_buoy_1080p.stream",
                          "--seed", "4242424243", "--seconds", "4"],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["program_checks"]["htod_records"] > 0
    assert r["program_checks"]["htod_misplaced"] == 0, r["program_checks"]
    assert all(v is not None for v in r["program"].values()), r["program"]
    assert all(v is not None for v in r["counters"].values()), r["counters"]
    assert r["host_spans"] and len(r["idle_gaps_program"]) == 10


@pytest.mark.cuda
def test_a_dump_lines_up_with_the_card_s_profile(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from cuauv_vision_pipeline_tpu_torch.core.trace import Tracer

    dev = _card()
    tr = Tracer()
    tr.enable()
    a = torch.ones(2048, 2048, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tr.span("op"):
            b = a @ a
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(tmp_path / "torch.json"))
    tr.dump(str(tmp_path / "mine.json"))
    theirs = json.loads((tmp_path / "torch.json").read_text())
    ours = json.loads((tmp_path / "mine.json").read_text())
    assert ours["baseTimeNanoseconds"] == theirs["baseTimeNanoseconds"]
    span = next(e for e in ours["traceEvents"] if e["name"] == "op")
    kernels = [e for e in theirs["traceEvents"] if e.get("cat") == "kernel" and e.get("ph") == "X"]
    assert kernels and float(b[0, 0]) == 2048.0
    for k in kernels:
        assert span["ts"] <= float(k["ts"]) <= float(k["ts"]) + float(k["dur"]) <= span["ts"] + span["dur"]

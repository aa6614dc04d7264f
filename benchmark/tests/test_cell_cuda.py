"""On the card: every cell of BENCHMARK.json runs through the command and
comes out correct, and a traced run reads the trace. Skips without a card
(decided inside the test, never at import).

    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests/test_cell_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
CELLS = [c["name"] for c in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


def _run(workload: str, trace: int):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", workload, "--seed", "4242424242",
                          "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=600, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_cell_runs_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _run(workload, 0)
    assert r["correct"] is True and r["failed"] == 0
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    t = _run(workload, 1)
    assert t["correct"] is True and t["device"]["busy_s"] > 0
    assert "device_idle_pct" in t["metrics"] and "chain_device_ms_per_frame" in t["metrics"]

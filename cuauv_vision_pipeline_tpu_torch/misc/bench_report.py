"""Render a JSON array of metric objects as a markdown report against the
BASELINE targets.

Each object is one measurement in the bench schema: ``metric``, ``value``,
``unit``, an optional ``note`` and ``vs_baseline``, and any context fields
(the card, its power limit, the lane, the sample count). ``chip_smoke.py``
writes such an array to ``smoke_logs/bench_results.json`` from the numbers
it measures on the card; this tool turns it into something a human can read
at a glance: the metrics that have a target first, then every recorded
metric with its context fields. The markdown is the same, byte for byte, as
the JAX package's ``misc/bench_report.py`` gives for the same input.

Usage::

    python -m cuauv_vision_pipeline_tpu_torch.misc.bench_report [results.json]
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

# metric name -> (target value, comparator, target description): the
# system targets of BASELINE.json (the red_buoy chain's 1080p frames/s per
# accelerator, YOLO's p50 from camera to detection), not measurements
TARGETS: Dict[str, Tuple[float, str, str]] = {
    "red_buoy_1080p_device_chain_fps_per_chip": (
        2000.0, ">=", ">= 2,000 frames/sec/chip (BASELINE.json)"
    ),
    "yolo_p50_camera_to_detection_ms": (
        5.0, "<", "< 5 ms p50 (BASELINE.json)"
    ),
    "derived_pcie_p50_ms_config5_yolo": (
        5.0, "<", "< 5 ms p50, derived PCIe-host budget"
    ),
}

# fields every entry carries; everything else is context worth showing
_CORE_FIELDS = ("metric", "value", "unit", "vs_baseline", "note")

# what main() reads without an argument: the file chip_smoke.py writes
DEFAULT_RESULTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "smoke_logs", "bench_results.json",
)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:,.4g}" if abs(v) < 1000 else f"{v:,.0f}"
    return str(v)


def _meets(value: float, target: float, op: str) -> bool:
    return value >= target if op == ">=" else value < target


def render(results: List[Dict[str, Any]]) -> str:
    lines: List[str] = ["# Benchmark report", ""]

    targeted = [r for r in results if r.get("metric") in TARGETS]
    if targeted:
        lines += ["## Targets", "",
                  "| metric | value | target | met |",
                  "|---|---|---|---|"]
        for r in targeted:
            tgt, op, desc = TARGETS[r["metric"]]
            ok = _meets(float(r["value"]), tgt, op)
            lines.append(
                f"| {r['metric']} | {_fmt(r['value'])} {r.get('unit', '')} "
                f"| {desc} | {'yes' if ok else 'NO'} |"
            )
        lines.append("")

    lines += ["## All metrics", "",
              "| metric | value | unit | context |",
              "|---|---|---|---|"]
    for r in sorted(results, key=lambda r: str(r.get("metric"))):
        extras = ", ".join(
            f"{k}={_fmt(v)}" for k, v in r.items() if k not in _CORE_FIELDS
        )
        ctx = "; ".join(x for x in (extras, r.get("note", "")) if x)
        vs = r.get("vs_baseline")
        value = _fmt(r["value"]) + (f" ({_fmt(vs)}x target)" if vs else "")
        lines.append(
            f"| {r.get('metric')} | {value} | {r.get('unit', '')} | {ctx} |"
        )
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else DEFAULT_RESULTS
    try:
        with open(path) as f:
            results = json.load(f)
    except (OSError, ValueError) as e:
        print(f"cannot read {path}: {e}", file=sys.stderr)
        return 1
    if not isinstance(results, list):
        print(f"{path}: expected a JSON array of metric objects",
              file=sys.stderr)
        return 1
    try:
        print(render(results))
    except BrokenPipeError:  # piped into head/less and closed early
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The YOLO cell's loop and check at a small size on the CPU (scale p,
240x320 frames letterboxed to 160: 525 anchors, a pool of 64 and 8 picks,
the cell's 16 candidates a pick; the module's bf16 chain on the CPU against
the float32 reference), and the faults its check must catch, each planted
under the timed path and each failing its own number."""

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
CELL = "yolov8n_obb_640.stream"
SMALL = {"config": {"height": 240, "width": 320, "image_size": 160, "size": "p", "nms_pool": 64, "max_det": 8},
         "traffic": {"ring_frames": 4}}
CFG = {**harness.load_json(BENCH / "configs" / "yolov8n_obb_640.json"), **SMALL["config"]}


def run(seed=9, wrap_chain=None):
    return harness.run_cell(CELL, seed, 0.4, False, CPU, time.monotonic(), overrides=SMALL, wrap_chain=wrap_chain,
                            log=lambda *a: None)


def failing(r):
    return sorted(k for k, c in r["checks"].items() if c["value"] > c["limit"])


@pytest.mark.parametrize("seed", [9, 2**31 + 77])
def test_a_sound_run_is_correct(seed):
    r = run(seed)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert set(r["checks"]) == set(CFG["limits"])


def _edit(fn, change):
    """The chain with ``change(result)`` applied to its result tree."""
    def chain(image, *, tuners, want_posts):
        out, posts = fn(image, tuners=tuners, want_posts=want_posts)
        out = dict(out)
        change(out)
        return out, posts
    return chain


def _shift_scores(fn):
    def change(out):  # every pick's logit up by 0.5
        s = out["score"]
        out["score"] = torch.where(out["valid"], torch.sigmoid(torch.logit(s) + 0.5), s)
    return _edit(fn, change)


def _other_class(fn):
    def change(out):
        out["cls"] = torch.where(out["valid"], (out["cls"] + 7) % CFG["num_classes"], out["cls"])
    return _edit(fn, change)


def _twin_picks(fn):
    def change(out):  # the second pick made a copy of the first, nudged by a pixel
        for k in ("xyxy", "score", "cls", "angle"):
            v = out[k].clone()
            v[1] = out[k][0] + (1.0 if k == "xyxy" else 0)
            out[k] = v
    return _edit(fn, change)


def _drop_last_pick(fn):
    def change(out):
        valid = out["valid"].clone()
        valid[int(valid.sum()) - 1] = False
        out["valid"] = valid
    return _edit(fn, change)


@pytest.mark.parametrize("fault,number", [
    (_shift_scores, "logit_rms"),
    (_other_class, "unmatched_picks"),
    (_twin_picks, "nms_violations"),
    (_drop_last_pick, "valid_count_gap"),
], ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_fault_in_the_served_result_fails_its_number(fault, number):
    r = run(wrap_chain=fault)
    assert r["correct"] is False
    assert number in failing(r), r["checks"]


def _pool_from_the_lowest(scores, pool):
    """A descending sort become ascending: the pool the lowest scores."""
    scores, idx = torch.sort(scores, dim=1, descending=False, stable=True)
    return scores[:, :pool].contiguous(), idx[:, :pool]


def _pool_by_index(scores, pool):
    """The pool the first ``pool`` anchors, whatever their scores."""
    return scores[:, :pool].contiguous(), torch.arange(pool, device=scores.device).expand(len(scores), -1)


def _nms_keeping_the_lowest(nms):
    """An NMS that takes the lowest-scored live candidate first (the
    served scores are gathered from the pool as before)."""
    def keep_lowest(boxes, scores, classes, angle, iou_thresh, max_det):
        live = scores > 0
        flipped = torch.where(live, scores.amax(1, keepdim=True) + scores.amin(1, keepdim=True) - scores, 0.0)
        return nms(boxes, flipped, classes, angle, iou_thresh, max_det)
    return keep_lowest


@pytest.mark.parametrize("fault", ["pool_from_the_lowest", "pool_by_index", "nms_keeping_the_lowest"])
def test_a_wrong_selection_fails_pick_logit_rms(fault, monkeypatch):
    # each pick still matches an anchor of its own class and no two overlap: only the tie to the
    # reference's own picks sees that they are the wrong ones
    from cuauv_vision_pipeline_tpu_torch.models.yolo import decode

    if fault == "nms_keeping_the_lowest":
        monkeypatch.setattr(decode, "nms_fixed_cuda", _nms_keeping_the_lowest(decode.nms_fixed_cuda))
    else:
        monkeypatch.setattr(decode, "_top_pool", {"pool_from_the_lowest": _pool_from_the_lowest,
                                                  "pool_by_index": _pool_by_index}[fault])
    r = run()
    assert r["correct"] is False
    assert "pick_logit_rms" in failing(r), r["checks"]
    assert r["checks"]["unmatched_picks"]["value"] == 0 and r["checks"]["nms_violations"]["value"] == 0


def test_a_changed_letterbox_pixel_fails_letterbox_mismatch(monkeypatch):
    from cuauv_vision_pipeline_tpu_torch.models.yolo import predictor

    fused = predictor.preprocess_fused

    def one_pixel_off(images, size):
        x = fused(images, size).clone()
        x[..., size // 2, size // 2, 0] += 1.0 / 255.0
        return x

    monkeypatch.setattr(predictor, "preprocess_fused", one_pixel_off)
    r = run()
    assert r["checks"]["letterbox_mismatch_px"]["value"] == len(range(SMALL["traffic"]["ring_frames"]))
    assert r["correct"] is False


def test_the_e4m3_control_fails_logit_rms():
    adapter = harness.load_file(BENCH / "systems" / "yolo.py")
    reference = harness.load_file(BENCH / "configs" / "yolov8n_obb_640_ref.py")
    r = run(wrap_chain=adapter.control_wrap(CFG, reference))
    assert r["correct"] is False
    assert "logit_rms" in failing(r), r["checks"]
    assert r["checks"]["letterbox_mismatch_px"]["value"] == 0


def test_the_reference_e4m3_rounds_to_three_mantissa_bits():
    reference = harness.load_file(BENCH / "configs" / "yolov8n_obb_640_ref.py")
    t = torch.linspace(-3.0, 3.0, 1001)
    q = reference.e4m3(t)
    rel = ((q - t).abs() / t.abs().clamp_min(1e-3))[t.abs() > 0.1]
    assert 0 < float(rel.max()) <= 2 ** -4 and np.unique(q.numpy()).size < 200

"""The red_buoy modules under test: ``BuoyLAB.buoy_chain`` (one camera) and
``BuoyStereo.stereo_chain`` (both ZED eyes), as ``ModuleBase`` dispatches
them, and their check against the plain reference."""

from __future__ import annotations

import importlib
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

REF_BLOCK = 8  # frames per reference call


def device_function(cfg: Dict, cameras: int):
    """The configuration's ``module:Class.method`` that takes ``cameras``
    frames per dispatch, bound to a bare instance of its module class: the
    chain reads nothing of the instance, and a bare one opens no bus."""
    spec = cfg["device_functions"][str(cameras)]
    module_name, attr = spec.split(":")
    cls_name, method = attr.split(".")
    cls = getattr(importlib.import_module(module_name), cls_name)
    return getattr(cls.__new__(cls), method)


def build(cfg, cameras, device, seed, frames, workdir, reference):
    return SimpleNamespace(
        chain=device_function(cfg, cameras),
        tuners={k: np.int32(v) for k, v in cfg["tuners"].items()},
        want_posts=not cfg["performance_mode"],
        release=lambda: None,
    )


def expected(cfg, reference, host_frames: np.ndarray, device) -> Dict[str, np.ndarray]:
    """The reference's stats of every ring frame, computed on ``device`` in
    blocks."""
    parts: List[Dict[str, np.ndarray]] = []
    for i in range(0, len(host_frames), REF_BLOCK):
        block = torch.from_numpy(host_frames[i:i + REF_BLOCK]).to(device)
        parts.append(reference.largest_blob(block, cfg["tuners"]["thresh_min"], cfg["tuners"]["thresh_max"],
                                            cfg["max_components"]))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def compare(want: Dict[str, np.ndarray], got: Dict[str, np.ndarray], frame: int, i: int, gaps: Dict):
    """Frame ``frame`` of the ring, lane ``i`` of a served result: exact
    found, area and box; the centroid's gap where a blob is found."""
    found = bool(np.asarray(got["found"])[i])
    exact = found == bool(want["found"][frame]) and int(np.asarray(got["area"])[i]) == int(want["area"][frame])
    if "bbox" in got:
        exact &= bool(np.array_equal(np.asarray(got["bbox"])[i], want["bbox"][frame]))
    if not exact:
        gaps["mismatched_frames"] += 1
    elif found:
        gap = float(np.abs(np.asarray(got["centroid"], np.float64)[i] - want["centroid"][frame]).max())
        gaps["centroid_gap_px"] = max(gaps["centroid_gap_px"], gap)


def judge(cfg, reference, host_frames, per_dispatch, distinct, system, device):
    """The numbers over every frame served: frames whose found, area or box
    differ from the reference's, and the widest centroid gap in pixels.
    Each distinct answer of a dispatch slot counts once per time served."""
    want = expected(cfg, reference, host_frames, device)
    gaps = {"mismatched_frames": 0, "centroid_gap_px": 0.0}
    for slot, answers in distinct.items():
        for best, count in answers:
            before = gaps["mismatched_frames"]
            for i in range(per_dispatch):
                compare(want, best, slot * per_dispatch + i, i, gaps)
            gaps["mismatched_frames"] = before + (gaps["mismatched_frames"] - before) * count
    return gaps


def control_wrap(cfg, reference):
    """The control: the reference's bfloat16-centroid answer put in the
    module chain's place, as the same tree of device tensors."""
    def wrap(fn):
        def chain(*frames, tuners, want_posts):
            single = len(frames) == 1 and frames[0].ndim == 3
            batch = frames[0][None] if single else frames[0] if len(frames) == 1 else torch.stack(frames)
            out = reference.control(batch, int(tuners["thresh_min"]), int(tuners["thresh_max"]),
                                    cfg["max_components"])
            dtypes = {"found": torch.bool, "area": torch.int32, "bbox": torch.int32, "centroid": torch.float32}
            best = {k: torch.as_tensor(v).to(dtypes[k]).to(batch.device) for k, v in out.items()}
            return ({k: v[0] for k, v in best.items()} if single else best), {}
        return chain
    return wrap

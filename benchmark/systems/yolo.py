"""The YOLO module under test: ``Yolo.detect_chain`` (letterbox, the conv
stack, decode, the candidate pool and ``nms_fixed``) as ``ModuleBase``
dispatches it, serving a ``YoloModel`` that loads, through the port's own
importer of ultralytics checkpoints, weights this run makes from its seed,
and its check against the plain reference.

Weights (:func:`make_state`, :func:`calibrate`): made here in ultralytics'
layout and names, from the reference's list of convolutions, with no code
of the program: every conv lecun-normal, head biases zero, every BatchNorm
of scale ``BATCHNORM_SCALE``; then, in one float32 forward of the reference
over the ring's letterboxed frames, each BatchNorm takes as running
statistics the mean and (biased) variance of its input (so each sees the
earlier ones' output) and each head's output conv is scaled so that its
largest output is ``HEAD_MAX``. Left at identity statistics, such an init
shrinks its activations about 10^4-fold over its depth: every logit is
~1e-4, every box the same, and no number of the check could tell one
precision from another. The smaller the BatchNorm scale, the nearer to
linear the network (on an H100: at scale 1 bf16 reorders most class
logits; at 0.1 SiLU's curvature, on a frame whose large disc drives a few
units far out, grew bf16's gap on the head maps to 37 %, 4 % on the other
frames; at 0.03 it stays at bf16's ~3 % on every frame). Heads scaled by
their spread instead of their largest value gave logits past 100. The
state is written as an ultralytics ``.pt`` checkpoint in the run's workdir;
the served model reads it with the port's loader (``load_checkpoint`` ->
``map_ultralytics_state``), the reference takes the state as made.

What the check compares (:func:`judge`), on every frame the window served,
against the reference run on the card after the window:

- ``letterbox_mismatch_px``: pixels of the port's letterboxed u8 input
  (``YoloModel._letterbox`` of each ring frame, read at set-up) that differ
  from the reference's.
- Each valid pick is matched to the reference anchor that lies nearest in
  box, angle and the score of the pick's class: the sum of the box's
  distance (its Euclidean gap in pixels with the angle's gap times half the
  box's diagonal, how far a corner moves, over the box's mean side, at
  least one stride-8 cell) and the logit's gap over its magnitude (at least
  1). Neighbouring anchors of a smooth random network carry boxes a few
  pixels apart, so the box alone can take a neighbour. ``unmatched_picks``:
  picks whose anchor lies farther than ``MATCH_SHARE`` in box or
  ``CLASS_MARGIN`` in logit, or is not of the pick's class: an anchor is of
  a class where that class's logit lies within ``CLASS_MARGIN`` times the
  best one's magnitude (at least 1) of the best (an anchor's 15 class
  logits lie close on random weights, and rounding reorders them).
- ``nms_violations``: pairs of valid picks of one class whose ProbIoU (the
  reference's, on the served boxes) exceeds ``iou`` by more than
  ``IOU_MARGIN``.
- ``valid_count_gap``: the mean gap, over the frames served, between the
  valid picks served and those of the reference's own greedy NMS over its
  pool. Where a pool's candidates suppress each other below ``max_det``
  picks the count depends on which candidates made the pool, which
  rounding can change: a frame may then read one pick apart.
- ``pick_logit_rms``: what ties the served selection to the reference's:
  the pooled RMS gap between the served picks' logits and the logits of
  the reference's own greedy-NMS picks, each frame's two lists sorted
  from the highest, over the shorter one's length. A pool taken in the
  wrong order or by index, or an NMS that keeps the wrong candidate,
  serves picks that each match an anchor of their own but score below the
  reference's picks.
- ``logit_rms``, ``box_rms_px``, ``angle_rms_rad``: pooled RMS gaps over
  every matched pick of every frame served: the score's logit ``log(s / (1 -
  s))`` against the reference anchor's logit of the pick's class (both as
  float32 scores, so a logit past float32's last score below 1 reads as
  that score's), the four box values, the angle.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

import scenes
from systems.red_buoy import device_function  # the module's chain on a bare instance; build gives it its model

REF_BLOCK = 8  # frames per reference call in the check
SETUP_BLOCK = 2  # frames per letterbox call at set-up
WEIGHT_STREAM = 3  # the seed's substream for the weights (scenes take 1 and 2)
BATCHNORM_SCALE = 0.03
HEAD_MAX = 8.0
MATCH_SHARE = 0.5
CLASS_MARGIN = 0.5
IOU_MARGIN = 1e-3


def _boxes5(xyxy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """[..., 4] xyxy (the unrotated box around the rotated centre) and [...]
    angles -> [..., 5] (cx, cy, w, h, angle)."""
    x1, y1, x2, y2 = xyxy.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1, angle], -1)


def _logit(score: torch.Tensor) -> torch.Tensor:
    """A float32 score's logit in float64, a score of 1 taken as the largest
    float32 below 1 (float32's sigmoid rounds any logit past ~16.6 to 1)."""
    s = score.double().clamp(2.0 ** -126, 1.0 - 2.0 ** -24)
    return torch.log(s / (1.0 - s))


def make_state(cfg, reference, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights on the CPU under ultralytics' names, for every
    conv of ``reference.conv_layers``: weights lecun-normal (standard
    deviation 1 / sqrt(fan in)), head biases 0, BatchNorms of scale
    ``BATCHNORM_SCALE``, shift 0 and identity statistics (``calibrate``
    sets them), with the DFL's fixed conv and the BatchNorms' step counts
    as ultralytics saves them."""
    gen = torch.Generator().manual_seed(scenes.substream(seed, WEIGHT_STREAM))
    state: Dict[str, torch.Tensor] = {}
    for name, c_in, c_out, k, _, head in reference.conv_layers(cfg["size"], cfg["num_classes"]):
        w = torch.randn(c_out, c_in, k, k, generator=gen) / math.sqrt(c_in * k * k)
        if head:
            state.update({f"{name}.weight": w, f"{name}.bias": torch.zeros(c_out)})
            continue
        state.update({f"{name}.conv.weight": w, f"{name}.bn.weight": torch.full((c_out,), BATCHNORM_SCALE),
                      f"{name}.bn.bias": torch.zeros(c_out), f"{name}.bn.running_mean": torch.zeros(c_out),
                      f"{name}.bn.running_var": torch.ones(c_out),
                      f"{name}.bn.num_batches_tracked": torch.tensor(0)})
    state["model.22.dfl.conv.weight"] = torch.arange(reference.REG_MAX, dtype=torch.float32).view(1, -1, 1, 1)
    return state


def calibrate(reference, state: Dict[str, torch.Tensor], letterboxed: torch.Tensor, size: str) -> None:
    """Set ``state``'s BatchNorm statistics and head scales in place, in one
    float32 forward of the reference over every frame of ``letterboxed``
    (u8 RGB [F, S, S, 3]): each conv's output gives its BatchNorm's mean and
    biased variance before the BatchNorm reads them; each head conv is
    scaled to a largest output of ``HEAD_MAX``."""
    names = {t.data_ptr(): k for k, t in state.items()}

    def conv(x, w, b, stride, pad):
        y = F.conv2d(x, w, b, stride, pad)
        name = names[w.data_ptr()]
        if name.endswith(".conv.weight"):
            bn = name[:-len("conv.weight")] + "bn."
            y64 = y.double()
            mean = y64.mean((0, 2, 3))
            state[bn + "running_mean"].copy_(mean)
            state[bn + "running_var"].copy_((y64 * y64).mean((0, 2, 3)) - mean * mean)
            return y
        scale = HEAD_MAX / y.abs().max()
        w.mul_(scale)
        b.mul_(scale)
        return y * scale

    reference.head_maps(state, letterboxed, size, conv)


def build(cfg, cameras, device, seed, frames, workdir, reference):
    from cuauv_vision_pipeline_tpu_torch.models.yolo.decode import candidates
    from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel

    size = cfg["image_size"]
    t0 = time.monotonic()
    state = {k: v.to(device) for k, v in make_state(cfg, reference, seed).items()}
    ring = torch.cat([reference.letterbox(frames[i:i + SETUP_BLOCK], size)
                      for i in range(0, len(frames), SETUP_BLOCK)])
    calibrate(reference, state, ring, cfg["size"])
    del ring
    state = {k: v.cpu() for k, v in state.items()}
    path = str(Path(workdir) / f"{cfg['name']}.pt")
    torch.save({"model": state, "names": cfg["class_names"], "task": cfg["task"]}, path)
    t1 = time.monotonic()
    served = YoloModel(path, task=cfg["task"], image_size=size, conf_thresh=cfg["conf"], max_det=cfg["max_det"],
                       half_precision=cfg["half_precision"], quantize=cfg.get("quantize"),
                       nms_pool=cfg["nms_pool"], device=device)
    if (served.nms_pool, served.quantize, served.task) != (cfg["nms_pool"], cfg.get("quantize"), cfg["task"]):
        raise RuntimeError(f"the environment changed the served model: pool {served.nms_pool}, "
                           f"quantize {served.quantize}, task {served.task}")
    chain = device_function(cfg, cameras)
    owner = chain.__self__
    owner.model = served
    # the weights as made, for the reference and the control
    owner.reference_state = {k: v.numpy() for k, v in state.items()}
    t2 = time.monotonic()

    # set-up readings, off the timed path: the port's letterbox of every ring
    # frame, and its candidates above ``conf``
    lb, above = [], []
    for i in range(0, len(frames), SETUP_BLOCK):
        x = served._letterbox(frames[i:i + SETUP_BLOCK])
        lb.append(torch.round(x * 255.0).to(torch.uint8).cpu())
        scores = candidates(served._heads(x), served.model.reg_max, cfg["conf"])[2]
        above.extend((scores > 0).sum(1).tolist())
    print(f"[bench] {cfg['name']}: anchors above conf {cfg['conf']} per ring frame: min {min(above)}, "
          f"max {max(above)} of {scores.shape[1]}; set-up s: weights and calibration {t1 - t0:.3f}, "
          f"the port's load {t2 - t1:.3f}, readings {time.monotonic() - t2:.3f}")

    def release():
        owner.model = None

    return SimpleNamespace(chain=chain, tuners={}, want_posts=not cfg["performance_mode"], release=release,
                           state=owner.reference_state, letterboxed=torch.cat(lb), above_conf=above)


def expected(cfg, reference, state, host_frames: np.ndarray, device):
    """The reference on every ring frame, in blocks on ``device``: (its
    letterboxed u8 [F, S, S, 3] on the host, per frame the anchors' boxes
    [N, 5] and class logits [N, nc] on ``device``, and the logits of its own
    greedy NMS's picks as float32 scores, sorted from the highest)."""
    lbs, frames = [], []
    for i in range(0, len(host_frames), REF_BLOCK):
        block = torch.from_numpy(host_frames[i:i + REF_BLOCK]).to(device)
        lb, dec = reference.forward(state, block, cfg["image_size"], cfg["size"])
        lbs.append(lb.cpu())
        boxes = torch.stack([dec[k] for k in ("cx", "cy", "w", "h", "angle")], -1)
        scores = reference.scores_of(dec, cfg["conf"])
        for j in range(len(block)):
            picks = reference.greedy_nms(boxes[j], scores[j], dec["cls"][j], cfg["iou"], cfg["max_det"],
                                         cfg["nms_pool"])
            picked = _logit(scores[j][picks]).sort(descending=True).values
            frames.append((boxes[j], dec["logits"][j], picked))
    return torch.cat(lbs), frames


def judge(cfg, reference, host_frames, per_dispatch, distinct, system, device):
    """The numbers over every frame served (see the module's docstring);
    each distinct answer of a dispatch slot counts once per time served."""
    state = reference.state_from_numpy(system.state, device)
    ref_lb, want = expected(cfg, reference, state, host_frames, device)
    nums = {"letterbox_mismatch_px": int((ref_lb != system.letterboxed).any(-1).sum()),
            "unmatched_picks": 0, "nms_violations": 0, "valid_count_gap": 0}
    sq = {"logit": 0.0, "box": 0.0, "angle": 0.0, "pick": 0.0}
    matched = gaps = served = ranked = 0
    for slot, answers in distinct.items():
        for best, count in answers:
            for i in range(per_dispatch):
                boxes, logits, ref_picks = want[slot * per_dispatch + i]
                valid = np.asarray(best["valid"])[i]
                gaps += abs(int(valid.sum()) - len(ref_picks)) * count
                served += count
                sel = np.nonzero(valid)[0]
                if not len(sel):
                    continue
                got = _boxes5(torch.as_tensor(np.asarray(best["xyxy"])[i][sel], dtype=torch.float64),
                              torch.as_tensor(np.asarray(best["angle"])[i][sel], dtype=torch.float64)).to(device)
                cls = torch.as_tensor(np.asarray(best["cls"])[i][sel], dtype=torch.long, device=device)
                s = torch.as_tensor(np.asarray(best["score"])[i][sel], dtype=torch.float64, device=device)
                logit = _logit(s)
                # the served picks' logits against the reference's picks', rank by rank
                k = min(len(logit), len(ref_picks))
                sq["pick"] += float(((logit.sort(descending=True).values[:k] - ref_picks[:k]) ** 2).sum()) * count
                ranked += k * count
                # pairs of one class overlapping past the threshold
                iou = reference.probiou(got[:, None], got[None, :])
                pairs = torch.triu((cls[:, None] == cls[None, :]) & (iou > cfg["iou"] + IOU_MARGIN), 1)
                nums["nms_violations"] += int(pairs.sum()) * count
                # each pick against the reference anchor nearest in box, angle and its class's score
                ref = boxes.double()
                gap = got[:, None, :4] - ref[None, :, :4]
                reach = torch.hypot(got[:, 2], got[:, 3])[:, None] / 2
                side = ((got[:, 2:3] + got[:, 3:4]) / 2).clamp_min(min(reference.STRIDES))
                dist = torch.sqrt((gap * gap).sum(-1) + ((got[:, None, 4] - ref[None, :, 4]) * reach) ** 2) / side
                # every anchor's logit of each pick's class, as a float32 score would serve it
                of_cls = _logit(torch.sigmoid(logits.t()[cls]))  # [picks, N]
                miss = (logit[:, None] - of_cls).abs() / logit.abs().clamp_min(1.0)[:, None]
                idx = (dist + miss).min(1).indices
                picked = torch.arange(len(idx), device=device)
                at = logits.double()[idx]  # [picks, nc]: the matched anchors' class logits
                own = at.gather(1, cls[:, None])[:, 0]
                top = at.max(1).values
                ok = ((dist[picked, idx] <= MATCH_SHARE) & (miss[picked, idx] <= CLASS_MARGIN)
                      & (own >= top - CLASS_MARGIN * top.abs().clamp_min(1.0)))
                nums["unmatched_picks"] += int((~ok).sum()) * count
                d_logit = logit[ok] - of_cls[picked, idx][ok]
                d = got[ok] - ref[idx[ok]]
                sq["logit"] += float((d_logit ** 2).sum()) * count
                sq["box"] += float((d[:, :4] ** 2).sum()) * count
                sq["angle"] += float((d[:, 4] ** 2).sum()) * count
                matched += int(ok.sum()) * count
    n = max(matched, 1)
    nums["valid_count_gap"] = gaps / max(served, 1)
    nums.update(pick_logit_rms=math.sqrt(sq["pick"] / max(ranked, 1)), logit_rms=math.sqrt(sq["logit"] / n),
                box_rms_px=math.sqrt(sq["box"] / (4 * n)), angle_rms_rad=math.sqrt(sq["angle"] / n),
                picks_matched=matched, anchors_above_conf_min=min(system.above_conf))
    return nums


def _answer(cfg, reference, state, image: torch.Tensor, forward) -> Dict[str, torch.Tensor]:
    """The reference's own picks on one [H, W, 3] frame, as the chain's
    result tree (``max_det`` slots, model-input coordinates)."""
    _, dec = forward(state, image[None], cfg["image_size"], cfg["size"])
    boxes = torch.stack([dec[k][0] for k in ("cx", "cy", "w", "h", "angle")], -1)
    scores = reference.scores_of(dec, cfg["conf"])[0]
    picks = reference.greedy_nms(boxes, scores, dec["cls"][0], cfg["iou"], cfg["max_det"], cfg["nms_pool"])
    m, dev = cfg["max_det"], image.device
    idx = torch.zeros(m, dtype=torch.long, device=dev)
    idx[:len(picks)] = torch.as_tensor(picks, dtype=torch.long, device=dev)
    valid = torch.arange(m, device=dev) < len(picks)
    b = boxes[idx]
    xyxy = torch.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2, b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], -1)
    return {"xyxy": xyxy, "score": torch.where(valid, scores[idx], 0.0),
            "cls": torch.where(valid, dec["cls"][0][idx], -1).to(torch.int32), "valid": valid, "angle": b[:, 4],
            "orig_h": torch.tensor(image.shape[0], dtype=torch.int32, device=dev),
            "orig_w": torch.tensor(image.shape[1], dtype=torch.int32, device=dev)}


def control_wrap(cfg, reference):
    """The control: the reference in float8 e4m3 (``control_forward``) with
    its own greedy NMS put in the module chain's place, as the same tree of
    device tensors."""
    def wrap(fn):
        state: List = []

        def chain(image, *, tuners, want_posts):
            if not state:
                state.append(reference.state_from_numpy(fn.__self__.reference_state, image.device))
            return _answer(cfg, reference, state[0], image, reference.control_forward), {}
        return chain
    return wrap

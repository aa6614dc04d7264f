"""Train a YOLO detector on synthetic scenes, end to end in the port.

The twin of the JAX package's ``examples/train_synthetic.py``, with its
flags, defaults and output: the port's model (``models/yolo/model.py``),
trainer (``train.py``) and data (``synth.py``) make a usable checkpoint from
nothing, on ``cuda:0`` unless ``--device cpu``:

    python -m cuauv_vision_pipeline_tpu_torch.examples.train_synthetic --task detect --out /tmp/synth.msgpack

The ``.msgpack`` (+ ``.json`` sidecar) is flax's format: the port's
``YoloModel`` and ``modules.yolo`` serve it (``CUAUV_YOLO_WEIGHT=/tmp/synth.msgpack
python -m cuauv_vision_pipeline_tpu_torch.modules.yolo zed``), and so does
the JAX package. The host renders fresh scenes every step (no epochs); a
held-out evaluation reports recall and precision at IoU >= 0.5 through the
port's ``decode`` (greedy NMS by the ``nms_fixed`` kernel on the card).

``--dp``/``--tp`` train on a (data, model) mesh of ``dp * tp`` ranks
(``parallel/mesh.py``; the same layout ``entry.dryrun_multichip`` runs): dp
splits each step's batch (``--batch`` must divide by it), tp the wide conv
output channels, and the ranks together take the one-process step on the
global batch. ``--backend nccl`` puts rank r on ``cuda:r``; ``--backend
gloo`` puts every rank on ``--device`` (the CPU with ``--device cpu``).
Rank 0 evaluates and saves the whole model:

    python -m cuauv_vision_pipeline_tpu_torch.examples.train_synthetic --dp 2 --tp 2 --backend gloo --device cpu --steps 50
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def evaluate(model, args, seed: int = 10_000):
    """Recall/precision at IoU >= 0.5 over fresh held-out scenes, plus the
    task's quality term over matched detections: segment -> mean
    prototype-grid mask IoU; obb -> mean absolute angle error (degrees);
    pose -> mean keypoint distance (pixels)."""
    from ..models.yolo.decode import decode
    from ..models.yolo.synth import make_task_batch, mask_iou, match_detections, to_model_input

    task = model.task
    device = next(model.parameters()).device
    model.eval()
    rng = np.random.default_rng(seed)
    tp = n_gt = n_pred = 0
    quality: List[float] = []
    for _ in range(args.eval_scenes // 8):
        batch = make_task_batch(rng, 8, args.image_size, task=args.task)
        imgs, boxes, cls = batch[:3]
        x = torch.from_numpy(to_model_input(imgs)).to(device).permute(0, 3, 1, 2)
        with torch.inference_mode():
            decoded = decode(model(x), args.image_size, reg_max=model.reg_max, conf_thresh=args.conf, max_det=8)
        decoded = {k: v.cpu().numpy() for k, v in decoded.items()}
        for b in range(len(imgs)):
            one = {k: v[b] for k, v in decoded.items()}
            t, g, p, pairs = match_detections(one, boxes[b], cls[b], conf=args.conf, return_pairs=True)
            tp, n_gt, n_pred = tp + t, n_gt + g, n_pred + p
            for pi, gi in pairs:
                if task == "segment":
                    quality.append(mask_iou(one["mask"][pi], batch[3][b][gi]))
                elif task == "obb":
                    err = abs(float(one["angle"][pi]) - float(batch[3][b][gi]))
                    # a rectangle's orientation is modulo pi
                    quality.append(np.degrees(min(err, abs(np.pi - err))))
                elif task == "pose":
                    gk, pk = batch[3][b][gi], one["kpts"][pi]
                    quality.append(float(np.mean(np.hypot(pk[:, 0] - gk[:, 0], pk[:, 1] - gk[:, 1]))))
    recall = tp / max(n_gt, 1)
    precision = tp / max(n_pred, 1)
    q = float(np.mean(quality)) if quality else float("nan")
    return recall, precision, n_gt, q


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=128)
    ap.add_argument("--model-size", default="p", help="SIZES key (p=pico)")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--eval-scenes", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "synth_yolo.msgpack"))
    ap.add_argument(
        "--task", default="detect", choices=("detect", "segment", "obb", "pose", "gate"),
        help="the task branch to train: segment adds the prototype-mask BCE (exact instance "
        "masks), obb the angle L1 (rotated slabs), pose the keypoint L1+visibility BCE (disc "
        "rim points); gate trains the detect head on shark/saw scenes",
    )
    ap.add_argument("--device", default=None,
                    help="cuda:N or N (default cuda:0), or cpu; with --dp/--tp, gloo's device")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel ranks (--batch must divide by it)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks (split the wide conv channels)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="with --dp/--tp: nccl puts rank r on cuda:r, gloo every rank on --device")
    args = ap.parse_args(argv)
    assert args.batch % args.dp == 0, "--batch must divide by --dp"
    return args


def run(argv: Optional[List[str]] = None) -> Dict:
    """Train, evaluate and save as the command line asks; returns the run's
    summary (steps, seconds, steps/s, last loss, recall, precision, the
    task's quality term, the checkpoint's path). With ``--dp``/``--tp`` the
    ranks train together and rank 0's summary is returned."""
    from ..core.device import resolve_device
    from ..parallel.mesh import launch

    args = _parse(argv)
    if args.dp * args.tp == 1:
        return _train(args, resolve_device(args.device))
    print(f"[train] mesh: dp={args.dp} tp={args.tp} ({args.dp * args.tp} ranks, {args.backend})", flush=True)
    # launch's bound covers the whole run after the ranks join, and a run
    # of --steps on the CPU can take well past its default 300 s
    return launch(_train_rank, args.dp * args.tp, args.backend, args.device, args=(args,),
                  timeout_s=3600.0)[0]


def _train_rank(device, args: argparse.Namespace) -> Dict:
    from ..parallel.mesh import make_mesh

    return _train(args, device, make_mesh(args.dp * args.tp, dp=args.dp, tp=args.tp))


def _train(args: argparse.Namespace, device, mesh=None) -> Dict:
    """The run on ``device``; on a mesh every rank draws the same global
    batches (one seed) and steps on its share, and rank 0 (the whole model
    gathered) evaluates and saves."""
    from ..models.yolo.model import create_model
    from ..models.yolo.synth import (
        CLASS_NAMES,
        GATE_CLASS_NAMES,
        OBB_CLASS_NAMES,
        POSE_CLASS_NAMES,
        POSE_NUM_KEYPOINTS,
        make_task_batch,
        to_model_input,
    )
    from ..models.yolo.train import create_train_state, make_train_step
    from ..models.yolo.weights import save_checkpoint
    from ..parallel.mesh import full_state_dict, param_shardings, place, shard_batch

    names = {"obb": OBB_CLASS_NAMES, "pose": POSE_CLASS_NAMES, "gate": GATE_CLASS_NAMES}.get(args.task, CLASS_NAMES)
    # "gate" is a dataset: shark/saw scenes train the plain detect head
    model_task = "detect" if args.task == "gate" else args.task

    def build():
        return create_model(len(names), size=args.model_size, task=model_task, seed=args.seed,
                            num_keypoints=POSE_NUM_KEYPOINTS).to(device)

    model = build()
    lead = mesh is None or mesh.rank == 0
    if lead:
        n_params = sum(p.numel() for p in model.parameters())
        print(f"[train] {args.model_size}-size {args.task} model: {n_params:,} params on {device}")
    if mesh is not None:
        # the same wide-channel rule as the JAX example's
        shardings = param_shardings(mesh, model, min_channels=32)
        place(model, mesh, shardings)
    step = make_train_step(create_train_state(model, learning_rate=args.lr), mesh)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    loss = None
    for i in range(args.steps):
        batch = make_task_batch(rng, args.batch, args.image_size, task=args.task)
        parts = (to_model_input(batch[0]),) + tuple(batch[1:])
        if mesh is not None:
            parts = shard_batch(mesh, parts)
        loss = step(*(torch.from_numpy(np.ascontiguousarray(p)).to(device, non_blocking=True) for p in parts))
        if lead and (i % 50 == 0 or i == args.steps - 1):
            print(f"[train] step {i:5d}  loss {float(loss):8.4f}  ({(time.time() - t0):6.1f}s)", flush=True)
    seconds = time.time() - t0
    if mesh is not None:
        state = full_state_dict(model, mesh, shardings)
        if not lead:
            return {}
        model = build()
        model.load_state_dict(state)

    recall, precision, n_gt, quality = evaluate(model, args)
    q_note = {"segment": f"  mask-IoU {quality:.3f}", "obb": f"  angle-err {quality:.2f} deg",
              "pose": f"  kpt-err {quality:.2f} px"}.get(args.task, "")
    print(f"[eval] recall {recall:.3f}  precision {precision:.3f}{q_note}  "
          f"({n_gt} gt objects, IoU>=0.5, conf>={args.conf})")

    save_checkpoint(args.out, model, {"names": list(names), "image_size": args.image_size})
    print(f"[train] saved {args.out} (+ .json sidecar)")
    return {"steps": args.steps, "seconds": seconds, "steps_per_s": args.steps / seconds if seconds else None,
            "loss": None if loss is None else float(loss), "recall": recall, "precision": precision,
            "n_gt": n_gt, "quality": None if np.isnan(quality) else quality, "out": args.out,
            "device": str(device)}


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

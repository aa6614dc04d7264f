"""Entry points of the port: the flagship forward step and one train step.

``entry`` is the twin of the JAX package's ``__graft_entry__.entry``: the
YOLO-OBB detector (YOLOv8n-obb, 15 classes, seeded random init) with
letterbox, decode and greedy NMS (the ``nms_fixed`` kernel on the card), at
a 320 square and ``max_det`` 16.

    fn, args = entry()      # on cuda:0; entry("cpu") on the host
    decoded = fn(*args)     # xyxy, score, cls, valid, angle: [1, 16, ...]

``train_step_entry`` is the one-card twin of the training step that
``__graft_entry__.dryrun_multichip`` shards over a mesh: YOLOv8n detect, 4
classes, 64 px, batch 2, inputs seeded as there, one step.

    loss = train_step_entry()   # on cuda:0; train_step_entry("cpu")

``dryrun_multichip`` is the twin of ``__graft_entry__.dryrun_multichip`` on
``torch.distributed``: ``n`` ranks (``parallel/mesh.py``) run its four parts
with its shapes, seeds and assertions -- the YOLO train step under dp x tp,
the red_buoy chain with one camera per rank, the SIFT pose front end per
rank and the cross-camera merge by ``all_gather``.

    dryrun_multichip(4, backend="gloo", device="cpu")   # 4 processes on the host
    dryrun_multichip(1)                                  # nccl, rank r on cuda:r

    python -m cuauv_vision_pipeline_tpu_torch.entry --dryrun-multichip 8 --backend gloo --device cpu
"""

from __future__ import annotations

import numpy as np


def entry(device=None):
    """-> (fn, example_args): the flagship forward step and one example
    frame (u8 BGR ``[1, 320, 320, 3]``), both on ``device`` (``cuda:0``
    unless told otherwise; raises without CUDA)."""
    import torch

    from .core.device import resolve_device
    from .models.yolo.decode import decode
    from .models.yolo.model import create_model, preprocess_fused

    dev = resolve_device(device)
    image_size = 320
    model = create_model(num_classes=15, size="n", task="obb").to(dev)

    def forward(model, image_u8):
        with torch.inference_mode():
            x = preprocess_fused(image_u8, image_size).permute(0, 3, 1, 2)
            return decode(model(x), image_size, reg_max=model.reg_max, max_det=16)

    rng = np.random.default_rng(0)
    example_image = torch.from_numpy(rng.integers(0, 255, (1, image_size, image_size, 3), dtype=np.uint8)).to(dev)
    return forward, (model, example_image)


def train_step_entry(device=None) -> float:
    """One YOLO training step (YOLOv8n detect, 4 classes, 64 px, batch 2, 3
    gts per image; seeded random init and inputs) on ``device`` (``cuda:0``
    unless told otherwise; raises without CUDA). Returns the loss, which
    must be finite."""
    import torch

    from .core.device import resolve_device
    from .models.yolo.model import create_model
    from .models.yolo.train import create_train_state, make_train_step

    dev = resolve_device(device)
    image_size, batch = 64, 2
    model = create_model(num_classes=4, size="n", task="detect").to(dev)
    step = make_train_step(create_train_state(model))
    rng = np.random.default_rng(0)
    images = rng.random((batch, image_size, image_size, 3)).astype(np.float32)
    t_xyxy = rng.random((batch, 3, 4)).astype(np.float32) * image_size
    t_cls = rng.integers(0, 4, (batch, 3)).astype(np.int32)
    loss = float(step(*(torch.from_numpy(a).to(dev) for a in (images, t_xyxy, t_cls))))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss: {loss}")
    return loss


# dryrun_multichip's shapes (__graft_entry__.dryrun_multichip's)
DRYRUN_IMAGE_SIZE = 64
DRYRUN_CLASSES = 4
DRYRUN_MIN_CHANNELS = 32
DRYRUN_FRAME = (48, 64)
DRYRUN_TEMPLATE = (56, 72)
DRYRUN_GRAY = (96, 128)
DRYRUN_K, DRYRUN_MAX_DET = 8, 16


def dryrun_layout(n_devices: int):
    """(dp, tp): two-way tensor parallelism whenever ``n_devices`` is even."""
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // tp, tp


def dryrun_data(n_devices: int) -> dict:
    """The inputs of the dry run's four parts, drawn as the JAX dry run
    draws them: one generator seeded 0, in the same order (train images,
    boxes and classes at batch ``dp * 2``; the cameras' frames with one red
    disc each; the pose template and the cameras' grays with the template
    pasted; then the detection lists, which take no random numbers)."""
    dp, _ = dryrun_layout(n_devices)
    rng = np.random.default_rng(0)
    S, batch = DRYRUN_IMAGE_SIZE, dp * 2
    out = {"images": rng.random((batch, S, S, 3)).astype(np.float32),
           "t_xyxy": rng.random((batch, 3, 4)).astype(np.float32) * S,
           "t_cls": rng.integers(0, DRYRUN_CLASSES, (batch, 3)).astype(np.int32)}
    H, W = DRYRUN_FRAME
    frames = rng.integers(40, 90, (n_devices, H, W, 3), dtype=np.uint8)
    frames[..., 2] = 50  # keep the backdrop un-red
    yy, xx = np.mgrid[0:H, 0:W]
    centers = []
    for cam in range(n_devices):  # one red disc per camera, distinct spots
        y, x = 8 + (cam * 11) % (H - 16), 8 + (cam * 17) % (W - 16)
        centers.append((y, x))
        frames[cam][(yy - y) ** 2 + (xx - x) ** 2 < 36] = (40, 40, 220)
    out.update(frames=frames, centers=np.array(centers))
    th, tw = DRYRUN_TEMPLATE
    gh, gw = DRYRUN_GRAY
    template = rng.integers(0, 255, (th, tw), dtype=np.uint8)
    grays = rng.integers(0, 255, (n_devices, gh, gw), dtype=np.uint8)
    for cam in range(n_devices):
        y, x = 8 + (cam * 7) % (gh - th - 16), 8 + (cam * 13) % (gw - tw - 16)
        grays[cam, y:y + th, x:x + tw] = template
    # one object every camera sees (camera i at confidence .5 + .04 i) and
    # one of each camera's own, at disjoint coordinates
    dets = np.zeros((n_devices, DRYRUN_K, 6), np.float32)
    for cam in range(n_devices):
        dets[cam, 0] = (100, 100, 140, 140, 0.5 + 0.04 * cam, 0)
        x = 20 * cam
        dets[cam, 1] = (x, 200, x + 12, 212, 0.9, 1)
    out.update(template=template, grays=grays, dets=dets)
    return out


def _mesh_train(device, mesh, inputs, state_dict=None, dtype=None, steps: int = 1,
                num_classes: int = DRYRUN_CLASSES) -> dict:
    """``steps`` dp x tp train steps of YOLOv8n detect (seeded init or
    ``state_dict``) on this rank's share of the global batch ``inputs``
    (numpy images, boxes, classes), TF32 off: the global loss, the wall ms
    of each step (synchronized on the card), this rank's gradients, updated
    parameters and running statistics (split tensors as its slices) and the
    parameter shardings."""
    import time

    import torch

    from .core.device import full_f32
    from .models.yolo.model import create_model
    from .models.yolo.train import create_train_state, make_train_step
    from .parallel.mesh import param_shardings, place, shard_batch

    model = create_model(num_classes, "n", "detect")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.to(device=device, dtype=dtype)
    shardings = param_shardings(mesh, model, min_channels=DRYRUN_MIN_CHANNELS)
    place(model, mesh, shardings)
    step = make_train_step(create_train_state(model), mesh)
    batch = shard_batch(mesh, [torch.from_numpy(a).to(device) for a in inputs])
    batch = [b.to(dtype) if dtype is not None and b.is_floating_point() else b for b in batch]
    sync = torch.cuda.synchronize if batch[0].is_cuda else (lambda: None)
    ms = []
    with full_f32():
        for _ in range(steps):
            sync()
            t0 = time.perf_counter()
            loss = float(step(*batch))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss: {loss}")
    return {"index": mesh.index, "loss": loss, "ms_per_step": ms, "shardings": shardings,
            "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()}}


def mesh_train_rank(device, dp: int, tp: int, inputs, state_dict=None, dtype=None, steps: int = 1,
                    num_classes: int = DRYRUN_CLASSES) -> dict:
    """A rank of a dp x tp train run on its own (``parallel.mesh.launch``):
    :func:`_mesh_train` on a mesh of dp x tp ranks."""
    from .parallel.mesh import make_mesh

    return _mesh_train(device, make_mesh(dp * tp, dp=dp, tp=tp), inputs, state_dict, dtype, steps, num_classes)


def _gathered(obj, n: int) -> list:
    import torch.distributed as dist

    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


def _dryrun_rank(device, n: int, data: dict) -> dict:
    """One rank of :func:`dryrun_multichip`: the four parts, each asserted
    on every rank from every rank's results (``all_gather_object``)."""
    import torch
    import torch.distributed as dist

    from .core.device import full_f32
    from .ops.cuda import launch_counts, reset_launch_counts
    from .ops.feature import detect_describe
    from .parallel.crosscam import make_mesh_cross_camera_merge
    from .parallel.fanout import chain_one
    from .parallel.mesh import make_mesh
    from .utils.sift import device_match_topk, prepare_descriptors

    reset_launch_counts()
    rank = dist.get_rank()
    dp, tp = dryrun_layout(n)
    out = {"dp": dp, "tp": tp, **_mesh_train(device, make_mesh(n, dp=dp, tp=tp),
                                              (data["images"], data["t_xyxy"], data["t_cls"]))}

    # 2) the streaming chain, one camera per rank: no collective
    frame = torch.from_numpy(data["frames"][rank]).to(device)
    out["fan"] = {k: v.cpu().numpy() for k, v in chain_one(frame, 140, 255).items()}
    for cam, (got, (y, x)) in enumerate(zip(_gathered(out["fan"], n), data["centers"])):
        assert got["area"] > 0, f"cam{cam}: no detection"
        cy, cx = got["centroid"]
        assert abs(cy - y) < 3 and abs(cx - x) < 3, f"cam{cam}: centroid ({cy:.1f},{cx:.1f}) != disc ({y},{x})"

    # 3) the pose front end per rank (detect + describe + template 2-NN)
    with full_f32():
        _, des_t, n_t = detect_describe(torch.from_numpy(data["template"]).to(device), 32, 0.01, 4)
        n_t = int(n_t)
        assert n_t >= 4, f"template produced only {n_t} keypoints"
        prep = prepare_descriptors(des_t[:n_t].cpu().numpy(), "query", device)
        _, des, n_valid = detect_describe(torch.from_numpy(data["grays"][rank]).to(device), 128, 0.01, 4)
        d2, idx = device_match_topk(prep, des, n_valid)
    out["pose"] = {"d2": d2.cpu().numpy(), "idx": idx.cpu().numpy(), "n_query": prep[1]}
    d_all = np.sqrt(np.maximum(np.stack([p["d2"] for p in _gathered(out["pose"], n)])[:, :prep[1]], 0.0))
    good = ((d_all[..., 0] < 0.7 * d_all[..., 1]) & (d_all[..., 1] < 1.0e4)).sum(axis=1)
    assert (good >= 4).all(), f"pose front end: per-camera ratio-test survivors {good}"
    out["pose_good"] = good

    # 4) the cross-camera merge: all_gather of every camera's list, then NMS
    merge = make_mesh_cross_camera_merge(make_mesh(n), max_det=DRYRUN_MAX_DET)
    out["merged"] = merge(torch.from_numpy(data["dets"][rank]).to(device)).cpu().numpy()
    merged = _gathered(out["merged"], n)
    assert merged[0].shape == (DRYRUN_MAX_DET, 6)
    for cam in range(1, n):
        assert np.array_equal(merged[cam], merged[0]), (
            f"cam{cam}: consensus list differs from cam0; the merge must give every rank one result")
    kept = merged[0][merged[0][:, 4] > 0]
    assert len(kept) == n + 1, f"expected {n + 1} consensus objects (1 shared + {n} unique), got {len(kept)}"
    shared = kept[kept[:, 5] == 0]
    assert len(shared) == 1 and abs(float(shared[0, 4]) - (0.5 + 0.04 * (n - 1))) < 1e-6, (
        "the shared object must merge to its highest-confidence view")
    # cam0's own list never held the other cameras' boxes, yet its merge
    # does (a witness that needs another camera: one rank has none)
    if n > 1:
        assert kept[:, 0].max() >= 20 * (n - 1) and float(shared[0, 4]) > data["dets"][0, 0, 4]
    out["kept"] = len(kept)
    out["launches"] = launch_counts()
    return out


def dryrun_multichip(n_devices: int, backend: str = "nccl", device=None) -> dict:
    """The JAX dry run's four parts on ``n_devices`` ranks
    (``parallel.mesh.launch``: ``nccl`` puts rank r on ``cuda:r``; ``gloo``
    puts every rank on ``device``, ``cuda:0`` unless told, or ``"cpu"``).
    Every rank asserts what the JAX dry run asserts; returns ``{"dp", "tp",
    "loss", "data", "ranks"}`` with each rank's results (loss, gradients,
    parameters, running statistics and shardings of the train step, its
    camera's blob stats, its pose ``d2``/``idx``, the merged list, its
    kernel launch counts)."""
    from .parallel.mesh import launch

    data = dryrun_data(n_devices)
    ranks = launch(_dryrun_rank, n_devices, backend, device, args=(n_devices, data))
    r0 = ranks[0]
    print(f"dryrun_multichip OK: {n_devices} ranks ({backend}) -- train step (dp={r0['dp']}, "
          f"tp={r0['tp']}, loss={r0['loss']:.4f}) + streaming chain fan-out ({n_devices} cameras, "
          f"all detected) + pose front end (min {int(r0['pose_good'].min())} matches/camera) + "
          f"cross-camera all_gather consensus ({r0['kept']} merged objects, the same on every rank)")
    return {"dp": r0["dp"], "tp": r0["tp"], "loss": r0["loss"], "data": data, "ranks": ranks}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the port's multi-rank dry run")
    ap.add_argument("--dryrun-multichip", type=int, metavar="N", required=True,
                    help="ranks (dp x tp with tp = 2 when N is even)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="nccl: rank r on cuda:r; gloo: every rank on --device")
    ap.add_argument("--device", default=None, help="gloo's device: cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.dryrun_multichip, args.backend, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

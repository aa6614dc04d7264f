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

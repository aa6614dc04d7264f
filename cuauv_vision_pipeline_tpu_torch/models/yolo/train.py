"""Training step for the port's YOLO family (all five tasks).

Port of ``cuauv_vision_pipeline_tpu.models.yolo.train``, function for
function: a center-assigned detection loss (BCE classification over all
anchors + DFL distribution loss + L1 box regression on each gt's assigned
anchor), the task terms (segment: a cropped, area-normalised prototype-mask
BCE; obb: an L1 on the decoded angle; pose: keypoint L1 + visibility BCE),
the classify softmax cross-entropy, and AdamW as ``optax.adamw`` defines it.

The state is the module itself (parameters and BatchNorm buffers, in train
mode), a ``torch.optim.AdamW`` with optax's defaults (betas 0.9 / 0.999,
eps 1e-8, weight decay 1e-4 on every parameter, BatchNorm scales and biases
included) and a step count. The step takes NHWC float32 images, as the JAX
step does (``synth.to_model_input``), and returns the loss as a 0-d tensor
on the model's device without reading it: nothing in the step waits for the
device.

Padding gts (``t_cls == -1``) contribute nothing to any term: their class
row is all zero (as ``jax.nn.one_hot(-1, C)``), and their box, DFL and
task terms are masked out. Assigned cells truncate toward zero
(``.to(torch.int32)``, as JAX's ``astype(int32)``), then clip to the grid.

On a mesh (``make_train_step(state, mesh)``, ``parallel/mesh.py``) the ranks
together take the one-process step on the global batch, as GSPMD makes the
JAX step do: each rank holds its data index's equal share of the batch
(``mesh.shard_batch``), the loss normalisers (the gt count of ``_denom``,
the element count of each mean) are global (``group``: the data group),
the train-mode BatchNorms take their statistics over the data group, each
rank's loss is the global loss's share of its data index, and the gradients
are summed (not averaged): replicated parameters over every rank, split
ones over the data group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ...parallel.mesh import sum_gradients
from .decode import STRIDES
from .model import YOLO, BatchNorm

# optax.adamw's defaults (b1, b2, eps, weight_decay)
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


@dataclass
class TrainState:
    model: YOLO
    optimizer: torch.optim.AdamW
    step: int = 0


def create_train_state(model: YOLO, learning_rate: float = 1e-3) -> TrainState:
    """The model (put in train mode) with optax.adamw's optimizer over
    every parameter."""
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                            weight_decay=ADAMW_WEIGHT_DECAY)
    return TrainState(model, opt)


def _bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, elementwise."""
    return F.binary_cross_entropy_with_logits(logits, targets, reduction="none")


def _cells(targets_xyxy: torch.Tensor, stride: int, H: int, W: int):
    """Each gt's center-assigned cell (gx, gy), int64 ``[B, T]``."""
    cx = (targets_xyxy[..., 0] + targets_xyxy[..., 2]) / 2
    cy = (targets_xyxy[..., 1] + targets_xyxy[..., 3]) / 2
    gx = torch.clamp((cx / stride).to(torch.int32), 0, W - 1).long()
    gy = torch.clamp((cy / stride).to(torch.int32), 0, H - 1).long()
    return gx, gy


def _gather_assigned(feature_map: torch.Tensor, targets_xyxy: torch.Tensor, stride: int) -> torch.Tensor:
    """Each gt's center-assigned anchor's feature row: ``[B, H, W, C]`` ->
    ``[B, T, C]``."""
    B, H, W, C = feature_map.shape
    gx, gy = _cells(targets_xyxy, stride, H, W)
    flat = feature_map.reshape(B, H * W, C)
    return flat.gather(1, (gy * W + gx)[..., None].expand(-1, -1, C))


def _denom(valid_t: torch.Tensor, group=None) -> torch.Tensor:
    """The number of real gts (at least 1); with ``group``, in the whole
    batch of the data group."""
    count = valid_t.sum()
    if group is not None:
        count = count.detach().clone()
        dist.all_reduce(count, group=group)
    return torch.clamp_min(count, 1)


def _mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x.mean()``; with ``group``, this rank's share of the mean over the
    group's equal shares."""
    if group is None:
        return x.mean()
    return x.sum() / (x.numel() * dist.get_world_size(group))


def segment_loss(outputs: Dict, targets_xyxy: torch.Tensor, targets_masks: torch.Tensor,
                 valid_t: torch.Tensor, image_size: int, group=None) -> torch.Tensor:
    """Mask loss of the segment task: per gt, the mask its assigned anchor's
    coefficients make from the prototypes, BCE over the prototype grid
    cropped to the gt box (left/top inclusive, right/bottom exclusive) and
    divided by the box's area there, averaged over the three scales."""
    proto = outputs["proto"]  # [B, Hp, Wp, nm]
    hp, wp = proto.shape[1], proto.shape[2]
    sx, sy = wp / float(image_size), hp / float(image_size)
    x1 = targets_xyxy[..., 0] * sx
    y1 = targets_xyxy[..., 1] * sy
    x2 = targets_xyxy[..., 2] * sx
    y2 = targets_xyxy[..., 3] * sy
    cols = torch.arange(wp, dtype=torch.float32, device=proto.device)
    rows = torch.arange(hp, dtype=torch.float32, device=proto.device)[:, None]
    crop = ((cols >= x1[..., None, None]) & (cols < x2[..., None, None])
            & (rows >= y1[..., None, None]) & (rows < y2[..., None, None]))  # [B, T, hp, wp]
    area = torch.clamp_min((x2 - x1) * (y2 - y1), 1.0)
    denom = _denom(valid_t, group)
    total = 0.0
    for i, stride in enumerate(STRIDES):
        coefs = _gather_assigned(outputs["mcoef"][i], targets_xyxy, stride)  # [B, T, nm]
        logits = torch.einsum("btc,bhwc->bthw", coefs, proto)
        per_gt = (_bce(logits, targets_masks) * crop).sum((-2, -1)) / area
        total = total + (per_gt * valid_t).sum() / denom
    return total / len(STRIDES)


def obb_angle_loss(outputs: Dict, targets_xyxy: torch.Tensor, targets_angle: torch.Tensor,
                   valid_t: torch.Tensor, group=None) -> torch.Tensor:
    """L1 on the decoded angle ``(sigmoid - 0.25) * pi`` (decode's
    dist2rbox) at each gt's assigned anchor, averaged over the scales."""
    denom = _denom(valid_t, group)
    total = 0.0
    for i, stride in enumerate(STRIDES):
        logits = _gather_assigned(outputs["angle"][i], targets_xyxy, stride)
        pred = (torch.sigmoid(logits[..., 0]) - 0.25) * math.pi
        total = total + ((pred - targets_angle).abs() * valid_t).sum() / denom
    return total / len(STRIDES)


def pose_kpt_loss(outputs: Dict, targets_xyxy: torch.Tensor, targets_kpts: torch.Tensor,
                  valid_t: torch.Tensor, group=None) -> torch.Tensor:
    """Per gt, the assigned anchor's keypoints decoded as decode does
    (``(k * 2) * stride + anchor - stride / 2``): an L1 on the visible
    keypoints' positions over the gt box's diagonal, averaged over the
    visible ones, plus a visibility BCE over all; averaged over scales."""
    denom = _denom(valid_t, group)
    diag = torch.sqrt(torch.clamp_min((targets_xyxy[..., 2] - targets_xyxy[..., 0]) ** 2
                                      + (targets_xyxy[..., 3] - targets_xyxy[..., 1]) ** 2, 1.0))
    gx, gy, gv = targets_kpts.unbind(-1)
    total = 0.0
    for i, stride in enumerate(STRIDES):
        fmap = outputs["kpts"][i]
        H, W = fmap.shape[1], fmap.shape[2]
        k = _gather_assigned(fmap, targets_xyxy, stride)
        k = k.reshape(k.shape[0], k.shape[1], -1, 3)  # [B, T, nk, 3]
        cx, cy = _cells(targets_xyxy, stride, H, W)
        ax = (cx.float() + 0.5) * stride
        ay = (cy.float() + 0.5) * stride
        kx = (k[..., 0] * 2.0) * stride + (ax[..., None] - 0.5 * stride)
        ky = (k[..., 1] * 2.0) * stride + (ay[..., None] - 0.5 * stride)
        pos_l1 = ((kx - gx).abs() + (ky - gy).abs()) / diag[..., None]
        n_vis = torch.clamp_min(gv.sum(-1), 1.0)
        pos = (pos_l1 * gv).sum(-1) / n_vis
        vis = _bce(k[..., 2], gv).mean(-1)
        total = total + ((pos + vis) * valid_t).sum() / denom
    return total / len(STRIDES)


def detection_loss(outputs: Dict, targets_xyxy: torch.Tensor, targets_cls: torch.Tensor,
                   num_classes: int, reg_max: int = 16, targets_angle: torch.Tensor = None,
                   group=None) -> torch.Tensor:
    """Center-assignment loss: each gt claims the anchor holding its center
    at every scale; the class target is the union of the gts an anchor
    holds (clipped to 1), every other anchor learns zero objectness.

    ``targets_angle`` (obb): the ltrb target comes from the anchor-to-center
    offset rotated into the box frame, ``f = R(-angle) @ (center - anchor)``:
    lt = (w, h) / 2 - f, rb = (w, h) / 2 + f, so that decode's dist2rbox
    puts the center back exactly. cos and sin are taken in float64 and
    rounded to the targets' dtype."""
    B, T = targets_cls.shape
    centers_x = (targets_xyxy[..., 0] + targets_xyxy[..., 2]) / 2
    centers_y = (targets_xyxy[..., 1] + targets_xyxy[..., 3]) / 2
    dtype = targets_xyxy.dtype
    valid_t = targets_cls >= 0
    valid_f = valid_t.to(dtype)
    denom = _denom(valid_t, group)
    # the class rows of real gts; a padding gt's row is all zero
    onehot_t = (targets_cls[..., None] == torch.arange(num_classes, device=targets_cls.device)).to(dtype)
    if targets_angle is not None:
        cos = torch.cos(targets_angle.double()).to(dtype)
        sin = torch.sin(targets_angle.double()).to(dtype)
    total = 0.0
    for i, stride in enumerate(STRIDES):
        cls_map, box_map = outputs["cls"][i], outputs["box"][i]
        H, W = cls_map.shape[1], cls_map.shape[2]
        gx, gy = _cells(targets_xyxy, stride, H, W)
        flat_idx = gy * W + gx  # [B, T]

        cls_target = torch.zeros(B, H * W, num_classes, dtype=dtype, device=cls_map.device)
        cls_target.scatter_add_(1, flat_idx[..., None].expand(-1, -1, num_classes), onehot_t)
        cls_target.clamp_(0.0, 1.0)
        total = total + _mean(_bce(cls_map.reshape(B, H * W, num_classes), cls_target), group)

        # the assigned anchors' DFL logits: expected ltrb and the bin terms
        picked_logits = box_map.reshape(B, H * W, 4, reg_max).gather(
            1, flat_idx[..., None, None].expand(-1, -1, 4, reg_max))  # [B, T, 4, reg_max]
        bins = torch.arange(reg_max, dtype=dtype, device=box_map.device)
        picked = (torch.softmax(picked_logits, -1) * bins).sum(-1) * stride  # [B, T, 4]
        ax = (gx.float() + 0.5) * stride
        ay = (gy.float() + 0.5) * stride
        if targets_angle is None:
            gt_ltrb = torch.stack([ax - targets_xyxy[..., 0], ay - targets_xyxy[..., 1],
                                   targets_xyxy[..., 2] - ax, targets_xyxy[..., 3] - ay], -1)
        else:
            half_w = (targets_xyxy[..., 2] - targets_xyxy[..., 0]) / 2
            half_h = (targets_xyxy[..., 3] - targets_xyxy[..., 1]) / 2
            ox = centers_x - ax
            oy = centers_y - ay
            fx = ox * cos + oy * sin
            fy = -ox * sin + oy * cos
            gt_ltrb = torch.stack([half_w - fx, half_h - fy, half_w + fx, half_h + fy], -1)
        box_l1 = (picked - gt_ltrb).abs() * valid_f[..., None]
        total = total + (box_l1.sum() / denom) / stride

        # DFL (ultralytics df_loss): each side's bin distribution against the
        # two integer bins around the stride-unit target, linearly weighted
        t_bins = torch.clamp(gt_ltrb / stride, 0.0, reg_max - 1 - 1e-4)
        tl = torch.floor(t_bins)
        wl = tl + 1.0 - t_bins
        logp = torch.log_softmax(picked_logits, -1)
        tl_i = tl.long()[..., None]
        lp_l = logp.gather(-1, tl_i)[..., 0]
        lp_r = logp.gather(-1, tl_i + 1)[..., 0]
        dfl = -(wl * lp_l + (1.0 - wl) * lp_r)
        total = total + (dfl.mean(-1) * valid_f).sum() / denom
    return total


def classify_loss(outputs: Dict, labels: torch.Tensor, group=None) -> torch.Tensor:
    """Softmax cross-entropy of the logits against integer labels, mean
    over the batch (optax.softmax_cross_entropy_with_integer_labels)."""
    if group is None:
        return F.cross_entropy(outputs["logits"], labels.long())
    return _mean(F.cross_entropy(outputs["logits"], labels.long(), reduction="none"), group)


def task_loss(model: YOLO, outputs: Dict, image_size: int, *targets: torch.Tensor,
              group=None) -> torch.Tensor:
    """The step's loss on the forward's ``outputs``: classify's CE for
    ``targets = (labels,)``, else detection_loss on ``(t_xyxy, t_cls,
    *extra)`` plus the task's term on the trailing target. With ``group``
    (a data group), this rank's share of the loss over the group's batch."""
    if model.task == "classify":
        (labels,) = targets
        return classify_loss(outputs, labels, group)
    t_xyxy, t_cls, *extra = targets
    t_extra = extra[0] if extra else None
    loss = detection_loss(outputs, t_xyxy, t_cls, model.num_classes, model.reg_max,
                          targets_angle=t_extra if model.task == "obb" else None, group=group)
    valid_t = (t_cls >= 0).to(t_xyxy.dtype)
    if model.task == "segment":
        loss = loss + segment_loss(outputs, t_xyxy, t_extra, valid_t, image_size, group)
    elif model.task == "obb":
        loss = loss + obb_angle_loss(outputs, t_xyxy, t_extra, valid_t, group)
    elif model.task == "pose":
        loss = loss + pose_kpt_loss(outputs, t_xyxy, t_extra, valid_t, group)
    return loss


def make_train_step(state: TrainState, mesh=None) -> Callable[..., torch.Tensor]:
    """Returns ``step(images, t_xyxy, t_cls, *extra) -> loss``: one forward
    in train mode (the BatchNorms move their running statistics), the loss,
    its gradients and one AdamW update of ``state``. ``images`` are NHWC
    float32 RGB in [0, 1]. Per task, the trailing argument is

    * segment: t_masks ``[B, T, Hp, Wp]`` (binary gt masks on the prototype
      grid, Hp = image_size // 4) -> segment_loss;
    * obb: t_angle ``[B, T]`` radians in (-pi/4, 3pi/4), with ``t_xyxy`` the
      unrotated extents (center +- w/2, h/2) -> obb_angle_loss;
    * pose: t_kpts ``[B, T, nk, 3]`` (x, y, visibility) -> pose_kpt_loss;
    * classify: ``step(images, labels [B])``, softmax cross-entropy.

    With ``mesh`` (``parallel.mesh.make_mesh``, the model already
    ``place``d, the optimiser built after), each rank passes its share of
    the global batch (``shard_batch``) and gets back the global loss; the
    BatchNorms take their statistics over the data group from here on.
    """
    model, opt = state.model, state.optimizer
    group = tp = None
    if mesh is not None:
        group, tp = mesh.groups["data"], mesh.shape["model"]
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.group = group

    def step(images: torch.Tensor, *targets: torch.Tensor) -> torch.Tensor:
        if not model.training:
            model.train()
        outputs = model(images.permute(0, 3, 1, 2))
        loss = task_loss(model, outputs, images.shape[1], *targets, group=group)
        opt.zero_grad(set_to_none=True)
        if mesh is None:
            loss.backward()
        else:
            # the tp ranks of a data index each hold its whole share
            (loss / tp).backward()
            sum_gradients(model, mesh)
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=group)
        opt.step()
        state.step += 1
        return loss.detach()

    return step

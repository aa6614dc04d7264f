"""YOLOv8-family architecture as torch ``nn.Module``s (all five tasks).

Port of ``cuauv_vision_pipeline_tpu.models.yolo.model``: CSP backbone
(Conv-BN-SiLU + C2f blocks + SPPF), PAN neck and the decoupled per-scale
heads (detect, obb, pose, segment with its ``Proto`` prototype head), and
the classify model (backbone to the P5 C2f, then ultralytics' Classify
head), at the ultralytics n/s/m width-depth multiples. Parameter names are
ultralytics' own (``model.<yaml index>.cv1.conv.weight``, ...), so one
naming serves the carry-over of the JAX package's flax parameters
(weights.params_from_flax), ``.pt`` import and export.

Layouts: the modules run NCHW (``channels_last`` memory on the card); the
forward's outputs are NHWC views, as flax returns them, so decode flattens
anchors in the JAX package's order (row-major H, then W).

``create_model`` returns the model in eval mode (serving); ``model.train()``
switches the BatchNorms to flax's training semantics (batch statistics,
the running ones moved at momentum 0.97) for ``train.py``.

``YOLO.fuse_`` folds each BatchNorm into its convolution for inference
(one conv with bias + SiLU per layer instead of conv, BN, SiLU); the fold is
computed in float32 and then cast to the serving dtype. The quantized
serving modes (``quant.py``) hook in through ``ConvBnSilu.qconv`` and
``PlainConv.qconv``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SIZES = {
    # depth_multiple, width_multiple, max_channels; "p" (pico) is the in-repo
    # CPU-trainable width of the fixture checkpoints
    "p": (1 / 3, 0.125, 1024),
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "l": (1.0, 1.00, 512),
    "x": (1.0, 1.25, 512),
}
TASKS = ("detect", "obb", "pose", "segment", "classify")
BN_EPS = 1e-3
BN_MOMENTUM = 0.97  # flax's: the running statistics' weight per step
# ultralytics Classify head's fixed embedding width (not width-scaled)
CLASSIFY_EMBED = 1280


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(round(x / divisor) * divisor))


class BatchNorm(nn.Module):
    """BatchNorm with ultralytics' four tensors and nothing else
    (``nn.BatchNorm2d`` adds ``num_batches_tracked``, which no checkpoint of
    the JAX package carries).

    In eval mode it normalises with the running statistics. In train mode it
    is flax's ``nn.BatchNorm(momentum=0.97, epsilon=1e-3)`` with
    ``use_running_average=False``: it normalises with the batch mean and the
    biased variance over N, H, W (gradients flow through both), and moves
    the running statistics by ``running = 0.97 * running + 0.03 * batch``
    with that biased variance, flax's fast form ``E[x^2] - E[x]^2`` clamped
    at 0. torch's own running update (unbiased variance, momentum the new
    value's weight) is not used.

    With ``group`` set (``train.make_train_step`` on a mesh: the data group)
    the batch is the union of the group's equal shares: the sums behind the
    mean and the variance are all-reduced over the group (with their
    gradients) before normalising, the variance still the two-pass biased
    one ``F.batch_norm`` takes."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.group = None

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)

    def _group_forward(self, x: torch.Tensor) -> torch.Tensor:
        from torch.distributed import get_world_size

        from ...parallel.mesh import sum_over

        count = x.numel() // x.shape[1] * get_world_size(self.group)
        sums = sum_over(torch.stack([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)).detach()]), self.group)
        mean = sums[0] / count
        centred = x - mean[:, None, None]
        var = sum_over((centred * centred).sum((0, 2, 3)), self.group) / count
        with torch.no_grad():
            self._move_running(mean, torch.clamp_min(sums[1] / count - mean * mean, 0.0))
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        return centred * scale[:, None, None] + self.bias[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, BN_EPS)
        if self.group is not None:
            return self._group_forward(x)
        with torch.no_grad():
            mean = x.mean((0, 2, 3))
            var = torch.clamp_min((x * x).mean((0, 2, 3)) - mean * mean, 0.0)
            self._move_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, BN_EPS)


class ConvBnSilu(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, kernel // 2, bias=False)
        self.bn = BatchNorm(c_out)
        # (weight, bias) with the BatchNorm folded in; set by YOLO.fuse_
        self.fused: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        # w8a8 (quant.w8a8_): the int8 conv, and the BatchNorm as a
        # per-channel affine (mean, multiplier, shift) in the activation dtype
        self.qconv: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        self.bn_affine: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.qconv is not None:
            mean, mul, shift = self.bn_affine
            return F.silu((self.qconv(x) - mean) * mul + shift)
        if self.fused is not None:
            w, b = self.fused
            return F.silu(F.conv2d(x, w, b, self.conv.stride, self.conv.padding))
        return F.silu(self.bn(self.conv(x)))

    def fuse_(self, dtype: torch.dtype) -> None:
        bn = self.bn
        scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + BN_EPS)
        w = self.conv.weight.float() * scale[:, None, None, None]
        b = bn.bias.float() - bn.running_mean.float() * scale
        self.fused = (w.to(dtype).contiguous(memory_format=torch.channels_last), b.to(dtype))


class Bottleneck(nn.Module):
    def __init__(self, channels: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBnSilu(channels, channels, 3)
        self.cv2 = ConvBnSilu(channels, channels, 3)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Cross-stage partial block: split + n bottlenecks + concat, in the
    order ``[a, b, *bottleneck outputs]``."""

    def __init__(self, c_in: int, c_out: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        hidden = c_out // 2
        self.cv1 = ConvBnSilu(c_in, 2 * hidden, 1)
        self.cv2 = ConvBnSilu((2 + n) * hidden, c_out, 1)
        self.m = nn.ModuleList(Bottleneck(hidden, shortcut) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = list(self.cv1(x).chunk(2, dim=1))
        for block in self.m:
            outs.append(block(outs[-1]))
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 stride-1 max pools
    (implicit -inf padding, as flax's max_pool)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        hidden = c_in // 2
        self.cv1 = ConvBnSilu(c_in, hidden, 1)
        self.cv2 = ConvBnSilu(4 * hidden, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, stride=1, padding=2))
        return self.cv2(torch.cat(y, dim=1))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class PlainConv(nn.Conv2d):
    """A head's output conv (1x1, with bias); ``qconv`` (quant.w8a8_)
    replaces it by the int8 conv."""

    qconv: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.qconv(x) if self.qconv is not None else super().forward(x)


def _branch(c_in: int, c_mid: int, c_out: int) -> nn.Sequential:
    return nn.Sequential(ConvBnSilu(c_in, c_mid, 3), ConvBnSilu(c_mid, c_mid, 3),
                         PlainConv(c_mid, c_out, 1))


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class Proto(nn.Module):
    """Mask prototype head (ultralytics v8 Segment's Proto): Conv 3x3 ->
    2x ConvTranspose upsample -> Conv 3x3 -> Conv 1x1 to ``num_masks``
    maps at 1/4 of the model resolution, from the P3 feature."""

    def __init__(self, c_in: int, c_mid: int, num_masks: int):
        super().__init__()
        self.cv1 = ConvBnSilu(c_in, c_mid, 3)
        self.upsample = nn.ConvTranspose2d(c_mid, c_mid, 2, 2, 0, bias=True)
        self.cv2 = ConvBnSilu(c_mid, c_mid, 3)
        self.cv3 = ConvBnSilu(c_mid, num_masks, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class Head(nn.Module):
    """ultralytics v8 Detect/OBB/Pose/Segment head: ``cv2`` box (DFL
    logits), ``cv3`` classes, ``cv4`` angle (obb), keypoints (pose) or mask
    coefficients (segment), one branch per scale, and segment's ``proto``;
    branch widths as ultralytics', so real checkpoints map tensor for
    tensor."""

    def __init__(self, chans: Tuple[int, int, int], num_classes: int, task: str, reg_max: int,
                 num_keypoints: int = 17, num_masks: int = 32):
        super().__init__()
        c0 = chans[0]
        box_ch = max(16, c0 // 4, 4 * reg_max)
        cls_ch = max(c0, min(num_classes, 100))
        self.cv2 = nn.ModuleList(_branch(c, box_ch, 4 * reg_max) for c in chans)
        self.cv3 = nn.ModuleList(_branch(c, cls_ch, num_classes) for c in chans)
        # (width, output channels, output key) of the task's extra branch
        extra = {"obb": (max(c0 // 4, 1), 1, "angle"),
                 "pose": (max(c0 // 4, 3 * num_keypoints), 3 * num_keypoints, "kpts"),
                 "segment": (max(c0 // 4, num_masks), num_masks, "mcoef")}.get(task)
        self.cv4 = (nn.ModuleList(_branch(c, extra[0], extra[1]) for c in chans)
                    if extra else None)
        self.cv4_key = extra[2] if extra else None
        # prototype width: ultralytics' npr 256, width-scaled like any channel count
        self.proto = Proto(c0, c0, num_masks) if task == "segment" else None

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, Union[List[torch.Tensor], torch.Tensor]]:
        out = {"box": [_nhwc(b(f)) for b, f in zip(self.cv2, feats)],
               "cls": [_nhwc(c(f)) for c, f in zip(self.cv3, feats)]}
        if self.cv4 is not None:
            out[self.cv4_key] = [_nhwc(a(f)) for a, f in zip(self.cv4, feats)]
        if self.proto is not None:
            out["proto"] = _nhwc(self.proto(feats[0]))
        return out


class Classify(nn.Module):
    """ultralytics Classify head: 1x1 conv to ``CLASSIFY_EMBED``, global
    average pool, linear classifier (raw logits)."""

    def __init__(self, c_in: int, num_classes: int):
        super().__init__()
        self.conv = ConvBnSilu(c_in, CLASSIFY_EMBED, 1)
        self.linear = nn.Linear(CLASSIFY_EMBED, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"logits": self.linear(self.conv(x).mean((2, 3)))}


class YOLO(nn.Module):
    """Backbone + PAN neck + per-scale heads, or the classify model.

    ``forward(x [B, 3, S, S])`` returns per-scale NHWC maps at strides
    (8, 16, 32): ``box`` [B, H, W, 4*reg_max] DFL logits, ``cls`` [B, H, W,
    num_classes], and ``angle`` [B, H, W, 1] (obb), ``kpts`` [B, H, W,
    3*num_keypoints] (pose) or ``mcoef`` [B, H, W, num_masks] (segment);
    segment adds one ``proto`` [B, S/4, S/4, num_masks]. Classify returns
    ``{"logits": [B, num_classes]}``."""

    def __init__(self, num_classes: int = 80, size: str = "n", task: str = "detect",
                 reg_max: int = 16, num_keypoints: int = 17, num_masks: int = 32):
        super().__init__()
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r} (tasks: {TASKS})")
        self.num_classes, self.size, self.task, self.reg_max = num_classes, size, task, reg_max
        self.num_keypoints, self.num_masks = num_keypoints, num_masks
        depth, width, max_ch = SIZES[size]

        def ch(base: int) -> int:
            return _make_divisible(min(base, max_ch) * width)

        def reps(base: int) -> int:
            return max(1, round(base * depth))

        c64, c128, c256, c512, c1024 = ch(64), ch(128), ch(256), ch(512), ch(1024)
        # keys are the ultralytics yolov8 yaml indices (10, 11, 13, 14, 17,
        # 20 are the parameterless upsamples and concats)
        layers = {
            "0": ConvBnSilu(3, c64, 3, 2),
            "1": ConvBnSilu(c64, c128, 3, 2),
            "2": C2f(c128, c128, reps(3)),
            "3": ConvBnSilu(c128, c256, 3, 2),
            "4": C2f(c256, c256, reps(6)),
            "5": ConvBnSilu(c256, c512, 3, 2),
            "6": C2f(c512, c512, reps(6)),
            "7": ConvBnSilu(c512, c1024, 3, 2),
            "8": C2f(c1024, c1024, reps(3)),
        }
        if task == "classify":
            # yolov8-cls: the backbone ends at the P5 C2f (yaml index 8: no
            # SPPF, no neck); its Classify head is yaml index 9
            layers["9"] = Classify(c1024, num_classes)
        else:
            layers.update({
                "9": SPPF(c1024, c1024),
                "12": C2f(c1024 + c512, c512, reps(3), shortcut=False),
                "15": C2f(c512 + c256, c256, reps(3), shortcut=False),
                "16": ConvBnSilu(c256, c256, 3, 2),
                "18": C2f(c256 + c512, c512, reps(3), shortcut=False),
                "19": ConvBnSilu(c512, c512, 3, 2),
                "21": C2f(c512 + c1024, c1024, reps(3), shortcut=False),
                "22": Head((c256, c512, c1024), num_classes, task, reg_max, num_keypoints, num_masks),
            })
        self.model = nn.ModuleDict(layers)

    def forward(self, x: torch.Tensor) -> Dict[str, Union[List[torch.Tensor], torch.Tensor]]:
        m = self.model
        x = m["2"](m["1"](m["0"](x)))
        p3 = m["4"](m["3"](x))
        p4 = m["6"](m["5"](p3))
        if self.task == "classify":
            return m["9"](m["8"](m["7"](p4)))
        p5 = m["9"](m["8"](m["7"](p4)))
        n4 = m["12"](torch.cat([_upsample2(p5), p4], 1))
        n3 = m["15"](torch.cat([_upsample2(n4), p3], 1))
        n4b = m["18"](torch.cat([m["16"](n3), n4], 1))
        n5 = m["21"](torch.cat([m["19"](n4b), p5], 1))
        return m["22"]([n3, n4b, n5])

    def train(self, mode: bool = True) -> "YOLO":
        """Train mode (``mode=True``), as ``nn.Module.train``; refused once
        :meth:`fuse_` or a quantized mode (``quant.py``) has replaced the
        BatchNorms or convs: a folded or quantized model cannot train."""
        if mode and any(getattr(m, "fused", None) is not None or getattr(m, "qconv", None) is not None
                        for m in self.modules()):
            raise RuntimeError("a fused or quantized YOLO cannot train: build it anew from its weights")
        return super().train(mode)

    @torch.no_grad()
    def fuse_(self, dtype: torch.dtype = torch.float32) -> "YOLO":
        """Fold every BatchNorm into its conv (computed in float32 from the
        current parameters, on their device) and cast the folded tensors and
        the layers without a BatchNorm (the heads' output convs, Proto's
        ConvTranspose, the classify Linear) to ``dtype``. Call again after
        ``.to()``."""
        for mod in self.modules():
            if isinstance(mod, ConvBnSilu):
                mod.fuse_(dtype)
            elif isinstance(mod, (PlainConv, nn.ConvTranspose2d)):
                mod.to(dtype=dtype, memory_format=torch.channels_last)
            elif isinstance(mod, nn.Linear):
                mod.to(dtype=dtype)
        return self


def init_parameters_(model: YOLO, seed: int = 0) -> YOLO:
    """Seeded random init with flax's defaults: conv, ConvTranspose and
    Linear kernels lecun-normal (truncated at 2 sigma, fan-in = kernel
    height x width x input channels), biases 0, BatchNorm scale 1, shift 0,
    mean 0, variance 1. A ``torch.Generator`` on the CPU makes the numbers,
    so they are the same on every machine for one seed."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                # ConvTranspose2d kernels are [in, out, kh, kw]
                fan_in = (mod.weight[:, 0].numel() if isinstance(mod, nn.ConvTranspose2d)
                          else mod.weight[0].numel())
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
    return model


def create_model(num_classes: int, size: str = "n", task: str = "detect", seed: int = 0,
                 num_keypoints: int = 17, num_masks: int = 32) -> YOLO:
    """A float32 model on the CPU with seeded random parameters."""
    return init_parameters_(YOLO(num_classes, size, task, num_keypoints=num_keypoints,
                                 num_masks=num_masks), seed).eval()


def letterbox_params(h: int, w: int, image_size: int = 640) -> Tuple[float, int, int, int, int]:
    """Aspect-preserving letterbox geometry for an h x w frame into an
    image_size square, matching ultralytics' LetterBox (resize by the min
    scale, center-pad): returns (scale, pad_left, pad_top, new_h, new_w).
    Undo a model-space coordinate v with (v - pad) / scale."""
    scale = min(image_size / h, image_size / w)
    nh, nw = round(h * scale), round(w * scale)
    dh, dw = (image_size - nh) / 2, (image_size - nw) / 2
    return scale, round(dw - 0.1), round(dh - 0.1), nh, nw


@functools.lru_cache(maxsize=16)
def _interp_matrix(out_n: int, in_n: int, scale: float = 1.0) -> np.ndarray:
    """Dense 1-D bilinear interpolation matrix (cv2 pixel-center alignment:
    src = (dst+0.5)*in/out - 0.5), optionally pre-scaled."""
    f = (np.arange(out_n) + 0.5) * (in_n / out_n) - 0.5
    i0 = np.clip(np.floor(f), 0, in_n - 1).astype(np.int64)
    i1 = np.clip(i0 + 1, 0, in_n - 1)
    w = np.clip(f - i0, 0.0, 1.0).astype(np.float32)
    M = np.zeros((out_n, in_n), np.float32)
    np.add.at(M, (np.arange(out_n), i0), (1.0 - w) * scale)
    np.add.at(M, (np.arange(out_n), i1), w * scale)
    return M


_MATRICES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _matrices(nh: int, h: int, nw: int, w: int, device: torch.device):
    key = (nh, h, nw, w, str(device))
    if key not in _MATRICES:
        _MATRICES[key] = (torch.from_numpy(_interp_matrix(nh, h)).to(device),
                          torch.from_numpy(_interp_matrix(nw, w)).to(device))
    return _MATRICES[key]


def preprocess_fused(image_u8: torch.Tensor, image_size: int = 640) -> torch.Tensor:
    """Matmul-form letterbox: u8 BGR ``[..., H, W, 3]`` -> f32 RGB ``[..., S,
    S, 3]`` in [0, 1] (NHWC, the JAX package's layout). The bilinear resize
    is two constant-matrix products (rows, then columns) in full float32,
    then cv2's u8 re-quantization floor(x + 0.5), /255 and the 114-gray pad.
    Equal to the JAX package's ``preprocess_fused`` at the u8 level."""
    img = image_u8.flip(-1)  # BGR -> RGB
    h, w = img.shape[-3], img.shape[-2]
    _, left, top, nh, nw = letterbox_params(h, w, image_size)
    x = img.float()
    if (nh, nw) != (h, w):
        R, C = _matrices(nh, h, nw, w, x.device)
        x = torch.einsum("rh,...hwc->...rwc", R, x)
        x = torch.einsum("qw,...rwc->...rqc", C, x)
        x = torch.clamp(torch.floor(x + 0.5), 0, 255) / 255.0
    else:
        x = x / 255.0
    if (nh, nw) != (image_size, image_size):
        pad = (0, 0, left, image_size - nw - left, top, image_size - nh - top)
        x = F.pad(x, pad, value=float(np.float32(114.0 / 255.0)))
    return x


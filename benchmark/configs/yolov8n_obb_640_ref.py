"""Plain reference of the YOLOv8n-OBB configuration, in PyTorch ops.

Independent of the program (it imports nothing of it): from u8 BGR frames and
an ultralytics-layout state dict (``model.<yaml index>.cv1.conv.weight``,
``...bn.running_var``, the head's ``model.22.cv2.<scale>.2.weight``, ...) to
the letterboxed input and every anchor's decoded box, angle, best-class logit
and class, in float32 with TF32 off for matrix products and convolutions.

The architecture is ``ultralytics/cfg/models/v8/yolov8-obb.yaml`` at a scale
(``n``: depth 0.33, width 0.25, max channels 1024): Conv-BN-SiLU, C2f
(split, bottlenecks, concat in the order ``[a, b, *bottlenecks]``) and SPPF
(three chained 5x5 stride-1 max pools) in the backbone, the PAN neck
(nearest 2x upsamples, concats ``[upsampled, skip]``), and the OBB head: per
stride 8, 16, 32 a box branch (two 3x3 Conv-BN-SiLU, a 1x1 conv to 4 x 16 DFL
logits), a class branch (to ``nc`` logits) and an angle branch (to one
logit). BatchNorm in eval mode with eps 1e-3 (ultralytics sets it so in
``initialize_weights``). Decode: DFL as the softmax expectation over 16 bins,
the angle ``(sigmoid - 0.25) * pi``, ``dist2rbox`` in grid units, then times
the stride.

Departures from ultralytics, each deliberate:

- Letterbox: bilinear resize with cv2's pixel-centre alignment computed in
  float64 and rounded half up, where cv2 uses 11-bit fixed-point weights.
  At 1920x1080 -> 640x360 (an exact 3:1 ratio) every sample point falls on a
  source pixel and both give that pixel; at other ratios a pixel may differ
  by one level. The pad is 114 gray, centred with ultralytics' rounding.
  The letterboxed input is returned in RGB, the order the model takes.
- Anchor order: row-major H then W, stride 8 then 16 then 32, as
  ultralytics flattens its head maps.
- The score is the best class's logit (its sigmoid is ultralytics' score);
  the class is the first of equal logits.
- Selection (for the judge only): a top-``pool`` candidate set by a stable
  descending sort of the scores (zero below ``conf``) and class-aware greedy
  NMS by ProbIoU with at most ``max_det`` picks, where ultralytics keeps up
  to 30,000 candidates and drops every box that any higher-scored box
  overlaps, suppressed or not. The configuration serves the greedy form.

``control_forward`` is the lower-precision form the control uses: every
conv's input and weights rounded to float8 e4m3 with one scale per tensor.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

STRIDES = (8, 16, 32)
REG_MAX = 16
BN_EPS = 1e-3
PAD_GRAY = 114
# scale -> (depth multiple, width multiple, max channels), ultralytics' yaml; "p" is
# the repository's own pico width (half of n), for tests at small sizes
SCALES = {"p": (0.33, 0.125, 1024), "n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024), "m": (0.67, 0.75, 768),
          "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512)}
# ultralytics' ProbIoU constant
PROBIOU_EPS = 1e-7
E4M3_MAX = 448.0


# full float32: no TF32 in cuBLAS or cuDNN (cuDNN's convolutions take it by default)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# -- letterbox -------------------------------------------------------------

def letterbox_geometry(h: int, w: int, size: int) -> Tuple[int, int, int, int]:
    """(new_h, new_w, top, left) of ultralytics' LetterBox (scale by the
    smaller ratio, centre the pad; ``round(d - 0.1)`` on the top and left)."""
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    top, left = int(round((size - nh) / 2 - 0.1)), int(round((size - nw) / 2 - 0.1))
    return nh, nw, top, left


def _bilinear_weights(out_n: int, in_n: int, device) -> torch.Tensor:
    """[out_n, in_n] float64: cv2's INTER_LINEAR taps, src = (dst + 0.5) *
    in / out - 0.5, edges clamped."""
    f = (torch.arange(out_n, dtype=torch.float64) + 0.5) * (in_n / out_n) - 0.5
    i0 = torch.floor(f).clamp(0, in_n - 1)
    frac = (f - i0).clamp(0.0, 1.0)
    i1 = (i0 + 1).clamp(max=in_n - 1)
    m = torch.zeros(out_n, in_n, dtype=torch.float64)
    rows = torch.arange(out_n)
    m.index_put_((rows, i0.long()), 1.0 - frac, accumulate=True)
    m.index_put_((rows, i1.long()), frac, accumulate=True)
    return m.to(device)


def letterbox(frames: torch.Tensor, size: int) -> torch.Tensor:
    """u8 BGR [B, H, W, 3] -> u8 RGB [B, size, size, 3]."""
    B, H, W, _ = frames.shape
    nh, nw, top, left = letterbox_geometry(H, W, size)
    x = frames.flip(-1).to(torch.float64)
    x = torch.einsum("rh,bhwc->brwc", _bilinear_weights(nh, H, frames.device), x)
    x = torch.einsum("qw,brwc->brqc", _bilinear_weights(nw, W, frames.device), x)
    out = torch.full((B, size, size, 3), PAD_GRAY, dtype=torch.uint8, device=frames.device)
    out[:, top:top + nh, left:left + nw] = torch.floor(x + 0.5).clamp(0, 255).to(torch.uint8)
    return out


# -- the network -----------------------------------------------------------

def widths(size: str, nc: int) -> Dict[str, int]:
    """Channel widths and repeats of yolov8-obb at a scale, from the yaml."""
    depth, width, max_ch = SCALES[size]

    def ch(c: int) -> int:  # ultralytics' make_divisible(min(c, max) * width, 8)
        return int(math.ceil(min(c, max_ch) * width / 8) * 8)

    def reps(n: int) -> int:
        return max(round(n * depth), 1)

    c = {k: ch(k) for k in (64, 128, 256, 512, 1024)}
    return {"c64": c[64], "c128": c[128], "c256": c[256], "c512": c[512], "c1024": c[1024],
            "n3": reps(3), "n6": reps(6),
            "box": max(16, c[256] // 4, REG_MAX * 4), "cls": max(c[256], min(nc, 100)),
            "ang": max(c[256] // 4, 1), "nc": nc}


# (input, weight, bias, stride, padding) -> output, as F.conv2d takes them positionally
Conv2d = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor], int, int], torch.Tensor]


class _Net:
    """The forward over a state dict; ``conv`` is the one convolution every
    layer calls (the control rounds its operands)."""

    def __init__(self, state: Dict[str, torch.Tensor], conv: Conv2d):
        self.s = state
        self.conv = conv

    def cbs(self, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        """Conv (no bias, pad k // 2) -> BatchNorm (eval) -> SiLU."""
        s = self.s
        w = s[f"{name}.conv.weight"]
        y = self.conv(x, w, None, stride, w.shape[-1] // 2)
        inv = s[f"{name}.bn.weight"] / torch.sqrt(s[f"{name}.bn.running_var"] + BN_EPS)
        y = (y - s[f"{name}.bn.running_mean"][:, None, None]) * inv[:, None, None] + s[f"{name}.bn.bias"][:, None, None]
        return F.silu(y)

    def c2f(self, name: str, x: torch.Tensor, n: int, shortcut: bool) -> torch.Tensor:
        ys = list(self.cbs(f"{name}.cv1", x).chunk(2, dim=1))
        for i in range(n):
            y = self.cbs(f"{name}.m.{i}.cv2", self.cbs(f"{name}.m.{i}.cv1", ys[-1]))
            ys.append(ys[-1] + y if shortcut else y)
        return self.cbs(f"{name}.cv2", torch.cat(ys, 1))

    def sppf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cbs(f"{name}.cv1", x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], 5, 1, 2))
        return self.cbs(f"{name}.cv2", torch.cat(ys, 1))

    def branch(self, name: str, x: torch.Tensor) -> torch.Tensor:
        s = self.s
        y = self.cbs(f"{name}.1", self.cbs(f"{name}.0", x))
        return self.conv(y, s[f"{name}.2.weight"], s[f"{name}.2.bias"], 1, 0)

    def __call__(self, x: torch.Tensor, n3: int, n6: int) -> List[Tuple[torch.Tensor, ...]]:
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        x = self.c2f("model.2", self.cbs("model.1", self.cbs("model.0", x, 2), 2), n3, True)
        p3 = self.c2f("model.4", self.cbs("model.3", x, 2), n6, True)
        p4 = self.c2f("model.6", self.cbs("model.5", p3, 2), n6, True)
        p5 = self.sppf("model.9", self.c2f("model.8", self.cbs("model.7", p4, 2), n3, True))
        h12 = self.c2f("model.12", torch.cat([up(p5), p4], 1), n3, False)
        h15 = self.c2f("model.15", torch.cat([up(h12), p3], 1), n3, False)
        h18 = self.c2f("model.18", torch.cat([self.cbs("model.16", h15, 2), h12], 1), n3, False)
        h21 = self.c2f("model.21", torch.cat([self.cbs("model.19", h18, 2), p5], 1), n3, False)
        return [(self.branch(f"model.22.cv2.{i}", f), self.branch(f"model.22.cv3.{i}", f),
                 self.branch(f"model.22.cv4.{i}", f)) for i, f in enumerate((h15, h18, h21))]


def head_maps(state: Dict[str, torch.Tensor], letterboxed: torch.Tensor, size: str = "n",
              conv: Conv2d = F.conv2d) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """u8 RGB [B, S, S, 3] -> per stride (8, 16, 32) the raw NCHW maps (box
    DFL logits [B, 64, h, w], class logits [B, nc, h, w], angle logit [B, 1,
    h, w]), float32."""
    nc = state["model.22.cv3.0.2.weight"].shape[0]
    wd = widths(size, nc)
    if state["model.0.conv.weight"].shape[0] != wd["c64"]:
        raise ValueError(f"the state dict is not scale {size!r}")
    x = letterboxed.permute(0, 3, 1, 2).float() / 255.0
    with torch.inference_mode():
        return _Net(state, conv)(x, wd["n3"], wd["n6"])


def decode(maps: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Head maps -> per anchor [B, N]: ``cx``, ``cy``, ``w``, ``h`` (model
    input pixels), ``angle`` (radians), ``logit`` (best class), ``cls``;
    and ``logits`` [B, N, nc], every class's."""
    out = {k: [] for k in ("cx", "cy", "w", "h", "angle", "logit", "cls", "logits")}
    for (box, cls, ang), stride in zip(maps, STRIDES):
        B, _, H, W = box.shape
        flat = lambda t: t.reshape(B, t.shape[1], H * W)  # noqa: E731
        probs = torch.softmax(flat(box).reshape(B, 4, REG_MAX, H * W), dim=2)
        dist = (probs * torch.arange(REG_MAX, dtype=torch.float32, device=box.device)[:, None]).sum(2)
        lt, rb = dist[:, :2], dist[:, 2:]
        angle = (torch.sigmoid(flat(ang)[:, 0]) - 0.25) * math.pi
        cos, sin = torch.cos(angle), torch.sin(angle)
        xf, yf = ((rb - lt) / 2).unbind(1)
        ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=box.device) + 0.5,
                                torch.arange(W, dtype=torch.float32, device=box.device) + 0.5, indexing="ij")
        cx = (xf * cos - yf * sin + xs.reshape(-1)) * stride
        cy = (xf * sin + yf * cos + ys.reshape(-1)) * stride
        wh = (lt + rb) * stride
        logit, c = flat(cls).max(1)
        for k, v in (("cx", cx), ("cy", cy), ("w", wh[:, 0]), ("h", wh[:, 1]), ("angle", angle),
                     ("logit", logit), ("cls", c), ("logits", flat(cls).transpose(1, 2))):
            out[k].append(v)
    return {k: torch.cat(v, 1) for k, v in out.items()}


def forward(state: Dict[str, torch.Tensor], frames: torch.Tensor, image_size: int, size: str = "n",
            conv: Conv2d = F.conv2d) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u8 BGR frames [B, H, W, 3] -> (letterboxed u8 RGB, :func:`decode`)."""
    lb = letterbox(frames, image_size)
    return lb, decode(head_maps(state, lb, size, conv))


def e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude at e4m3's largest finite value), back in float32."""
    scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _e4m3_conv(x, w, b, stride, pad):
    return F.conv2d(e4m3(x), e4m3(w), b, stride, pad)


def control_forward(state, frames, image_size, size="n"):
    """:func:`forward` with every conv's input and weights in float8 e4m3."""
    return forward(state, frames, image_size, size, _e4m3_conv)


# -- selection (for the judge) -----------------------------------------------

def probiou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ProbIoU (ultralytics' ``probiou``: Bhattacharyya distance of the
    boxes' Gaussians, 1 - Hellinger) of [..., 5] (cx, cy, w, h, angle)
    boxes, broadcast, in float64."""
    a, b = a.double(), b.double()

    def cov(r):
        w2, h2 = r[..., 2] ** 2 / 12, r[..., 3] ** 2 / 12
        c, s = torch.cos(r[..., 4]), torch.sin(r[..., 4])
        return w2 * c * c + h2 * s * s, w2 * s * s + h2 * c * c, (w2 - h2) * c * s

    a1, b1, c1 = cov(a)
    a2, b2, c2 = cov(b)
    dx, dy = a[..., 0] - b[..., 0], a[..., 1] - b[..., 1]
    det = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2
    t1 = ((a1 + a2) * dy * dy + (b1 + b2) * dx * dx) / (det + PROBIOU_EPS) * 0.25
    t2 = ((c1 + c2) * (-dx) * dy) / (det + PROBIOU_EPS) * 0.5
    root = torch.sqrt((a1 * b1 - c1 * c1).clamp_min(0)) * torch.sqrt((a2 * b2 - c2 * c2).clamp_min(0))
    t3 = torch.log(det / (4 * root + PROBIOU_EPS) + PROBIOU_EPS) * 0.5
    bd = (t1 + t2 + t3).clamp(PROBIOU_EPS, 100.0)
    return 1.0 - torch.sqrt(1.0 - torch.exp(-bd) + PROBIOU_EPS)


def scores_of(dec: Dict[str, torch.Tensor], conf: float) -> torch.Tensor:
    """Each anchor's score: the best class's sigmoid, 0 below ``conf``."""
    s = torch.sigmoid(dec["logit"])
    return torch.where(s >= conf, s, torch.zeros_like(s))


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, iou: float,
               max_det: int, pool: int) -> List[int]:
    """One frame: boxes [N, 5] (cx, cy, w, h, angle), scores [N] (0 = not a
    candidate), classes [N] -> the picked anchors in pick order. The pool
    is the top ``pool`` scores, equal scores lowest anchor first; each round
    picks the best live candidate and drops it and every live one of its
    class whose ProbIoU with it is >= ``iou``."""
    order = torch.sort(scores, descending=True, stable=True).indices[:pool]
    live = scores[order] > 0
    b, c = boxes[order], classes[order]
    picks = []
    while len(picks) < max_det:
        alive = torch.nonzero(live).flatten()
        if alive.numel() == 0:
            break
        best = int(alive[0])
        same = alive[c[alive] == c[best]]
        picks.append(int(order[best]))
        drop = same[probiou(b[best], b[same]) >= iou]
        live[drop] = False
        live[best] = False
    return picks


# -- work ------------------------------------------------------------------

def conv_layers(size: str, nc: int) -> List[Tuple[str, int, int, int, int, bool]]:
    """Every convolution of the network in forward order, as the state dict
    names it: (name, in channels, out channels, kernel side, the output's
    stride against the input image, head). A head conv is the last 1x1 of a
    head branch, with a bias and no BatchNorm (``<name>.weight``,
    ``<name>.bias``); every other is a Conv-BN-SiLU (``<name>.conv.weight``,
    ``<name>.bn.{weight,bias,running_mean,running_var}``)."""
    wd = widths(size, nc)
    c64, c128, c256, c512, c1024 = (wd[k] for k in ("c64", "c128", "c256", "c512", "c1024"))
    n3, n6 = wd["n3"], wd["n6"]
    out: List[Tuple[str, int, int, int, int, bool]] = []

    def conv(name, c_in, c_out, k, stride, head=False):
        out.append((name, c_in, c_out, k, stride, head))

    def c2f(name, c_in, c_out, n, stride):
        h = c_out // 2
        conv(f"{name}.cv1", c_in, 2 * h, 1, stride)
        for i in range(n):
            conv(f"{name}.m.{i}.cv1", h, h, 3, stride)
            conv(f"{name}.m.{i}.cv2", h, h, 3, stride)
        conv(f"{name}.cv2", (2 + n) * h, c_out, 1, stride)

    conv("model.0", 3, c64, 3, 2)
    conv("model.1", c64, c128, 3, 4)
    c2f("model.2", c128, c128, n3, 4)
    conv("model.3", c128, c256, 3, 8)
    c2f("model.4", c256, c256, n6, 8)
    conv("model.5", c256, c512, 3, 16)
    c2f("model.6", c512, c512, n6, 16)
    conv("model.7", c512, c1024, 3, 32)
    c2f("model.8", c1024, c1024, n3, 32)
    conv("model.9.cv1", c1024, c1024 // 2, 1, 32)  # SPPF
    conv("model.9.cv2", c1024 // 2 * 4, c1024, 1, 32)
    c2f("model.12", c1024 + c512, c512, n3, 16)
    c2f("model.15", c512 + c256, c256, n3, 8)
    conv("model.16", c256, c256, 3, 16)
    c2f("model.18", c256 + c512, c512, n3, 16)
    conv("model.19", c512, c512, 3, 32)
    c2f("model.21", c512 + c1024, c1024, n3, 32)
    for branch, (mid, last) in (("cv2", (wd["box"], 4 * REG_MAX)), ("cv3", (wd["cls"], nc)), ("cv4", (wd["ang"], 1))):
        for i, (c_in, stride) in enumerate(((c256, 8), (c512, 16), (c1024, 32))):
            conv(f"model.22.{branch}.{i}.0", c_in, mid, 3, stride)
            conv(f"model.22.{branch}.{i}.1", mid, mid, 3, stride)
            conv(f"model.22.{branch}.{i}.2", mid, last, 1, stride, head=True)
    return out


def forward_flops(cfg: Dict) -> int:
    """Floating-point operations of one frame's conv stack at the
    configuration's shapes: 2 x the multiply-adds of every convolution of
    :func:`conv_layers` and the DFL's fixed 16-tap 1x1 conv, at
    ``cfg["image_size"]``; max pools, upsamples, BatchNorms, activations and
    the decode are not counted.

    Against ultralytics: its published 23.3 GFLOPs for YOLOv8n-obb at 1024
    is thop's multiply-add count times 2, linear in the pixels
    (``get_flops`` counts at 32 x 32 and scales), so 23.3 x (640 / 1024)^2
    = 9.10 GFLOPs at 640. This count at 640, scale n, with the yaml's
    ``nc: 80`` is 8,989,401,600 (1.2 % below; thop also counts a bias add per
    output of the fused convs); with the configuration's 15 classes (class
    branch 64 wide, not 80) it is 8,343,206,400. The same count for the
    80-class YOLOv8n detect model gives 8.74 against ultralytics' 8.7.
    """
    S = cfg["image_size"]
    macs = sum(c_in * c_out * k * k * (S // stride) ** 2
               for _, c_in, c_out, k, stride, _ in conv_layers(cfg["size"], cfg["num_classes"]))
    anchors = sum((S // s) ** 2 for s in STRIDES)
    return 2 * (macs + 4 * REG_MAX * anchors)  # and the DFL conv


def state_from_numpy(state: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """An ultralytics-layout state dict of arrays as float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in state.items()}

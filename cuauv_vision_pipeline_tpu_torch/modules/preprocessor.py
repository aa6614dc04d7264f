#!/usr/bin/env python3
"""Composable debug preprocessor: a tuner-driven stack of image stages.

Port of ``cuauv_vision_pipeline_tpu.modules.preprocessor`` (reference
modules/preprocessor.py:47-151): the same 16 tuners and the same stage
order — color balance, LAB/HSV/HLS/YCrCb/LUV/gray channel split,
grayscale, RGB bias, contrast/brightness, Gaussian blur, noise,
erode/dilate, rotate, resize, translate — applied in turn. The frame stays
on the module's device (``--device N|cpu``, cuda:0 by default) across the
stages: one upload and one fetch per frame.

Erode and dilate work per channel, as cv2 does; the JAX module's windows
span W and the channels of its ``[H, W, 3]`` frame. The noise stage draws
from a ``torch.Generator`` on the module's device, seeded from OS entropy
unless the caller passes ``seed``.

    python -m cuauv_vision_pipeline_tpu_torch.modules.preprocessor forward [--device N|cpu]
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.base import ModuleBase
from ..core.tuners import BoolTuner, DoubleTuner, IntTuner
from ..ops import color as C
from ..ops import morphology as M
from ..ops import transform as X
from ..ops.balance import balance

module_tuners = [
    BoolTuner("grayscale", False),
    BoolTuner("balance", False),
    IntTuner("channel_split", 0, 0, 18),  # 0=off; see _CHANNEL_SPLITS
    IntTuner("bias_r", 0, -255, 255),
    IntTuner("bias_g", 0, -255, 255),
    IntTuner("bias_b", 0, -255, 255),
    DoubleTuner("contrast", 1.0, 0.0, 3.0),
    IntTuner("brightness", 0, -255, 255),
    IntTuner("blur_kernel", 0, 0, 31),
    DoubleTuner("noise_stddev", 0.0, 0.0, 50.0),
    IntTuner("erode_kernel", 0, 0, 15),
    IntTuner("dilate_kernel", 0, 0, 15),
    DoubleTuner("rotate_deg", 0.0, -180.0, 180.0),
    DoubleTuner("resize_factor", 1.0, 0.05, 4.0),
    IntTuner("translate_x", 0, -500, 500),
    IntTuner("translate_y", 0, -500, 500),
]

# the channel_split tuner's converters: value v > 0 picks converter
# (v-1)//3 and its channel (v-1)%3 (gray has one)
_CHANNEL_SPLITS = [
    C.bgr_to_lab,
    C.bgr_to_hsv,
    C.bgr_to_hls,
    C.bgr_to_ycrcb,
    C.bgr_to_luv,
    C.bgr_to_gray,
]


def _as_bgr(chan: torch.Tensor) -> torch.Tensor:
    return chan.unsqueeze(-1).expand(*chan.shape, 3).contiguous()


class Preprocessor(ModuleBase):
    def __init__(self, *args, seed: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._rng = torch.Generator(device=self.device)
        if seed is None:
            self._rng.seed()
        else:
            self._rng.manual_seed(seed)

    def stages(self, img: torch.Tensor) -> torch.Tensor:
        """The tuners' stage stack on a u8 BGR ``[H, W, 3]`` tensor, on its
        device."""
        out = img

        if self.tuners["balance"]:
            out = balance(out)

        split_idx = self.tuners["channel_split"]
        if split_idx > 0:
            conv_idx = (split_idx - 1) // 3
            chan_idx = (split_idx - 1) % 3
            if conv_idx < len(_CHANNEL_SPLITS):
                conv = _CHANNEL_SPLITS[conv_idx](out)
                n = conv.shape[-1] if conv.ndim == 3 else 1
                chan = conv[..., min(chan_idx, n - 1)] if conv.ndim == 3 else conv
                out = _as_bgr(chan)

        if self.tuners["grayscale"] and out.ndim == 3:
            out = _as_bgr(C.bgr_to_gray(out))

        bias = (self.tuners["bias_b"], self.tuners["bias_g"], self.tuners["bias_r"])
        if any(bias) and out.ndim == 3:
            wide = out.to(torch.int16)
            out = torch.stack([wide[..., c] + int(bias[c]) for c in range(3)], dim=-1)
            out = out.clamp(0, 255).to(torch.uint8)

        contrast = self.tuners["contrast"]
        brightness = self.tuners["brightness"]
        if contrast != 1.0 or brightness != 0:
            out = (out.to(torch.float32) * float(contrast) + float(brightness)).clamp(0, 255).to(torch.uint8)

        k = self.tuners["blur_kernel"]
        if k > 0:
            out = X.gaussian_blur(out, int(k) | 1)

        std = self.tuners["noise_stddev"]
        if std > 0:
            noise = torch.randn(out.shape, generator=self._rng, device=out.device) * float(std)
            out = (out.to(torch.float32) + noise).clamp(0, 255).to(torch.uint8)

        k = self.tuners["erode_kernel"]
        if k > 0:
            out = M.per_channel(M.erode, out, M.rect_kernel(int(k) | 1))
        k = self.tuners["dilate_kernel"]
        if k > 0:
            out = M.per_channel(M.dilate, out, M.rect_kernel(int(k) | 1))

        angle = self.tuners["rotate_deg"]
        if angle != 0.0:
            out = X.rotate(out, float(angle))

        factor = self.tuners["resize_factor"]
        if factor != 1.0:
            h, w = out.shape[:2]
            out = X.resize(out, (max(int(w * factor), 1), max(int(h * factor), 1)))

        tx, ty = self.tuners["translate_x"], self.tuners["translate_y"]
        if tx or ty:
            out = X.translate(out, float(tx), float(ty))
        return out

    def process(self, direction, img):
        frame = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        self.post("preprocessed", self.stages(frame).cpu().numpy())


if __name__ == "__main__":
    Preprocessor(["forward"], module_tuners)()

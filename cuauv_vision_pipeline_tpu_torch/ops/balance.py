"""Underwater color-correction engine on torch tensors.

Port of ``cuauv_vision_pipeline_tpu.ops.balance`` (reference
utils/color_correction/color_balance.cpp:343-780, ``process_frame``):

* percentile extrema clipping — 0.4% of outliers (0.2% per tail) from
  per-channel u8 histograms (exact, no sort);
* blockwise gray-world equalization — per-tile channel means (falling back
  to the global mean where a tile deviates by more than 1/6 of it), gain-up
  of the two non-dominant channels toward the dominant one, optional
  adaptive taper ``((255-v)/255)^0.25``;
* RGB contrast stretch by channel rank;
* HSV contrast stretch through the bit-exact HSV ops;
* HSI contrast stretch — float HSI with S/I percentile stretch.

Every stage is a short run of eager torch ops on the image's device with no
host synchronisation: percentile bounds stay 0-dim device tensors. Where
the JAX version leans on XLA, the port keeps its arithmetic but not its
route:

* u8 percentiles: a histogram (a segment sum) + ``cumsum``; the first
  bin whose cumulative count passes the threshold is the count of bins
  that do not (the cumulative sum is monotone), so no ``argmax`` is
  needed.
* Channel and tile means sum in float64. The channels are integer-valued
  where the means are taken, so the sums are exact, and a segment sum
  (``index_add_``) takes no TF32 path, which a one-hot float32 matrix
  product on the card would.
* Float percentiles (``jnp.percentile``'s ``linear`` method) sort and
  interpolate with JAX's own float32 position and weights, computed on the
  host from the static element count.
* A division by a constant multiplies by its float32 reciprocal, as XLA
  rewrites it (``ieee.recip_f32``); a constant divided by a tensor is a
  true division (``torch.div``), as XLA keeps it.
* ``argsort`` is stable, as ``jnp.argsort`` is (equal channel means occur
  on gray frames).
* The HSI square root, arccos and cosines and the adaptive taper's power
  run in float64 and round to float32 (``_f64``).

The HSI inverse picks its sector by ``floor(h / (2π/3))``: a hue an ulp
from a sector edge may fall on either side in two implementations (the JAX
package's own jitted and eager runs differ so), swapping two channels of
that pixel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.device import DeviceLike, run_np
from . import color as C
from .feature import sqrt_f32
from .ieee import recip_f32

# x / c of the JAX version, as XLA computes it: x * float32(1/c)
_INV_3, _INV_6, _INV_255 = recip_f32(3.0), recip_f32(6.0), recip_f32(255.0)
_INV_THIRD_TURN = recip_f32(2 * math.pi / 3)


class BalanceConfig(NamedTuple):
    """Which stages run (the reference's boolean arguments)."""

    equalize_rgb: bool = True
    rgb_contrast_correct: bool = False
    hsv_contrast_correct: bool = False
    hsi_contrast_correct: bool = True
    rgb_extrema_clipping: bool = True
    adaptive_cast_correction: bool = False
    horizontal_blocks: int = 1
    vertical_blocks: int = 1


def _histogram(index: torch.Tensor, bins: int, dtype: torch.dtype, weights=None) -> torch.Tensor:
    """Per-bin count (or sum of ``weights``) of a flat int64 index. A
    segment sum: ``torch.bincount`` on the card reads the index's maximum
    back to the host to size its output, which would stall the stream."""
    if weights is None:
        weights = torch.ones_like(index, dtype=dtype)
    return torch.zeros(bins, dtype=dtype, device=index.device).index_add_(0, index, weights)


def _u8_percentiles(channel: torch.Tensor, lo: float, hi: float):
    """Exact u8 percentile bounds via histogram + cumulative search (the
    reference's percentile_min_max, cpp:112-142): the smallest v with
    cum(v) > lo*n and the smallest with cum(v) >= hi*n, the counts
    truncated to integers as JAX's int32 cast does."""
    flat = channel.reshape(-1).to(torch.int64)
    cum = torch.cumsum(_histogram(flat, 256, torch.int64), 0)
    n = flat.numel()
    vmin = (cum <= int(lo * n)).sum()
    vmax = (cum < int(hi * n)).sum()
    return vmin.to(torch.float32), vmax.to(torch.float32)


def _clip_stretch(channel_f, vmin, vmax, out_lo=0.0, out_hi=255.0):
    span = torch.clamp_min(vmax - vmin, 1.0)
    out = (torch.clamp(channel_f, vmin, vmax) - vmin) * torch.div(out_hi - out_lo, span) + out_lo
    return out.clamp(0.0, 255.0)


def _f64(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn`` of a float32 tensor evaluated in float64 and rounded to
    float32: torch's float32 ``sqrt``, ``arccos``, ``cos`` and ``pow`` on
    the CPU were seen to round differently in one worker thread's chunk of
    a call than in the others (``ops/feature.py:sqrt_f32``), which moves a
    hue across a sector edge; the float64 ones were not."""
    return fn(x.to(torch.float64), *args).to(torch.float32)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """float32 mean of all of ``x``, summed in float64."""
    return x.to(torch.float64).mean().to(torch.float32)


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (q in percent, ``linear``): the sorted
    values at floor and ceil of ``q/100 * (n-1)``, weighted as JAX weighs
    them, all in float32."""
    n = x.numel()
    pos = np.float32(q) / np.float32(100.0) * np.float32(n - 1)
    low, high = int(np.floor(pos)), int(np.ceil(pos))
    w_high = pos - np.float32(low)
    w_low = np.float32(1.0) - w_high
    s = torch.sort(x.reshape(-1)).values
    return s[low] * float(w_low) + s[high] * float(w_high)


def _block_means(channel_f: torch.Tensor, hb: int, vb: int) -> torch.Tensor:
    """Per-pixel map of the mean of the tile containing each pixel."""
    H, W = channel_f.shape[-2], channel_f.shape[-1]
    dev = channel_f.device
    ys = (torch.arange(H, device=dev) * vb) // H
    xs = (torch.arange(W, device=dev) * hb) // W
    tile = (ys[:, None] * hb + xs[None, :]).reshape(-1)  # [H*W] in [0, hb*vb)
    n_tiles = hb * vb
    sums = _histogram(tile, n_tiles, torch.float64, channel_f.reshape(-1).to(torch.float64))
    counts = _histogram(tile, n_tiles, torch.float64)
    means = (sums / counts.clamp_min(1.0)).to(torch.float32)
    return means[tile].reshape(H, W)


def _equalize_rgb(r, g, b, cfg: BalanceConfig):
    """Blockwise gray-world cast removal (cpp:441-544)."""
    hb, vb = max(cfg.horizontal_blocks, 1), max(cfg.vertical_blocks, 1)
    r_avg, g_avg, b_avg = _mean(r), _mean(g), _mean(b)

    if hb == 1 and vb == 1:
        lr, lg, lb = r_avg, g_avg, b_avg
    else:
        lr = _block_means(r, hb, vb)
        lg = _block_means(g, hb, vb)
        lb = _block_means(b, hb, vb)
        # fall back to the global mean where a tile deviates > avg/6
        deviant = (
            ((lr - r_avg).abs() > r_avg * _INV_6)
            | ((lg - g_avg).abs() > g_avg * _INV_6)
            | ((lb - b_avg).abs() > b_avg * _INV_6)
        )
        lr = torch.where(deviant, r_avg, lr)
        lg = torch.where(deviant, g_avg, lg)
        lb = torch.where(deviant, b_avg, lb)

    dominant = torch.maximum(torch.maximum(lr, lg), lb)

    def gain_for(channel, local_mean):
        gain = dominant / torch.clamp_min(local_mean, 1e-6)
        if cfg.adaptive_cast_correction:
            taper = _f64(torch.pow, ((255.0 - channel) * _INV_255).clamp(0.0, 1.0), 0.25)
            return taper * (gain - 1.0) + 1.0
        return gain

    r2 = torch.where(lr < dominant, (r * gain_for(r, lr)).clamp(0, 255), r)
    g2 = torch.where(lg < dominant, (g * gain_for(g, lg)).clamp(0, 255), g)
    b2 = torch.where(lb < dominant, (b * gain_for(b, lb)).clamp(0, 255), b)
    return r2, g2, b2


def _rgb_contrast(r, g, b):
    """Rank-ordered per-channel stretch (cpp:546-645): min channel stretches
    up, mid both ways, max down, all toward the mean of the three maxima."""
    channels = (r, g, b)
    avgs = torch.stack([_mean(c) for c in channels])
    bounds = [_u8_percentiles(c, 0.002, 0.998) for c in channels]
    maxs = torch.stack([hi for _, hi in bounds])

    order = torch.argsort(avgs, stable=True)  # [min_idx, mid_idx, max_idx]
    rank = torch.argsort(order)  # rank of each channel in that order
    desired_max = maxs.sum() * _INV_3

    out = []
    for i, c in enumerate(channels):
        cmin, cmax = bounds[i]
        span = torch.clamp_min(cmax - cmin, 1.0)
        ratio = torch.where(
            rank[i] == 0,
            (desired_max - cmin) / span,  # min channel: stretch up
            torch.where(rank[i] == 1, desired_max / span, cmax / span),
        )
        out.append(((c - cmin) * ratio).clamp(0, 255))
    return tuple(out)


def _hsv_contrast(image_u8):
    """S/V percentile stretch through the exact HSV ops (cpp:647-700)."""
    hsv = C.bgr_to_hsv(image_u8).to(torch.float32)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    s_min, s_max = _u8_percentiles(s, 0.002, 0.998)
    v_min, v_max = _u8_percentiles(v, 0.002, 0.998)
    s2 = _clip_stretch(s, s_min, s_max)
    v2 = _clip_stretch(v, v_min, v_max)
    out = torch.stack([h, s2, v2], dim=-1).to(torch.uint8)
    return C.hsv_to_bgr(out)


def _rgb_to_hsi(r, g, b):
    """Float HSI (the reference's custom converter, cpp:167-240)."""
    i = (r + g + b) * _INV_3
    minimum = torch.minimum(torch.minimum(r, g), b)
    s = torch.where(i > 0, 1.0 - minimum / torch.clamp_min(i, 1e-6), 0.0)
    rg, rb, gb = r - g, r - b, g - b
    num = 0.5 * (rg + rb)
    den = sqrt_f32(rg * rg + rb * gb)
    theta = _f64(torch.arccos, (num / torch.clamp_min(den, 1e-6)).clamp(-1.0, 1.0))
    h = torch.where(b <= g, theta, 2 * math.pi - theta)
    return h, s, i


def _hsi_to_rgb(h, s, i):
    """Inverse HSI (cpp:242-341), sector-based."""
    h = torch.where(h < 0, h + 2 * math.pi, h)
    sector = torch.floor(h * _INV_THIRD_TURN)  # 0, 1, 2
    h_local = h - sector * (2 * math.pi / 3)
    cos_h = _f64(torch.cos, h_local)
    cos_rest = _f64(torch.cos, math.pi / 3 - h_local)
    x = i * (1.0 - s)
    y = i * (1.0 + s * cos_h / torch.clamp_min(cos_rest, 1e-6))
    z = 3.0 * i - x - y
    r = torch.where(sector == 0, y, torch.where(sector == 1, x, z))
    g = torch.where(sector == 0, z, torch.where(sector == 1, y, x))
    b = torch.where(sector == 0, x, torch.where(sector == 1, z, y))
    return r, g, b


def _hsi_contrast(r, g, b):
    """S/I percentile stretch in HSI space (cpp:702-774)."""
    h, s, i = _rgb_to_hsi(r, g, b)
    s_min, s_max = _percentile(s, 0.2), _percentile(s, 99.8)
    i_min, i_max = _percentile(i, 0.2), _percentile(i, 99.8)
    s2 = (torch.clamp(s, s_min, s_max) - s_min) / torch.clamp_min(s_max - s_min, 1e-6)
    i2 = _clip_stretch(i, i_min, i_max)
    r2, g2, b2 = _hsi_to_rgb(h, s2, i2)
    return r2.clamp(0, 255), g2.clamp(0, 255), b2.clamp(0, 255)


def corrected_rgb(image: torch.Tensor, cfg: BalanceConfig = BalanceConfig()):
    """The float r, g, b planes after every stage before the HSI stretch
    (extrema clipping, equalization, RGB and HSV contrast)."""
    img = image.to(torch.float32)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]

    if cfg.rgb_extrema_clipping:
        r, g, b = (torch.clamp(c, *_u8_percentiles(c, 0.002, 0.998)) for c in (r, g, b))

    if cfg.equalize_rgb:
        r, g, b = _equalize_rgb(r, g, b, cfg)

    if cfg.rgb_contrast_correct:
        r, g, b = _rgb_contrast(r, g, b)

    if cfg.hsv_contrast_correct:
        out = _hsv_contrast(torch.stack([b, g, r], dim=-1).to(torch.uint8)).to(torch.float32)
        b, g, r = out[..., 0], out[..., 1], out[..., 2]
    return r, g, b


def balance(image: torch.Tensor, cfg: BalanceConfig = BalanceConfig()) -> torch.Tensor:
    """Full color-correction pipeline on a u8 BGR ``[H, W, 3]`` image
    (cpp:343-780), on the image's device. Stages run in the reference's
    order: extrema clipping -> blockwise gray-world equalization ->
    (rgb | hsv | hsi) contrast correction."""
    r, g, b = corrected_rgb(image, cfg)
    if cfg.hsi_contrast_correct:
        r, g, b = _hsi_contrast(r, g, b)
    return torch.stack([b, g, r], dim=-1).to(torch.uint8)


def process_frame(
    arr: np.ndarray,
    equalize_rgb: bool = True,
    rgb_contrast_correct: bool = False,
    hsv_contrast_correct: bool = False,
    hsi_contrast_correct: bool = True,
    rgb_extrema_clipping: bool = True,
    adaptive_cast_correction: bool = False,
    horizontal_blocks: int = 1,
    vertical_blocks: int = 1,
    device: DeviceLike = None,
) -> np.ndarray:
    """Flat-argument entry matching the reference C ABI call shape
    (color_balance.cpp:343; the reference mutates in place — this returns
    the corrected image). Runs on ``device`` (``core/device.py``: cuda:0
    unless told ``cpu``)."""
    cfg = BalanceConfig(
        equalize_rgb,
        rgb_contrast_correct,
        hsv_contrast_correct,
        hsi_contrast_correct,
        rgb_extrema_clipping,
        adaptive_cast_correction,
        horizontal_blocks,
        vertical_blocks,
    )
    return run_np(lambda t: balance(t, cfg), arr, device)

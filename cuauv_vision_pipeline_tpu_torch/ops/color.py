"""Colorspace conversions on torch tensors, OpenCV-u8-exact.

Port of the integer paths of ``cuauv_vision_pipeline_tpu.ops.color``
(reference utils/color.py:11-32): pure functions over ``[..., H, W, 3]`` u8
tensors. All arithmetic is int32, as OpenCV's fixed-point pipelines are;
``>>`` on int32 tensors is an arithmetic shift, which ``_descale`` needs for
negative values. Lookup tables (``cvtables``) are gathered with index tensors
on the image's own device.

* ``bgr_to_gray``, ``bgr_to_hsv``, ``bgr_to_ycrcb``, ``bgr_to_lab`` —
  bit-exact vs OpenCV's u8 fixed-point pipelines (and vs the JAX package:
  tests/test_torch_ops.py).
* ``bgr_to_hls`` — bit-exact vs OpenCV's vectorized kernel for every image
  at least 8 px wide, through the emulated FMA and correctly rounded
  division of ``ops/ieee.py`` (tests/test_torch_color_extra.py).
* ``bgr_to_luv`` and the ``*_to_bgr`` inverses — float32 paths,
  tolerance-matched (OpenCV's own u8 LUV uses interpolated LUTs).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cvtables as T
from . import ieee as I


@functools.lru_cache(maxsize=None)
def _lut(name: str, device: torch.device, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """A cvtables table as a tensor on ``device``, copied once: a copy from
    host memory per call would wait for the card."""
    return torch.as_tensor(getattr(T, name), dtype=dtype, device=device)


def _pow_f64(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """float32 ``x ** exponent`` evaluated in float64 and rounded: torch's
    float32 ``pow`` on the CPU does not round alike in every worker
    thread's chunk of a call."""
    return torch.pow(x.to(torch.float64), exponent).to(torch.float32)


def _descale(x: torch.Tensor, shift: int) -> torch.Tensor:
    """OpenCV CV_DESCALE: round-half-up fixed-point rescale (arithmetic
    shift, valid for negative values)."""
    return (x + (1 << (shift - 1))) >> shift


def _split_bgr(image: torch.Tensor):
    img = image.to(torch.int32)
    return img[..., 0], img[..., 1], img[..., 2]


def bgr_to_gray(image: torch.Tensor) -> torch.Tensor:
    """u8 BGR -> u8 GRAY, bit-exact vs cv2 (BT.601, 15-bit fixed point)."""
    b, g, r = _split_bgr(image)
    y = _descale(r * T.GRAY_R + g * T.GRAY_G + b * T.GRAY_B, T.GRAY_SHIFT)
    return y.to(torch.uint8)


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    return bgr_to_gray(image.flip(-1))


def gray_to_bgr(image: torch.Tensor) -> torch.Tensor:
    """u8 GRAY -> u8 BGR (channel replication, exact)."""
    if image.ndim >= 1 and image.shape[-1] == 1:
        image = image[..., 0]
    return torch.stack([image, image, image], dim=-1).to(torch.uint8)


def bgr_to_hsv(image: torch.Tensor) -> torch.Tensor:
    """u8 BGR -> u8 HSV (H in [0,180)), bit-exact vs cv2's 12-bit tables."""
    b, g, r = _split_bgr(image)
    v = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = v - vmin

    sdiv = _lut("HSV_SDIV_TABLE", image.device)
    hdiv = _lut("HSV_HDIV_TABLE", image.device)
    half = 1 << (T.HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> T.HSV_SHIFT

    h_raw = torch.where(
        v == r,
        g - b,
        torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff),
    )
    h = (h_raw * hdiv[diff] + half) >> T.HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def bgr_to_ycrcb(image: torch.Tensor) -> torch.Tensor:
    """u8 BGR -> u8 YCrCb, bit-exact vs cv2 (14-bit fixed point)."""
    b, g, r = _split_bgr(image)
    y = _descale(
        r * T.YCRCB_YR + g * T.YCRCB_YG + b * T.YCRCB_YB, T.YCRCB_SHIFT
    )
    cr = _descale((r - y) * T.YCRCB_CR, T.YCRCB_SHIFT) + 128
    cb = _descale((b - y) * T.YCRCB_CB, T.YCRCB_SHIFT) + 128
    out = torch.stack([y, cr.clamp(0, 255), cb.clamp(0, 255)], dim=-1)
    return out.to(torch.uint8)


def bgr_to_lab(image: torch.Tensor) -> torch.Tensor:
    """u8 BGR (sRGB) -> u8 Lab, bit-exact vs cv2's integer LUT pipeline."""
    b8, g8, r8 = _split_bgr(image)
    gamma = _lut("LAB_GAMMA_TABLE", image.device)
    cbrt = _lut("LAB_CBRT_TABLE", image.device)
    C = [[int(c) for c in row] for row in T.LAB_XYZ_COEFFS]

    r, g, b = gamma[r8], gamma[g8], gamma[b8]

    def f(row):
        return cbrt[_descale(r * row[0] + g * row[1] + b * row[2], T.LAB_SHIFT)]

    fx, fy, fz = f(C[0]), f(C[1]), f(C[2])

    L = _descale(T.LAB_L_SCALE * fy + T.LAB_L_SHIFT, T.LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + (128 << T.LAB_SHIFT2), T.LAB_SHIFT2)
    bb = _descale(200 * (fy - fz) + (128 << T.LAB_SHIFT2), T.LAB_SHIFT2)
    out = torch.stack(
        [L.clamp(0, 255), a.clamp(0, 255), bb.clamp(0, 255)], dim=-1
    )
    return out.to(torch.uint8)


def hsv_to_bgr(image: torch.Tensor) -> torch.Tensor:
    """u8 HSV -> u8 BGR via the float sector algorithm (tolerance-matched
    against cv2). ``1 - s*frac`` and ``1 - s*(1 - frac)`` are fused
    multiply-adds (``ieee.fma_rn``), as XLA:CPU compiles the JAX version
    at its default optimization level; with two roundings, as eager ops
    give, 414 of the 11.8M HSV inputs round to another u8 than the JAX
    package's, and the HSI stretch of ``ops/balance.py`` after the HSV one
    magnifies each such count about fourfold."""
    img = image.to(torch.float32)
    h = img[..., 0] * float(np.float32(6.0 / 180.0))
    s = img[..., 1] * float(np.float32(1.0 / 255.0))
    v = img[..., 2]

    sector = torch.floor(h)
    frac = h - sector
    sector = sector.to(torch.int32) % 6

    p = v * (1.0 - s)
    q = v * I.fma_rn(-s, frac, 1.0)
    t = v * I.fma_rn(-s, 1.0 - frac, 1.0)

    def select(choices, default):
        out = default
        for k in range(4, -1, -1):  # jnp.select: the first true case wins
            out = torch.where(sector == k, choices[k], out)
        return out

    r = select([v, q, p, p, t], v)
    g = select([t, v, v, q, p], p)
    b = select([p, p, t, v, v], q)
    out = torch.stack([b, g, r], dim=-1)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def lab_to_bgr(image: torch.Tensor) -> torch.Tensor:
    """u8 Lab -> u8 BGR via the float inverse (tolerance-matched)."""
    img = image.to(torch.float32)
    L = img[..., 0] * float(np.float32(100.0 / 255.0))
    a = img[..., 1] - 128.0
    b = img[..., 2] - 128.0

    # x / c as XLA computes it: x * float32(1/c) (ieee.recip_f32)
    fy = (L + 16.0) * I.recip_f32(116.0)
    fx = fy + a * I.recip_f32(500.0)
    fz = fy - b * I.recip_f32(200.0)

    def finv(f):
        f3 = f * f * f
        return torch.where(f3 > 0.008856, f3, (f - 16.0 / 116.0) * I.recip_f32(7.787))

    wp = [float(v) for v in T.D65_WHITEPOINT]
    X = finv(fx) * wp[0]
    Y = finv(fy) * wp[1]
    Z = finv(fz) * wp[2]

    M = np.linalg.inv(T.SRGB2XYZ_D65.astype(np.float64)).astype(np.float32)
    M = [[float(v) for v in row] for row in M]
    rl = X * M[0][0] + Y * M[0][1] + Z * M[0][2]
    gl = X * M[1][0] + Y * M[1][1] + Z * M[1][2]
    bl = X * M[2][0] + Y * M[2][1] + Z * M[2][2]

    def srgb_encode(c):
        c = c.clamp(0.0, 1.0)
        return torch.where(
            c <= 0.0031308, c * 12.92, 1.055 * _pow_f64(c, 1.0 / 2.4) - 0.055
        )

    out = torch.stack([srgb_encode(bl), srgb_encode(gl), srgb_encode(rl)], dim=-1)
    return torch.round(out * 255.0).clamp(0, 255).to(torch.uint8)


def bgr_to_hls(image: torch.Tensor) -> torch.Tensor:
    """u8 BGR -> u8 HLS, bit-exact vs cv2's vectorized kernel.

    Replicates OpenCV's AVX2 RGB2HLS kernel operation for operation:
    ``s = diff / (2 - (vmax+vmin))`` with the sum computed once, hue via a
    true fused multiply-add ``fma(delta, 60/diff, sector_base)`` with the
    +360 wraparound folded into the fma base (``ieee.fma_rn``), and
    correctly rounded division (``ieee.div_rn``). Bit-exact vs cv2 for every
    image >= 8 px wide; narrower images hit cv2's scalar loop, which rounds
    differently from cv2's own SIMD body for rare colors."""
    scale = float(np.float32(1.0) / np.float32(255.0))
    bf = image[..., 0].to(torch.float32) * scale
    gf = image[..., 1].to(torch.float32) * scale
    rf = image[..., 2].to(torch.float32) * scale

    vmax = torch.maximum(torch.maximum(bf, gf), rf)
    vmin = torch.minimum(torch.minimum(bf, gf), rf)
    summ = vmax + vmin
    lum = summ * 0.5
    diff = vmax - vmin

    denom = torch.where(lum < 0.5, summ, 2.0 - summ)
    denom_safe = torch.where(denom > 0, denom, 1.0)
    s = torch.where(diff > 0, I.div_rn(diff, denom_safe), 0.0)

    diff_safe = torch.where(diff > 0, diff, 1.0)
    ddiff = I.div_rn(60.0, diff_safe)
    h = torch.where(
        vmax == rf,
        I.fma_rn(gf - bf, ddiff, torch.where(gf < bf, 360.0, 0.0)),
        torch.where(
            vmax == gf,
            I.fma_rn(bf - rf, ddiff, 120.0),
            I.fma_rn(rf - gf, ddiff, 240.0),
        ),
    )
    h = torch.where(diff > 0, h, 0.0)

    out = torch.stack(
        [torch.round(h * 0.5), torch.round(lum * 255.0), torch.round(s * 255.0)],
        dim=-1,
    )
    return out.clamp(0, 255).to(torch.uint8)


def bgr_to_luv(image: torch.Tensor) -> torch.Tensor:
    """u8 BGR (sRGB) -> u8 Luv with OpenCV's output scaling
    (L*255/100, (u+134)*255/354, (v+140)*255/262); a float path within a
    count of cv2's interpolated-LUT u8 output."""
    lin = _lut("SRGB_LINEAR_TABLE_F32", image.device, torch.float32)
    idx = image.to(torch.int64)
    b, g, r = lin[idx[..., 0]], lin[idx[..., 1]], lin[idx[..., 2]]

    M = [[float(v) for v in row] for row in T.SRGB2XYZ_D65]
    X = r * M[0][0] + g * M[0][1] + b * M[0][2]
    Y = r * M[1][0] + g * M[1][1] + b * M[1][2]
    Z = r * M[2][0] + g * M[2][1] + b * M[2][2]

    # cube root (torch has no cbrt); only Y > 0.008856 takes it
    L = torch.where(Y > 0.008856, 116.0 * _pow_f64(Y.clamp_min(0.0), 1.0 / 3.0) - 16.0, 903.3 * Y)
    d = X + 15.0 * Y + 3.0 * Z
    d_safe = torch.where(d > 0, d, 1.0)
    u_prime = torch.where(d > 0, 4.0 * X / d_safe, T.LUV_UN)
    v_prime = torch.where(d > 0, 9.0 * Y / d_safe, T.LUV_VN)
    u = 13.0 * L * (u_prime - T.LUV_UN)
    v = 13.0 * L * (v_prime - T.LUV_VN)

    Lo = torch.round(L * (255.0 / 100.0))
    uo = torch.round((u + 134.0) * (255.0 / 354.0))
    vo = torch.round((v + 140.0) * (255.0 / 262.0))
    out = torch.stack([Lo, uo, vo], dim=-1)
    return out.clamp(0, 255).to(torch.uint8)


def bgr_to_rgb(image: torch.Tensor) -> torch.Tensor:
    return image.flip(-1)


rgb_to_bgr = bgr_to_rgb

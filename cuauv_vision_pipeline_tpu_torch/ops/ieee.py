"""Bit-exact IEEE-754 binary32 helpers: error-free transforms + emulated FMA.

Port of ``cuauv_vision_pipeline_tpu.ops.ieee``. OpenCV's vectorized
colorspace kernels use a fused multiply-add (one rounding); matching them bit
for bit (``ops/color.py:bgr_to_hls``) needs a deterministic FMA built from
ordinary float32 operations.

``two_sum`` (Knuth) and ``two_prod`` (Dekker split) are error-free
transforms; ``fma_rn`` composes them with a round-to-odd intermediate sum
(Boldo–Muller) so the final add is the only rounding: ``fma_rn(a, b, c) ==
RN(a*b + c)``. ``div_rn`` corrects the hardware quotient to the correctly
rounded one.

These are plain eager torch ops on float32 tensors. Eager torch runs each
operation as its own kernel (one CPU loop or one CUDA launch per op), so
nothing contracts a product and a sum into an FMA, and each step rounds
once, as the algorithms require. Running this path under ``torch.compile``
or fusing it into one kernel would let the compiler contract ``a*b + c``
(nvcc and Triton do so by default) and break the exactness; a fused kernel
would need ``--fmad=false`` or explicit ``__fmul_rn``/``__fadd_rn``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_SPLIT = 4097.0  # 2^12 + 1 for binary32 Dekker splitting


def recip_f32(c: float) -> float:
    """float32 1/c: XLA rewrites ``x / c`` for a constant ``c`` into
    ``x * (1/c)``, and the port multiplies by this where the JAX package
    divides by a constant (CUDA's PyTorch multiplies by a reciprocal for a
    scalar divisor too, the CPU's divides, so neither is left to choose)."""
    return float(np.float32(1) / np.float32(c))


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth TwoSum: s = RN(a+b), e exact error (a+b == s+e)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dekker TwoProd: p = RN(a*b), e exact error (a*b == p+e). Assumes no
    overflow and error terms above the subnormal range (true for the
    colorspace magnitudes this backs)."""
    p = a * b
    ta = a * _SPLIT
    ah = ta - (ta - a)
    al = a - ah
    tb = b * _SPLIT
    bh = tb - (tb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _next_toward(x: torch.Tensor, positive: torch.Tensor) -> torch.Tensor:
    """nextafter(x, +-inf) via the monotonic sign-magnitude integer map."""
    i = x.contiguous().view(torch.int32)
    m = i ^ ((i >> 31) & 0x7FFFFFFF)
    m = m + torch.where(positive, 1, -1).to(torch.int32)
    i2 = m ^ ((m >> 31) & 0x7FFFFFFF)
    return i2.view(torch.float32)


def round_odd_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """RO(a+b): exact when representable, else the neighbor with an odd last
    mantissa bit (carries sticky information through a later RN)."""
    s, r = two_sum(a, b)
    i = s.contiguous().view(torch.int32)
    needs_odd = (r != 0) & ((i & 1) == 0)
    return torch.where(needs_odd, _next_toward(s, r > 0), s)


def fma_rn(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """Correctly rounded fused multiply-add RN(a*b + c) in float32."""
    ph, pl = two_prod(a, b)
    th, tl = two_sum(ph, c)
    return th + round_odd_sum(tl, pl)


def div_rn(a, b: torch.Tensor) -> torch.Tensor:
    """Correctly rounded division RN(a/b) in float32, whatever the backend's
    divide does: a Markstein correction on top of the hardware quotient."""
    q = a / b
    y = 1.0 / b
    e = fma_rn(-b, y, torch.ones_like(b))
    y = fma_rn(y, e, y)
    r = fma_rn(-q, b, a)
    return fma_rn(r, y, q)

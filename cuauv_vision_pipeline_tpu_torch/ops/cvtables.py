"""Fixed-point tables reproducing OpenCV's u8 colorspace semantics.

OpenCV's 8-bit conversions are integer pipelines over small lookup tables.
To deliver the bit-exact threshold masks the rebuild promises (BASELINE.md
"Mask fidelity"), these tables are regenerated here with numpy at import
time, matching OpenCV's construction:

* GRAY: 15-bit fixed-point BT.601 weights (verified exhaustively).
* HSV:  12-bit ``sdiv``/``hdiv`` reciprocal tables.
* LAB:  sRGB gamma table (3-bit headroom) + cube-root table built with
  *float32* cbrt (OpenCV builds it via softfloat — float64 cbrt differs in
  ~1e-4 of entries) + 12-bit row-normalized XYZ matrix.

All tables are plain numpy arrays; the JAX ops gather from them as constants
baked into the jitted graph.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# GRAY (BT.601), 15-bit fixed point
# ---------------------------------------------------------------------------

GRAY_SHIFT = 15
GRAY_R = int(round(0.299 * (1 << GRAY_SHIFT)))  # 9798
GRAY_G = int(round(0.587 * (1 << GRAY_SHIFT)))  # 19235
GRAY_B = (1 << GRAY_SHIFT) - GRAY_R - GRAY_G  # 3735

# ---------------------------------------------------------------------------
# YCrCb (BT.601), 14-bit fixed point deltas
# ---------------------------------------------------------------------------

YCRCB_SHIFT = 14
YCRCB_YR = 4899  # 0.299 * 2^14
YCRCB_YG = 9617  # 0.587 * 2^14
YCRCB_YB = 1868  # 0.114 * 2^14
YCRCB_CR = 11682  # 0.713 * 2^14
YCRCB_CB = 9241  # 0.564 * 2^14

# ---------------------------------------------------------------------------
# HSV, 12-bit reciprocal tables
# ---------------------------------------------------------------------------

HSV_SHIFT = 12


def _build_hsv_tables() -> tuple[np.ndarray, np.ndarray]:
    i = np.arange(256, dtype=np.float64)
    hdiv = np.zeros(256, np.int32)
    sdiv = np.zeros(256, np.int32)
    hdiv[1:] = np.floor((180 << HSV_SHIFT) / (6.0 * i[1:]) + 0.5).astype(np.int32)
    sdiv[1:] = np.floor((255 << HSV_SHIFT) / (1.0 * i[1:]) + 0.5).astype(np.int32)
    return hdiv, sdiv


HSV_HDIV_TABLE, HSV_SDIV_TABLE = _build_hsv_tables()

# ---------------------------------------------------------------------------
# LAB, 12-bit XYZ + 15-bit f() tables
# ---------------------------------------------------------------------------

LAB_SHIFT = 12
LAB_GAMMA_SHIFT = 3
LAB_SHIFT2 = LAB_SHIFT + LAB_GAMMA_SHIFT  # 15
LAB_CBRT_TAB_SIZE = 256 * 3 // 2 * (1 << LAB_GAMMA_SHIFT)  # 3072

# D65 whitepoint and the sRGB->XYZ matrix (rows scaled by 1/whitepoint).
_SRGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
_D65 = np.array([0.950456, 1.0, 1.088754])


def _build_lab_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    # sRGB gamma: u8 -> linear in [0, 255 * 2^gamma_shift]
    x = np.arange(256, dtype=np.float64) / 255.0
    linear = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.round(255 * (1 << LAB_GAMMA_SHIFT) * linear).astype(np.int32)

    # f(t) table over scaled XYZ; cbrt in float32 to match OpenCV's softfloat
    # build (float64 cbrt flips ~0.01% of a/b by one).
    t = np.arange(LAB_CBRT_TAB_SIZE, dtype=np.float64) / (
        255.0 * (1 << LAB_GAMMA_SHIFT)
    )
    cbrt32 = np.cbrt(t.astype(np.float32)).astype(np.float64)
    fvals = np.where(t < 0.008856, t * 7.787 + 16.0 / 116.0, cbrt32)
    cbrt_tab = np.round((1 << LAB_SHIFT2) * fvals).astype(np.int32)

    coeffs = np.round((_SRGB2XYZ / _D65[:, None]) * (1 << LAB_SHIFT)).astype(
        np.int32
    )
    return gamma_tab, cbrt_tab, coeffs


LAB_GAMMA_TABLE, LAB_CBRT_TABLE, LAB_XYZ_COEFFS = _build_lab_tables()
LAB_L_SCALE = (116 * 255 + 50) // 100  # 296
LAB_L_SHIFT = -((16 * 255 * (1 << LAB_SHIFT2) + 50) // 100)

# ---------------------------------------------------------------------------
# LUV constants (float path; tolerance-matched, not bit-exact)
# ---------------------------------------------------------------------------

# u' v' of the D65 whitepoint
_LUV_UN = 4.0 * _D65[0] / (_D65[0] + 15.0 * _D65[1] + 3.0 * _D65[2])
_LUV_VN = 9.0 * _D65[1] / (_D65[0] + 15.0 * _D65[1] + 3.0 * _D65[2])
LUV_UN = float(_LUV_UN)
LUV_VN = float(_LUV_VN)

# sRGB linearization as float table (for LUV / float LAB paths)
_x = np.arange(256, dtype=np.float64) / 255.0
SRGB_LINEAR_TABLE_F32 = np.where(
    _x <= 0.04045, _x / 12.92, ((_x + 0.055) / 1.055) ** 2.4
).astype(np.float32)
SRGB2XYZ_D65 = _SRGB2XYZ.astype(np.float32)
D65_WHITEPOINT = _D65.astype(np.float32)

"""The Bayer decode's host tables and develop matrix, on the host.

Copies of the pieces of the JAX package's `ref/demosaic.py` that the
port's Bayer outputs need: the BYR4 decode's log-to-linear table, the 1D
develop's curve tables (float32 on the host, as the reference builds
them), the develop matrix composition, the YUY2 output's row parity and
its RGB->YUV coefficients.  The device chain that uses them is
`ops.demosaic`.
"""

from __future__ import annotations

import numpy as np

from cineform_tpu_torch.ref.intra import byr4_log90_curve

#: the LOG-90 curve's base, the one curve the decoder's tables take
CURVE_BASE = 90.0


def log2lin_lut() -> np.ndarray:
    """BYR4LinearRestore: 16384-entry log-to-linear LUT of the LOG-90
    curve (decoder.c:10742-10785 with CURVE_LOG2LIN's float truncation)."""
    j = np.arange(16384, dtype=np.float64)
    i32 = (j.astype(np.float32) / np.float32(16384.0)).astype(np.float64)
    lin = (np.power(CURVE_BASE, i32) - 1.0) / (CURVE_BASE - 1.0)
    val = (lin.astype(np.float32) * np.float32(65535.0)).astype(np.float32)
    return np.clip(np.trunc(val).astype(np.int64), 0, 65535).astype(np.uint16)


def curve2linear_lut() -> np.ndarray:
    """decoder->Curve2Linear (Build1DCurves2Linear, bayer.c:5196-5262):
    49152-entry signed 13-bit curve-to-linear table over [-2, +4)."""
    k = np.arange(-16384, 32768, dtype=np.float64)
    i32 = (k.astype(np.float32) / np.float32(8192.0)).astype(np.float64)
    lin = (np.power(CURVE_BASE, i32) - 1.0) / (CURVE_BASE - 1.0)
    val = (lin.astype(np.float32) * np.float32(8192.0)).astype(np.float32)
    return np.clip(np.trunc(val).astype(np.int64), -16384, 32767)


def linear2curve_lut() -> np.ndarray:
    """decoder->Linear2CurveRed (Build1DLinear2Curves, bayer.c:5289-5527,
    cg-unity branch): 65536-entry signed 13-bit linear-to-curve table
    over [-2, +6)."""
    j = np.arange(65536, dtype=np.float64)
    intensity = (j - 16384.0).astype(np.float32)
    x = (intensity / np.float32(8192.0)).astype(np.float64)
    x = x.astype(np.float32).astype(np.float64)
    b = CURVE_BASE
    pos = np.log10(np.maximum(x, 0) * (b - 1.0) + 1.0) / np.log10(b)
    neg = -np.log10(np.maximum(-x, 0) * (b - 1.0) + 1.0) / np.log10(b)
    cur = np.where(x >= 0.0, pos, neg).astype(np.float32)
    val = (cur * np.float32(8192.0)).astype(np.float32)
    return np.clip(np.trunc(val).astype(np.int64), -16384, 32767)


def normalize_white_balance(wb) -> np.ndarray:
    """The reference's white-balance conditioning (bayer.c:4395-4427):
    floor gains at 0.4 and cap at 10.0 (the renormalize-below-1.0 block
    is compiled out with `#if 0`)."""
    wb = np.maximum(np.asarray(wb, np.float64)[:3], 0.4)
    return np.minimum(wb, 10.0)


def compose_develop_matrix(colm=None, saturation: float = 1.0,
                           exposure: float = 1.0, wb=None) -> np.ndarray:
    """NeedCube's linear matrix composition (bayer.c:4431-4530), float32:

    - start from COLM (use_base_matrix defaults to the custom matrix) or
      identity
    - saturation blends toward the desat / fullsat matrices
      (sat = SATU payload; <1 desaturates, >1 amplifies via
      ((sat-1)/3)*fullsat + ((4-sat)/3)*m)
    - exposure scales every column
    - white balance scales column j by wb[j] and the offset of row j by
      wb[j]
    """
    m = np.eye(3, 4, dtype=np.float32) if colm is None else \
        np.asarray(colm, np.float32).reshape(3, 4).copy()
    sat = np.float32(saturation)
    if sat != np.float32(1.0):
        desat = np.array([[0.309, 0.609, 0.082]] * 3, np.float32)
        fullsat = np.array([[4.042, -2.681, -0.361],
                            [-1.358, 2.719, -0.361],
                            [-1.358, -2.681, 5.039]], np.float32)
        if sat < 1.0:
            m[:, :3] = ((np.float32(1.0) - sat) * desat
                        + sat * m[:, :3]).astype(np.float32)
        else:
            m[:, :3] = (((sat - np.float32(1.0)) / np.float32(3.0)) * fullsat
                        + ((np.float32(4.0) - sat) / np.float32(3.0))
                        * m[:, :3]).astype(np.float32)
    exp = np.float32(exposure)
    if exp != np.float32(1.0):
        m = (m * exp).astype(np.float32)
    if wb is not None:
        wbn = normalize_white_balance(wb).astype(np.float32)
        m[:, :3] = (m[:, :3] * wbn[None, :]).astype(np.float32)
        m[:, 3] = (m[:, 3] * wbn).astype(np.float32)
    return m.astype(np.float64)


# RGB -> YUV coefficient tables (bayer.c:446-469), 1.15 fixed point
_RGB2YUV_709 = ((0.183, 0.614, 0.062), (-0.101, -0.338, 0.439),
                (0.439, -0.399, -0.040))
_RGB2YUV_VS709 = ((0.213, 0.715, 0.072), (-0.117, -0.394, 0.511),
                  (0.511, -0.464, -0.047))


def bayer_yuyv_parity(height: int) -> np.ndarray:
    """Output-row dither parity for the Bayer YUY2 path: DemosaicRAW
    calls ConvertLinesToOutput(width*2, 2, y) once per MOSAIC row, so
    output row t uses lines = y + (t & 1) -> parity (t//2 + t%2) & 1."""
    t = np.arange(height)
    return ((t // 2) + (t & 1)) & 1


def log90_inverse_lut() -> np.ndarray:
    """The inverse of the LOG-90 encode curve on 12-bit values, as the JAX
    package's `intra_host.decode_sample_bayer` builds it: for each 12-bit
    curve value the largest 12-bit linear value that maps to it."""
    curve = byr4_log90_curve()
    inv = np.zeros(4096, np.int64)
    np.maximum.at(inv, np.clip(curve, 0, 4095), np.arange(1 << 14) >> 2)
    return inv

"""Host tables of the reference codec: the decoder's output dithers, the
BYR4 encode curve, the YUV->RGB multipliers of the 16-bit outputs and the
10-bit RGB formats' word layouts.

A copy of `decode_dither_rows`, `byr4_log90_curve`, `_yuv2rgb_coeffs`
with its two tables and `RGB10_INPUT_FORMATS` from the JAX package's
NumPy oracle (`ref/intra.py`), and `rg24_dither`, the table its
`intra_host._decode_sample_rg24` draws inline; the port's transform is
held against that oracle in the tests and keeps no copy of it.
"""

from __future__ import annotations

import numpy as np

from cineform_tpu_torch.utils.glibc_random import glibc_rand_sequence


def decode_dither_rows(height: int, frame_index: int = 0) -> np.ndarray:
    """Per-row output dither vectors replicating the reference decoder.

    `InvertHorizontalStrip16sToYUYV` draws 16 `rand()&1` bits per output
    row (two 8-lane SSE rounding vectors, InvertHorizontalStrip16s.c:3869)
    from glibc's default-seed rand().  The decoder emits the two border
    strips first, so the draw blocks land on rows in the order
    [0, 1, H-2, H-1, 2, 3, ..., H-3] (pinned against the reference binary).
    Returns (height, 16) bits; lanes 0-7 = rounding1, 8-15 = rounding2.
    frame_index selects the draw window for the n-th decoded frame of one
    decoder process.
    """
    draws = (glibc_rand_sequence(16 * height * (frame_index + 1)) & 1)
    draws = draws[16 * height * frame_index:].reshape(height, 16)
    row_draws = np.empty((height, 16), dtype=np.int64)
    order = [0, 1, height - 2, height - 1] + list(range(2, height - 2))
    for blk, r in enumerate(order):
        row_draws[r] = draws[blk]
    return row_draws


def rg24_dither(width: int, height: int) -> np.ndarray:
    """The RG24 output's per-pixel dither of a 4:2:2 frame: glibc rand() &
    0x7FFF, one draw a pixel, the rows filled in the decoder's
    border-strips-first order [0, 1, H-2, H-1, 2, ..., H-3], as the JAX
    package's `intra_host._decode_sample_rg24` lays them.  (H, W) int32."""
    draws = (glibc_rand_sequence(width * height) & 0x7FFF).astype(np.int32)
    order = [0, 1, height - 2, height - 1] + list(range(2, height - 2))
    out = np.empty((height, width), np.int32)
    out[order] = draws.reshape(height, width)
    return out


def byr4_log90_curve() -> np.ndarray:
    """The default BYR4 encode curve (LOG 90): 14-bit linear -> 12-bit log.

    `Codec/frame.c:5218-5237` BYR4_LOGTABLE with MAX_INPUT_PRECISION=14
    (`frame.c:4843`); float32 division and final multiply match the
    reference build bit for bit.
    """
    i = np.arange(1 << 14)
    x = i.astype(np.float32) / np.float32(16384.0)
    l2l = (np.log10(x.astype(np.float64) * 89.0 + 1.0)
           / np.log10(90.0)).astype(np.float32)
    return np.where(i == 0, 0, (l2l * np.float32(4095.0)).astype(np.int64))


#: CG YUV->RGB multipliers at 13-bit fixed point, exactly as the
#: reference computes them: float32 products plus the TWEAK_YUV2RGB
#: per-coefficient adjustments (`PlanarYUV16toPlanarRGB16`,
#: `Codec/RGB2YUV.c:40-57,1824-1846`).  Tweak order:
#: [y_offset, ymult, r_vmult, g_vmult, g_umult, b_umult, u_off, v_off]
def _yuv2rgb_coeffs(ry, rv, gv, gu, bu, tweak):
    f = np.float32
    return {
        "y_offset": 2048 + tweak[0],
        "ymult": int(f(8192) * f(ry)) + tweak[1],
        "r_vmult": int(f(8192) * f(rv)) + tweak[2],
        "g_vmult": int(f(8192) * f(gv)) + tweak[3],
        "g_umult": int(f(8192) * f(gu)) + tweak[4],
        "b_umult": int(f(8192) * f(bu)) + tweak[5],
        "u_offset": (1 << 14) + tweak[6],
        "v_offset": (1 << 14) + tweak[7],
    }


_YUV2RGB_CG709 = _yuv2rgb_coeffs(1.164, 1.793, 0.534, 0.213, 2.115,
                                 (-32, 11, 6, -17, -6, 0, 22, 22))
_YUV2RGB_CG601 = _yuv2rgb_coeffs(1.164, 1.596, 0.813, 0.391, 2.018,
                                 (-28, 14, 6, 1, 7, 3, 23, 23))


RGB10_INPUT_FORMATS = {
    # fourcc -> (INPUT_FORMAT code, byteswap, (r_shift, g_shift, b_shift))
    "r210": (123, True, (20, 10, 0)),
    "DPX0": (128, True, (22, 12, 2)),
    "RG30": (122, False, (0, 10, 20)),
    "AB10": (125, False, (0, 10, 20)),
    "AR10": (124, False, (20, 10, 0)),
}

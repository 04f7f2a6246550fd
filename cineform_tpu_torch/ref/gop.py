"""Host tables of the two-frame GOP (FIELDPLUS) transform: the band scales
and quantizers, the prescale table, and the interlaced output dither.

A copy of `fieldplus_band_scales`, `fieldplus_band_quant` and
`FIELDPLUS_PRESCALE` from the JAX package's NumPy model (`ref/gop.py`),
and of the interlaced draw blocks of its `models/gop_host.decode_group`.
The port's transform is held against that model in the tests and keeps
no copy of it.

Wavelet forest per channel (`Codec/encoder.c:8431`, progressive input):
w0, w1 the level-1 spatial wavelets of frames 0 and 1; w2 the 2-2
temporal wavelet between their lowpass bands (not coded); w3 the spatial
wavelet of the temporal high, all four bands coded (the LL with quantizer
1); w4 that of the temporal low, with prescale 2; w5 that of w4's LL,
whose LL is the sample's lowpass.
"""

from __future__ import annotations

import numpy as np

from cineform_tpu_torch.spec.production import quality_tables
from cineform_tpu_torch.utils.glibc_random import glibc_rand_sequence


def fieldplus_band_scales() -> dict:
    """Display scales per wavelet (`SetTransformScale` FIELDPLUS case),
    confirmed against golden sample headers."""
    return {
        0: [4, 2, 2, 1],          # frame wavelets
        1: [4, 2, 2, 1],
        2: [8, 4],                # temporal
        3: [16, 8, 8, 4],         # spatial of temporal high
        4: [32, 16, 16, 8],       # spatial of temporal low
        5: [128, 64, 64, 32],     # deepest spatial
    }


def fieldplus_band_quant(quality: int, precision: int, channel: int,
                         progressive: bool = True) -> dict:
    """Per-wavelet band quantizers for the FIELDPLUS transform.

    `SetTransformQuantization` (`Codec/quantize.c:3355+`, FIELDPLUS case):
    spatial wavelets use table[sb] * scale[band] >> 2; the temporal-high
    spatial's LL is forced to 1 (`encoder.c:8524`); the frame wavelets use
    table[sb] directly (progressive).  For interlaced input the w0/w1
    quantizers are LH = t*3/2, HL = t*2/3, HH = t."""
    luma, chroma = quality_tables(quality, precision, gop_length=2)
    t = chroma if channel > 0 else luma
    s = fieldplus_band_scales()

    def frame_q(base: int) -> tuple:
        if progressive:
            return tuple(t[base + b] for b in range(3))
        return ((t[base] * 3) >> 1, (t[base + 1] * 2) // 3, t[base + 2])

    return {
        5: tuple((t[1 + b] * s[5][1 + b]) >> 2 for b in range(3)),
        4: tuple((t[4 + b] * s[4][1 + b]) >> 2 for b in range(3)),
        3: (1,) + tuple((t[8 + b] * s[3][1 + b]) >> 2 for b in range(3)),
        1: frame_q(11),
        0: frame_q(14),
    }


FIELDPLUS_PRESCALE = [0, 0, 0, 0, 2, 0]   # per wavelet index, 10-bit


def interlaced_dither_rows(height: int, frame_index: int = 0) -> np.ndarray:
    """The interlaced group output's dither: 16 `rand() & 1` draws per
    output row pair, pairs in linear order (`InvertInterlacedRow16s10bitToYUV`,
    `Codec/temporal.c:5994`); the n-th decoded frame of one decoder process
    takes window n.  Returns (height // 2, 16) bits."""
    pairs = height // 2
    seq = glibc_rand_sequence(16 * pairs * (frame_index + 1)) & 1
    return seq[16 * pairs * frame_index:].reshape(pairs, 16)

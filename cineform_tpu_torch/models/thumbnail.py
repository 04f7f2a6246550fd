"""Thumbnail extraction straight from the encoded lowpass band.

A copy of the JAX package's `models/thumbnail.py`.
Mirrors `GenerateThumbnail` (`Codec/thumbnail.c:65-230`): parse the sample
header only, read the raw 16-bit lowpass planes of each channel, shift to
10-bit, convert YUV -> RGB with the BT.709 integer matrix and pack as
big-endian DPX0 10:10:10:2 words — no wavelet inverse at all.
"""

from __future__ import annotations

import numpy as np

from cineform_tpu_torch.bitstream import parse_sample


def extract(sample: bytes) -> tuple[int, int, bytes]:
    """Returns (width, height, packed DPX0 bytes), width = frame/8."""
    s = parse_sample(sample)
    y = s.channels[0].lowpass
    v = s.channels[1].lowpass  # Cr (channel order Y, V, U)
    u = s.channels[2].lowpass  # Cb
    height, width = y.shape

    shift = 4  # intra frame (`thumbnail.c:190-195`)
    y10 = ((y >> shift) & 0x3FF) - 64
    cr = ((v >> shift) & 0x3FF) - 0x200
    cb = ((u >> shift) & 0x3FF) - 0x200

    # expand 4:2:2 chroma across luma pairs
    cr2 = np.repeat(cr, 2, axis=1)[:, :width]
    cb2 = np.repeat(cb, 2, axis=1)[:, :width]

    r = (1192 * y10 + 1836 * cr2) >> 10
    g = (1192 * y10 - 547 * cr2 - 218 * cb2) >> 10
    b = (1192 * y10 + 2166 * cb2) >> 10
    r = np.clip(r, 0, 0x3FF)
    g = np.clip(g, 0, 0x3FF)
    b = np.clip(b, 0, 0x3FF)
    rgb = ((r.astype(np.uint32) << 22) | (g.astype(np.uint32) << 12)
           | (b.astype(np.uint32) << 2))
    return width, height, rgb.astype(">u4").tobytes()

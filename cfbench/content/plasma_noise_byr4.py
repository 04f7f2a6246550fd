"""BYR4 mosaics (16-bit little-endian, rows R G / G B): the gradient of
`testframes.byr4_frame`, frame i rolled by an even number of rows near
i / N of the height (the CFA phase kept), plus `noise_bits` of noise a
site.  The seed draws the noise and the frames' order; the rolls are the
same for every seed."""

import numpy as np

from cfbench.content import noise, rng


def make(cfg: dict, seed: int) -> np.ndarray:
    w, h, n = cfg["width"], cfg["height"], cfg["frames"]
    mask = (1 << cfg["noise_bits"]) - 1
    xg, yg = np.meshgrid(np.arange(w), np.arange(h))
    base = (((xg * 9 + yg * 13) << 5) & 0xFFFF).astype(np.uint16)
    g = rng(seed)
    order = g.permutation(n)
    frames = np.empty((n, h, 2 * w), np.uint8)
    for i in range(n):
        roll = 2 * (int(order[i]) * (h // 2) // n)
        mosaic = np.roll(base, roll, axis=0) + noise(g, base.shape, "<u2",
                                                     mask)
        frames[i] = mosaic.astype("<u2").view(np.uint8)
    return frames

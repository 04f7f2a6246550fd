"""YUY2 frame pairs of a slow pan, the groups of a 2-frame-GOP clip:
(frames / 2, 2, H, row bytes) uint8.

Frame 0 of group g is `plasma_noise_yuy2`'s pattern-1 frame rolled by
g / G of the height (G groups); frame 1 is the same frame rolled 4 rows
further.  Each frame has its own `noise_bits` of noise on every
component, drawn from the seed; the rolls, and so the groups' order, are
the same for every seed."""

import numpy as np

from cfbench.content import noise, plasma_noise_yuy2, rng

#: rows the picture moves from frame 0 to frame 1 of a group
PAN_ROWS = 4


def make(cfg: dict, seed: int) -> np.ndarray:
    w, h, n = cfg["width"], cfg["height"], cfg["frames"] // 2
    mask = (1 << cfg["noise_bits"]) - 1
    # the pattern-1 frame: one frame of that generator, unrolled and clean
    base = plasma_noise_yuy2.make(dict(cfg, frames=1, noise_bits=0), 0)[0]
    g = rng(seed)
    pairs = np.empty((n, 2, h, 2 * w), np.uint8)
    for i in range(n):
        for f in range(2):
            pairs[i, f] = (np.roll(base, i * h // n + PAN_ROWS * f, axis=0)
                           + noise(g, base.shape, np.uint8, mask))
    return pairs

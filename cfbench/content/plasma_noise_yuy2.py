"""YUY2 frames: the repo's pattern-1 test frame, vectorised and seeded.

The integer plasma gradient of `testframes.yuy2_frame` (the frame of the
reference SDK's 1080p golden), frame i rolled by i / N of the height,
plus `noise_bits` of noise on every component.  The seed draws the noise
and the frames' order; the rolls are the same for every seed."""

import numpy as np

from cfbench.content import noise, rng


def make(cfg: dict, seed: int) -> np.ndarray:
    w, h, n = cfg["width"], cfg["height"], cfg["frames"]
    mask = (1 << cfg["noise_bits"]) - 1
    xg, yg = np.meshgrid(np.arange(0, w, 2), np.arange(h))
    base = np.stack([((xg * 3 + yg * 7) >> 2) & 0xFF,
                     ((xg + yg) >> 3) & 0xFF,
                     (((xg + 1) * 3 + yg * 7) >> 2) & 0xFF,
                     ((xg * 2 - yg) >> 3) & 0xFF], -1).astype(np.uint8)
    g = rng(seed)
    order = g.permutation(n)
    frames = np.empty((n, h, 2 * w), np.uint8)
    for i in range(n):
        roll = int(order[i]) * h // n
        frames[i] = (np.roll(base, roll, axis=0)
                     + noise(g, base.shape, np.uint8, mask)).reshape(h, 2 * w)
    return frames

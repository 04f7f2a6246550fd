"""Synthetic YUY2 test frames, for checks and benchmarks of the port.

A copy of `yuy2_frame` from the JAX package's `utils/testframes.py`,
mirrored in tools/probe_sample.c (integer plasma gradient + xorshift32
noise), so that golden samples are reproducible: the 1080p golden
`tests/golden/samples/s_1920x1080_q6_p1.cfhd` is its pattern 1 encoded by
the reference SDK.
"""

from __future__ import annotations

import numpy as np


def _xorshift32_stream(seed: int, count: int) -> np.ndarray:
    out = np.empty(count, dtype=np.uint32)
    x = seed & 0xFFFFFFFF
    for i in range(count):
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        out[i] = x
    return out


def yuy2_frame(width: int, height: int, pattern: int = 0) -> bytes:
    """Deterministic YUY2 frame (matches tools/probe_sample.c fill_yuy2)."""
    xs = np.arange(0, width, 2)
    ys = np.arange(height)
    xg, yg = np.meshgrid(xs, ys)
    l0 = ((xg * 3 + yg * 7) >> 2) & 0xFF
    l1 = (((xg + 1) * 3 + yg * 7) >> 2) & 0xFF
    cb = ((xg + yg) >> 3) & 0xFF
    cr = ((xg * 2 - yg) >> 3) & 0xFF
    if pattern > 0:
        r = _xorshift32_stream(0x12345 + pattern, height * (width // 2)).reshape(
            height, width // 2).astype(np.int64)
        l0 = (l0 + (r & 7)) & 0xFF
        l1 = (l1 + ((r >> 3) & 7)) & 0xFF
        cb = (cb + ((r >> 6) & 7)) & 0xFF
        cr = (cr + ((r >> 9) & 7)) & 0xFF
    quad = np.stack([l0, cb, l1, cr], axis=-1).astype(np.uint8)
    return quad.tobytes()

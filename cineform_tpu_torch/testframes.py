"""Synthetic test frames, for checks and benchmarks of the port.

A copy of `yuy2_frame`, `rg48_frame` and `b64a_frame` from the JAX
package's `utils/testframes.py`, mirrored in tools/probe_sample.c (integer
plasma gradient + xorshift32 noise), so that golden samples are
reproducible: the 1080p golden `tests/golden/samples/s_1920x1080_q6_p1.cfhd`
is `yuy2_frame` pattern 1 encoded by the reference SDK, and
`rg48_320x240_q4_p1.cfhd` and `b64a_320x240_q4_p1.cfhd` are the RGB ones'.
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


def rg48_frame(width: int, height: int, pattern: int = 0) -> bytes:
    """Deterministic RG48 frame (matches probe do_encode_rg48)."""
    xg, yg = np.meshgrid(np.arange(width), np.arange(height))
    r = ((xg * 23 + yg * 7) << 4) & 0xFFFF
    g = ((xg * 11 + yg * 17) << 4) & 0xFFFF
    b = ((xg * 5 + yg * 31) << 4) & 0xFFFF
    if pattern > 0:
        s = _xorshift32_stream(0xABCDE + pattern, height * width).reshape(
            height, width).astype(np.int64)
        r = (r + (s & 1023)) & 0xFFFF
        g = (g + ((s >> 10) & 1023)) & 0xFFFF
        b = (b + ((s >> 20) & 1023)) & 0xFFFF
    return np.stack([r, g, b], axis=-1).astype("<u2").tobytes()


def b64a_frame(width: int, height: int, pattern: int = 0) -> bytes:
    """Deterministic b64a frame (big-endian ARGB; matches probe)."""
    rgb = np.frombuffer(rg48_frame(width, height, pattern), "<u2").reshape(
        height, width, 3).astype(np.int64)
    xg, yg = np.meshgrid(np.arange(width), np.arange(height))
    a = (0xFFFF - ((xg + yg) & 0xFF)) & 0xFFFF
    argb = np.stack([a, rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]], axis=-1)
    return argb.astype(">u2").tobytes()

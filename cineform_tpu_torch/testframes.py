"""Synthetic test frames, for checks and benchmarks of the port.

A copy of `components10`, `yuy2_frame`, `v210_frame`, `yu64_frame`,
`rg48_frame`, `b64a_frame` and `byr4_frame` from the JAX package's
`utils/testframes.py`, mirrored in tools/probe_sample.c (integer plasma
gradient + xorshift32 noise), so that golden samples are reproducible: the
1080p golden `tests/golden/samples/s_1920x1080_q6_p1.cfhd` is `yuy2_frame`
pattern 1 encoded by the reference SDK, and the 320x240 quality-4 goldens
`<format>_320x240_q4_p1.cfhd` are pattern 1 of each format's frame.  Also
`uyvy_frame`, the YUY2 frame in UYVY byte order (the frame of
`uyvy_320x240_q4_p1.cfhd`), `raw_fill`, the probe's raw fill, which
`raw_RG64.cfhd` and `raw_BYR5.cfhd` encode, and `plasma_noise_frames`,
rolled copies of the plasma gradient with seeded noise.
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


def plasma_noise_frames(width: int, height: int, rolls, seed: int
                        ) -> np.ndarray:
    """(len(rolls), height, 2 * width) uint8 YUY2 frames: `yuy2_frame`'s
    plasma gradient (pattern 0) rolled down by each of `rolls` rows, plus
    3 bits of noise on every component from `seed`.  The gradient wraps,
    so a roll puts sharp edges inside the bands: dense chunks in sparse
    bands, as in the benchmark's encode content."""
    base = np.frombuffer(yuy2_frame(width, height), np.uint8).reshape(
        height, 2 * width)
    g = np.random.default_rng(seed)
    return np.stack([np.roll(base, r, axis=0)
                     + (g.integers(0, 256, base.shape, dtype=np.uint8) & 7)
                     for r in rolls])


def uyvy_frame(width: int, height: int, pattern: int = 0) -> bytes:
    """`yuy2_frame` in UYVY byte order (U Y0 V Y1)."""
    quad = np.frombuffer(yuy2_frame(width, height, pattern),
                         np.uint8).reshape(-1, 4)
    return quad[:, [1, 0, 3, 2]].tobytes()


def components10(width: int, height: int, pattern: int = 0):
    """Deterministic 10-bit Y/Cb/Cr planes (matches probe
    fill_components10)."""
    xs = np.arange(0, width, 2)
    ys = np.arange(height)
    xg, yg = np.meshgrid(xs, ys)
    y0 = ((xg * 13 + yg * 29) >> 1) & 0x3FF
    y1 = (((xg + 1) * 13 + yg * 29) >> 1) & 0x3FF
    cb = (512 + ((xg - yg) >> 2)) & 0x3FF
    cr = (512 + ((xg // 2 + yg) >> 2)) & 0x3FF
    if pattern > 0:
        r = _xorshift32_stream(0x54321 + pattern, height * (width // 2))
        r = r.reshape(height, width // 2).astype(np.int64)
        y0 = (y0 + (r & 31)) & 0x3FF
        y1 = (y1 + ((r >> 5) & 31)) & 0x3FF
        cb = (cb + ((r >> 10) & 31)) & 0x3FF
        cr = (cr + ((r >> 15) & 31)) & 0x3FF
    y = np.empty((height, width), np.int32)
    y[:, 0::2] = y0
    y[:, 1::2] = y1
    return y, cb.astype(np.int32), cr.astype(np.int32)


def v210_frame(width: int, height: int, pattern: int = 0) -> bytes:
    """Deterministic v210 frame (matches probe do_encode_v210)."""
    y, cb, cr = components10(width, height, pattern)
    pitch = ((width + 47) // 48) * 128
    ngroups = (width + 5) // 6
    ypad = np.zeros((height, 6 * ngroups), np.uint32)
    upad = np.zeros((height, 3 * ngroups), np.uint32)
    vpad = np.zeros((height, 3 * ngroups), np.uint32)
    ypad[:, :width] = y
    upad[:, :width // 2] = cb
    vpad[:, :width // 2] = cr
    g = np.zeros((height, ngroups, 4), np.uint32)
    g[..., 0] = upad[:, 0::3] | (ypad[:, 0::6] << 10) | (vpad[:, 0::3] << 20)
    g[..., 1] = ypad[:, 1::6] | (upad[:, 1::3] << 10) | (ypad[:, 2::6] << 20)
    g[..., 2] = vpad[:, 1::3] | (ypad[:, 3::6] << 10) | (upad[:, 2::3] << 20)
    g[..., 3] = ypad[:, 4::6] | (vpad[:, 2::3] << 10) | (ypad[:, 5::6] << 20)
    rows = np.zeros((height, pitch // 4), dtype="<u4")
    rows[:, :4 * ngroups] = g.reshape(height, 4 * ngroups)
    return rows.tobytes()


def yu64_frame(width: int, height: int, pattern: int = 0) -> bytes:
    """Deterministic YU64 frame (matches probe do_encode_yu64)."""
    y, cb, cr = components10(width, height, pattern)
    buf = np.zeros((height, width * 2), dtype="<u2")
    buf[:, 0::4] = y[:, 0::2] << 6
    buf[:, 1::4] = cb << 6
    buf[:, 2::4] = y[:, 1::2] << 6
    buf[:, 3::4] = cr << 6
    return buf.tobytes()


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


def byr4_frame(width: int, height: int, pattern: int = 0) -> bytes:
    """Deterministic BYR4 mosaic (matches probe do_encode_byr4)."""
    xg, yg = np.meshgrid(np.arange(width), np.arange(height))
    v = ((xg * 9 + yg * 13) << 5) & 0xFFFF
    if pattern > 0:
        s = _xorshift32_stream(0xBEEF0 + pattern, height * width).reshape(
            height, width).astype(np.int64)
        v = (v + (s & 2047)) & 0xFFFF
    return v.astype("<u2").tobytes()


def raw_fill(nbytes: int, pattern: int) -> bytes:
    """The probe's xorshift32 fill of a raw frame (tools/probe_sample.c
    do_encode_raw)."""
    return _xorshift32_stream(0x77777 + pattern,
                              nbytes // 4).astype("<u4").tobytes()

"""Host tables of the reference codec: the decoder's output dither and
the BYR4 encode curve.

A copy of `decode_dither_rows` and `byr4_log90_curve` from the JAX
package's NumPy oracle (`ref/intra.py`); the port's transform is held
against that oracle in the tests and keeps no copy of it.
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

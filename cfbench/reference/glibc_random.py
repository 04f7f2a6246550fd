"""Bit-exact model of glibc's rand() (TYPE_3 additive feedback generator).

A copy of the JAX package's `utils/glibc_random.py`: the reference
decoder's output dither draws from this sequence.

The reference's WaveletDemo injects noise into the low bits of 8-bit test
images via unseeded `rand()` (`Example/WaveletDemo/utils.c:601`).  Its PSNR
gate (54.386 dB on data/testpatt.pgm, reference README.md:103-112) therefore
depends on glibc's deterministic default-seed sequence; this model reproduces
it so our golden tests can hit the same number.
"""

from __future__ import annotations

import numpy as np


def glibc_rand_sequence(n: int, seed: int = 1) -> np.ndarray:
    """First n outputs of glibc rand() with the given seed."""
    r = np.zeros(344 + n, dtype=np.uint64)
    # glibc __srandom_r keeps the seed in a SIGNED 32-bit word and runs
    # Schrage's method with C truncating division (matters for seeds
    # >= 2^31, which appear e.g. in the uncompressed-frame decision,
    # `Codec/encoder.c:2006` srand(first frame word))
    word = seed & 0xFFFFFFFF
    if word == 0:
        word = 1  # glibc __srandom_r: "seed == 0 would produce all zeros"
    if word >= 1 << 31:
        word -= 1 << 32
    r[0] = np.uint64(word & 0xFFFFFFFF)
    for i in range(1, 31):
        q = int(word / 127773) if word >= 0 else -((-word) // 127773)
        lo = word - q * 127773
        word = 16807 * lo - 2836 * q
        if word < 0:
            word += 2147483647
        r[i] = word
    for i in range(31, 34):
        r[i] = r[i - 31]
    out = np.empty(n, dtype=np.int64)
    mask = np.uint64(0xFFFFFFFF)
    for i in range(34, 344 + n):
        r[i] = (r[i - 31] + r[i - 3]) & mask
        if i >= 344:
            out[i - 344] = int(r[i] >> np.uint64(1))
    return out

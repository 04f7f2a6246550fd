"""Quantization + cubic companding contract.

Dead-zone quantizer with "midpoint prequant" (reference
`Example/WaveletDemo/utils.c:29-131`, production `Codec/quantize.c`):

    multiplier = 65536 // q
    midpoint   = max(q // 2 - 1, 0)
    code       = sign(v) * (((|v| + midpoint) * multiplier) >> 16)

followed by cubic companding of the magnitude into an 8-bit code
(`utils.c:617-640`; production folds the inverse into the decoder FSM tables,
`Codec/codebooks.c` ScaleFSM, `_COMPANDING_MORE` in `Codec/vlc.h:33`):

    companded(i) = i + 3*i^3 / 2^16           (demo model, i in 0..255)

The forward map takes a quantized magnitude (0..1024) to the largest i whose
companded value is <= mag; the inverse maps a code to the largest magnitude
with that code.  `ops/quant.py` computes both arithmetically, as the JAX
ops do, so no table is copied here.
"""

from __future__ import annotations


def quant_multiplier(q: int) -> int:
    """Fixed-point reciprocal used by the quantizer (`utils.c:93`)."""
    return (1 << 16) // q


def quant_midpoint(q: int) -> int:
    """Dead-zone midpoint offset (`utils.c:94-95`)."""
    return max((q >> 1) - 1, 0)


def demo_quant_tables(bitdepth: int = 12) -> tuple[list[int], list[int]]:
    """Per-level (qh, qv, qd) quant divisors + lowpass prescale shifts.

    From `Example/WaveletDemo/wavelets.c:49-68`.  Returns
    (quant_subband flat list of 3 per level, prescale per level).
    """
    if bitdepth in (8, 9):
        return ([8, 8, 12, 16, 16, 12] + [48, 48, 24] * 5, [0, 0, 2, 2, 2, 2, 2])
    if bitdepth == 10:
        return ([24, 24, 36, 12, 12, 6] + [48, 48, 24] * 5, [0, 1, 2, 2, 2, 2, 2])
    if bitdepth == 11:
        return ([24, 24, 36, 24, 24, 36] + [48, 48, 24] * 5, [1, 2, 2, 2, 2, 2, 2])
    if bitdepth == 12:
        return ([48, 48, 72] + [48, 48, 24] * 6, [1, 2, 2, 2, 2, 2, 2])
    if bitdepth == 13:
        return ([48, 48, 72] + [48, 48, 24] * 6, [2, 2, 2, 2, 2, 2, 2])
    return ([48, 48, 72] + [48, 48, 24] * 6, [2, 2, 2, 2, 2, 2, 2])

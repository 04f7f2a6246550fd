"""Multi-level transform pyramids (the demo's per-channel wavelet forest)
on a torch device: port of the JAX package's `ops/pyramid.py`.

The intra-frame ("SPATIAL") transform is 3 chained 2D 2-6 levels per
channel (`Codec/encoder.c:8688` FinishFrameTransformQuant): subbands 0 =
deepest LL, then per level (LH, HL, HH) from deepest to shallowest.
Subbands are kept as separate tensors, not the reference's packed
in-place quadrant layout.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from cineform_tpu_torch.ops import dwt, quant


class Pyramid(NamedTuple):
    """Quantized coefficient pyramid for one channel (intra transform).

    lowpass: deepest LL band (unquantized 16-bit, like the reference's raw
             lowpass subband 0, `Codec/encoder.c:4251`).
    highs:   tuple of (LH, HL, HH) triples, index 0 = deepest level.
    """

    lowpass: torch.Tensor
    highs: tuple  # ((lh, hl, hh), ...) deepest first


def forward_intra(x: torch.Tensor, levels: int, quant_table: Sequence[int],
                  prescale: Sequence[int]) -> Pyramid:
    """Forward intra pyramid with fused quantization of int32 `x` (...,
    H, W).

    quant_table: 3 entries per level (qh, qv, qd), level-1 (shallowest)
    first, the reference demo's order (`wavelets.c:49-68`).  prescale:
    per-level lowpass prescale shifts applied between levels."""
    ll = x
    highs_rev = []
    for level in range(levels):
        ll, lh, hl, hh = dwt.dwt2d_forward(ll)
        qh, qv, qd = quant_table[level * 3:level * 3 + 3]
        highs_rev.append((quant.quantize_band(lh, qh),
                          quant.quantize_band(hl, qv),
                          quant.quantize_band(hh, qd)))
        if level < levels - 1:
            ll = quant.prescale_lowpass(ll, -prescale[level])
    return Pyramid(lowpass=ll, highs=tuple(reversed(highs_rev)))


def inverse_intra(pyr: Pyramid, quant_table: Sequence[int],
                  prescale: Sequence[int], bitdepth: int,
                  dc_offset: int | None = None) -> torch.Tensor:
    """Inverse intra pyramid (dequantize and 2D inverse a level), clipped
    to `bitdepth` bits."""
    levels = len(pyr.highs)
    if dc_offset is None:
        dc_offset = 64 >> (bitdepth - 8)
    ll = pyr.lowpass + dc_offset
    for i, (lh, hl, hh) in enumerate(pyr.highs):
        level = levels - 1 - i  # quant-table index (shallowest = 0)
        if level < levels - 1:
            ll = quant.prescale_lowpass(ll, prescale[level])
        qh, qv, qd = quant_table[level * 3:level * 3 + 3]
        ll = dwt.dwt2d_inverse(ll, quant.dequantize_band(lh, qh),
                               quant.dequantize_band(hl, qv),
                               quant.dequantize_band(hh, qd))
    return ll.clamp(0, (1 << bitdepth) - 1)

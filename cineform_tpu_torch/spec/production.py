"""Production encoder parameters: quality -> per-band quantizers.

A copy of the JAX package's `spec/production.py`, cut to what the intra
codec's YUY2, RGB 4:4:4 and RGBA 4:4:4:4 paths need: the preset quality
tables with the 12-bit RGB gains, no custom quantization and no FILMSCAN
rate control.  It mirrors the reference's quality system for the shipping
encoder:

- base quality tables `LUMA_QUALITY_*` / `CHROMA_QUALITY_*`
  (`Codec/quantize.h:54-65`), indexed by the 17-subband FIELDPLUS layout;
- `QuantizationSetQuality` adjustments for quality factor and precision
  (`Codec/quantize.c:186-585`);
- `SetTransformScale` per-wavelet band scales (`Codec/wavelet.c:7022`);
- `SetTransformQuantization` subband quant computation
  (`Codec/quantize.c:2865-3360`);
- `SetTransformPrescale` per-wavelet lowpass prescale shifts
  (`Codec/wavelet.c:1710-1784`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

from cineform_tpu_torch.spec import tags

# Quality factor tables: index 0=default, 1=low, 2=medium, 3=high
# (`Codec/quantize.h:54-65`); 17 entries per row (FIELDPLUS subband layout).
LUMA_QUALITY = [
    [4, 4, 5, 5, 4, 5, 5, 9, 8, 8, 8, 4, 4, 4, 4, 4, 4],
    [4, 8, 8, 12, 8, 8, 12, 9, 12, 12, 16, 32, 32, 48, 32, 32, 48],
    [4, 6, 6, 8, 6, 6, 8, 5, 8, 8, 12, 16, 16, 24, 16, 16, 24],
    [4, 4, 4, 6, 4, 4, 6, 5, 8, 8, 8, 8, 8, 12, 8, 8, 12],
]
CHROMA_QUALITY = [
    [4, 4, 5, 5, 4, 5, 5, 9, 8, 8, 8, 8, 8, 8, 8, 8, 8],
    [4, 8, 8, 12, 8, 8, 12, 9, 12, 12, 16, 32, 32, 48, 32, 32, 48],
    [4, 6, 6, 8, 6, 6, 8, 5, 8, 8, 12, 16, 16, 32, 16, 16, 32],
    [4, 6, 6, 8, 6, 6, 8, 5, 8, 8, 8, 8, 8, 16, 8, 8, 16],
]

QUANT_SCALE_FACTOR = 2      # `Codec/quantize.h:52`


def quality_tables(quality: int, precision: int,
                   chroma_full_res: bool = False,
                   rgb_quality: int = 0) -> tuple[list[int], list[int]]:
    """17-entry (luma, chroma) quant tables after QuantizationSetQuality
    for a progressive intra frame on the first frame (the FILMSCAN rate
    limiter at its first-frame value: 8 for FILMSCAN2, 4 for FILMSCAN3,
    `Codec/quantize.c:224-233`).  `chroma_full_res` gives the chroma
    channels the luma table (4:4:4 RGB); at 12-bit precision the RGB gains
    of `rgb_quality` apply.

    quality: CFHD_ENCODING_QUALITY_* numeric (1=low .. 6=filmscan3).
    Mirrors `Codec/quantize.c:186-585` for the FixedQuality path with
    vbrscale=256 (no VBR feedback on the first frame)."""
    factor = quality & 0xFF
    new_quality = factor
    fs_rate_limiter = {5: 8, 6: 4}.get(new_quality, 0)
    if factor < 1 or factor > 10:
        factor = 0
    if factor > 3:
        factor = 3

    luma = list(LUMA_QUALITY[factor])
    chroma = list(LUMA_QUALITY[factor] if chroma_full_res
                  else CHROMA_QUALITY[factor])

    lowfreqquant = 4
    if precision >= tags.PRECISION_10BIT:
        scale = 4 * 16
        limiter = min(fs_rate_limiter, 16)
        if new_quality == 4:
            lowfreqquant = 3
            scale = 3 * 16
        elif new_quality >= 5:
            lowfreqquant = 2
            scale = 1 * 16 + limiter * 2
        if new_quality >= 5 and scale >= 4:
            scale >>= 1
        if new_quality >= 4:
            for i in range(1, 7):
                luma[i] = lowfreqquant
                chroma[i] = lowfreqquant
        for i in range(8, 17):
            luma[i] = max((luma[i] * scale) >> 4, 2)
            chroma[i] = max((chroma[i] * scale) >> 4, 2)
        luma[7] = 4
        chroma[7] = 4

    if precision == tags.PRECISION_12BIT:
        if new_quality >= 4:
            for i in range(1, 7):
                luma[i] = lowfreqquant
                chroma[i] = lowfreqquant
        for i in range(4, 7):
            luma[i] *= 4
            chroma[i] *= 4
        # chromagain by CFEncode_RGB_Quality bits (`quantize.c:1195-1200`)
        chromagain = {0: 8, 1: 6, 2: 4, 3: 4}[rgb_quality & 3]
        for i in range(11, 17):
            luma[i] *= 4
            chroma[i] *= chromagain

    # Intra: frame-wavelet subbands read table entries 11-13
    # (`Codec/quantize.c:548-565`)
    for t in (luma, chroma):
        t[7], t[8], t[9] = t[11], t[12], t[13]
    return luma, chroma


def spatial_band_scales(num_spatial: int = 2) -> list[list[int]]:
    """Per-wavelet [LL, LH, HL, HH] display scales for the intra transform.

    `SetTransformScale` TRANSFORM_TYPE_SPATIAL case (`Codec/wavelet.c:7049`):
    w[0] = [4, 2, 2, 1], each deeper spatial wavelet multiplies the lowpass
    scale by 4.
    """
    scales = [[4, 2, 2, 1]]
    for _ in range(num_spatial):
        low = scales[-1][0]
        scales.append([4 * low, 2 * low, 2 * low, low])
    return scales


def intra_band_quant(quality: int, precision: int, channel: int,
                     num_spatial: int = 2, chroma_full_res: bool = False,
                     rgb_quality: int = 0) -> list[tuple[int, int, int]]:
    """Per-wavelet (q_lh, q_hl, q_hh) quantizers for the intra transform,
    wavelet index 0 (finest, the frame wavelet) first.

    `SetTransformQuantization` TRANSFORM_TYPE_SPATIAL case
    (`Codec/quantize.c:3222-3355`) with vbrscale=256, midpoint_prequant=2:
      spatial wavelets (deepest first, subbands 1..3*num_spatial):
          quant = table[subband] * wavelet_scale[band] >> 2
      frame wavelet (subbands 3*num_spatial+1 ..):
          quant = table[subband]  (scale not applied)
    """
    luma, chroma = quality_tables(quality, precision, chroma_full_res,
                                  rgb_quality)
    table = chroma if channel > 0 else luma
    scales = spatial_band_scales(num_spatial)

    out: list[tuple[int, int, int] | None] = [None] * (num_spatial + 1)
    subband = 1
    for k in range(num_spatial, 0, -1):         # deepest spatial first
        s = scales[k]
        out[k] = tuple(
            (table[subband + b] * s[1 + b]) >> QUANT_SCALE_FACTOR
            for b in range(3)
        )
        subband += 3
    out[0] = tuple(table[subband + b] for b in range(3))
    return out  # type: ignore[return-value]


def intra_prescale(precision: int) -> list[int]:
    """Per-wavelet lowpass prescale shifts for the intra (SPATIAL) transform.

    `SetTransformPrescale` (`Codec/wavelet.c:1710-1784`): prescale[k] is the
    right-shift applied to wavelet k's *input*.
    """
    if precision <= tags.PRECISION_8BIT:
        return [0, 0, 0]
    if precision == tags.PRECISION_10BIT:
        return [0, 2, 0]
    return [0, 2, 2]


def pack_prescale_table(prescale: list[int]) -> int:
    """Pack prescale shifts into the PRESCALE_TABLE tag value
    (`Codec/codec.c:998-1001`): 2 bits per wavelet from bit 14 down."""
    value = 0
    for i, p in enumerate(prescale):
        value += p << (14 - i * 2)
    return value


@dataclass(frozen=True)
class IntraParams:
    """Everything the intra-frame encoder needs for one channel config:
    YUY2 is encoded at the reference's 10-bit precision, RGB and RGBA at
    12 bits."""

    width: int
    height: int
    quality: int
    precision: int = tags.PRECISION_10BIT
    chroma_full_res: bool = False
    rgb_quality: int = 0
    num_spatial: ClassVar[int] = 2

    @property
    def num_wavelets(self) -> int:
        return self.num_spatial + 1

    def band_quant(self, channel: int) -> list[tuple[int, int, int]]:
        return intra_band_quant(self.quality, self.precision, channel,
                                self.num_spatial, self.chroma_full_res,
                                self.rgb_quality)

    @property
    def prescale(self) -> list[int]:
        return intra_prescale(self.precision)

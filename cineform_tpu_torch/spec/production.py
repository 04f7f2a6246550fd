"""Production encoder parameters: quality -> per-band quantizers.

A copy of the JAX package's `spec/production.py`, cut to what the intra
codec's paths, the two-frame GOP codec and the API need: the preset
quality tables with the 12-bit RGB gains, the GOP length and the FILMSCAN
rate limiter with its per-frame update, and the custom quantization
override; no interlaced remap.  It mirrors the reference's quality system
for the shipping encoder:

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
                   rgb_quality: int = 0,
                   gop_length: int = 1,
                   fs_rate_limiter: int | None = None
                   ) -> tuple[list[int], list[int]]:
    """17-entry (luma, chroma) quant tables after QuantizationSetQuality
    for a progressive frame.  fs_rate_limiter is the FILMSCAN2/3 rate
    control's state (`update_fs_rate_limiter`); None is its first-frame
    value, 8 for FILMSCAN2 and 4 for FILMSCAN3
    (`Codec/quantize.c:224-233`).  `chroma_full_res` gives the chroma
    channels the luma table (4:4:4 RGB); at 12-bit precision the RGB gains
    of `rgb_quality` apply.  `gop_length` 1 is an intra frame, 2 a
    two-frame group (FIELDPLUS), whose subbands 7-9 keep their own
    entries.

    quality: CFHD_ENCODING_QUALITY_* numeric (1=low .. 6=filmscan3).
    Mirrors `Codec/quantize.c:186-585` for the FixedQuality path with
    vbrscale=256 (no VBR feedback on the first frame)."""
    factor = quality & 0xFF
    new_quality = factor
    if fs_rate_limiter is None:
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

    if gop_length == 1:
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


def update_fs_rate_limiter(limiter: int, quality: int,
                           last_sample_bytes: int, width: int,
                           height: int) -> int:
    """Per-frame FILMSCAN rate-control feedback (`QuantizationSetQuality`,
    `Codec/quantize.c:236-310`) for a 10-bit 4:2:2 frame, the formats the
    API rate-controls: the FSratelimiter walks up/down from the achieved
    compression ratio of the PREVIOUS sample, moving the subband-8..16
    quantizer scale (16 + 2*limiter, see quality_tables).  quality is the
    raw CFHD quality word; only FILMSCAN2/3 (5/6) adapt.  Returns the
    updated limiter, clamped to [0, 20]."""
    new_quality = quality & 0xFF
    if new_quality < 5 or not last_sample_bytes or (quality & 0x1F00):
        return limiter
    # 3 channels of 10 bits, over 1.5 for the half-width chroma
    compression = width * height * 3 * 10 / 8.0 / float(last_sample_bytes)
    compression /= 1.5
    if new_quality == 5:      # FILMSCAN2: target 4.0-5.5:1
        if compression > 5.5:
            limiter -= 1
            if compression > 6.5:
                limiter -= 1
            if compression > 7.5:
                limiter -= 2
        elif compression < 4.0:
            limiter += 1
            if compression < 3.5:
                limiter += 1
            if compression < 3.0:
                limiter += 1
            if compression < 2.5:
                limiter += 1
            if compression < 2.0:
                limiter += 1
            if compression < 1.5:
                limiter += 2
    else:                     # FILMSCAN3 (and higher): target 3.0-4.5:1
        if compression > 4.5:
            limiter -= 1
            if compression > 5.5:
                limiter -= 1
            if compression > 6.5:
                limiter -= 2
        elif compression < 3.0:
            limiter += 1
            if compression < 2.5:
                limiter += 1
            if compression < 2.0:
                limiter += 1
            if compression < 1.5:
                limiter += 2
    return max(0, min(limiter, 20))


def custom_quant_tables(quant_y, quant_c, precision: int,
                        gop_length: int = 1,
                        chroma_full_res: bool = False,
                        rgb_quality: int = 0) -> tuple[list[int], list[int]]:
    """Custom quantization override (`SetEncoderQuantization`,
    `Codec/encoder.c:1143-1225`, custom_quant magic 0x12345678): the
    caller's 17-entry tables replace the quality presets (newQuality=7),
    then receive the same precision scaling as the presets: subband 7
    forced to 4 (lossless TLL), subbands >8 scaled x4 at 10-bit, the
    12-bit RGB gains, and the gop_length==1 remap of subbands 7..9 from
    11..13."""
    luma = list(quant_y)
    chroma = list(quant_y if chroma_full_res else quant_c)
    if precision >= tags.PRECISION_10BIT:
        for i in range(17):
            if i == 7:
                luma[i] = chroma[i] = 4
            elif i > 8:
                luma[i] *= 4
                chroma[i] *= 4
    if precision == tags.PRECISION_12BIT:
        chromagain = {0: 8, 1: 6, 2: 4, 3: 4}[min(rgb_quality, 3)]
        for i in range(4, 7):
            luma[i] *= 4
            chroma[i] *= 4
        for i in range(11, 17):
            luma[i] *= 4
            chroma[i] *= chromagain
    if gop_length == 1:
        for i in range(7, 10):
            luma[i] = luma[i + 4]
            chroma[i] = chroma[i + 4]
    return luma, chroma


def _spatial_band_quant(table, num_spatial: int
                        ) -> list[tuple[int, int, int]]:
    """A 17-entry table -> per-wavelet (q_lh, q_hl, q_hh), finest first:
    the spatial wavelets' table[subband] * scale >> 2, deepest first, then
    the frame wavelet's table[subband] as it is."""
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


def intra_band_quant(quality: int, precision: int, channel: int,
                     num_spatial: int = 2, chroma_full_res: bool = False,
                     rgb_quality: int = 0,
                     fs_rate_limiter: int | None = None
                     ) -> list[tuple[int, int, int]]:
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
                                  rgb_quality,
                                  fs_rate_limiter=fs_rate_limiter)
    return _spatial_band_quant(chroma if channel > 0 else luma,
                               num_spatial)


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
    #: FILMSCAN2/3 rate-control state (None = first-frame default);
    #: advance per frame with update_fs_rate_limiter
    fs_rate_limiter: int | None = None
    #: custom quantization override: (luma17, chroma17) as produced by
    #: custom_quant_tables; replaces the quality-derived tables
    custom_quant: tuple | None = None
    num_spatial: ClassVar[int] = 2

    @property
    def num_wavelets(self) -> int:
        return self.num_spatial + 1

    def band_quant(self, channel: int) -> list[tuple[int, int, int]]:
        if self.custom_quant is not None:
            return _spatial_band_quant(
                self.custom_quant[1 if channel > 0 else 0], self.num_spatial)
        return intra_band_quant(self.quality, self.precision, channel,
                                self.num_spatial, self.chroma_full_res,
                                self.rgb_quality, self.fs_rate_limiter)

    @property
    def prescale(self) -> list[int]:
        return intra_prescale(self.precision)

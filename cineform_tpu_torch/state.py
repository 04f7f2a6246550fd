"""The codec's carried-across state: its constant tables as tensors.

The codec has no learned weights.  What an encode or decode needs besides
the frames is a set of integer tables fixed by the format and the
configuration: the prescale shifts and band quantizers of
`spec.production.IntraParams`, the band entropy code tables of codeset 17
(`spec.codebooks`), and the reference decoder's output dither draws for
the n-th decoded frame (`ref.intra.decode_dither_rows`).  `codec_tables`
builds them from the package's host modules and places the tensors on an
explicit device.  What the input format decides (the precision, whether
chroma takes the luma tables, the number of channels) comes in as
keywords, with the dimensions of the planes that the codec transforms (a
Bayer mosaic's are half its own), and so does the FILMSCAN rate limiter's
state and a custom quantization override (`spec.production.
custom_quant_tables`, as a tuple of two 17-entry tuples, which the cache
keys on); the defaults are YUY2's on the first frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from cineform_tpu_torch.entropy.device import (EncodeTables, encode_tables,
                                               magnitude_lut)
from cineform_tpu_torch.ref.intra import decode_dither_rows
from cineform_tpu_torch.spec import tags
from cineform_tpu_torch.spec.production import IntraParams


@lru_cache(maxsize=64)
def dither_rows(height: int, frame_index: int = 0) -> np.ndarray:
    """Reference-exact (H, 16) output dither draws, uint8, for the n-th
    decoded frame of a decoder process (glibc rand stream; see
    ref/intra.decode_dither_rows)."""
    return np.ascontiguousarray(
        decode_dither_rows(height, frame_index).astype(np.uint8))


@dataclass(frozen=True, eq=False)
class CodecTables:
    """Tables of one (width, height, quality, frame index, format)
    config."""

    prescale: tuple[int, ...]                 # per wavelet level
    band_quant: tuple[tuple[tuple[int, int, int], ...], ...]  # [channel][level]
    encode: EncodeTables                      # codeset 17 entropy codes
    mag_bits: torch.Tensor                    # (max_mag + 1,) int32
    mag_sizes: torch.Tensor                   # (max_mag + 1,) int32
    dither_rows: torch.Tensor                 # (height, 16) int32


@lru_cache(maxsize=64)
def codec_tables(width: int, height: int, quality: int, frame_index: int = 0,
                 *, device: torch.device | str,
                 precision: int = tags.PRECISION_10BIT,
                 chroma_full_res: bool = False,
                 rgb_quality: int = 0,
                 num_channels: int = 3,
                 fs_rate_limiter: int | None = None,
                 custom_quant: tuple | None = None) -> CodecTables:
    device = torch.device(device)
    p = IntraParams(width=width, height=height, quality=quality,
                    precision=precision, chroma_full_res=chroma_full_res,
                    rgb_quality=rgb_quality, fs_rate_limiter=fs_rate_limiter,
                    custom_quant=custom_quant)
    enc = encode_tables(17)
    mag_bits, mag_sizes = magnitude_lut(enc, device)
    return CodecTables(
        prescale=tuple(p.prescale),
        band_quant=tuple(tuple(tuple(q) for q in p.band_quant(ch))
                         for ch in range(num_channels)),
        encode=enc,
        mag_bits=mag_bits,
        mag_sizes=mag_sizes,
        dither_rows=torch.from_numpy(
            dither_rows(height, frame_index).astype(np.int32)).to(device),
    )

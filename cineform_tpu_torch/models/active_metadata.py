"""Active Metadata: sample metadata drives the Bayer develop.

Port of the JAX package's `models/active_metadata.py`: the develop
parameters (`PROCESSING_*`, `DevelopParams`, `develop_params`) are a copy
of its host code, the wiring of `ApplyActiveMetaData` (`Codec/bayer.c:
7427`) and `UpdateCFHDDATA` (`Codec/DemoasicFrames.cpp:5286`): tuples of
the sample (and decoder-side database items) gated by the TAG_PROCESS_PATH
flags (`Common/CFHDMetadataTags.h:25-44`); nothing applies unless
PROCESSING_ACTIVE is set, and each stage has its own bit.
`decode_bayer_developed` runs on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cineform_tpu_torch import metadata as md
from cineform_tpu_torch.bitstream import parse_sample
from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.ops import develop as dv

# TAG_PROCESS_PATH bits (`Common/CFHDMetadataTags.h:26-44`)
PROCESSING_ACTIVE = 1 << 0
PROCESSING_COLORMATRIX = 1 << 1
PROCESSING_WHITEBALANCE = 1 << 2
PROCESSING_LOOK_FILE = 1 << 3
PROCESSING_GAMMA_TWEAKS = 1 << 5   # CFHDMetadataTags.h:31


@dataclass
class DevelopParams:
    """Parameters for ops.develop extracted from metadata."""

    enabled: bool = False
    vignette_start: float = 0.0   # VGNS (`decoder.c:7440`: 0 = off)
    vignette_end: float = 0.0     # VGNE
    vignette_gain: float = 0.0    # VGNG
    blur_sharpen: float = 0.0     # BLSH (- blur .. + sharpen)
    wb: tuple = (1.0, 1.0, 1.0)
    matrix: np.ndarray | None = None        # full 3x4 (COLM layout)
    saturation: float = 1.0                  # SATU (payload value)
    exposure: float = 1.0                    # EXPS (payload value)
    look_crc: int = 0
    gamma: float = 1.0
    contrast: float = 1.0           # CTRS (effective value)
    rgb_gamma: tuple = (1.0, 1.0, 1.0)       # GAMT per-channel tweaks
    flags: int = 0


def _floats(item: md.MetadataItem, n: int) -> np.ndarray:
    return np.frombuffer(item.payload[:4 * n], dtype="<f4").astype(np.float64)


def _u32(item: md.MetadataItem) -> int:
    return int.from_bytes(item.payload[:4], "little")


def develop_params(sample: bytes,
                   database: list[md.MetadataItem] | None = None,
                   parsed=None) -> DevelopParams:
    """Parse develop parameters from sample metadata, then overlay the
    decoder-side database items (the reference's priority layering:
    sample/global < database/override; `Common/CFHDMetadataTags.h:60-71`).
    `parsed`: the sample as `parse_sample` gives it, where the caller has
    it."""
    items = list(md.read_metadata(sample, parsed))
    if database:
        items += list(database)

    p = DevelopParams()
    for item in items:
        tag = item.tag
        if tag == "PRCS":
            p.flags = _u32(item)
        elif tag == "WBAL" and len(item.payload) >= 12:
            # 4-float payload is (r, g1, g2, b): the SECOND GREEN is
            # skipped when building the channel gains
            # (`DemoasicFrames.cpp:5756-5768`)
            n = len(item.payload) // 4
            vals = _floats(item, min(n, 4))
            if n >= 4:
                vals = np.array([vals[0], vals[1], vals[3]])
            p.wb = tuple(float(np.clip(v, 0.4, 10.0)) for v in vals[:3])
        elif tag == "COLM" and len(item.payload) >= 48:
            p.matrix = _floats(item, 12).reshape(3, 4)
        elif tag == "SATU" and len(item.payload) >= 4:
            p.saturation = float(np.clip(_floats(item, 1)[0], 0.0, 11.0))
        elif tag == "EXPS" and len(item.payload) >= 4:
            p.exposure = float(np.clip(_floats(item, 1)[0], 0.0, 11.0))
        elif tag == "UTYM" and _u32(item):
            p.matrix = None                  # unity matrix bypasses COLM
        elif tag == "LCRC":      # TAG_LOOK_CRC (CFHDMetadataTags.h:213)
            p.look_crc = _u32(item)
        elif tag == "VGNS" and len(item.payload) >= 4:
            p.vignette_start = float(_floats(item, 1)[0])
        elif tag == "VGNE" and len(item.payload) >= 4:
            p.vignette_end = float(_floats(item, 1)[0])
        elif tag == "VGNG" and len(item.payload) >= 4:
            p.vignette_gain = float(_floats(item, 1)[0])
        elif tag == "BLSH" and len(item.payload) >= 4:
            p.blur_sharpen = float(_floats(item, 1)[0])
        elif tag == "CTRS" and len(item.payload) >= 4:
            # stored unity-at-0 (tag - 1, clamp [-1, 10]); the decode
            # uses stored + 1 (`DemoasicFrames.cpp:6045`, bayer.c:4562)
            p.contrast = float(np.clip(_floats(item, 1)[0] - 1.0,
                                       -1.0, 10.0) + 1.0)
        elif tag == "GAMT" and len(item.payload) >= 4:
            n = min(len(item.payload) // 4, 3)
            vals = [float(np.clip(v, 0.01, 10.0)) for v in _floats(item, n)]
            while len(vals) < 3:
                vals.append(vals[-1])
            p.rgb_gamma = tuple(vals)
            if 0.2 <= vals[0] <= 5.0:
                p.gamma = vals[0]

    p.enabled = bool(p.flags & PROCESSING_ACTIVE)
    if not p.enabled:
        return DevelopParams()
    if not (p.flags & PROCESSING_WHITEBALANCE):
        p.wb = (1.0, 1.0, 1.0)
    if not (p.flags & PROCESSING_COLORMATRIX):
        p.matrix = None
        p.saturation = 1.0
        p.exposure = 1.0
        # NOTE: blur_sharpen survives a PRCS without the COLORMATRIX bit
        # (the SDK defaults process_path_flags_mask so decoder.c:8697's
        # zeroing does not engage) — pinned empirically: PRCS=1 and
        # PRCS=3 BLSH decodes are byte-identical from the binary
    if not (p.flags & PROCESSING_LOOK_FILE):
        p.look_crc = 0
    if not (p.flags & PROCESSING_GAMMA_TWEAKS):
        p.gamma = 1.0
        p.rgb_gamma = (1.0, 1.0, 1.0)
        p.contrast = 1.0
    return p


def decode_bayer_developed(sample: bytes,
                           database: list[md.MetadataItem] | None = None,
                           look_db=None,
                           device: torch.device | str = "cuda"):
    """Decode a RAW (Bayer) sample and run the metadata-driven develop on
    `device`: quarter-res linear RGB -> white balance -> color matrix ->
    LOOK 3D LUT -> gamma.  Returns ((h, w, 3) uint16 RGB at quarter
    (mosaic-cell) resolution, as the JAX package's function returns it,
    fallback): fallback is `IntraCodec.decode_checked`'s, (0,) where the
    sample took the host entropy decode instead of the device's.

    The linear RGB is `IntraCodec.inverse_bayer_linear` of the decoded
    coefficients (the planes' un-difference and the inverse of the LOG-90
    curve, `intra_host.decode_sample_bayer`'s).  `look_db` is
    any object whose `.load(crc)` returns something with a `.lut` (N, N,
    N, 3), or None."""
    s = parse_sample(sample)
    codec = IntraCodec(2 * s.width, 2 * s.height, 4, device=device,
                       input_format="BYR4")
    p = develop_params(sample, database, s)
    look = None
    if p.enabled and p.look_crc and look_db is not None:
        look = look_db.load(p.look_crc)

    def develop(coeffs, frames):
        rgb = codec.inverse_bayer_linear(coeffs).to(torch.float32) / 4095.0
        if p.enabled:
            rgb = dv.white_balance(rgb, p.wb)
            if p.matrix is not None:
                rgb = dv.color_matrix(rgb, p.matrix[:, :3])
            if look is not None:
                rgb = dv.apply_lut3d(rgb, np.asarray(look.lut, np.float32))
            if p.gamma != 1.0:
                rgb = dv.gamma_curve(rgb, 1.0 / p.gamma)
        return rgb.clamp(0.0, 1.0)

    rgb, fallback = codec.decode_checked([sample], develop)
    return np.round(rgb[0] * 65535.0).astype(np.uint16), fallback

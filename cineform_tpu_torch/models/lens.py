"""The lens-correction decode stage's metadata decision.

A copy of `parse_lens_metadata` of the JAX package's `models/lens.py`; it
reads the tuples with the port's copy of `metadata.read_metadata`.  The port
has no warp yet: the API reads the sample's lens and framing tags with
this and refuses a decode the reference would warp (the reference's
`WarpFrame`, `Codec/decoder.c:9133-9445`; `CopyMetadataForPreset`'s doMesh
decision, lutpath.cpp:1980-2042), so that no sample decodes unwarped.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cineform_tpu_torch.metadata import read_metadata

f4 = np.float32


@dataclass
class LensParams:
    """The CFHDDATA lens fields after CopyMetadataForPreset."""

    lens_gopro: int = 1       # LGPR (default lutpath.cpp:1005)
    lens_sphere: int = 0      # LSPH
    lens_fill: int = 0        # LFIL
    lens_style: int = 0       # LSTL
    offset_x: float = 0.0     # LensOffsetX (<- -OFFX)
    offset_y: float = 0.0     # LensOffsetY (<- OFFY)
    offset_r: float = 0.0     # LensOffsetR (<- OFFR)
    fish_fov: float = 0.0     # LensFishFOV (<- OFFF)
    offset_z: float = 1.0     # LensOffsetZ (<- FrameHScale, HSCL)
    zoom: float = 1.0         # LensZoom (<- FrameZoom, ZOOM)
    custom_src: tuple = (0.0,) * 6   # LSRC
    custom_dst: tuple = (0.0,) * 6   # LDST


def _clampf(v, lo, hi):
    v = f4(v)
    if v < lo:
        v = f4(lo)
    if v > hi:
        v = f4(hi)
    return float(v)


def parse_lens_metadata(sample: bytes, parsed=None) -> LensParams | None:
    """Parse the lens/framing tags from the sample's metadata and apply
    the doMesh decision (lutpath.cpp:1982-2040).  Returns None when the
    decoder would not warp.  `parsed`: as `read_metadata` takes it."""
    items = {}
    try:
        for item in read_metadata(sample, parsed):
            items[item.tag] = item
    except Exception:
        return None
    if not items:
        return None

    def flt(tag, default=0.0):
        it = items.get(tag)
        if it is None or len(it.payload) < 4:
            return default
        return float(np.frombuffer(it.payload[:4], "<f4")[0])

    def ul(tag, default=0):
        it = items.get(tag)
        if it is None or len(it.payload) < 4:
            return default
        return int.from_bytes(it.payload[:4], "little")

    p = LensParams()
    p.lens_gopro = ul("LGPR", 1)
    p.lens_sphere = ul("LSPH", 0)
    p.lens_fill = ul("LFIL", 0)
    p.lens_style = ul("LSTL", 0)
    # tag clamps from DemoasicFrames.cpp:6293-6321; OFFX is negated
    frame_off_x = -_clampf(flt("OFFX"), -0.5, 0.5)
    frame_off_y = _clampf(flt("OFFY"), -0.5, 0.5)
    frame_off_r = _clampf(flt("OFFR"), -0.5, 0.5)
    frame_off_f = _clampf(flt("OFFF"), -90.0, 90.0)
    frame_zoom = _clampf(flt("ZOOM", 1.0), 0.10, 4.0)
    frame_hscale = flt("HSCL", 1.0)
    if "LSRC" in items and len(items["LSRC"].payload) >= 24:
        p.custom_src = tuple(np.frombuffer(
            items["LSRC"].payload[:24], "<f4").tolist())
    if "LDST" in items and len(items["LDST"].payload) >= 24:
        p.custom_dst = tuple(np.frombuffer(
            items["LDST"].payload[:24], "<f4").tolist())

    do_mesh = False
    if p.lens_gopro == 0 and p.lens_sphere == 1:
        do_mesh = True
    if p.lens_fill == 1 and (frame_off_x != 0.0 or frame_off_y != 0.0
                             or frame_off_r != 0.0 or frame_off_f != 0.0
                             or frame_zoom < 1.0):
        do_mesh = True
    if p.lens_sphere == 1:
        do_mesh = True
    if (p.lens_sphere == 1 and frame_off_r != 0.0) or \
            abs(frame_off_r) > 0.01:
        do_mesh = True
    if p.lens_gopro >= 2:
        do_mesh = True
    if not do_mesh:
        return None
    p.zoom = frame_zoom
    p.offset_x = frame_off_x
    p.offset_y = frame_off_y
    p.offset_r = frame_off_r
    p.fish_fov = frame_off_f
    p.offset_z = frame_hscale
    return p

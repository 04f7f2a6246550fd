"""Lens-correction decode stage: the reference's WarpFrame pipeline on a
torch device.

Port of the JAX package's `models/lens.py`, which models the metadata-driven
mesh warp the reference decoder runs on the final output buffer
(`WarpFrame`, Codec/decoder.c:9133-9445):

  1. `parse_lens_metadata`: `OverrideCFHDDATA` parses the sample's
     metadata chunks into CFHDDATA lens fields and `CopyMetadataForPreset`
     decides `doMesh` and folds the framing offsets into the Lens* fields
     (lutpath.cpp:1980-2042);
  2. `build_mesh`: WarpFrame picks a mesh size and source lens from the
     frame aspect, stacks the transforms and builds the bilinear cache, on
     the host in the reference's float arithmetic (`ref.geomesh`);
  3. `warp_output`: the cache goes to the device once (`ops.warp.upload`)
     and warps the decoded frames there (`ops.warp.apply_bilinear`, and
     `blur_vertical` with lensFill), built and uploaded once a set of lens
     parameters, size, pitch, format and device, as the decoder keeps its
     lastLens* fields;
  4. `warp_decode`: the doMesh detour of the YUY2 and WP13 outputs, which
     warps the WP13 decode and converts it.

With lensFill=1 the reference draws border samples from the process-global
glibc rand() stream; this model, as the JAX one, draws from a fresh seed-1
stream, in one thread.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from cineform_tpu_torch.metadata import read_metadata
from cineform_tpu_torch.ops import demosaic as dmops
from cineform_tpu_torch.ops import warp as wops
from cineform_tpu_torch.ref import geomesh as gmref

f4 = np.float32

# decoder.c:48 defines PI as the FLOAT constant 3.14159265359f and
# DEG2RAD as PI*(d)/180.0f — all single precision (unlike WarpLib's
# double PI)
PI_F = f4(3.14159265359)


def _deg2rad_f(d) -> np.float32:
    return PI_F * f4(d) / f4(180.0)


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

    def key(self):
        return tuple(getattr(self, f.name) for f in fields(self))


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


# output fourcc -> WARPLIB format (decoder.c:9230-9242)
_WARP_FORMATS = {
    "YUY2": gmref.FORMAT_YUY2,
    "BGRA": gmref.FORMAT_32BGRA,
    "W13A": gmref.FORMAT_W13A,
    "WP13": gmref.FORMAT_WP13,
    "RG48": gmref.FORMAT_RG48,
    "b64a": gmref.FORMAT_64ARGB,
}


def warp_supported(fourcc: str) -> bool:
    return fourcc in _WARP_FORMATS


def _approx_equal(x: int, y: int) -> bool:
    """approx_equal (decoder.c:9101-9121)."""
    if y > 1080:
        x >>= 6
        y >>= 6
    elif y > 540:
        x >>= 5
        y >>= 5
    else:
        x >>= 4
        y >>= 4
    return x == y or x + 1 == y or x == y + 1


def build_mesh(p: LensParams, width: int, height: int, pitch: int,
               fourcc: str) -> gmref.GeoMesh:
    """WarpFrame's mesh construction (decoder.c:9160-9310)."""
    fmt = _WARP_FORMATS[fourcc]

    if _approx_equal(width, height * 2):          # ~2:1 equirect
        srclens = gmref.EQUIRECT
        sensorcrop = 1.00623
        if p.custom_src[1]:
            aspect = f4(p.custom_src[0]) / f4(p.custom_src[1])
            if 1.0 <= aspect <= 3.0:
                if f4(aspect) * f4(0.99) < f4(4.0 / 3.0) < \
                        f4(aspect) * f4(1.01):
                    sensorcrop = float(
                        gmref.sqrtf(f4(width * width + height * height))
                        / gmref.sqrtf(f4((width * 2 // 3) ** 2
                                         + height * height)))
        if width >= 2496:
            mesh = gmref.GeoMesh(199, 99)
        elif width >= 1272:
            mesh = gmref.GeoMesh(99, 49)
        else:
            mesh = gmref.GeoMesh(49, 25)
        phi = f4(p.offset_x) * _deg2rad_f(720.0)
        theta = f4(p.offset_y) * _deg2rad_f(720.0)
    elif _approx_equal(width * 3, height * 4):    # ~4:3
        srclens = gmref.HERO4
        sensorcrop = 1.0
        if width > 2880:
            mesh = gmref.GeoMesh(159, 119)
        elif width >= 1920:
            mesh = gmref.GeoMesh(79, 59)
        else:
            mesh = gmref.GeoMesh(39, 29)
        phi = f4(p.offset_x) * _deg2rad_f(120.0)
        theta = f4(p.offset_y) * _deg2rad_f(98.0)
    else:                                         # ~16:9 and the rest
        srclens = gmref.HERO4
        sensorcrop = float(
            gmref.sqrtf(f4(1920 * 1920 + 1080 * 1080))
            / gmref.sqrtf(f4(2000 * 2000 + 1500 * 1500)))
        if width > 2880:
            mesh = gmref.GeoMesh(159, 119)
        elif width >= 1920:
            mesh = gmref.GeoMesh(79, 59)
        else:
            mesh = gmref.GeoMesh(39, 29)
        phi = f4(p.offset_x) * _deg2rad_f(120.0)
        theta = f4(p.offset_y) * _deg2rad_f(70.0)
    rho = (f4(p.offset_z) - f4(1.0)) * f4(4.0) * _deg2rad_f(360.0)

    mesh.init(width, height, pitch, fmt, width, height, pitch, fmt,
              p.lens_fill)

    if p.lens_sphere == 1:
        if p.lens_gopro != 2:
            if p.offset_r != 0.0:
                r = f4(p.offset_r)
                angle = f4(360.0) * r * r * f4(2.1)
                if p.offset_r < 0.0:
                    angle = -angle
                mesh.transform_rotate(angle)
            if p.zoom != 1.0:
                mesh.transform_scale(p.zoom, p.zoom)
            if p.fish_fov != 0.0:
                fov = _clampf(p.fish_fov, -89.9, 89.9)
                if fov:
                    mesh.transform_defish(fov)
        if p.lens_gopro == 0:
            mesh.transform_repoint_src_to_dst(
                sensorcrop, phi, theta, rho, srclens, gmref.RECTILINEAR)
        elif p.lens_gopro == 1:
            mesh.transform_repoint_src_to_dst(
                sensorcrop, phi, theta, rho, srclens, gmref.HERO4)
        elif p.lens_gopro == 2:
            mesh.transform_repoint_src_to_dst(
                sensorcrop, phi, theta, rho, srclens, gmref.EQUIRECT)
        elif p.lens_gopro == 4:
            mesh.set_custom_lens(p.custom_src, p.custom_dst)
            src = gmref.EQUIRECT if srclens == gmref.EQUIRECT \
                else gmref.CUSTOM_LENS
            mesh.transform_repoint_src_to_dst(
                sensorcrop, phi, theta, rho, src, gmref.CUSTOM_LENS)
    else:
        if p.zoom != 1.0:
            mesh.transform_scale(p.zoom, p.zoom)
        if p.offset_x != 0.0 or p.offset_y != 0.0:
            mesh.transform_pan(f4(p.offset_x) * f4(width),
                               -f4(p.offset_y) * f4(height))
        if p.offset_r != 0.0:
            angle = (f4(360.0)
                     * gmref.asinf(f4(p.offset_r) * f4(1.7777777777))
                     / (f4(2.0) * f4(3.14159)))
            mesh.transform_rotate(angle)
        if p.lens_gopro == 0:
            mesh.transform_gopro_to_rectilinear(sensorcrop)

    mesh.alloc_cache()
    mesh.cache_init_bilinear_range(0, height, gmref.GlibcRand())
    return mesh


def _device_mesh(p: LensParams, width: int, height: int, pitch: int,
                 fourcc: str, device: torch.device,
                 mesh_cache: dict | None) -> wops.DeviceMesh:
    """The mesh of these parameters on `device`: built on the host and
    uploaded once, and kept in `mesh_cache` (one entry, as the decoder's
    lastLens* fields keep one mesh)."""
    key = (p.key(), width, height, pitch, fourcc, device)
    dm = None if mesh_cache is None else mesh_cache.get(key)
    if dm is None:
        dm = wops.upload(build_mesh(p, width, height, pitch, fourcc), device)
        if mesh_cache is not None:
            mesh_cache.clear()
            mesh_cache[key] = dm
    return dm


def warp_output(p: LensParams, out: torch.Tensor, width: int, height: int,
                fourcc: str, mesh_cache: dict | None = None) -> torch.Tensor:
    """Apply WarpFrame to decoded output frames on their device: (B, ...)
    uint8 frames of `height` rows -> the warped (B, height, pitch) uint8
    frames, the fill border blurred where the parameters ask.
    `mesh_cache` memoizes the built and uploaded mesh."""
    flat = out.reshape(out.shape[0], -1)
    pitch = flat.shape[1] // height
    dm = _device_mesh(p, width, height, pitch, fourcc, out.device,
                      mesh_cache)
    warped = wops.apply_bilinear(dm, flat)
    if p.lens_fill:
        warped = wops.blur_vertical(dm, warped)
    return warped.reshape(out.shape[0], height, -1)


def warp_decode(p: LensParams, wp13: torch.Tensor, width: int, height: int,
                fourcc: str, mesh_cache: dict | None = None) -> torch.Tensor:
    """The doMesh decode detour (decoder.c:10648-10706, 11125-11136): with
    a mesh warp pending, the reference decodes into a signed-13-bit WP13
    buffer, runs WarpFrame on that buffer, then converts to the requested
    output (ProcessLine3D -> ConvertLinesToOutput), so the output levels
    differ from the direct decode's.  `wp13`: the frames' WP13 decode,
    (B, H, 6W) uint8 -> the warped WP13 frames ("WP13"), or their YUY2
    conversion ("YUY2", (B, height, 2 * width) uint8)."""
    if fourcc not in ("YUY2", "WP13"):
        raise ValueError(f"warp_decode to {fourcc} not supported")
    warped = warp_output(p, wp13, width, height, "WP13", mesh_cache)
    if fourcc == "WP13":
        return warped
    rgb = warped.view(torch.int16).reshape(-1, height, width, 3) \
        .to(torch.int32)
    parity = torch.arange(height, device=wp13.device) & 1
    return dmops.convert_rgb16_to_yuyv(rgb, parity, whitepoint=13)

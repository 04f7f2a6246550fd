"""The decoder's deep and 8-bit output packers as PyTorch tensor functions.

Port of the JAX package's host packers of a 4:2:2 sample's Row16u planes
(`models/intra_host.pack_deep_output`, `yuv16_to_wp13`, `_wp13_pack`,
`_decode_sample_r408`, `_decode_sample_avid`, `_decode_sample_rg24`, and
`ref/intra.chroma_422_to_444` and `yuv16_to_rgb16`), and of the 8-bit
outputs of an RGB source (`decode_sample_rgb`), byte for byte.

The planes are (..., H, W) int32 tensors of uint16 values (chroma (..., H,
W/2)), as `ops.intra_transform.h26_inverse_to_row16u` gives them.  Each
packer returns the frames' bytes as (..., H, row_bytes) uint8, or the
16-bit outputs as (..., H, row_bytes / 2) int16 bit patterns (the CPU
build of torch lacks most uint16 ops); formats of two planes (NV12, av28)
lay their planes one after the other and cut the frame's bytes into H
rows.  All arithmetic is integer: int32, and int64 only for the 32-bit
words of the 10-bit RGB formats.  These are plain versions with no kernel;
they run on any device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from cineform_tpu_torch.models.intra_host import (_R408_DITHER_EVEN,
                                                  _R408_DITHER_ODD)
from cineform_tpu_torch.ops.intra_transform import sat16, wrap16
from cineform_tpu_torch.ref.intra import (_YUV2RGB_CG601, _YUV2RGB_CG709,
                                          RGB10_INPUT_FORMATS)

#: the outputs of a 4:2:2 source built from Row16u planes with the deep-YUV
#: lowpass offset (+4, `decoder.c:12278`); the others take the default +24
DEEP_YUV = ("YU64", "v210", "NV12")
#: the outputs of a 4:2:2 source that `pack` builds, all from Row16u planes
OUTPUTS_422 = (*DEEP_YUV, "RG48", "b64a", "r210", "DPX0", "RG30", "AB10",
               "AR10", "WP13", "W13A", "R408", "V408", "RG24", "av16",
               "a106", "a214", "av28")


def u16(x: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65535] -> int16 of the same bit patterns."""
    return torch.where(x >= 32768, x - 65536, x).to(torch.int16)


def _rows(parts: list[torch.Tensor], height: int) -> torch.Tensor:
    """Per-frame byte planes (..., n_i) uint8, laid one after the other and
    cut into `height` rows."""
    flat = torch.cat(parts, dim=-1)
    return flat.reshape(*flat.shape[:-1], height, -1)


def _le_bytes(words: torch.Tensor, n: int, swap: bool = False
              ) -> torch.Tensor:
    """(..., W) integer words -> (..., n * W) uint8, little-endian, or
    big-endian where `swap`."""
    shifts = range(8 * (n - 1), -1, -8) if swap else range(0, 8 * n, 8)
    return torch.stack([(words >> s) & 0xFF for s in shifts],
                       dim=-1).flatten(-2).to(torch.uint8)


def _pairs(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           d: torch.Tensor) -> torch.Tensor:
    """Four (..., W/2) planes -> (..., 2W) rows a0 b0 c0 d0 a1 b1 ..."""
    return torch.stack([a, b, c, d], dim=-1).flatten(-2)


def chroma_422_to_444(c: torch.Tensor) -> torch.Tensor:
    """`ChannelYUYV16toPlanarYUV16` without COLOR_SPACE_422_TO_444
    (`Codec/RGB2YUV.c:1308`): each chroma value replicated over its pixel
    pair, (..., W/2) -> (..., W)."""
    return c.unsqueeze(-1).expand(*c.shape, 2).flatten(-2)


def yuv16_to_rgb16(y16: torch.Tensor, u16_: torch.Tensor, v16: torch.Tensor,
                   colorspace: int = 2):
    """`PlanarYUV16toPlanarRGB16` (`Codec/RGB2YUV.c:1760`), pinned:
    inputs >>1 to 15-bit, offsets subtracted, 13-bit fixed-point CG
    matrix via mulhi (>>16 floor), <<2 to 14-bit, clamp [0,16383], <<2
    to 16-bit.  u16_ is the 4:4:4 plane fed to the U taps (the reference
    wires channel 2 there), v16 the V taps (channel 1).  Every product
    stays inside int32.  Returns (r16, g16, b16) int32."""
    k = _YUV2RGB_CG601 if (colorspace & 3) == 1 else _YUV2RGB_CG709
    y = (y16 >> 1) - k["y_offset"]
    u = (u16_ >> 1) - k["u_offset"]
    v = (v16 >> 1) - k["v_offset"]
    ym = (y * k["ymult"]) >> 16
    # the SSE kernel negates the G multipliers before mulhi, so the >>16
    # floor applies to the negated product (RGB2YUV.c:1919-1920)
    r = sat16(ym + ((v * k["r_vmult"]) >> 16))
    g = sat16(sat16(ym + ((u * -k["g_umult"]) >> 16))
              + ((v * -k["g_vmult"]) >> 16))
    b = sat16(ym + ((u * k["b_umult"]) >> 16))
    out = []
    for c in (r, g, b):
        x14 = wrap16(c << 2)                     # slli_epi16 wraps
        z = sat16(x14 + 16384) & 0xFFFF          # adds_epi16 then as-unsigned
        c14 = (z - 16384).clamp(min=0)           # subs_epu16
        out.append((c14 << 2) & 0xFFFF)          # final slli wraps
    return tuple(out)


def pack_yu64(y16, c1, c2) -> torch.Tensor:
    """YU64: 16-bit [Y0 C1 Y1 C2] pairs (`ConvertPlanarYUVToYU64`,
    `Codec/convert.c:13985`), int16 (..., H, 2W)."""
    return u16(_pairs(y16[..., 0::2], c1, y16[..., 1::2], c2))


def pack_nv12(y16, c1, c2) -> torch.Tensor:
    """NV12: 8-bit Y, then the interleaved (C1, C2) plane with the chroma
    rows averaged in pairs; uint8 (..., H, 3W/2)."""
    y, cb, cr = y16 >> 6, c1 >> 6, c2 >> 6
    y8 = ((y + 2) >> 2).clamp(0, 255)
    cb2 = (cb[..., 0::2, :] + cb[..., 1::2, :] + 1) >> 1
    cr2 = (cr[..., 0::2, :] + cr[..., 1::2, :] + 1) >> 1
    uv = torch.stack([((cb2 + 2) >> 2).clamp(0, 255),
                      ((cr2 + 2) >> 2).clamp(0, 255)], dim=-1).flatten(-2)
    lead = y8.shape[:-2]
    return _rows([y8.reshape(*lead, -1).to(torch.uint8),
                  uv.reshape(*lead, -1).to(torch.uint8)], y16.shape[-2])


def pack_v210(y16, c1, c2) -> torch.Tensor:
    """v210: 6 pixels -> 4 words of three 10-bit slots
    (`ConvertPlanarYUVToV210`, `Codec/convert.c:13526`, the precision-16
    branch), rows of ((W + 47) // 48) * 128 bytes, uint8.  The reference's
    writer swaps Cb/Cr against its own v210 reader (slot 0 carries channel
    2), and in a partial tail group its scalar loop updates its y1/y2/u/v
    registers only while `column + k < width`, so slots past the edge
    reuse the last value assigned (`convert.c:13891-13975`).

    At width % 6 == 4 the JAX model reads a chroma column past the row
    (an IndexError), so the reference's bytes there are unknown: raises."""
    w = y16.shape[-1]
    if w % 6 == 4:
        raise ValueError(f"v210 output of a {w}-wide frame: the tail group "
                         "reads past the chroma row")
    y, cb, cr = y16 >> 6, c2 >> 6, c1 >> 6
    lead = y.shape[:-1]
    gfull = w // 6
    yg = y[..., :6 * gfull].reshape(*lead, gfull, 6)
    cbg = cb[..., :3 * gfull].reshape(*lead, gfull, 3)
    crg = cr[..., :3 * gfull].reshape(*lead, gfull, 3)
    slots = [torch.stack([cbg[..., 0], yg[..., 0], crg[..., 0], yg[..., 1],
                          cbg[..., 1], yg[..., 2], crg[..., 1], yg[..., 3],
                          cbg[..., 2], yg[..., 4], crg[..., 2], yg[..., 5]],
                         dim=-1).flatten(-2)]
    c0 = 6 * gfull
    if c0 != w:
        # w % 6 == 2: the tail group holds one pixel pair; y2 keeps its
        # first value, y[c0]
        u, v = cb[..., c0 // 2], cr[..., c0 // 2]
        y0, y1 = y[..., c0], y[..., c0 + 1]
        slots.append(torch.stack([u, y0, v, y1, u, y0, v, y1, u, y1, v, y0],
                                 dim=-1))
    pitch_words = ((w + 47) // 48) * 32
    stream = torch.cat(slots, dim=-1)
    stream = torch.nn.functional.pad(stream,
                                     (0, 3 * pitch_words - stream.shape[-1]))
    words = stream[..., 0::3] | (stream[..., 1::3] << 10) \
        | (stream[..., 2::3] << 20)
    return _le_bytes(words, 4)


def pack_rgb(fourcc: str, y16, c1, c2) -> torch.Tensor:
    """The RGB outputs of a 4:2:2 source (RG48, b64a, r210, DPX0, RG30,
    AB10, AR10): the chroma replicated to 4:4:4, `yuv16_to_rgb16`, then
    `ConvertLinesToOutput`'s packing (`Codec/bayer.c:478`).  RG48 and
    b64a (alpha 0xFFFF first) are int16 (..., H, 3W) and (..., H, 4W); the
    10-bit formats uint8 (..., H, 4W), their 32-bit words byte-swapped for
    r210 and DPX0."""
    r16, g16, b16 = yuv16_to_rgb16(y16, chroma_422_to_444(c2),
                                   chroma_422_to_444(c1))
    if fourcc == "RG48":
        return u16(torch.stack([r16, g16, b16], dim=-1).flatten(-2))
    if fourcc == "b64a":
        return u16(torch.stack([torch.full_like(r16, 0xFFFF), r16, g16, b16],
                               dim=-1).flatten(-2))
    _, swap, (rs, gs, bs) = RGB10_INPUT_FORMATS[fourcc]
    r, g, b = ((x >> 6).to(torch.int64) for x in (r16, g16, b16))
    return _le_bytes((r << rs) | (g << gs) | (b << bs), 4, swap)


def yuv16_to_wp13(y16, c1, c2) -> torch.Tensor:
    """16-bit planar 4:2:2 YUV -> signed 13-bit-whitepoint RGB (..., H, W,
    3) int32, the Active-Metadata working format (`ConvertYUVRow16uToBGRA64`
    with format WP13: saturate=0, whitebitdepth=13, CG 709 constants,
    `Codec/convert.c:12183-12460`; chroma duplicated, not smoothed)."""
    y15 = y16 >> 1
    uu = sat16(chroma_422_to_444(c2 >> 1) - 16384)
    vv = sat16(chroma_422_to_444(c1 >> 1) - 16384)
    y14 = ((sat16(y15 - 2048) * _WP13["ymult"]) >> 16) << 2

    def term(x, mult):
        return ((x * _WP13[mult]) >> 16) << 2

    r = sat16(y14 + term(vv, "r_vmult")) >> 1
    g = sat16(sat16(y14 - term(vv, "g_vmult")) - term(uu, "g_umult")) >> 1
    b = sat16(y14 + term(uu, "b_umult")) >> 1
    return torch.stack([r, g, b], dim=-1)


def _wp13_multipliers() -> dict:
    mp = np.float32(8192.0)
    return {name: int(mp * np.float32(f)) for name, f in (
        ("ymult", 1.164), ("r_vmult", 1.793), ("g_vmult", 0.534),
        ("g_umult", 0.213), ("b_umult", 2.115))}


_WP13 = _wp13_multipliers()


def wp13_pack(rgb13: torch.Tensor, fourcc: str) -> torch.Tensor:
    """(..., H, W, 3) signed 13-bit RGB -> WP13 (..., H, 3W) or W13A (...,
    H, 4W, alpha 8191 last) int16."""
    if fourcc == "W13A":
        rgb13 = torch.cat([rgb13, torch.full_like(rgb13[..., :1], 8191)],
                          dim=-1)
    return rgb13.flatten(-2).to(torch.int16)


def _chroma_444_smoothed(c: torch.Tensor) -> torch.Tensor:
    """`ConvertYUVRow16uToYUV444`'s 4:2:2 -> 4:4:4 chroma smoothing
    (`Codec/convert.c:13195`): out[2i] = (c[i-1]>>1) + (c[i]>>1) saturated,
    out[2i+1] = (c[i]>>1)*2."""
    half = c >> 1
    prev = torch.cat([half[..., :1], half[..., :-1]], dim=-1)
    return torch.stack([(prev + half).clamp(max=0xFFFF), half * 2],
                       dim=-1).flatten(-2)


@lru_cache(maxsize=None)
def _r408_lanes(device: torch.device) -> torch.Tensor:
    """The R408 dither lanes, (2, 8) int32 on `device`: the even rows'
    pattern, then the odd rows'."""
    return torch.from_numpy(np.stack([_R408_DITHER_EVEN, _R408_DITHER_ODD])
                            .astype(np.int32)).to(device)


def pack_r408(fourcc: str, y16, c1, c2) -> torch.Tensor:
    """R408 (AYUV) / V408 (UYVA) 8-bit 4:4:4:4, uint8 (..., H, 4W): the
    chroma smoothed to 4:4:4, 16->13 bit, the fixed 5-bit dither lanes,
    >>5; R408 subtracts 16 from Y with unsigned saturation
    (`ConvertLinesToOutput`, `Codec/bayer.c:3497-3700`)."""
    h, w = y16.shape[-2:]
    dev = y16.device
    cols = torch.arange(w, device=dev) % 8
    odd = (torch.arange(h, device=dev) & 1).bool()[:, None]
    even_lanes, odd_lanes = _r408_lanes(dev)
    d_yu = torch.where(odd, odd_lanes[cols], even_lanes[cols])
    d_v = torch.where(odd, even_lanes[cols], odd_lanes[cols])

    def conv(p, d):
        return (sat16((p >> 3) + d) >> 5).clamp(0, 255)

    y8 = conv(y16, d_yu)
    u8 = conv(_chroma_444_smoothed(c2), d_yu)
    v8 = conv(_chroma_444_smoothed(c1), d_v)
    a8 = torch.full_like(y8, 255)
    if fourcc == "R408":
        out = [a8, (y8 - 16).clamp(min=0), u8, v8]
    else:
        out = [u8, y8, v8, a8]
    return torch.stack(out, dim=-1).flatten(-2).to(torch.uint8)


def pack_avid(fourcc: str, y16, c1, c2) -> torch.Tensor:
    """The Avid CT family (`ConvertYUV16ToCbYCrY_*`,
    `Codec/convert.c:19023-19929`), pixel-pair quads [C1, Y1, C2, Y2]:

    - av16 / a106: the 16-bit values, int16 (..., H, 2W);
    - a214: signed 2.14, luma (v - 4096) << 6 / 219, chroma (v - 4096) << 6
      / 224 - 8192, C-truncating division, int16 (..., H, 2W);
    - av28: the 2-bit uppers ((v >> 6) & 3) packed four to a byte [C2|Y1|
      C1|Y2] high to low, then the 8-bit lowers (v >> 8) as [C2, Y1, C1,
      Y2] rows (this converter wires the chroma the other way round),
      uint8 (..., H, 5W/2)."""
    y1, y2 = y16[..., 0::2], y16[..., 1::2]
    if fourcc in ("av16", "a106"):
        return u16(_pairs(c1, y1, c2, y2))
    if fourcc == "a214":
        def scaled(v, d, off):
            q = torch.div((v - 4096) << 6, d, rounding_mode="trunc")
            return sat16(q - off)

        return _pairs(scaled(c1, 224, 8192), scaled(y1, 219, 0),
                      scaled(c2, 224, 8192), scaled(y2, 219, 0)).to(
                          torch.int16)
    quads = (c2, y1, c1, y2)
    upper = (((quads[0] >> 6) & 3) << 6 | ((quads[1] >> 6) & 3) << 4
             | ((quads[2] >> 6) & 3) << 2 | ((quads[3] >> 6) & 3))
    lower = _pairs(*((q >> 8) & 0xFF for q in quads))
    lead = y16.shape[:-2]
    return _rows([upper.reshape(*lead, -1).to(torch.uint8),
                  lower.reshape(*lead, -1).to(torch.uint8)], y16.shape[-2])


def pack_rg24(y16, c1, c2, dither: torch.Tensor) -> torch.Tensor:
    """RG24 (8-bit BGR, bottom-up rows) of a 4:2:2 source: the scalar
    `ConvertRow16uToDitheredRGB` loop (`Codec/convert.c:11390`), CG 709,
    with `dither` the (H, W) int32 rand() & 0x7FFF draws of each pixel
    (`ref.intra.rg24_dither`).  uint8 (..., H, 3W)."""
    u = chroma_422_to_444(c2) - 32768
    v = chroma_422_to_444(c1) - 32768
    y = ((y16 - (16 << 8)) * (128 * 149)) >> 7
    rr = (y + 230 * v + dither) >> 15
    gg = (y - 55 * (u >> 1) - 137 * (v >> 1) + dither) >> 15
    bb = (y + 2 * 135 * u + dither) >> 15
    out = torch.stack([bb, gg, rr], dim=-1).clamp(0, 255).to(torch.uint8)
    return out.flip(-3).flatten(-2)


def pack(fourcc: str, y16, c1, c2, rg24_dither=None) -> torch.Tensor:
    """A 4:2:2 source's Row16u planes (Y, C1, C2) -> the `fourcc` output
    (one of `OUTPUTS_422`) as `pack_deep_output` and the JAX package's
    other host packers write it; RG24 takes `rg24_dither`."""
    if fourcc == "YU64":
        return pack_yu64(y16, c1, c2)
    if fourcc == "NV12":
        return pack_nv12(y16, c1, c2)
    if fourcc == "v210":
        return pack_v210(y16, c1, c2)
    if fourcc in ("WP13", "W13A"):
        return wp13_pack(yuv16_to_wp13(y16, c1, c2), fourcc)
    if fourcc in ("R408", "V408"):
        return pack_r408(fourcc, y16, c1, c2)
    if fourcc in ("av16", "a106", "a214", "av28"):
        return pack_avid(fourcc, y16, c1, c2)
    if fourcc == "RG24":
        return pack_rg24(y16, c1, c2, rg24_dither)
    return pack_rgb(fourcc, y16, c1, c2)


def rgb16_to_8bit(r, g, b, fourcc: str) -> torch.Tensor:
    """An RGB source's 16-bit planes -> BGRA (bottom-up rows), BGRa or RG24
    (bottom-up BGR), uint8, rounded to nearest as the JAX package's
    `decode_sample_rgb` does (the reference dithers with rand() & 127
    vectors whose order is not recoverable: within +/-1 of its bytes)."""
    v8 = ((torch.stack([b, g, r], dim=-1) + 128) >> 8).clamp(0, 255)
    if fourcc != "RG24":
        v8 = torch.cat([v8, torch.full_like(v8[..., :1], 255)], dim=-1)
    if fourcc != "BGRa":
        v8 = v8.flip(-3)
    return v8.flatten(-2).to(torch.uint8)

"""The Bayer RAW decode chain on a torch device: port of the JAX package's
`ops/demosaic_jax.py`, and of the 8-bit outputs' chain of its host model
`ref/demosaic.py`.

All on (N, h, w) int32 batches of the four quarter-res Row16u planes (G,
RG, BG, GD) that the decoder reconstructs, in integer arithmetic:

- `demosaic_raw`: ColorDifference2Bayer (with the reference's scalar tail
  at widths that are not a multiple of 8), the CF-enhanced 5x5 debayer
  with its 3x3 border bracket and explicit edges, and the horizontal and
  vertical Advanced Detail sharpening -> the 16-bit RG48 rows
  (`ref/demosaic.demosaic_raw_rg48`, `Codec/bayer.c:9339`);
- `develop_1d`: the integer 1D-LUT develop, Curve2Linear -> 3x4 matrix
  (one per frame, in int64) -> Linear2Curve -> signed 13-bit values
  (`CURVES_PROCESSING_MACRO`, bayer.c:7164);
- `demosaic_bilinear_rgb` and `convert_rgb16_to_yuyv`: the 8-bit outputs'
  bilinear debayer without sharpening and the deterministic YUYV
  conversion (`ConvertLinesToOutput`, bayer.c:3200-3400).

`develop_1d(demosaic_raw(...))` is the JAX `demosaic_develop` before its
final `<< 3` store.  The debayer computes each of the four Bayer sites on
its own quarter-res lattice, from strided views of the zero-padded mosaic;
the JAX code computes every cell type on the whole mosaic with wrapping
rolls and selects, and the positions where the two differ are the frame
ring, which the explicit edge writes overwrite in both.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from cineform_tpu_torch.ref.demosaic import _RGB2YUV_709, _RGB2YUV_VS709


def _sat16(v: torch.Tensor) -> torch.Tensor:
    return v.clamp(-32768, 32767)


def _sat16u(v: torch.Tensor) -> torch.Tensor:
    return v.clamp(0, 65535)


def _trunc_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """C integer division (truncate toward zero), den > 0."""
    return torch.div(num, den, rounding_mode="trunc")


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg4(a, b, c, d):
    return (a + b + c + d + 2) >> 2


def interleave_sites(q00, q01, q10, q11) -> torch.Tensor:
    """Four (N, h, w) site lattices -> the (N, 2h, 2w) mosaic: q00 at even
    rows and columns, q01 at even rows and odd columns, and so on."""
    n, h, w = q00.shape
    top = torch.stack([q00, q01], dim=-1)
    bottom = torch.stack([q10, q11], dim=-1)
    return torch.stack([top, bottom], dim=-3).reshape(n, 2 * h, 2 * w)


def color_difference_to_bayer(G, RG, BG, GD) -> torch.Tensor:
    """ColorDifference2Bayer (RED_GRN order) -> (N, 2h, 2w) int32 mosaic.

    The first `w & ~7` columns take the SSE path: 14-bit quantization,
    saturating int16 mixes, the zero clamp, <<2.  The scalar tail keeps
    the full 16-bit math (`ref/demosaic.color_difference_to_bayer`)."""
    w = G.shape[-1]
    g14, rg14, bg14 = G >> 2, RG >> 2, BG >> 2
    gd14 = _sat16((GD >> 2) - 8192)
    protect = 0x7FFF - 0x3FFF

    def sse_limit(v):
        x = _sat16(v + protect)
        xu = torch.where(x < 0, x + 0x10000, x)
        return (xu - protect).clamp(min=0) << 2

    r = sse_limit(_sat16(_sat16(_sat16(rg14 - 8192) << 1) + g14))
    b = sse_limit(_sat16(_sat16(_sat16(bg14 - 8192) << 1) + g14))
    g1 = sse_limit(_sat16(g14 + gd14))
    g2 = sse_limit(_sat16(g14 - gd14))
    sse_w = w & ~7
    if sse_w < w:
        tail = slice(sse_w, w)
        g, gd = G[..., tail], GD[..., tail] - 32768
        r[..., tail] = _sat16u(((RG[..., tail] - 32768) << 1) + g)
        b[..., tail] = _sat16u(((BG[..., tail] - 32768) << 1) + g)
        g1[..., tail] = _sat16u(g + gd)
        g2[..., tail] = _sat16u(g - gd)
    return interleave_sites(r, g1, g2, b)


def _sites(pad: torch.Tensor, h: int, w: int, py: int, px: int):
    """p(dy, dx): the neighbour at (dy, dx) of every (py, px) site, a
    strided (N, h, w) view of the mosaic padded by 2."""
    def p(dy, dx):
        y0, x0 = 2 + py + dy, 2 + px + dx
        return pad[:, y0:y0 + 2 * h:2, x0:x0 + 2 * w:2]
    return p


def _red_cell(p):
    """REDCELL (DemoasicFrames.cpp:154): CF-enhanced 5x5 at a red site."""
    b, up, dn, lf, rt = p(0, 0), p(-1, 0), p(1, 0), p(0, -1), p(0, 1)
    ul, ur, dl, dr = p(-1, -1), p(-1, 1), p(1, -1), p(1, 1)
    diffR = (p(0, -2) - p(0, 2)).abs() >> 10
    diffG = (lf - rt).abs() >> 10
    diffB = (ul - dr).abs() >> 10
    fR = 2 + (2 * diffR * diffR) // (2 + diffG * diffG)
    fB = 4 + (4 * diffG * diffG) // (2 + diffB * diffB)
    g = _trunc_div(-p(-2, 0) + up * fR - p(0, -2) + lf * fR + b * 4
                   + rt * fR - p(0, 2) + dn * fR - p(2, 0), 4 * fR)
    bl = _trunc_div(-3 * p(-2, 0) + ul * fB + ur * fB - 3 * p(0, -2)
                    + 12 * b - 3 * p(0, 2) + dl * fB + dr * fB
                    - 3 * p(2, 0), 4 * fB)
    return b, _sat16u(g), _sat16u(bl)


def _grn_red_cell(p):
    """GRNREDCELL: green site on a red row."""
    b, up, dn, lf, rt = p(0, 0), p(-1, 0), p(1, 0), p(0, -1), p(0, 1)
    ul, ur, dl, dr = p(-1, -1), p(-1, 1), p(1, -1), p(1, 1)
    diffR = (lf - rt).abs() >> 10
    diffG = (p(0, -2) - p(0, 2)).abs() >> 10
    diffB = (up - dn).abs() >> 10
    fR = 8 + (4 * diffG * diffG) // (2 + diffR * diffR)
    fB = 8 + (4 * diffG * diffG) // (2 + diffB * diffB)
    r = _trunc_div(p(-2, 0) - 2 * ul - 2 * ur - 2 * p(0, -2) + lf * fR
                   + 10 * b + rt * fR - 2 * p(0, 2) - 2 * dl - 2 * dr
                   + p(2, 0), fR * 2)
    bl = _trunc_div(-2 * p(-2, 0) - 2 * ul + up * fB - 2 * ur + p(0, -2)
                    + 10 * b + p(0, 2) - 2 * dl + dn * fB - 2 * dr
                    - 2 * p(2, 0), fB * 2)
    return _sat16u(r), b, _sat16u(bl)


def _grn_blu_cell(p):
    """GRNBLUCELL: green site on a blue row."""
    b, up, dn, lf, rt = p(0, 0), p(-1, 0), p(1, 0), p(0, -1), p(0, 1)
    ul, ur, dl, dr = p(-1, -1), p(-1, 1), p(1, -1), p(1, 1)
    diffR = (up - dn).abs() >> 10
    diffG = (p(-2, 0) - p(2, 0)).abs() >> 10
    diffB = (lf - rt).abs() >> 10
    fR = 8 + (4 * diffG * diffG) // (2 + diffR * diffR)
    fB = 8 + (4 * diffG * diffG) // (2 + diffB * diffB)
    r = _trunc_div(-2 * p(-2, 0) - 2 * ul + up * fR - 2 * ur + p(0, -2)
                   + 10 * b + p(0, 2) - 2 * dl + dn * fR - 2 * dr
                   - 2 * p(2, 0), fR * 2)
    bl = _trunc_div(p(-2, 0) - 2 * ul - 2 * ur - 2 * p(0, -2) + lf * fB
                    + 10 * b + rt * fB - 2 * p(0, 2) - 2 * dl - 2 * dr
                    + p(2, 0), fB * 2)
    return _sat16u(r), b, _sat16u(bl)


def _blu_cell(p):
    """BLUCELL: blue site."""
    b, up, dn, lf, rt = p(0, 0), p(-1, 0), p(1, 0), p(0, -1), p(0, 1)
    ul, ur, dl, dr = p(-1, -1), p(-1, 1), p(1, -1), p(1, 1)
    diffR = (ul - dr).abs() >> 10
    diffG = (lf - rt).abs() >> 10
    diffB = (p(0, -2) - p(0, 2)).abs() >> 10
    fR = 4 + (4 * diffG * diffG) // (2 + diffR * diffR)
    fB = 2 + (2 * diffB * diffB) // (2 + diffG * diffG)
    r = _trunc_div(-3 * p(-2, 0) + ul * fR + ur * fR - 3 * p(0, -2)
                   + 12 * b - 3 * p(0, 2) + dl * fR + dr * fR
                   - 3 * p(2, 0), fR * 4)
    g = _trunc_div(-p(-2, 0) + up * fB - p(0, -2) + lf * fB + b * 4
                   + rt * fB - p(0, 2) + dn * fB - p(2, 0), fB * 4)
    return _sat16u(r), _sat16u(g), b


def _bracket(p, py: int, px: int):
    """The generic 3x3 bracket at a (py, px) site: the fallback rows and
    the frame ring of the high-quality debayer, everything of the
    bilinear one."""
    b, up, dn, lf, rt = p(0, 0), p(-1, 0), p(1, 0), p(0, -1), p(0, 1)
    if (py, px) == (0, 0):
        return b, _avg4(lf, rt, up, dn), _avg4(p(-1, -1), p(-1, 1),
                                               p(1, -1), p(1, 1))
    if (py, px) == (0, 1):
        return _avg2(lf, rt), b, _avg2(up, dn)
    if (py, px) == (1, 0):
        return _avg2(up, dn), b, _avg2(lf, rt)
    return (_avg4(p(-1, -1), p(-1, 1), p(1, -1), p(1, 1)),
            _avg4(lf, rt, up, dn), b)


_CELLS = {(0, 0): _red_cell, (0, 1): _grn_red_cell, (1, 0): _grn_blu_cell,
          (1, 1): _blu_cell}


def _set_edges(r, g, bl, b) -> None:
    """The debayer's explicit edge writes, in place, in the JAX order:
    columns 0 and w-1, then the first-row and last-row brackets, corners
    last."""
    h, w = b.shape[-2:]
    er, orx = slice(2, h - 1, 2), slice(1, h - 1, 2)
    r[:, er, 0] = b[:, er, 0]
    g[:, er, 0] = _avg2(b[:, 1:h - 2:2, 0], b[:, 3:h:2, 0])
    bl[:, er, 0] = _avg2(b[:, 1:h - 2:2, 1], b[:, 3:h:2, 1])
    r[:, orx, 0] = _avg2(b[:, 0:h - 2:2, 0], b[:, 2:h:2, 0])
    g[:, orx, 0] = b[:, orx, 0]
    bl[:, orx, 0] = b[:, orx, 1]
    r[:, er, w - 1] = b[:, er, w - 2]
    g[:, er, w - 1] = b[:, er, w - 1]
    bl[:, er, w - 1] = _avg2(b[:, 1:h - 2:2, w - 1], b[:, 3:h:2, w - 1])
    r[:, orx, w - 1] = _avg2(b[:, 0:h - 2:2, w - 2], b[:, 2:h:2, w - 2])
    g[:, orx, w - 1] = _avg2(b[:, 0:h - 2:2, w - 1], b[:, 2:h:2, w - 1])
    bl[:, orx, w - 1] = b[:, orx, w - 1]
    xo, xe = slice(1, w - 1, 2), slice(2, w - 1, 2)
    r[:, 0, xo] = _avg2(b[:, 0, 0:w - 2:2], b[:, 0, 2:w:2])
    g[:, 0, xo] = b[:, 0, xo]
    bl[:, 0, xo] = b[:, 1, xo]
    r[:, 0, xe] = b[:, 0, xe]
    g[:, 0, xe] = _avg2(b[:, 0, 1:w - 2:2], b[:, 0, 3:w:2])
    bl[:, 0, xe] = _avg2(b[:, 1, 1:w - 2:2], b[:, 1, 3:w:2])
    r[:, 0, 0] = b[:, 0, 0]
    g[:, 0, 0] = _avg2(b[:, 0, 1], b[:, 1, 0])
    bl[:, 0, 0] = b[:, 1, 1]
    r[:, 0, w - 1] = b[:, 0, w - 2]
    g[:, 0, w - 1] = b[:, 0, w - 1]
    bl[:, 0, w - 1] = b[:, 1, w - 1]
    r[:, h - 1, xo] = _avg2(b[:, h - 2, 0:w - 2:2], b[:, h - 2, 2:w:2])
    g[:, h - 1, xo] = _avg2(b[:, h - 1, 0:w - 2:2], b[:, h - 1, 2:w:2])
    bl[:, h - 1, xo] = b[:, h - 1, xo]
    r[:, h - 1, xe] = b[:, h - 2, xe]
    g[:, h - 1, xe] = b[:, h - 1, xe]
    bl[:, h - 1, xe] = _avg2(b[:, h - 1, 1:w - 2:2], b[:, h - 1, 3:w:2])
    r[:, h - 1, 0] = b[:, h - 2, 0]
    g[:, h - 1, 0] = b[:, h - 1, 0]
    bl[:, h - 1, 0] = b[:, h - 1, 1]
    r[:, h - 1, w - 1] = b[:, h - 2, w - 2]
    g[:, h - 1, w - 1] = b[:, h - 1, w - 2]
    bl[:, h - 1, w - 1] = b[:, h - 1, w - 1]


def debayer(bayer: torch.Tensor, highquality: bool) -> torch.Tensor:
    """(N, H, W) int32 RED_GRN mosaic -> (N, H, W, 3) int32 RGB, before
    sharpening: with `highquality` the CF-enhanced 5x5 cells where they
    apply (even rows 2..H-4, odd rows 3..H-3, columns 2..W-3) and the 3x3
    bracket elsewhere; without, the bracket everywhere (`DebayerLine`'s
    highquality 0).  The explicit edges overwrite the frame ring."""
    n, hh, ww = bayer.shape
    h, w = hh // 2, ww // 2
    pad = F.pad(bayer, (2, 2, 2, 2))
    dev = bayer.device
    lattices = {}
    for py in (0, 1):
        for px in (0, 1):
            p = _sites(pad, h, w, py, px)
            out = _bracket(p, py, px)
            if highquality:
                ys = 2 * torch.arange(h, device=dev) + py
                xs = 2 * torch.arange(w, device=dev) + px
                in_row = ((ys >= 2) & (ys < hh - 2)) if py == 0 else \
                    ((ys >= 3) & (ys < hh - 1))
                inside = in_row[:, None] & ((xs >= 2) & (xs < ww - 2))[None]
                cell = _CELLS[(py, px)](p)
                out = tuple(torch.where(inside, c, o)
                            for c, o in zip(cell, out))
            lattices[(py, px)] = out
    r, g, bl = (interleave_sites(*(lattices[s][c] for s in
                                 ((0, 0), (0, 1), (1, 0), (1, 1))))
                for c in range(3))
    _set_edges(r, g, bl, bayer)
    return torch.stack([r, g, bl], dim=-1)


#: the Advanced Detail sharpening (level 1, the decoder's): the
#: horizontal (-1, B, C, B, -1) >> shift taps
_SHIFT, _B, _C = 4, 4, 10


def sharpen_h(rgb: torch.Tensor) -> torch.Tensor:
    """FastSharpeningBlurHinplace (DemoasicFrames.cpp:345) on every row of
    (N, H, W, 3): the (-1, B, C, B, -1) >> shift taps saturated at columns
    2..W-3, the 1-2-1 blur at columns 1 and W-2, the outer columns kept."""
    w = rgb.shape[2]
    out = rgb.clone()
    out[:, :, 2:w - 2] = _sat16u((-rgb[:, :, 0:w - 4] + _B * rgb[:, :, 1:w - 3]
                                  + _C * rgb[:, :, 2:w - 2]
                                  + _B * rgb[:, :, 3:w - 1]
                                  - rgb[:, :, 4:w]) >> _SHIFT)
    for x in (1, w - 2):
        out[:, :, x] = (rgb[:, :, x - 1] + 2 * rgb[:, :, x]
                        + rgb[:, :, x + 1]) >> 2
    return out


def sharpen_v(rgb: torch.Tensor) -> torch.Tensor:
    """FastSharpeningBlurV (bayer.c:9238), DemosaicRAW job3's pointer walk:
    output row t of pair t//2 takes the tap rows A=t-2, B=t-1 (both t in
    the first pair), D=t+1, E=t+2 (both t in the last pair); the SSE
    unsigned-saturating 5-tap mix, the taps prescaled >> 4 and the
    outer ones and the weights >> 1 more, the sum << 1."""
    prescale, preshift = 4, 1
    bv, cv = _B >> preshift, _C >> preshift
    h = rgb.shape[1]
    t = torch.arange(h, device=rgb.device)
    pair = t // 2
    first, last = pair == 0, pair == (h // 2 - 1)
    rows = {k: torch.where(edge, t, t + d) for k, edge, d in
            (("a", first, -2), ("b", first, -1), ("d", last, 1),
             ("e", last, 2))}
    tap = {k: rgb.index_select(1, i) >> prescale for k, i in rows.items()}
    c = rgb >> prescale
    a, e = tap["a"] >> preshift, tap["e"] >> preshift
    mix = (c * cv) & 0xFFFF
    mix = (mix - a).clamp(min=0)
    mix = (mix - e).clamp(min=0)
    mix = (mix + ((tap["b"] * bv) & 0xFFFF)).clamp(max=0xFFFF)
    mix = (mix + ((tap["d"] * bv) & 0xFFFF)).clamp(max=0xFFFF)
    mix = ((mix + 0x8000).clamp(max=0xFFFF) - 0x8000).clamp(min=0)
    return (mix << (prescale + preshift - _SHIFT)) & 0xFFFF


def demosaic_raw(G, RG, BG, GD) -> torch.Tensor:
    """The DemosaicRAW chain for 16-bit RGB output: un-difference, the
    high-quality debayer, the horizontal then the vertical sharpening.
    (N, h, w) int32 Row16u planes -> (N, 2h, 2w, 3) int32 in [0, 65535],
    `ref/demosaic.demosaic_raw_rg48`."""
    rgb = debayer(color_difference_to_bayer(G, RG, BG, GD), True)
    return sharpen_v(sharpen_h(rgb))


def demosaic_bilinear_rgb(G, RG, BG, GD) -> torch.Tensor:
    """The 8-bit outputs' demosaic: the bilinear bracket everywhere, no
    sharpening (`ref/demosaic.demosaic_bilinear_rgb`).  (N, h, w) planes
    -> (N, 2h, 2w, 3) int32."""
    return debayer(color_difference_to_bayer(G, RG, BG, GD), False)


def develop_1d(rgb16: torch.Tensor, lcm: torch.Tensor, c2l: torch.Tensor,
               l2c: torch.Tensor) -> torch.Tensor:
    """ApplyActiveMetaData's integer 1D-LUT develop:

        lin = Curve2Linear[(v16 >> 3) + 16384]
        n_i = ((lcm[i0]*r + lcm[i1]*g + lcm[i2]*b) >> 13) + lcm[i3]
        out = Linear2Curve[clip(n, -16384, 49151) + 16384]

    rgb16 (N, H, W, 3) int32; lcm (N, 3, 4) int64, `(int)(m * 8192)` of
    each frame's matrix; c2l (49152,) and l2c (65536,) int32 tables on the
    device.  The product is summed in int64, as the host model does (the
    JAX einsum sums in int32).  Returns (N, H, W, 3) int32, signed 13-bit."""
    lin = c2l[((rgb16 >> 3) + 16384).long()].to(torch.int64)
    m = lcm[:, None, None]
    out = []
    for i in range(3):
        n = (m[..., i, 0] * lin[..., 0] + m[..., i, 1] * lin[..., 1]
             + m[..., i, 2] * lin[..., 2]) >> 13
        n = (n + m[..., i, 3]).clamp(-16384, 49151)
        out.append(l2c[n + 16384])
    return torch.stack(out, dim=-1)


def develop_matrix_lcm(matrix: np.ndarray, device) -> torch.Tensor:
    """(N, 3, 4) float develop matrices -> `develop_1d`'s int64 `lcm`,
    `(int)(m * 8192.0)`, on `device` (from pinned memory without waiting
    for the stream, on CUDA)."""
    lcm = np.trunc(np.asarray(matrix, np.float64).reshape(-1, 3, 4) * 8192.0)
    lcm = torch.from_numpy(lcm.astype(np.int64))
    if torch.device(device).type != "cuda":
        return lcm.to(device)
    return lcm.pin_memory().to(device, non_blocking=True)


def _mulhi_coeff(coeff: float) -> int:
    return int(np.trunc(np.float32(coeff) * np.float32(32768.0)))


@lru_cache(maxsize=None)
def _dither_lanes(device: torch.device) -> torch.Tensor:
    """The ordered dither lanes of ConvertLinesToOutput's YUYV store
    (`_mm_set_epi16` arguments are high to low, bayer.c:3222-3232), on
    `device`: luma on odd rows, luma on even rows, and the two chroma
    patterns, which swap with the row parity."""
    return torch.tensor([(9, 7, 11, 5, 13, 3, 15, 1),
                         (1, 15, 3, 13, 5, 11, 7, 9),
                         (18, 14, 22, 10, 26, 6, 30, 2),
                         (2, 30, 6, 26, 10, 22, 14, 18)],
                        dtype=torch.int32, device=device)


def convert_rgb16_to_yuyv(rgb: torch.Tensor, parity: torch.Tensor,
                          whitepoint: int = 16) -> torch.Tensor:
    """ConvertLinesToOutput's YUYV branch (`ref/demosaic.
    convert_rgb16_to_yuyv`, the SSE path: W a multiple of 8): the 13-bit
    rows through the 1.15 mulhi matrix with saturating adds, the in-block
    chroma filter, the ordered dither by row parity, the byte clamp.

    rgb (N, H, W, 3) int32: 16-bit RGB (whitepoint 16, the Rec. 709
    matrix, luma +16) or the develop's signed 13-bit values (whitepoint
    13: the video-safe range conversion and matrix, no luma offset);
    parity (H,) the dither parity of each row (on the device, or copied
    there).  Returns (N, H, 2W) uint8 YUY2 rows (UYVY is their byte pairs
    swapped, as the API stores it)."""
    n, h, w, _ = rgb.shape
    if w % 8:
        raise ValueError(f"the YUYV conversion takes widths that are a "
                         f"multiple of 8, not {w}")
    if whitepoint == 16:
        v13 = rgb >> 3
        coeffs, yoffset = _RGB2YUV_709, 16
    else:
        v = _sat16((((rgb * 28141) >> 16) << 1) + 512)
        t = _sat16(v + (0x7FFF - 0x1FFF)) & 0xFFFF
        v13 = t.clamp(min=0x7FFF - 0x1FFF) - (0x7FFF - 0x1FFF)
        coeffs, yoffset = _RGB2YUV_VS709, 0
    r, g, b = v13[..., 0], v13[..., 1], v13[..., 2]

    def channel(cs):
        mr, mg, mb = (_mulhi_coeff(c) for c in cs)
        return _sat16(_sat16(((r * mr) >> 16) + ((g * mg) >> 16))
                      + ((b * mb) >> 16))

    y, u, v = (channel(cs) for cs in coeffs)
    block0 = (torch.arange(w, device=rgb.device) % 8) == 0

    def blockprev(x):
        prev = F.pad(x[..., :-1], (1, 0))
        return torch.where(block0, 0, prev)

    u = _sat16(u + blockprev(u))
    v = _sat16(v + blockprev(v))
    odd = (parity.to(rgb.device) & 1).bool()[:, None]
    d = _dither_lanes(rgb.device).repeat(1, w // 8)

    def lanes(odd_lanes, even_lanes):
        return torch.where(odd, d[odd_lanes], d[even_lanes])

    y = _sat16(_sat16(_sat16(y + lanes(0, 1)) >> 4) + yoffset)
    u = _sat16(_sat16(u + lanes(2, 3)) >> 5) + 128
    v = _sat16(_sat16(v + lanes(3, 2)) >> 5) + 128

    def clamp255(x):
        t = _sat16(x + (0x7FFF - 0xFF)) & 0xFFFF
        return (t.clamp(min=0x7FFF - 0xFF) - (0x7FFF - 0xFF)) & 0xFF

    y, u, v = clamp255(y), clamp255(u), clamp255(v)
    ye, yo, uo, vo = y[..., 0::2], y[..., 1::2], u[..., 1::2], v[..., 1::2]
    return torch.stack((ye, uo, yo, vo), dim=-1).reshape(n, h, 2 * w).to(torch.uint8)

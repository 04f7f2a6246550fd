"""The Bayer RAW decode to 16-bit RGB in plain NumPy, bit-exact with the
reference SDK's DemosaicRAW chain: ColorDifference2Bayer, the CF-enhanced
5x5 debayer with its horizontal sharpen, and FastSharpeningBlurV
(`Codec/bayer.c:9339`).

A frozen copy of those parts of the JAX package's NumPy oracle
(`ref/demosaic.py`).
"""

from __future__ import annotations

import numpy as np


def _sat16u(v: np.ndarray) -> np.ndarray:
    return np.clip(v, 0, 65535)


def _trunc_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """C integer division: truncation toward zero (numerators can be
    negative; denominators are positive)."""
    q = np.abs(num) // den
    return np.where(num < 0, -q, q)


def color_difference_to_bayer(G, RG, BG, GD, bayer_format: int = 0):
    """ColorDifference2Bayer over all rows -> (2h, 2w) bayer mosaic.

    SSE path for the first width & ~7 columns: all four channels are
    quantized to 14 bits (>>2), mixed with saturating int16 adds, zero
    clamped via the +0x4000 adds/subs_epu16 trick, and restored with <<2;
    the scalar tail keeps the full 16-bit math of GenerateBYR2.
    bayer_format 0 = BAYER_FORMAT_RED_GRN: line A = [r g1 ...],
    line B = [g2 b ...].
    """
    h, w = G.shape
    sse_w = w & ~7

    def sat16(v):
        return np.clip(v, -32768, 32767)

    g14 = (G.astype(np.int64) >> 2)
    rg14 = (RG.astype(np.int64) >> 2)
    bg14 = (BG.astype(np.int64) >> 2)
    gd14 = sat16((GD.astype(np.int64) >> 2) - 8192)

    protect = 0x7FFF - 0x3FFF

    def clamp14(v):
        # adds_epi16(+protect) then subs_epu16(protect): clamp [0, 16383]
        x = sat16(v + protect)
        return np.maximum(x, protect) - protect  # subs_epu16 needs x>=0

    r = sat16(sat16((sat16(rg14 - 8192)) << 1) + g14)
    b = sat16(sat16((sat16(bg14 - 8192)) << 1) + g14)
    g1 = sat16(g14 + gd14)
    g2 = sat16(g14 - gd14)

    # subs_epu16 semantics on the int16 lane: reinterpret as uint16
    def subs_epu16(x, y):
        xu = np.asarray(x) & 0xFFFF
        return np.maximum(xu - y, 0)

    def sse_limit(v):
        x = sat16(v + protect)
        return subs_epu16(x, protect)

    r = (sse_limit(r) << 2) & 0xFFFF
    b = (sse_limit(b) << 2) & 0xFFFF
    g1 = (sse_limit(g1) << 2) & 0xFFFF
    g2 = (sse_limit(g2) << 2) & 0xFFFF

    # scalar tail: full 16-bit math
    if sse_w < w:
        rs, g1s, g2s, bs = generate_byr2_components(
            G[:, sse_w:], RG[:, sse_w:], BG[:, sse_w:], GD[:, sse_w:])
        # the scalar path does not mask the low bit here
        g = G[:, sse_w:].astype(np.int64)
        gd = GD[:, sse_w:].astype(np.int64) - 32768
        rs = np.clip(((RG[:, sse_w:].astype(np.int64) - 32768) << 1) + g,
                     0, 0xFFFF)
        bs = np.clip(((BG[:, sse_w:].astype(np.int64) - 32768) << 1) + g,
                     0, 0xFFFF)
        g1s = np.clip(g + gd, 0, 0xFFFF)
        g2s = np.clip(g - gd, 0, 0xFFFF)
        r[:, sse_w:] = rs
        b[:, sse_w:] = bs
        g1[:, sse_w:] = g1s
        g2[:, sse_w:] = g2s

    out = np.zeros((2 * h, 2 * w), dtype=np.int64)
    if bayer_format == 0:        # RED_GRN
        out[0::2, 0::2] = r
        out[0::2, 1::2] = g1
        out[1::2, 0::2] = g2
        out[1::2, 1::2] = b
    elif bayer_format == 1:      # GRN_RED
        out[0::2, 0::2] = g1
        out[0::2, 1::2] = r
        out[1::2, 0::2] = b
        out[1::2, 1::2] = g2
    elif bayer_format == 2:      # GRN_BLU
        out[0::2, 0::2] = g1
        out[0::2, 1::2] = b
        out[1::2, 0::2] = r
        out[1::2, 1::2] = g2
    else:                        # BLU_GRN
        out[0::2, 0::2] = b
        out[0::2, 1::2] = g1
        out[1::2, 0::2] = g2
        out[1::2, 1::2] = r
    return out


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg4(a, b, c, d):
    return (a + b + c + d + 2) >> 2


def _red_cell(p, width):
    """REDCELL (DemoasicFrames.cpp:154): CF-enhanced 5x5 at a red site.

    ``p(dy, dx)`` returns the neighbor plane slice."""
    diffR = np.abs(p(0, -2) - p(0, 2)) >> 10
    diffG = np.abs(p(0, -1) - p(0, 1)) >> 10
    diffB = np.abs(p(-1, -1) - p(1, 1)) >> 10
    factorR = 2 + (2 * diffR * diffR) // (2 + diffG * diffG)
    factorB = 4 + (4 * diffG * diffG) // (2 + diffB * diffB)
    r = p(0, 0)
    gnum = (-p(-2, 0) + p(-1, 0) * factorR
            - p(0, -2) + p(0, -1) * factorR + p(0, 0) * 4
            + p(0, 1) * factorR - p(0, 2)
            + p(1, 0) * factorR - p(2, 0))
    g = _trunc_div(gnum, 4 * factorR)
    bnum = (-3 * p(-2, 0) + p(-1, -1) * factorB + p(-1, 1) * factorB
            - 3 * p(0, -2) + 12 * p(0, 0) - 3 * p(0, 2)
            + p(1, -1) * factorB + p(1, 1) * factorB - 3 * p(2, 0))
    b = _trunc_div(bnum, 4 * factorB)
    return r & 0xFFFF, _sat16u(g), _sat16u(b)


def _grn_red_cell(p, width):
    """GRNREDCELL: green site on a red row."""
    diffR = np.abs(p(0, -1) - p(0, 1)) >> 10
    diffG = np.abs(p(0, -2) - p(0, 2)) >> 10
    diffB = np.abs(p(-1, 0) - p(1, 0)) >> 10
    factorR = 8 + (4 * diffG * diffG) // (2 + diffR * diffR)
    factorB = 8 + (4 * diffG * diffG) // (2 + diffB * diffB)
    rnum = (p(-2, 0) - 2 * p(-1, -1) - 2 * p(-1, 1)
            - 2 * p(0, -2) + p(0, -1) * factorR + 10 * p(0, 0)
            + p(0, 1) * factorR - 2 * p(0, 2)
            - 2 * p(1, -1) - 2 * p(1, 1) + p(2, 0))
    r = _trunc_div(rnum, factorR * 2)
    g = p(0, 0)
    bnum = (-2 * p(-2, 0) - 2 * p(-1, -1) + p(-1, 0) * factorB
            - 2 * p(-1, 1) + p(0, -2) + 10 * p(0, 0) + p(0, 2)
            - 2 * p(1, -1) + p(1, 0) * factorB - 2 * p(1, 1)
            - 2 * p(2, 0))
    b = _trunc_div(bnum, factorB * 2)
    return _sat16u(r), g & 0xFFFF, _sat16u(b)


def _grn_blu_cell(p, width):
    """GRNBLUCELL: green site on a blue row."""
    diffR = np.abs(p(-1, 0) - p(1, 0)) >> 10
    diffG = np.abs(p(-2, 0) - p(2, 0)) >> 10
    diffB = np.abs(p(0, -1) - p(0, 1)) >> 10
    factorR = 8 + (4 * diffG * diffG) // (2 + diffR * diffR)
    factorB = 8 + (4 * diffG * diffG) // (2 + diffB * diffB)
    rnum = (-2 * p(-2, 0) - 2 * p(-1, -1) + p(-1, 0) * factorR
            - 2 * p(-1, 1) + p(0, -2) + 10 * p(0, 0) + p(0, 2)
            - 2 * p(1, -1) + p(1, 0) * factorR - 2 * p(1, 1)
            - 2 * p(2, 0))
    r = _trunc_div(rnum, factorR * 2)
    g = p(0, 0)
    bnum = (p(-2, 0) - 2 * p(-1, -1) - 2 * p(-1, 1)
            - 2 * p(0, -2) + p(0, -1) * factorB + 10 * p(0, 0)
            + p(0, 1) * factorB - 2 * p(0, 2)
            - 2 * p(1, -1) - 2 * p(1, 1) + p(2, 0))
    b = _trunc_div(bnum, factorB * 2)
    return _sat16u(r), g & 0xFFFF, _sat16u(b)


def _blu_cell(p, width):
    """BLUCELL: blue site."""
    diffR = np.abs(p(-1, -1) - p(1, 1)) >> 10
    diffG = np.abs(p(0, -1) - p(0, 1)) >> 10
    diffB = np.abs(p(0, -2) - p(0, 2)) >> 10
    factorR = 4 + (4 * diffG * diffG) // (2 + diffR * diffR)
    factorB = 2 + (2 * diffB * diffB) // (2 + diffG * diffG)
    rnum = (-3 * p(-2, 0) + p(-1, -1) * factorR + p(-1, 1) * factorR
            - 3 * p(0, -2) + 12 * p(0, 0) - 3 * p(0, 2)
            + p(1, -1) * factorR + p(1, 1) * factorR - 3 * p(2, 0))
    r = _trunc_div(rnum, factorR * 4)
    gnum = (-p(-2, 0) + p(-1, 0) * factorB
            - p(0, -2) + p(0, -1) * factorB + 4 * p(0, 0)
            + p(0, 1) * factorB - p(0, 2)
            + p(1, 0) * factorB - p(2, 0))
    g = _trunc_div(gnum, factorB * 4)
    b = p(0, 0)
    return _sat16u(r), _sat16u(g), b & 0xFFFF


def _sharpen_h(row_rgb: np.ndarray, sharpening: int) -> np.ndarray:
    """FastSharpeningBlurHinplace (DemoasicFrames.cpp:345): per-channel
    horizontal 5-tap sharpen on an interleaved (w, 3) row.  Pixels 0 and
    w-1 keep their values, pixels 1 and w-2 get the 1-2-1 blur, the
    interior gets (-1, B, C, B, -1) >> shift with SATURATE16."""
    shift, B, C = {1: (4, 4, 10), 2: (3, 2, 6), 3: (2, 1, 4)}[sharpening]
    w = row_rgb.shape[0]
    out = row_rgb.copy()
    if w < 4:
        return out
    out[1] = (row_rgb[0] + 2 * row_rgb[1] + row_rgb[2]) >> 2
    out[w - 2] = (row_rgb[w - 3] + 2 * row_rgb[w - 2] + row_rgb[w - 1]) >> 2
    if w > 4:
        mid = (-row_rgb[0:w - 4]
               + B * row_rgb[1:w - 3]
               + C * row_rgb[2:w - 2]
               + B * row_rgb[3:w - 1]
               - row_rgb[4:w]) >> shift
        out[2:w - 2] = _sat16u(mid)
    return out


def debayer_line_red_grn(bayer: np.ndarray, y: int, highquality: int = 1,
                         sharpening: int = 1) -> np.ndarray:
    """DoDEBAYER_ORDER_RED_GRN for one mosaic row pair.

    ``bayer``: the (2h, 2w) mosaic (int64); ``y``: EVEN bayer row index.
    Returns the two demosaiced rows as (2, 2w, 3) int64, after the
    horizontal blur/sharpen pass."""
    height, width = bayer.shape
    row = y
    oddrow = row + 1
    out = np.zeros((2, width, 3), dtype=np.int64)

    def prow(r, base_row):
        def p(dy, dx):
            rr = base_row + dy
            return bayer[rr, 2 + dx: width - 2 + dx]
        return p

    # --- even row (red/green) -------------------------------------------
    even_hq = highquality and 0 < row < height - 2
    if even_hq:
        b = bayer
        o = out[0]
        # first red cell
        o[0, 0] = b[row, 0]
        o[0, 1] = _avg2(b[row - 1, 0], b[row + 1, 0])
        o[0, 2] = _avg2(b[row - 1, 1], b[row + 1, 1])
        # first green cell
        o[1, 0] = _avg2(b[row, 0], b[row, 2])
        o[1, 1] = b[row, 1]
        o[1, 2] = _avg2(b[row - 1, 1], b[row + 1, 1])
        # interior: red cells at even x, green cells at odd x
        p = prow(row, row)
        r, g, bl = _red_cell(p, width)
        o[2:width - 2:2, 0] = r[0:width - 4:2]
        o[2:width - 2:2, 1] = g[0:width - 4:2]
        o[2:width - 2:2, 2] = bl[0:width - 4:2]
        r, g, bl = _grn_red_cell(p, width)
        o[3:width - 2:2, 0] = r[1:width - 4:2]
        o[3:width - 2:2, 1] = g[1:width - 4:2]
        o[3:width - 2:2, 2] = bl[1:width - 4:2]
        # last red cell (x = width-2)
        x = width - 2
        o[x, 0] = b[row, x]
        o[x, 1] = _avg4(b[row, x - 1], b[row, x + 1],
                        b[row - 1, x], b[row + 1, x])
        o[x, 2] = _avg4(b[row - 1, x - 1], b[row - 1, x + 1],
                        b[row + 1, x - 1], b[row + 1, x + 1])
        # last green cell (x = width-1)
        x = width - 1
        o[x, 0] = b[row, x - 1]
        o[x, 1] = b[row, x]
        o[x, 2] = _avg2(b[row - 1, x], b[row + 1, x])
    else:
        b = bayer
        o = out[0]
        if row > 0:
            o[0, 0] = b[row, 0]
            o[0, 1] = _avg2(b[row - 1, 0], b[row + 1, 0])
            o[0, 2] = _avg2(b[row - 1, 1], b[row + 1, 1])
            xs = np.arange(1, width - 1, 2)
            o[xs, 0] = _avg2(b[row, xs - 1], b[row, xs + 1])
            o[xs, 1] = b[row, xs]
            o[xs, 2] = _avg2(b[row - 1, xs], b[row + 1, xs])
            xr = np.arange(2, width - 1, 2)
            o[xr, 0] = b[row, xr]
            o[xr, 1] = _avg4(b[row, xr - 1], b[row, xr + 1],
                             b[row - 1, xr], b[row + 1, xr])
            o[xr, 2] = _avg4(b[row - 1, xr - 1], b[row - 1, xr + 1],
                             b[row + 1, xr - 1], b[row + 1, xr + 1])
            x = width - 1
            o[x, 0] = b[row, x - 1]
            o[x, 1] = b[row, x]
            o[x, 2] = _avg2(b[row - 1, x], b[row + 1, x])
        else:
            o[0, 0] = b[row, 0]
            o[0, 1] = _avg2(b[row, 1], b[row + 1, 0])
            o[0, 2] = b[row + 1, 1]
            xs = np.arange(1, width - 1, 2)
            o[xs, 0] = _avg2(b[row, xs - 1], b[row, xs + 1])
            o[xs, 1] = b[row, xs]
            o[xs, 2] = b[row + 1, xs]
            xr = np.arange(2, width - 1, 2)
            o[xr, 0] = b[row, xr]
            o[xr, 1] = _avg2(b[row, xr - 1], b[row, xr + 1])
            o[xr, 2] = _avg2(b[row + 1, xr - 1], b[row + 1, xr + 1])
            x = width - 1
            o[x, 0] = b[row, x - 1]
            o[x, 1] = b[row, x]
            o[x, 2] = b[row + 1, x]

    # --- odd row (green/blue) -------------------------------------------
    odd_hq = highquality and 1 < oddrow < height - 1
    b = bayer
    o = out[1]
    if odd_hq:
        o[0, 0] = _avg2(b[oddrow - 1, 0], b[oddrow + 1, 0])
        o[0, 1] = b[oddrow, 0]
        o[0, 2] = b[oddrow, 1]
        o[1, 0] = _avg4(b[oddrow - 1, 0], b[oddrow - 1, 2],
                        b[oddrow + 1, 0], b[oddrow + 1, 2])
        o[1, 1] = _avg4(b[oddrow, 0], b[oddrow, 2],
                        b[oddrow - 1, 1], b[oddrow + 1, 1])
        o[1, 2] = b[oddrow, 1]
        p = prow(oddrow, oddrow)
        r, g, bl = _grn_blu_cell(p, width)
        o[2:width - 2:2, 0] = r[0:width - 4:2]
        o[2:width - 2:2, 1] = g[0:width - 4:2]
        o[2:width - 2:2, 2] = bl[0:width - 4:2]
        r, g, bl = _blu_cell(p, width)
        o[3:width - 2:2, 0] = r[1:width - 4:2]
        o[3:width - 2:2, 1] = g[1:width - 4:2]
        o[3:width - 2:2, 2] = bl[1:width - 4:2]
        x = width - 2
        o[x, 0] = _avg2(b[oddrow - 1, x], b[oddrow + 1, x])
        o[x, 1] = b[oddrow, x]
        o[x, 2] = _avg2(b[oddrow, x - 1], b[oddrow, x + 1])
        x = width - 1
        o[x, 0] = _avg2(b[oddrow - 1, x - 1], b[oddrow + 1, x - 1])
        o[x, 1] = _avg2(b[oddrow - 1, x], b[oddrow + 1, x])
        o[x, 2] = b[oddrow, x]
    else:
        if oddrow < height - 1:
            o[0, 0] = _avg2(b[oddrow - 1, 0], b[oddrow + 1, 0])
            o[0, 1] = b[oddrow, 0]
            o[0, 2] = b[oddrow, 1]
            xb = np.arange(1, width - 1, 2)
            o[xb, 0] = _avg4(b[oddrow - 1, xb - 1], b[oddrow - 1, xb + 1],
                             b[oddrow + 1, xb - 1], b[oddrow + 1, xb + 1])
            o[xb, 1] = _avg4(b[oddrow, xb - 1], b[oddrow, xb + 1],
                             b[oddrow - 1, xb], b[oddrow + 1, xb])
            o[xb, 2] = b[oddrow, xb]
            xg = np.arange(2, width - 1, 2)
            o[xg, 0] = _avg2(b[oddrow - 1, xg], b[oddrow + 1, xg])
            o[xg, 1] = b[oddrow, xg]
            o[xg, 2] = _avg2(b[oddrow, xg - 1], b[oddrow, xg + 1])
            x = width - 1
            o[x, 0] = _avg2(b[oddrow - 1, x - 1], b[oddrow + 1, x - 1])
            o[x, 1] = _avg2(b[oddrow - 1, x], b[oddrow + 1, x])
            o[x, 2] = b[oddrow, x]
        else:
            o[0, 0] = b[oddrow - 1, 0]
            o[0, 1] = b[oddrow, 0]
            o[0, 2] = b[oddrow, 1]
            xb = np.arange(1, width - 1, 2)
            o[xb, 0] = _avg2(b[oddrow - 1, xb - 1], b[oddrow - 1, xb + 1])
            o[xb, 1] = _avg2(b[oddrow, xb - 1], b[oddrow, xb + 1])
            o[xb, 2] = b[oddrow, xb]
            xg = np.arange(2, width - 1, 2)
            o[xg, 0] = b[oddrow - 1, xg]
            o[xg, 1] = b[oddrow, xg]
            o[xg, 2] = _avg2(b[oddrow, xg - 1], b[oddrow, xg + 1])
            # final blue cell: grn comes from the SAME row's x-1
            # (DemoasicFrames.cpp last-row tail)
            x = width - 1
            o[x, 0] = b[oddrow - 1, x - 1]
            o[x, 1] = b[oddrow, x - 1]
            o[x, 2] = b[oddrow, x]

    if sharpening == 0:
        raise NotImplementedError("FastBlurHinplace")
    elif sharpening in (1, 2, 3):
        out[0] = _sharpen_h(out[0], sharpening)
        out[1] = _sharpen_h(out[1], sharpening)
    return out


def fast_sharpening_blur_v(A, B, C, D, E, sharpening: int = 1):
    """FastSharpeningBlurV (bayer.c:9238): the SSE 5-tap vertical sharpen
    on interleaved RGB rows (uint16 lanes).

    sharpening=1: lanes are prescaled >>4, A/E further >>1, taps
    (B, C) = (2, 5) via mullo, accumulated with unsigned saturating
    adds/subs, clamped to 0x7fff by the +-0x8000 trick, then <<1."""
    params = {1: (4, 4, 10, 1, 4), 2: (3, 2, 6, 0, 4), 3: (2, 1, 4, 0, 3)}
    shift, Bc, Cc, preshift, prescale = params[sharpening]
    shiftsse2 = shift - prescale
    if preshift:
        Bc >>= preshift
        Cc >>= preshift
        shiftsse2 -= preshift
    a = A.astype(np.int64) >> prescale
    b = B.astype(np.int64) >> prescale
    c = C.astype(np.int64) >> prescale
    d = D.astype(np.int64) >> prescale
    e = E.astype(np.int64) >> prescale
    if preshift:
        a >>= preshift
        e >>= preshift
    mix = (c * Cc) & 0xFFFF
    mix = np.maximum(mix - a, 0)                 # subs_epu16
    mix = np.maximum(mix - e, 0)
    mix = np.minimum(mix + ((b * Bc) & 0xFFFF), 0xFFFF)   # adds_epu16
    mix = np.minimum(mix + ((d * Bc) & 0xFFFF), 0xFFFF)
    mix = np.minimum(mix + 0x8000, 0xFFFF)       # clamp to 0x7fff
    mix = np.maximum(mix - 0x8000, 0)
    return (mix << (-shiftsse2)) & 0xFFFF if shiftsse2 < 0 else \
        (mix >> shiftsse2)


def demosaic_raw_rg48(G, RG, BG, GD, bayer_format: int = 0,
                      sharpening: int = 1) -> np.ndarray:
    """Full DemosaicRAW chain for 16-bit RGB output (highquality 5x5,
    Advanced Detail 1): ColorDifference2Bayer -> DebayerLine (with the
    horizontal sharpen) -> FastSharpeningBlurV -> interleaved RGB48 rows
    (the RG48 whitepoint-16 store is a direct copy, bayer.c:1393-1401).

    Returns (2h, 2w, 3) uint16."""
    bayer = color_difference_to_bayer(G, RG, BG, GD, bayer_format)
    h2, w2 = bayer.shape
    h = h2 // 2

    rgb = np.zeros((h2, w2, 3), dtype=np.int64)
    for y in range(h):
        rgb[2 * y:2 * y + 2] = debayer_line_red_grn(
            bayer, 2 * y, highquality=1, sharpening=sharpening)

    flat = rgb.reshape(h2, -1)
    out = np.zeros_like(flat)
    for y in range(h):
        C = 2 * y
        Br = C - 1 if y >= 1 else C
        Ar = Br - 1 if y >= 1 else Br
        Dr = C + 1 if y < h - 1 else C
        Er = Dr + 1 if y < h - 1 else Dr
        out[2 * y] = fast_sharpening_blur_v(
            flat[Ar], flat[Br], flat[C], flat[Dr], flat[Er], sharpening)
        out[2 * y + 1] = fast_sharpening_blur_v(
            flat[Ar + 1], flat[Br + 1], flat[C + 1],
            flat[min(Dr + 1, h2 - 1)], flat[min(Er + 1, h2 - 1)],
            sharpening)
    return out.reshape(h2, w2, 3).astype(np.uint16)


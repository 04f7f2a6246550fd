"""Production CFHD intra transform as PyTorch tensor functions.

Port of `cineform_tpu.ops.intra_transform` (the 4:2:2 YUY2, UYVY, YU64 and
V210 paths, the RGB 4:4:4 RG48, the RGBA 4:4:4:4 B64A and RG64, the Bayer
BYR4 and BYR5, the decoder's dequantization, and the two-frame GOP's
row-0 carry and stale-bottom inverse), bit-exact against it and
therefore against the NumPy oracle
`cineform_tpu.ref.intra` and the reference SDK; the interlaced group's
frame inverse and the output's scalar tail follow the NumPy oracles
`cineform_tpu.ref.gop` and `ref.intra`, which have no JAX twin.  All
arithmetic is int32 on tensors of any leading shape; planes are (..., H,
W).

These plain versions run on any device.  The forward level
(`dwt2d_forward`) is also the reference that the hand-written CUDA level
(`ops.dwt_forward`) is held against; the inverse half has no kernel.

Behavioural contract: the production SSE2 kernels
(`Codec/spatial.c:14122` FilterSpatialYUVQuant16s,
 `Codec/spatial.c:3669`  FilterHorizontalRow10bit16s,
 `Codec/quantize.c:1256` QuantizeRow16sTo16s,
 `Codec/InvertHorizontalStrip16s.c:1374/3770` inverse strips).
"""

from __future__ import annotations

import torch

ROUNDING = 4


def sat16(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-32768, 32767)


def wrap16(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret as int16 (C short wraparound)."""
    return ((x + 32768) & 0xFFFF) - 32768


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = torch.stack([even, odd], dim=-1)
    return out.reshape(*even.shape[:-1], even.shape[-1] * 2)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def h26_forward(x: torch.Tensor, prescale: int = 0,
                row0_prev: torch.Tensor | None = None):
    """Horizontal production 2-6 forward along the last axis.

    prescale=2: per-tap (x+3)>>2 for the highpass, (x0+x1+3)>>2 lowpass
    (`FilterHorizontalRow10bit16s`).
    row0_prev: the raw (..., 2) pixels that precede the first row in
    memory, for the narrow-row quirk below (the GOP's temporal-high
    spatial reads the temporal lowpass' last two pixels there)."""
    even, odd = x[..., 0::2], x[..., 1::2]
    if prescale:
        r = (1 << prescale) - 1
        pe = (even + r) >> prescale
        po = (odd + r) >> prescale
        low = (even + odd + r) >> prescale
    else:
        pe, po = even, odd
        low = even + odd
    plow = pe + po
    diff = pe - po
    interior = ((-plow[..., :-2] + plow[..., 2:] + ROUNDING) >> 3) + diff[..., 1:-1]
    first = (
        5 * pe[..., 0] - 11 * po[..., 0]
        + 4 * pe[..., 1] + 4 * po[..., 1]
        - pe[..., 2] - po[..., 2] + ROUNDING
    ) >> 3
    if x.shape[-1] <= 16:
        # Narrow-row quirk of the reference's SSE2 row filters
        # (`Codec/spatial.c:912-1016,3669-4001`): at width <= 16 the SIMD
        # main loop never runs and the scalar tail applies the CENTER
        # filter at column 0, whose input[-2..-1] overread lands on the
        # previous row's last two (prescaled) pixels when the row pitch is
        # a multiple of 8 pixels, and on zeros otherwise and on the first
        # row unless `row0_prev` gives its predecessor (ref/intra.
        # _h26_forward, validated at 64x48..144x96).
        prev = torch.zeros_like(plow[..., 0])
        if x.shape[-1] % 8 == 0:
            prev[..., 1:] = plow[..., :-1, -1]
            if row0_prev is not None:
                p = row0_prev
                if prescale:
                    p = (p + ((1 << prescale) - 1)) >> prescale
                prev[..., 0] = p[..., 0] + p[..., 1]
        first = ((-prev + plow[..., 1] + ROUNDING) >> 3) + diff[..., 0]
    last = (
        11 * pe[..., -1] - 5 * po[..., -1]
        - 4 * po[..., -2] - 4 * pe[..., -2]
        + po[..., -3] + pe[..., -3] + ROUNDING
    ) >> 3
    high = torch.cat([first[..., None], interior, last[..., None]], dim=-1)
    return sat16(low), sat16(high)


def v26_forward(x: torch.Tensor):
    """Vertical production 2-6 forward along axis -2 (borders use the raw
    first/last six rows, `Codec/spatial.c:14266,9968`)."""
    even, odd = x[..., 0::2, :], x[..., 1::2, :]
    low = even + odd
    diff = even - odd
    interior = ((-low[..., :-2, :] + low[..., 2:, :] + ROUNDING) >> 3) + diff[..., 1:-1, :]
    first = (
        5 * x[..., 0:1, :] - 11 * x[..., 1:2, :]
        + 4 * x[..., 2:3, :] + 4 * x[..., 3:4, :]
        - x[..., 4:5, :] - x[..., 5:6, :] + ROUNDING
    ) >> 3
    last = (
        11 * x[..., -2:-1, :] - 5 * x[..., -1:, :]
        - 4 * x[..., -3:-2, :] - 4 * x[..., -4:-3, :]
        + x[..., -5:-4, :] + x[..., -6:-5, :] + ROUNDING
    ) >> 3
    high = torch.cat([first, interior, last], dim=-2)
    return sat16(low), sat16(high)


def quantize(v: torch.Tensor, q: int) -> torch.Tensor:
    """Production dead-zone quantizer (`Codec/quantize.c:1256`)."""
    if q <= 1:
        return v
    mult = (1 << 16) // q
    mid = q // 2
    if mid:
        mid -= 1
    mag = (((v.abs() + mid) & 0xFFFF) * mult) >> 16
    return torch.sign(v) * mag


def _compand_mag(c: torch.Tensor) -> torch.Tensor:
    """Cubic companded magnitude: c + (c^3*768)>>24, rewritten shift-exact
    as (c^3*3)>>16 so it stays in int32 (`Codec/codebooks.c:1048`)."""
    return c + ((c * c * c * 3) >> 16)


def requantize_magnitude(m: torch.Tensor) -> torch.Tensor:
    """Quantized magnitude -> reconstructed magnitude after the encoder's
    cubic companding and the decoder's expansion (ScaleFSM), i.e.
    mag(max{code : mag(code) <= m}), by an 8-step binary search over the
    monotone companding curve (elementwise, no table gather)."""
    c = torch.zeros_like(m)
    for bit in (128, 64, 32, 16, 8, 4, 2, 1):
        t = c | bit
        c = torch.where(_compand_mag(t) <= m, t, c)
    return _compand_mag(c)


def dequantize(codes: torch.Tensor, q: int) -> torch.Tensor:
    """FSM dequantization: clamp, compand and expand, then the int16
    wrapping multiply (`ScaleFSM` + `DeQuantFSM`, `Codec/decoder.c:20551`)."""
    mag = requantize_magnitude(codes.clamp(-1023, 1023).abs())
    return wrap16(torch.sign(codes) * mag * q)


def dwt2d_forward(x: torch.Tensor, prescale: int = 0,
                  quant: tuple[int, int, int] | None = None,
                  row0_prev: torch.Tensor | None = None):
    """One production 2D level; returns (LL, (LH, HL, HH))."""
    low, high = h26_forward(x, prescale, row0_prev)
    ll, hl = v26_forward(low)
    lh, hh = v26_forward(high)
    if quant is not None:
        lh = quantize(lh, quant[0])
        hl = quantize(hl, quant[1])
        hh = quantize(hh, quant[2])
    return ll, (lh, hl, hh)


def forward_channel(plane: torch.Tensor, band_quant, prescale):
    """3-level intra forward; returns (lowpass, [(LH, HL, HH)] finest first)."""
    ll = plane
    bands = []
    for k in range(3):
        ll, highs = dwt2d_forward(ll, prescale[k], tuple(band_quant[k]))
        bands.append(highs)
    return ll, bands


# ---------------------------------------------------------------------------
# Inverse
# ---------------------------------------------------------------------------

def v26_inverse(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    te = (low[..., :-2, :] - low[..., 2:, :] + ROUNDING) >> 3
    to = (-low[..., :-2, :] + low[..., 2:, :] + ROUNDING) >> 3
    even_i = (te + low[..., 1:-1, :] + high[..., 1:-1, :]) >> 1
    odd_i = (to + low[..., 1:-1, :] - high[..., 1:-1, :]) >> 1
    t0e = (11 * low[..., 0:1, :] - 4 * low[..., 1:2, :] + low[..., 2:3, :] + ROUNDING) >> 3
    t0o = (5 * low[..., 0:1, :] + 4 * low[..., 1:2, :] - low[..., 2:3, :] + ROUNDING) >> 3
    even_f = (t0e + high[..., 0:1, :]) >> 1
    odd_f = (t0o - high[..., 0:1, :]) >> 1
    tke = (5 * low[..., -1:, :] + 4 * low[..., -2:-1, :] - low[..., -3:-2, :] + ROUNDING) >> 3
    tko = (11 * low[..., -1:, :] - 4 * low[..., -2:-1, :] + low[..., -3:-2, :] + ROUNDING) >> 3
    even_l = (tke + high[..., -1:, :]) >> 1
    odd_l = (tko - high[..., -1:, :]) >> 1
    even = sat16(torch.cat([even_f, even_i, even_l], dim=-2))
    odd = sat16(torch.cat([odd_f, odd_i, odd_l], dim=-2))
    out = torch.stack([even, odd], dim=-2)  # (..., half, 2, W)
    return out.reshape(*even.shape[:-2], even.shape[-2] * 2, even.shape[-1])


def _h26_inverse_parts(low: torch.Tensor, high: torch.Tensor):
    """Shared horizontal inverse terms (before descale/output handling)."""
    te = (low[..., :-2] - low[..., 2:] + ROUNDING) >> 3
    to = (-low[..., :-2] + low[..., 2:] + ROUNDING) >> 3
    even_i = te + low[..., 1:-1] + high[..., 1:-1]
    odd_i = to + low[..., 1:-1] - high[..., 1:-1]
    t0e = (11 * low[..., 0] - 4 * low[..., 1] + low[..., 2] + ROUNDING) >> 3
    t0o = (5 * low[..., 0] + 4 * low[..., 1] - low[..., 2] + ROUNDING) >> 3
    even_f = t0e + high[..., 0]
    odd_f = t0o - high[..., 0]
    tke = (5 * low[..., -1] + 4 * low[..., -2] - low[..., -3] + ROUNDING) >> 3
    tko = (11 * low[..., -1] - 4 * low[..., -2] + low[..., -3] + ROUNDING) >> 3
    even_l = tke + high[..., -1]
    odd_l = tko - high[..., -1]
    even = torch.cat([even_f[..., None], even_i, even_l[..., None]], -1)
    odd = torch.cat([odd_f[..., None], odd_i, odd_l[..., None]], -1)
    return even, odd


def h26_inverse(low: torch.Tensor, high: torch.Tensor,
                descale: int = 1) -> torch.Tensor:
    """Horizontal inverse; descale=2 keeps the extra bit (<<1 instead of >>1,
    `InvertHorizontalStripDescale16s`)."""
    even, odd = _h26_inverse_parts(low, high)
    if descale == 2:
        even, odd = even << 1, odd << 1
    else:
        even, odd = even >> 1, odd >> 1
    return _interleave(sat16(even), sat16(odd))


def expand_dither_rows(row_draws: torch.Tensor, width: int,
                       group: int | None = None) -> torch.Tensor:
    """Expand the (H, 16) per-row dither draws to an (H, width) int32 plane
    (ref/intra.decode_dither_plane).  The SSE lane pattern
    `m%8 + 8*((m//8)%2)` has period 16, so the expansion is a tile; the
    four border columns (and, when the width leaves a half-step remainder
    of `group`, the final `group` columns — the reference's undithered
    scalar tail) are zero."""
    h = row_draws.shape[0]
    reps = -(-(width - 4) // 16)
    mid = row_draws.to(torch.int32).tile((1, reps))[:, :width - 4]
    z2 = torch.zeros((h, 2), dtype=torch.int32, device=row_draws.device)
    d = torch.cat([z2, mid, z2], dim=1)
    if group and width % (2 * group) == group:
        d[:, width - group:] = 0
    return d


def h26_inverse_to_output(low: torch.Tensor, high: torch.Tensor,
                          descale_shift: int = 2,
                          dither: torch.Tensor | None = None,
                          scalar_tail: int = 0) -> torch.Tensor:
    """Final horizontal inverse fused with 8-bit output conversion
    (`InvertHorizontalStrip16s.c:3770`), byte-exact vs the reference:
    interior (max(6tap±high, 0) + 3 + 2*dither) >> 3 with dither in {0,1};
    borders (6tap±high + 3) >> 3, undithered.  `scalar_tail` output
    columns at the row's end go through the reference's scalar loop
    (`InvertHorizontalStrip16s.c:4680+`): plain arithmetic, no dither and
    no lane wrap.  Returns uint8."""
    total = descale_shift + 1
    bias = (1 << (total - 1)) - 1
    te = (low[..., :-2] - low[..., 2:] + ROUNDING) >> 3
    to = (-low[..., :-2] + low[..., 2:] + ROUNDING) >> 3

    # exact int16 SSE lane semantics incl. the +2048 adds/subs_epu16 wrap
    # for sums below -2048 (mirrors ref/intra.h26_inverse_to_output)
    def _sse_lane(t, sign, d):
        e1 = sat16(t + low[..., 1:-1] + bias)
        x = sat16(sat16(e1 + 2048) + sign * high[..., 1:-1])
        u = x & 0xFFFF
        y = torch.where(u >= 2048, u - 2048, 0)
        s = wrap16(y) >> 1
        t8 = sat16(s + d)
        return wrap16((t8 & 0xFFFF) >> descale_shift).clamp(0, 255)

    de = dither[..., 0::2][..., 1:-1] if dither is not None else 0
    do = dither[..., 1::2][..., 1:-1] if dither is not None else 0
    even_i = _sse_lane(te, +1, de)
    odd_i = _sse_lane(to, -1, do)
    # the scalar region's last pair is the right border (below), which
    # leaves scalar_tail / 2 - 1 interior pairs
    n = scalar_tail // 2 - 1
    if n > 0:
        even_i[..., -n:] = ((te + low[..., 1:-1] + high[..., 1:-1]).clamp(
            min=0)[..., -n:] + bias) >> total
        odd_i[..., -n:] = ((to + low[..., 1:-1] - high[..., 1:-1]).clamp(
            min=0)[..., -n:] + bias) >> total
    t0e = (11 * low[..., 0] - 4 * low[..., 1] + low[..., 2] + ROUNDING) >> 3
    t0o = (5 * low[..., 0] + 4 * low[..., 1] - low[..., 2] + ROUNDING) >> 3
    even_f = ((t0e + high[..., 0] + bias) >> total)[..., None]
    odd_f = ((t0o - high[..., 0] + bias) >> total)[..., None]
    tke = (5 * low[..., -1] + 4 * low[..., -2] - low[..., -3] + ROUNDING) >> 3
    tko = (11 * low[..., -1] - 4 * low[..., -2] + low[..., -3] + ROUNDING) >> 3
    even_l = ((tke + high[..., -1] + bias) >> total)[..., None]
    odd_l = ((tko - high[..., -1] + bias) >> total)[..., None]
    even = torch.cat([even_f, even_i, even_l], -1)
    odd = torch.cat([odd_f, odd_i, odd_l], -1)
    return _interleave(even, odd).clamp(0, 255).to(torch.uint8)


def v26_inverse_shifted_bottom(low: torch.Tensor,
                               high: torch.Tensor) -> torch.Tensor:
    """v26_inverse with the bottom border taps one row stale
    (`InvertSpatialQuantOverflowProtected16s` advances its lowpass pointer
    past its border filter, `Codec/spatial.c:21114+690`): the GOP's w5
    and w3 inverses apply it to the (LL, HL) vertical pair."""
    out = v26_inverse(low, high)
    tke = (5 * low[..., -2, :] + 4 * low[..., -3, :]
           - low[..., -4, :] + ROUNDING) >> 3
    tko = (11 * low[..., -2, :] - 4 * low[..., -3, :]
           + low[..., -4, :] + ROUNDING) >> 3
    last2 = torch.stack([sat16((tke + high[..., -1, :]) >> 1),
                         sat16((tko - high[..., -1, :]) >> 1)], dim=-2)
    return torch.cat([out[..., :-2, :], last2], dim=-2)


def dwt2d_inverse(ll, lh, hl, hh, descale: int = 1,
                  bottom_shift: bool = False) -> torch.Tensor:
    v26 = v26_inverse_shifted_bottom if bottom_shift else v26_inverse
    low = v26(ll, hl)
    high = v26_inverse(lh, hh)
    return h26_inverse(low, high, descale)


def frame_wavelet_inverse(ll, lh, hl, hh, dither: torch.Tensor,
                          channel: int) -> torch.Tensor:
    """Inverse of the interlaced group's HORZTEMP frame wavelet to 8-bit
    rows: the horizontal 2-6 inverse, then the 2-2 row expansion
    (`InvertInterlacedRow16s10bitToYUV`, `Codec/temporal.c:5961`): even =
    clamp_0..2047(low - high) >> 1, odd = clamp(low + high) >> 1, then
    (row + dither) >> 2.

    `hl` holds the dequantized, difference-coded values: the row cumsum
    (`Codec/entropy_threading.c:205`, int16 wrap) is applied here.
    `dither` (pairs, 16) holds the {0, 1} draws of each output row pair
    (`ref.gop.interlaced_dither_rows`); luma's even rows take lanes 0-7
    and 8-15 alternating every 8 columns and its odd rows the swap,
    channel 1 (V) lanes 0-7 on even rows and 8-15 on odd, channel 2 (U)
    the swap.  Returns uint8 (..., 2h, w)."""
    hl = wrap16(torch.cumsum(hl.to(torch.int64), dim=-1)).to(torch.int32)
    tlow = h26_inverse(ll, lh)
    thigh = h26_inverse(hl, hh)
    c = torch.arange(tlow.shape[-1], device=tlow.device)
    block = (c // 8) % 2 == 0
    if channel == 0:
        lane_e = torch.where(block, c % 8, 8 + c % 8)
        lane_o = torch.where(block, 8 + c % 8, c % 8)
    elif channel == 1:
        lane_e, lane_o = c % 8, 8 + c % 8
    else:
        lane_e, lane_o = 8 + c % 8, c % 8
    d = dither.to(torch.int32)
    even = (sat16(tlow - thigh).clamp(0, 2047) >> 1) + d[:, lane_e]
    odd = (sat16(tlow + thigh).clamp(0, 2047) >> 1) + d[:, lane_o]
    out = torch.stack([even, odd], dim=-2)
    out = out.reshape(*even.shape[:-2], 2 * even.shape[-2], even.shape[-1])
    return (out >> 2).clamp(0, 255).to(torch.uint8)


def inverse_channel_strips(lowpass, bands, prescale):
    """Full 3-level inverse stopping at the final v26 vertical stage:
    returns the (low, high) strips the output kernels consume
    (`InvertHorizontalStrip*`)."""
    ll = lowpass
    for k in (2, 1):
        lh, hl, hh = bands[k]
        ll = dwt2d_inverse(ll, lh, hl, hh, 2 if prescale[k] == 2 else 1)
    lh, hl, hh = bands[0]
    return v26_inverse(ll, hl), v26_inverse(lh, hh)


def inverse_channel_to_8bit(lowpass, bands, prescale, dither=None):
    """Full 3-level inverse producing the 8-bit output plane."""
    low, high = inverse_channel_strips(lowpass, bands, prescale)
    return h26_inverse_to_output(low, high, dither=dither)


def inverse_channel_scaled(lowpass, bands, prescale,
                           levels: int) -> torch.Tensor:
    """The reduced-resolution inverse (`intra_host.decode_sample_scaled`):
    `levels` (0, 1 or 2) inverse levels from the deepest up, `descale` 2
    where the level's prescale is 2, then the 8-bit output without dither,
    clamp((ll + 2^(shift-1) - 1) >> shift), shift 6 at 0 levels (the
    deepest lowpass carries x16 over the 10-bit pixels) and 4 after one
    or two (x4).  `bands[k]` is read only for the levels run.  Returns
    uint8 planes."""
    ll = lowpass
    for k in range(2, 2 - levels, -1):
        ll = dwt2d_inverse(ll, *bands[k], 2 if prescale[k] == 2 else 1)
    shift = 6 if levels == 0 else 4
    return ((ll + (1 << (shift - 1)) - 1) >> shift).clamp(0, 255).to(
        torch.uint8)


def h26_inverse_to_row16u(low: torch.Tensor, high: torch.Tensor,
                          precision: int = 10) -> torch.Tensor:
    """Final horizontal 2-6 inverse for the deep (16-bit) output paths,
    byte-exact vs `InvertHorizontalStrip16sToRow16u`
    (`Codec/InvertHorizontalStrip16s.c:16571`): the SSE lanes clamp the
    reconstruction to [0, 2*2^precision-1] before >>1<<shift; the scalar
    tail (columns >= tail0, never column 0) shifts first and saturates the
    16-bit store.  (..., H, half) strips -> (..., H, 2*half) int32 rows
    holding uint16 values."""
    even, odd = _h26_inverse_parts(low, high)
    lim = (2 << precision) - 1
    shift = 16 - precision
    half = low.shape[-1]
    tail0 = (half - (half % 8) - 9) if half >= 16 else 2
    col = torch.arange(half, device=low.device)
    scalar = (col >= tail0) & (col > 0)

    def row16u(x):
        return torch.where(scalar, ((x >> 1) << shift).clamp(0, 65535),
                           (x.clamp(0, lim) >> 1) << shift)

    return _interleave(row16u(even), row16u(odd))


# ---------------------------------------------------------------------------
# Input unpacks, and the YUY2 pack
# ---------------------------------------------------------------------------

def unpack_yuy2(frame: torch.Tensor, precision: int = 10):
    """(..., H, 2W) uint8 YUY2 -> (Y, V, U) int32 planes at `precision` bits.

    Channel order Y, V(Cr), U(Cb) matches `UnpackRowYUV16s`
    (`Codec/convert.c:5222-5284`)."""
    *lead, h, w2 = frame.shape
    quad = frame.reshape(*lead, h, w2 // 4, 4).to(torch.int32)
    shift = precision - 8
    y = quad[..., 0::2].reshape(*lead, h, w2 // 2) << shift
    u = quad[..., 1] << shift
    v = quad[..., 3] << shift
    return y, v, u


def pack_yuy2(y: torch.Tensor, v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """8-bit (Y, V, U) planes -> (..., H, 2W) uint8 YUY2."""
    *lead, h, w = y.shape
    quad = torch.stack([y[..., 0::2], u, y[..., 1::2], v], dim=-1)
    return quad.reshape(*lead, h, 2 * w).to(torch.uint8)


def unpack_uyvy(frame: torch.Tensor, precision: int = 10):
    """(..., H, 2W) uint8 2vuy/UYVY (U Y0 V Y1) -> (Y, V, U) planes
    (`Codec/convert.c:5310`)."""
    *lead, h, w2 = frame.shape
    quad = frame.reshape(*lead, h, w2 // 4, 4).to(torch.int32)
    shift = precision - 8
    y = quad[..., 1::2].reshape(*lead, h, w2 // 2) << shift
    return y, quad[..., 2] << shift, quad[..., 0] << shift


def unpack_yu64(frame: torch.Tensor):
    """(..., H, 4W) uint8 little-endian YU64 (16-bit 4:2:2, pairs
    [Y0 C1 Y1 C2]) -> 10-bit (Y, C1, C2) planes (`Codec/frame.c:1556`)."""
    *lead, h, w4 = frame.shape
    px = _le16(frame, 4)                       # (..., H, W/2, 4)
    y = px[..., 0::2].reshape(*lead, h, w4 // 4) >> 6
    return y, px[..., 1] >> 6, px[..., 3] >> 6


def unpack_v210(frame: torch.Tensor, width: int):
    """(..., H, pitch) uint8 v210 rows -> 10-bit (Y, Cr, Cb) planes
    (`Codec/convert.c:3968`, including its cross-wired u/v outputs, and the
    Cr lag of its scalar tail, the columns past the last multiple of 48:
    each 6-pixel group there gives Cr [c0, c0, c1] and drops c2).  Equals
    the JAX package's device unpack where that one runs (width % 48 == 0)
    and its NumPy oracle `ref.intra.unpack_v210` at every width."""
    *lead, h, pitch = frame.shape
    if pitch != ((width + 47) // 48) * 128:
        raise ValueError(f"unpack_v210: rows of {pitch} bytes, a v210 row "
                         f"{width} pixels wide has "
                         f"{((width + 47) // 48) * 128}")
    ngroups = (width + 5) // 6
    b = frame.reshape(*lead, h, pitch // 4, 4).to(torch.int32)
    # the top two bits of a word carry no sample: dropped, so that the
    # shift stays inside int32
    w32 = (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
           | ((b[..., 3] & 0x3F) << 24))
    g = w32[..., :4 * ngroups].reshape(*lead, h, ngroups, 4)
    s0, s1, s2 = g & 0x3FF, (g >> 10) & 0x3FF, (g >> 20) & 0x3FF
    y = torch.stack([s1[..., 0], s0[..., 1], s2[..., 1],
                     s1[..., 2], s0[..., 3], s2[..., 3]], dim=-1)
    cb = torch.stack([s0[..., 0], s1[..., 1], s2[..., 2]], dim=-1)
    cr = torch.stack([s2[..., 0], s0[..., 2], s1[..., 3]], dim=-1)
    y = y.reshape(*lead, h, 6 * ngroups)[..., :width]
    cb = cb.reshape(*lead, h, 3 * ngroups)[..., :width // 2]
    cr = cr.reshape(*lead, h, 3 * ngroups)[..., :width // 2]
    i0 = (width - width % 48) // 2          # the tail's first chroma column
    n = (width // 2 - i0) // 3              # its whole 3-column groups
    if n:
        tail = cr[..., i0:i0 + 3 * n].reshape(*lead, h, n, 3)
        tail = torch.stack([tail[..., 0], tail[..., 0], tail[..., 1]], -1)
        cr = torch.cat([cr[..., :i0], tail.flatten(-2), cr[..., i0 + 3 * n:]],
                       dim=-1)
    return y, cr, cb


def _le16(frame: torch.Tensor, last: int) -> torch.Tensor:
    """(..., H, 2*N) uint8 -> (..., H, N/last, last) int32 little-endian
    u16."""
    *lead, h, n2 = frame.shape
    b = frame.reshape(*lead, h, n2 // (2 * last), last, 2).to(torch.int32)
    return b[..., 0] | (b[..., 1] << 8)


def unpack_rg48(frame: torch.Tensor):
    """(..., H, 6W) uint8 RG48 (16-bit RGB LE) -> 12-bit planes [G, R, B]
    (`Codec/frame.c:5968` ConvertRGB48ToFrame16s)."""
    px = _le16(frame, 3)                       # (..., H, W, 3)
    return px[..., 1] >> 4, px[..., 0] >> 4, px[..., 2] >> 4


def _alpha_companding(a12: torch.Tensor) -> torch.Tensor:
    """Encode-side alpha step curve (`Codec/frame.c:6699-6706`)."""
    return torch.where((a12 > 0) & (a12 < 4095),
                       ((a12 * 223 + 128) >> 8) + 256, a12)


def unpack_b64a(frame: torch.Tensor):
    """(..., H, 8W) uint8 b64a (16-bit ARGB, read native little-endian
    without the nominal byte swap) -> 12-bit planes [G, R, B, A] with the
    alpha step curve (`ConvertBGRA64ToFrame_4444_16s`,
    `Codec/frame.c:6569`)."""
    px = _le16(frame, 4)                       # (..., H, W, 4)
    return (px[..., 2] >> 4, px[..., 1] >> 4, px[..., 3] >> 4,
            _alpha_companding(px[..., 0] >> 4))


def unpack_rg64(frame: torch.Tensor):
    """(..., H, 8W) uint8 RG64 (16-bit RGBA LE) -> 12-bit [G, R, B, A]
    with the b64a alpha companding."""
    px = _le16(frame, 4)
    return (px[..., 1] >> 4, px[..., 0] >> 4, px[..., 2] >> 4,
            _alpha_companding(px[..., 3] >> 4))


def _bayer_planes(r, g1, g2, b, log_curve: bool):
    """Quadrant components -> [G, RG, BG, DG] 12-bit difference planes
    (`ConvertBYR4ToFrame16s` `Codec/frame.c:4993` with the LOG-90 curve
    applied upstream; `ConvertBYR5ToFrame16s` `frame.c:5473` linear)."""
    g = (g1 + g2) >> 1
    if log_curve:
        rg = ((r - g) >> 1) + 2048
        bg = ((b - g) >> 1) + 2048
    else:
        rg = (r - g + 4096) >> 1
        bg = (b - g + 4096) >> 1
    dg = (g1 - g2 + 4096) >> 1
    return g, rg, bg, dg


def _bayer_order(q00, q01, q10, q11, bayer_format: int):
    """The mosaic's four quadrants -> (R, G1, G2, B) for its Bayer order."""
    if bayer_format == 0:      # RED_GRN
        return q00, q01, q10, q11
    if bayer_format == 1:      # GRN_RED
        return q01, q00, q11, q10
    if bayer_format == 2:      # GRN_BLU
        return q10, q00, q11, q01
    return q11, q01, q10, q00  # BLU_GRN


def unpack_byr4(frame: torch.Tensor, log_lut: torch.Tensor,
                bayer_format: int = 0):
    """(..., H, 2W) uint8 BYR4 (16-bit Bayer mosaic LE) -> quarter-res
    12-bit planes [G, RG, BG, DG] after the LOG-90 encode curve
    (`ConvertBYR4ToFrame16s` `Codec/frame.c:4993`; log_lut is the 14-bit
    `ref.intra.byr4_log90_curve` table as int32 on the frame's device)."""
    mosaic = _le16(frame, 1)[..., 0] >> 2
    m = log_lut[mosaic.long()]
    q00, q01 = m[..., 0::2, 0::2], m[..., 0::2, 1::2]
    q10, q11 = m[..., 1::2, 0::2], m[..., 1::2, 1::2]
    r, g1, g2, bl = _bayer_order(q00, q01, q10, q11, bayer_format)
    return _bayer_planes(r, g1, g2, bl, log_curve=True)


def unpack_byr5(frame: torch.Tensor, bayer_format: int = 0):
    """(..., H/2, 3W) uint8 BYR5 (packed 12-bit Bayer: per quarter-res row
    the four component rows' high bytes, then 4-bit remainders two per
    byte, low nibble first) -> quarter-res 12-bit [G, RG, BG, DG]
    (`ConvertBYR5ToFrame16s`, `Codec/frame.c:5473`; linear, no curve)."""
    wc = frame.shape[-1] // 6
    rows = frame.to(torch.int32)
    nib = rows[..., 4 * wc:6 * wc]
    low = torch.stack([nib & 0xF, (nib >> 4) & 0xF], dim=-1).flatten(-2)
    v = (rows[..., :4 * wc] << 4) | low
    comp = [v[..., i * wc:(i + 1) * wc] for i in range(4)]
    if bayer_format == 0:
        r, g1, g2, b = comp
    elif bayer_format == 1:
        g1, r, b, g2 = comp
    elif bayer_format == 2:
        g1, b, r, g2 = comp
    else:
        b, g1, g2, r = comp
    return _bayer_planes(r, g1, g2, b, log_curve=False)

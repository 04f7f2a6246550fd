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

from cineform_tpu_torch.ref.intra import RGB10_INPUT_FORMATS

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


def quantize_mid(v: torch.Tensor, q: int) -> torch.Tensor:
    """Quantizer with midpoint exactly q/2 (no -1), as used inside
    `FilterHorizontalRowScaled16sDifferenceFiltered` (`Codec/spatial.c:
    5327`, prequant_midpoint = divisor / g_midpoint_prequant).  |v| <=
    32768, so the product stays inside int32."""
    if q <= 1:
        return v
    mag = ((v.abs() + q // 2) * ((1 << 16) // q)) >> 16
    return torch.sign(v) * mag


def frame_wavelet_forward(plane: torch.Tensor, quant):
    """The interlaced group's HORZTEMP frame wavelet of (..., H, W) int32
    planes -> (LL, (LH, HL, HH)), each (..., H/2, W/2) int32
    (`Codec/wavelet.c:6076` TransformForwardFrameYUV): the 2-2 temporal
    pair of each row pair, low = even + odd, high = odd - even
    (`FilterTemporalRowYUYVChannelTo16s`, `Codec/temporal.c:1915`); LL and
    LH the horizontal 2-6 of the temporal low, HH the horizontal 2-6 high
    of the temporal high, both highs dead-zone quantized; HL the
    horizontal lowpass of the temporal high, quantized with midpoint q/2
    (`quantize_mid`), then delta-coded along the row and saturated to 16
    bits (`Codec/spatial.c:5327`), which the encoder codes with codeset
    18."""
    tlow = sat16(plane[..., 0::2, :] + plane[..., 1::2, :])
    thigh = sat16(plane[..., 1::2, :] - plane[..., 0::2, :])
    ll, lh = h26_forward(tlow)
    _, hh = h26_forward(thigh)
    hl = quantize_mid(sat16(thigh[..., 0::2] + thigh[..., 1::2]), quant[1])
    d = torch.cat([hl[..., :1], hl[..., 1:] - hl[..., :-1]], dim=-1)
    return ll, (quantize(lh, quant[0]), sat16(d), quantize(hh, quant[2]))


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


def _quads(frame: torch.Tensor, le16: bool = False) -> torch.Tensor:
    """(..., H, row bytes) uint8 4:2:2 rows -> (..., H, W/2, 4) int32
    pixel-pair components, 8-bit or little-endian 16-bit."""
    if le16:
        return _le16(frame, 4)
    *lead, h, n = frame.shape
    return frame.reshape(*lead, h, n // 4, 4).to(torch.int32)


def _cbycry(quad: torch.Tensor, shift: int):
    """(..., H, W/2, 4) CbYCrY components -> 10-bit (Y, Cr, Cb), each
    shifted left by `shift` (or right by -shift)."""
    def sh(x):
        return x << shift if shift >= 0 else x >> -shift

    *lead, h, half, _ = quad.shape
    y = quad[..., 1::2].reshape(*lead, h, 2 * half)
    return sh(y), sh(quad[..., 2]), sh(quad[..., 0])


def unpack_avu8(frame: torch.Tensor):
    """(..., H, 2W) uint8 Avid CT_UCHAR ('avu8', 8-bit CbYCrY) -> 10-bit
    (Y, Cr, Cb), each component << 2 (`ConvertCbYCrY_8bitToFrame16s`,
    `Codec/frame.c:13386`)."""
    return _cbycry(_quads(frame), 2)


def unpack_av16(frame: torch.Tensor):
    """(..., H, 4W) uint8 Avid CT_SHORT ('av16') or CT_USHORT_10_6
    ('a106'): 16-bit little-endian CbYCrY components >> 6 -> 10-bit (Y,
    Cr, Cb) (`Codec/frame.c:13319/13453`, the same arithmetic)."""
    return _cbycry(_quads(frame, le16=True), -6)


def unpack_a214(frame: torch.Tensor):
    """(..., H, 4W) uint8 Avid CT_SHORT_2_14 ('a214', signed 2.14 fixed
    point CbYCrY) -> 10-bit (Y, Cr, Cb) (`ConvertCbYCrY_16bit_2_14To
    Frame16s`, `Codec/frame.c:13234`): luma (219 Y / 16384 + 16) << 2,
    chroma (224 (C + 8192) / 16384 + 16) << 2, the divisions truncating
    toward zero as C's do, then saturated to 10 bits."""
    q = _quads(frame, le16=True)
    q = q - ((q >> 15) << 16)                  # int16 bit patterns

    def scale(v, mul, offset):
        v = torch.div(mul * (v + offset), 16384, rounding_mode="trunc")
        return ((v + 16) * 4).clamp(0, 1023)

    y, cr, cb = _cbycry(q, 0)
    return scale(y, 219, 0), scale(cr, 224, 8192), scale(cb, 224, 8192)


def unpack_av28(frame: torch.Tensor):
    """(B, H, 5W/2) uint8 Avid CT_10BIT_2_8 ('av28') -> 10-bit (Y, Cr,
    Cb) (`ConvertCbYCrY_10bit_2_8ToFrame16s`, `Codec/frame.c:13144`).  A
    frame is two planes, not rows: W*H/2 bytes of 2-bit upper components,
    packed [Cb Y1 Cr Y2] high to low, then the 8-bit CbYCrY rows; the row
    shape only gives the frame a shape, so the planes are cut from the
    flat buffer."""
    b, h, n = frame.shape
    w = 2 * n // 5
    flat = frame.reshape(b, h * n)
    upper = flat[:, :w * h // 2].reshape(b, h, w // 2).to(torch.int32)
    lower = flat[:, w * h // 2:].reshape(b, h, 2 * w)
    y, cr, cb = _cbycry(_quads(lower), 2)
    y = y | torch.stack([(upper >> 4) & 3, upper & 3], dim=-1).reshape(
        b, h, w)
    return y, cr | ((upper >> 2) & 3), cb | ((upper >> 6) & 3)


def unpack_rgb10(frame: torch.Tensor, fourcc: str):
    """(..., H, 4W) uint8 packed 10-bit RGB (r210, DPX0, RG30, AB10, AR10)
    -> 12-bit planes [G, R, B] (`Codec/frame.c:6995`): r210 and DPX0 read
    the 32-bit word big-endian (the reference byte-swaps it), the others
    little-endian; each component is taken at its shift
    (`ref.intra.RGB10_INPUT_FORMATS`) and << 2.  The words are carried as
    int64, which has the shifts that uint32 lacks on the CPU."""
    _, swap, (rs, gs, bs) = RGB10_INPUT_FORMATS[fourcc]
    *lead, h, n = frame.shape
    b = frame.reshape(*lead, h, n // 4, 4).to(torch.int64)
    if swap:
        b = b.flip(-1)
    word = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)

    def comp(shift):
        return (((word >> shift) & 0x3FF) << 2).to(torch.int32)

    return comp(gs), comp(rs), comp(bs)


def _rgb8(frame: torch.Tensor, bpp: int, bottom_up: bool):
    *lead, h, n = frame.shape
    px = frame.reshape(*lead, h, n // bpp, bpp).to(torch.int32)
    if bottom_up:
        px = px.flip(-3)
    return px[..., 1] << 4, px[..., 2] << 4, px[..., 0] << 4


def unpack_bgra(frame: torch.Tensor, top_down: bool = False):
    """(..., H, 4W) uint8 BGRA -> 12-bit planes [G, R, B], alpha dropped
    (`ConvertBGRAToFrame16s`).  BGRA's rows are stored bottom-up, like a
    Windows DIB; `top_down` reads BGRa (COLOR_FORMAT_RGB32_INVERTED,
    `Codec/color.h:71`), the same pixels with the rows top-down."""
    return _rgb8(frame, 4, not top_down)


def unpack_rg24(frame: torch.Tensor):
    """(..., H, 3W) uint8 RG24 (8-bit BGR, rows bottom-up) -> 12-bit
    planes [G, R, B]."""
    return _rgb8(frame, 3, True)


def limit_convert_yuy2(frame: torch.Tensor, limit_yuv: int,
                       conv_601_709: int):
    """(..., H, 2W) uint8 YUY2 -> 10-bit (Y, V, U) through the encoder's
    LYUV/CV67 input transform (`Codec/convert.c:4668-5290`, shift 2), the
    arithmetic of its SSE2 main loop: LYUV maps full range to video range,
    y' = (55 y) >> 4 + 64, c' = (56 c) >> 4 + 64; CV67's 601 -> 709 matrix
    floors each product on its own (`_mm_mulhi_epi16`), the chroma path
    keeping 3 extra fraction bits ((56 c) >> 1 - 3584 after LYUV), and
    clamps to 10 bits.  Neither set: the plain << 2 unpack."""
    q = _quads(frame)
    y1, u8, y2, v8 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

    def mulhi(x, c):
        return (x * c) >> 16

    def clamp10(x):
        return x.clamp(0, 1023)

    def luma_709(y, uc, vc):
        return clamp10(y - mulhi(vc, 212 << 6) - mulhi(uc, 118 << 6))

    def chroma_709(u13, v13):
        return (clamp10(mulhi(u13, 1043 << 3) + mulhi(v13, 116 << 3) + 512),
                clamp10(mulhi(v13, 1049 << 3) + mulhi(u13, 76 << 3) + 512))

    if limit_yuv:
        y1 = ((y1 * 55) >> 4) + 64
        y2 = ((y2 * 55) >> 4) + 64
        if conv_601_709:
            # the luma terms use the 10-bit limited chroma
            u10 = ((u8 * 56) >> 4) + 64 - 512
            v10 = ((v8 * 56) >> 4) + 64 - 512
            y1, y2 = luma_709(y1, u10, v10), luma_709(y2, u10, v10)
            u, v = chroma_709(((u8 * 56) >> 1) - 3584,
                              ((v8 * 56) >> 1) - 3584)
        else:
            u = ((u8 * 56) >> 4) + 64
            v = ((v8 * 56) >> 4) + 64
    elif conv_601_709:
        uc = (u8 << 2) - 512
        vc = (v8 << 2) - 512
        y1, y2 = luma_709(y1 << 2, uc, vc), luma_709(y2 << 2, uc, vc)
        u, v = chroma_709(uc << 3, vc << 3)
    else:
        y1, y2, u, v = y1 << 2, y2 << 2, u8 << 2, v8 << 2
    y = torch.stack([y1, y2], dim=-1).flatten(-2)
    return y, v, u

"""The intra transform of the CFHD codec in plain NumPy, bit-exact with
the reference SDK: the YUY2 and BYR4 unpacks, the forward 2-6 wavelet with
its prescale and dead-zone quantizer, the inverse levels, the 8-bit YUY2
output stage with the decoder's glibc rand() dither, and the 16-bit
Row16u stage of the deep outputs.

A frozen copy of the JAX package's NumPy oracle (`ref/intra.py`), cut to
the YUY2 and Bayer intra paths; it imports nothing of either package, so
that the benchmark's check does not lean on the code it checks.
"""

from __future__ import annotations

import numpy as np

from cfbench.reference.glibc_random import glibc_rand_sequence

_I32 = np.int32


ROUNDING = 4


def sat16(x: np.ndarray) -> np.ndarray:
    return np.clip(x, -32768, 32767).astype(_I32)


def wrap16(x: np.ndarray) -> np.ndarray:
    """C short wraparound (used by DeQuantFSM's in-table multiply)."""
    return ((np.asarray(x, dtype=np.int64) + 32768) % 65536 - 32768).astype(_I32)


def unpack_yuy2(raw: bytes | np.ndarray, width: int, height: int,
                precision: int = 10) -> list[np.ndarray]:
    """YUY2 bytes -> [Y, V, U] int32 planes shifted to `precision` bits.

    Contract: `UnpackRowYUV16s` (`Codec/convert.c:4667`), default path
    (no limit_yuv, no 601->709 conversion): plain `<< (precision-8)`.
    """
    arr = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) else raw
    quad = arr.reshape(height, width // 2, 4).astype(_I32)
    shift = precision - 8
    y = quad[:, :, [0, 2]].reshape(height, width) << shift
    u = quad[:, :, 1] << shift
    v = quad[:, :, 3] << shift
    return [y, v, u]


def pack_yuy2(y: np.ndarray, v: np.ndarray, u: np.ndarray) -> bytes:
    """[Y, V, U] 8-bit planes -> YUY2 bytes."""
    h, w = y.shape
    out = np.empty((h, w // 2, 4), dtype=np.uint8)
    out[:, :, 0] = y[:, 0::2]
    out[:, :, 2] = y[:, 1::2]
    out[:, :, 1] = u
    out[:, :, 3] = v
    return out.tobytes()


def _h26_forward(x: np.ndarray, prescale: int = 0,
                 row0_prev: np.ndarray | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Horizontal 2-6 forward.

    prescale=0: `FilterHorizontalRow16s` (`Codec/spatial.c:253`).
    prescale=2: `FilterHorizontalRow10bit16s` (`Codec/spatial.c:3669`) —
      highpass taps use per-element px=(x+3)>>2; the stored lowpass is
      (x0+x1+3)>>2.
    row0_prev: for the width<=16 narrow-row quirk (below), the two raw
      pixels sitting in memory before the image's first row.  For a
      band-0 input this is fresh-allocation zeros (the default); a
      band-1 input (the GOP's temporal-highpass spatial) is preceded by
      band 0, so its row 0 overreads band 0's last two pixels.
    """
    x = x.astype(_I32)
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
    high = np.empty_like(plow)
    high[..., 1:-1] = ((-plow[..., :-2] + plow[..., 2:] + ROUNDING) >> 3) + diff[..., 1:-1]
    high[..., 0] = (
        5 * pe[..., 0] - 11 * po[..., 0]
        + 4 * pe[..., 1] + 4 * po[..., 1]
        - pe[..., 2] - po[..., 2] + ROUNDING
    ) >> 3
    if x.shape[-1] <= 16 and x.ndim >= 2:
        # Narrow-row quirk of the SSE2 FilterHorizontalRow16s
        # (`Codec/spatial.c:912-1016`) and its prescaled twin
        # FilterHorizontalRow10bit16s (`Codec/spatial.c:3669-4001`): with
        # width <= 16 the vectorized main loop never runs (post_column ==
        # 0), and the left-border highpass value it would have shifted
        # into column 0 is dropped.  The scalar tail then starts at
        # column 0 with the CENTER filter, whose input[-2..-1] reads run
        # off the row start into the last two pixels of the previous row
        # (the row pitch for widths 8/16 equals the width); the first row
        # reads fresh-allocation zeros.  In the prescaled variant the
        # overread pixels go through the same (x+3)>>2 per-element
        # prescale, so the pe/po arrays apply to both.
        prev = np.zeros_like(plow[..., 0])
        if x.shape[-1] % 8 == 0:
            # pitch == width: the overread lands on the previous row
            prev[..., 1:] = plow[..., :-1, -1]
            if row0_prev is not None:
                p0, p1 = int(row0_prev[0]), int(row0_prev[1])
                if prescale:
                    r = (1 << prescale) - 1
                    p0, p1 = (p0 + r) >> prescale, (p1 + r) >> prescale
                prev[..., 0] = p0 + p1
        # else: the 16-byte row pitch leaves >= 2 never-written pad pixels
        # at the end of each row, so the overread sees zeros on every row
        high[..., 0] = ((-prev + plow[..., 1] + ROUNDING) >> 3) + diff[..., 0]
    high[..., -1] = (
        11 * pe[..., -1] - 5 * po[..., -1]
        - 4 * po[..., -2] - 4 * pe[..., -2]
        + po[..., -3] + pe[..., -3] + ROUNDING
    ) >> 3
    return sat16(low), sat16(high)


def v26_forward(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vertical 2-6 forward (border rows use the 6-tap filters on the first/
    last six input rows, `Codec/spatial.c:14266-14306`)."""
    x = x.astype(_I32)
    even, odd = x[0::2], x[1::2]
    low = even + odd
    diff = even - odd
    high = np.empty_like(low)
    high[1:-1] = ((-low[:-2] + low[2:] + ROUNDING) >> 3) + diff[1:-1]
    high[0] = (
        5 * x[0] - 11 * x[1] + 4 * x[2] + 4 * x[3] - x[4] - x[5] + ROUNDING
    ) >> 3
    high[-1] = (
        11 * x[-2] - 5 * x[-1] - 4 * x[-3] - 4 * x[-4] + x[-5] + x[-6] + ROUNDING
    ) >> 3
    return sat16(low), sat16(high)


def quantize(v: np.ndarray, q: int, midpoint_prequant: int = 2) -> np.ndarray:
    """Production quantizer `QuantizeRow16sTo16s` (`Codec/quantize.c:1256`)."""
    if q <= 1:
        return v.astype(_I32)
    mult = (1 << 16) // q
    mid = q // midpoint_prequant
    if midpoint_prequant == 2 and mid:
        mid -= 1
    a = np.abs(v).astype(np.int64)
    mag = (((a + mid) & 0xFFFF) * mult) >> 16
    return (np.sign(v) * mag).astype(_I32)


def dwt2d_forward(x: np.ndarray, prescale: int = 0,
                  quant: tuple[int, int, int] | None = None,
                  row0_prev: np.ndarray | None = None):
    """One 2D production DWT level: horizontal (optionally prescaled) then
    vertical; returns (LL, (LH, HL, HH)) with optional fused quantization.

    Band order matches the reference: band1 = horizontal-high/vertical-low
    ("lowhigh"), band2 = horizontal-low/vertical-high ("highlow"), band3 = HH.
    """
    low, high = _h26_forward(x, prescale, row0_prev)
    ll, hl = v26_forward(low)
    lh, hh = v26_forward(high)
    if quant is not None:
        lh = quantize(lh, quant[0])
        hl = quantize(hl, quant[1])
        hh = quantize(hh, quant[2])
    return ll, (lh, hl, hh)


def v26_inverse(low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """Vertical 2-6 inverse, standard descale (>>1), int32 math + sat16.

    Contract: `InvertSpatialQuantDescale16s` vertical section
    (`Codec/spatial.c:22492-22540`) == demo math.
    """
    low, high = low.astype(_I32), high.astype(_I32)
    half = low.shape[0]
    even = np.empty_like(low)
    odd = np.empty_like(low)
    te = (low[:-2] - low[2:] + ROUNDING) >> 3
    to = (-low[:-2] + low[2:] + ROUNDING) >> 3
    even[1:-1] = (te + low[1:-1] + high[1:-1]) >> 1
    odd[1:-1] = (to + low[1:-1] - high[1:-1]) >> 1
    t0e = (11 * low[0] - 4 * low[1] + low[2] + ROUNDING) >> 3
    t0o = (5 * low[0] + 4 * low[1] - low[2] + ROUNDING) >> 3
    even[0] = (t0e + high[0]) >> 1
    odd[0] = (t0o - high[0]) >> 1
    tke = (5 * low[-1] + 4 * low[-2] - low[-3] + ROUNDING) >> 3
    tko = (11 * low[-1] - 4 * low[-2] + low[-3] + ROUNDING) >> 3
    even[-1] = (tke + high[-1]) >> 1
    odd[-1] = (tko - high[-1]) >> 1
    out = np.empty((half * 2,) + low.shape[1:], dtype=_I32)
    out[0::2] = sat16(even)
    out[1::2] = sat16(odd)
    return out


def h26_inverse(low: np.ndarray, high: np.ndarray, descale: int = 1) -> np.ndarray:
    """Horizontal 2-6 inverse.

    descale=1: standard >>1 (`InvertHorizontalStrip16s`).
    descale=2: `InvertHorizontalStripDescale16s`
      (`Codec/InvertHorizontalStrip16s.c:1374`): no >>1, result <<1 — the
      net x4 undoes the encoder's prescale-2.
    """
    low, high = low.astype(_I32), high.astype(_I32)
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
    even = np.concatenate([even_f[..., None], even_i, even_l[..., None]], -1)
    odd = np.concatenate([odd_f[..., None], odd_i, odd_l[..., None]], -1)
    if descale == 2:
        even <<= 1
        odd <<= 1
    else:
        even >>= 1
        odd >>= 1
    h, half = low.shape
    out = np.empty((h, half * 2), dtype=_I32)
    out[:, 0::2] = sat16(even)
    out[:, 1::2] = sat16(odd)
    return out


def h26_inverse_to_row16u(low: np.ndarray, high: np.ndarray,
                          precision: int = 10) -> np.ndarray:
    """Final horizontal 2-6 inverse for the DEEP output paths, pinned
    byte-exact against `InvertHorizontalStrip16sToRow16u`
    (`Codec/InvertHorizontalStrip16s.c:16571`): the reconstruction sum is
    clamped to [0, 2*2^precision-1] (the SSE protection add/sub pair)
    and floor-divided by two — no rounding, no dither — then scaled to
    16-bit (<< 16-precision).  This is the horizontal stage the reference
    uses for every 16-bit planar output (YU64/v210/RG48/... via
    `TransformInverseSpatialUniversalThreadedToRow16u`,
    `Codec/decoder.c:26359-26365`).  Returns (H, 2*half) uint16-valued
    int32 rows."""
    low, high = low.astype(_I32), high.astype(_I32)
    te = (low[..., :-2] - low[..., 2:] + ROUNDING) >> 3
    to = (-low[..., :-2] + low[..., 2:] + ROUNDING) >> 3
    even_i = te + low[..., 1:-1] + high[..., 1:-1]
    odd_i = to + low[..., 1:-1] - high[..., 1:-1]
    t0e = (11 * low[..., 0] - 4 * low[..., 1] + low[..., 2] + ROUNDING) >> 3
    t0o = (5 * low[..., 0] + 4 * low[..., 1] - low[..., 2] + ROUNDING) >> 3
    tke = (5 * low[..., -1] + 4 * low[..., -2] - low[..., -3] + ROUNDING) >> 3
    tko = (11 * low[..., -1] - 4 * low[..., -2] + low[..., -3] + ROUNDING) >> 3
    even = np.concatenate([(t0e + high[..., 0])[..., None], even_i,
                           (tke + high[..., -1])[..., None]], -1)
    odd = np.concatenate([(t0o - high[..., 0])[..., None], odd_i,
                          (tko - high[..., -1])[..., None]], -1)
    lim = (2 << precision) - 1
    shift = 16 - precision
    h, half = low.shape
    # SSE lanes clamp the sum to [0, lim] BEFORE >>1/<<shift (clean low
    # bits); the scalar tail and right border shift first and clamp the
    # 16-bit store (SATURATE_16U) — a clipped tail pixel stores 65535,
    # not 1023<<6 (InvertHorizontalStrip16s.c:16930-16965)
    sse_e = np.clip(even, 0, lim) >> 1 << shift
    sse_o = np.clip(odd, 0, lim) >> 1 << shift
    scl_e = np.clip((even >> 1) << shift, 0, 65535)
    scl_o = np.clip((odd >> 1) << shift, 0, 65535)
    if half >= 16:
        post = half - (half % 8) - 16
        tail0 = post + 7          # first scalar column
    else:
        tail0 = 2                 # no fast loop: scalar from col 2 on?
    out = np.empty((h, half * 2), dtype=_I32)
    out[:, 0::2] = sse_e
    out[:, 1::2] = sse_o
    out[:, 2 * tail0::2] = scl_e[:, tail0:]
    out[:, 2 * tail0 + 1::2] = scl_o[:, tail0:]
    # left border lanes are saturated at 10 bits before the SSE shift
    # (even<<shift; SATURATE_16U; >>shift) — same as the SSE clamp
    out[:, 0] = sse_e[:, 0]
    out[:, 1] = sse_o[:, 0]
    return out


def dwt2d_inverse(ll, lh, hl, hh, descale: int = 1) -> np.ndarray:
    """One 2D production inverse level: vertical then horizontal
    (`InvertSpatialQuantDescale16s` / `InvertSpatialQuant16s`)."""
    low = v26_inverse(ll, hl)
    high = v26_inverse(lh, hh)
    return h26_inverse(low, high, descale)


def h26_inverse_to_output(low: np.ndarray, high: np.ndarray,
                          descale_shift: int = 2,
                          dither: np.ndarray | None = None,
                          scalar_tail: int = 0) -> np.ndarray:
    """Final horizontal inverse fused with conversion to 8-bit output.

    Contract: `InvertHorizontalStrip16sToYUYV`
    (`Codec/InvertHorizontalStrip16s.c:3770`), pinned empirically against
    the reference binary (byte-exact with `decode_dither_rows`):
      border pairs:   ((6tap+4)>>3 ± high + 3) >> 3, no dither;
      interior:       (max((l[k-1]-l[k+1]+4)>>3 + l[k] ± h[k], 0)
                       + 3 + 2*dither) >> 3, dither in {0,1} drawn from
                      glibc rand() (see decode_dither_rows);
      final pack saturates to [0, 255].
    (descale_shift kept for API compatibility; the production YUY2 decode
    path is precision 10 -> shift 2, i.e. a total >>3 with the >>1.)
    """
    low, high = low.astype(_I32), high.astype(_I32)
    te = (low[..., :-2] - low[..., 2:] + ROUNDING) >> 3
    to = (-low[..., :-2] + low[..., 2:] + ROUNDING) >> 3
    total = descale_shift + 1
    bias = (1 << (total - 1)) - 1  # 3 for the 10-bit path (total >> 3)
    # Interior SSE lanes, exact int16 semantics (pinned against the
    # kernel driven directly with srand(1) dither): the "+bias" is the
    # exactly-propagated lowpass channeloffset riding in the coefficient
    # data; clamping-at-zero happens via the +2048 adds_epi16 /
    # subs_epu16 pair, which WRAPS for sums below -2048 (emitting bright
    # pixels where a plain max() would emit 0); the final +dither uses
    # saturating adds and a LOGICAL >>2 on the int16 lane.
    de = dither[..., 0::2][..., 1:-1] if dither is not None else 0
    do = dither[..., 1::2][..., 1:-1] if dither is not None else 0

    def _sse_lane(t, h_, sign, d):
        e1 = sat16(t + low[..., 1:-1] + bias)
        x = sat16(sat16(e1 + 2048) + sign * h_)
        u = x & 0xFFFF
        y = np.where(u >= 2048, u - 2048, 0)
        s = wrap16(y) >> 1
        t8 = sat16(s + d)
        return np.clip(wrap16((t8 & 0xFFFF) >> descale_shift), 0, 255)

    even_i = _sse_lane(te, high[..., 1:-1], +1, de)
    odd_i = _sse_lane(to, high[..., 1:-1], -1, do)
    if scalar_tail:
        # the reference's end-of-row scalar loop: plain int arithmetic,
        # no dither, no wrap quirks (InvertHorizontalStrip16s.c:4680+)
        v2e = np.maximum(te + low[..., 1:-1] + high[..., 1:-1], 0)
        v2o = np.maximum(to + low[..., 1:-1] - high[..., 1:-1], 0)
        se = (v2e + bias) >> total
        so = (v2o + bias) >> total
        # the scalar region spans the last `scalar_tail` output columns;
        # its final pair is the right border (handled below), leaving
        # scalar_tail/2 - 1 interior pairs to overwrite
        n = scalar_tail // 2 - 1
        if n > 0:
            even_i[..., -n:] = se[..., -n:]
            odd_i[..., -n:] = so[..., -n:]
    t0e = (11 * low[..., 0] - 4 * low[..., 1] + low[..., 2] + ROUNDING) >> 3
    t0o = (5 * low[..., 0] + 4 * low[..., 1] - low[..., 2] + ROUNDING) >> 3
    even_f = (t0e + high[..., 0] + bias) >> total
    odd_f = (t0o - high[..., 0] + bias) >> total
    tke = (5 * low[..., -1] + 4 * low[..., -2] - low[..., -3] + ROUNDING) >> 3
    tko = (11 * low[..., -1] - 4 * low[..., -2] + low[..., -3] + ROUNDING) >> 3
    even_l = (tke + high[..., -1] + bias) >> total
    odd_l = (tko - high[..., -1] + bias) >> total
    even = np.concatenate([np.clip(even_f, 0, 255)[..., None], even_i,
                           np.clip(even_l, 0, 255)[..., None]], -1)
    odd = np.concatenate([np.clip(odd_f, 0, 255)[..., None], odd_i,
                          np.clip(odd_l, 0, 255)[..., None]], -1)
    h, half = low.shape
    out = np.empty((h, half * 2), dtype=_I32)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return np.clip(out, 0, 255).astype(np.uint8)


def decode_dither_rows(height: int, frame_index: int = 0) -> np.ndarray:
    """Per-row output dither vectors replicating the reference decoder.

    `InvertHorizontalStrip16sToYUYV` draws 16 `rand()&1` bits per output
    row (two 8-lane SSE rounding vectors, InvertHorizontalStrip16s.c:3869)
    from glibc's default-seed rand().  The decoder emits the two border
    strips first, so the draw blocks land on rows in the order
    [0, 1, H-2, H-1, 2, 3, ..., H-3] (pinned against the reference binary).
    Returns (height, 16) bits; lanes 0-7 = rounding1, 8-15 = rounding2.
    frame_index selects the draw window for the n-th decoded frame of one
    decoder process (GOP groups decode two frames back to back).
    """
    draws = (glibc_rand_sequence(16 * height * (frame_index + 1)) & 1)
    draws = draws[16 * height * frame_index:].reshape(height, 16)
    row_draws = np.empty((height, 16), dtype=np.int64)
    order = [0, 1, height - 2, height - 1] + list(range(2, height - 2))
    for blk, r in enumerate(order):
        row_draws[r] = draws[blk]
    return row_draws


def decode_dither_plane(row_draws: np.ndarray, width: int,
                        group: int | None = None) -> np.ndarray:
    """Expand per-row 16-bit dither vectors to a (H, width) channel plane.

    Output column c >= 2 takes lane (c-2)%8 of rounding1 when
    ((c-2)//8)%2 == 0 else of rounding2 (the SSE groups alternate
    rounding1/rounding2 every 8 outputs); the four border columns are
    undithered.  Y, U and V share the same row vectors.

    group: the channel's SSE output group size (16 for luma, 8 for
    chroma).  When the width leaves a half-step remainder
    (width % (2*group) == group, e.g. luma width 112) the reference's
    fast loop stops one group early and the final `group` columns
    decode through the UNDITHERED scalar tail (pinned against the
    reference decoder at 112x48/144x96).
    """
    h = row_draws.shape[0]
    d = np.zeros((h, width), dtype=np.int64)
    m = np.arange(width - 4)
    lane = m % 8 + 8 * ((m // 8) % 2)
    d[:, 2:-2] = row_draws[:, lane]
    if group and width % (2 * group) == group:
        d[:, width - group:] = 0
    return d


def forward_channel(plane: np.ndarray, band_quant, prescale):
    """3-level intra forward for one channel.

    Returns (lowpass int32 (h/8, w/8), bands) where bands[k] = (LH, HL, HH)
    quantized coefficients of wavelet k (0 = finest).
    """
    ll = plane
    bands = []
    for k in range(3):
        ll, highs = dwt2d_forward(ll, prescale[k], band_quant[k])
        bands.append(highs)
    return ll, bands


def inverse_channel_to_16s(lowpass: np.ndarray, bands, prescale) -> np.ndarray:
    """Inverse through w[2] and w[1]; returns the reconstructed w[0] lowpass
    input (still needs the final level + output conversion)."""
    ll = lowpass
    for k in (2, 1):
        lh, hl, hh = bands[k]
        descale = 2 if prescale[k] == 2 else 1
        ll = dwt2d_inverse(ll, lh, hl, hh, descale)
    return ll


def inverse_channel_to_8bit(lowpass, bands, prescale, descale_shift=2,
                            dither=None, dither_group=None):
    """Full inverse for one channel producing the 8-bit output plane.

    `dither` is either None, a precomputed (H, W) plane, or the (H, 16)
    row-draw matrix from `decode_dither_rows` (expanded per channel
    width here; `dither_group` is the channel's SSE group size — 16
    luma / 8 chroma — for the half-step undithered tail rule).
    """
    ll = inverse_channel_to_16s(lowpass, bands, prescale)
    lh, hl, hh = bands[0]
    low = v26_inverse(ll, hl)
    high = v26_inverse(lh, hh)
    width = low.shape[-1] * 2
    tail = dither_group if (dither_group
                            and width % (2 * dither_group) == dither_group) \
        else 0
    if dither is not None and dither.shape[-1] == 16:
        dither = decode_dither_plane(dither, width, dither_group)
    return h26_inverse_to_output(low, high, descale_shift, dither,
                                 scalar_tail=tail)


def byr4_log90_curve() -> np.ndarray:
    """The default BYR4 encode curve (LOG 90): 14-bit linear -> 12-bit log.

    `Codec/frame.c:5218-5237` BYR4_LOGTABLE with MAX_INPUT_PRECISION=14
    (`frame.c:4843`); float32 division and final multiply match the
    reference build bit for bit.
    """
    i = np.arange(1 << 14)
    x = i.astype(np.float32) / np.float32(16384.0)
    l2l = (np.log10(x.astype(np.float64) * 89.0 + 1.0)
           / np.log10(90.0)).astype(np.float32)
    return np.where(i == 0, 0, (l2l * np.float32(4095.0)).astype(np.int64))


def unpack_byr4(raw: bytes | np.ndarray, width: int, height: int,
                bayer_format: int = 0) -> list[np.ndarray]:
    """BYR4 (16-bit Bayer mosaic) -> quarter-res 12-bit planes
    [G, RG, BG, DG] (`ConvertBYR4ToFrame16s`, `Codec/frame.c:4993`):

        G  = (g1 + g2) >> 1
        RG = ((r - G) >> 1) + 2048
        BG = ((b - G) >> 1) + 2048
        DG = (g1 - g2 + 4096) >> 1

    after the LOG-90 encode curve (values indexed at 14-bit precision).
    bayer_format: CFHD_BAYER_FORMAT_* (0 = RED_GRN: rows R G / G B).
    """
    arr = (np.frombuffer(raw, dtype="<u2") if isinstance(raw, (bytes, bytearray))
           else raw)
    mosaic = arr.reshape(height, width).astype(np.int64) >> 2
    m = byr4_log90_curve()[mosaic]
    q00, q01 = m[0::2, 0::2], m[0::2, 1::2]
    q10, q11 = m[1::2, 0::2], m[1::2, 1::2]
    if bayer_format == 0:      # RED_GRN
        r, g1, g2, b = q00, q01, q10, q11
    elif bayer_format == 1:    # GRN_RED
        g1, r, b, g2 = q00, q01, q10, q11
    elif bayer_format == 2:    # GRN_BLU
        g1, b, r, g2 = q00, q01, q10, q11
    else:                      # BLU_GRN
        b, g1, g2, r = q00, q01, q10, q11
    g = (g1 + g2) >> 1
    rg = ((r - g) >> 1) + 2048
    bg = ((b - g) >> 1) + 2048
    dg = (g1 - g2 + 4096) >> 1
    return [p.astype(_I32) for p in (g, rg, bg, dg)]



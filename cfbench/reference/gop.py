"""The plain reference of the two-frame GOP (FIELDPLUS) codec in NumPy:
the forward of a YUY2 frame pair into its six wavelets, the coefficients
a decoder reads back from the GROUP sample, and the decode of either
frame: deep (16-bit, packed as v210 or YU64) or 8-bit YUY2 with the
decoder's dither.

Contract (`Codec/encoder.c:8431`, progressive input; `Codec/decoder.c:
11180` DecodeSampleGroup with the 17-subband map at `decoder.c:11191`),
per channel:

- w0, w1: the level-1 spatial 2-6 wavelets of frames 0 and 1;
- w2: the 2-2 temporal Haar pair of their lowpass bands (not coded):
  low = f0 + f1, high = f1 - f0, each saturated to 16 bits;
- w3: the spatial wavelet of the temporal high, its LL stored raw as a
  16-bit band (quantizer 1, `encoder.c:8524`);
- w4: the spatial wavelet of the temporal low, prescale 2;
- w5: the spatial wavelet of w4's LL, whose LL is the sample's lowpass.

Band quantizers and scales are `SetTransformQuantization`'s FIELDPLUS
case (`Codec/quantize.c:3355+`) over `production.quality_tables` with
`gop_length` 2.  The decode is the reference's deep-output chain for a
group (`TransformInverseSpatial...ToRow16u` over the GOP pyramid): the
lowpass with the absolute channel offset of a two-frame sample (+14 for
the deep YUV outputs at even lowpass widths, +10 at odd ones,
`decoder.c:12258-12505`); w5 and w3 inverted with the stale bottom taps
of `InvertSpatialQuantOverflowProtected16s`, w4 with the standard ones
and descale 2; frame 0's field (low - high) >> 1 with w0's bands, frame
1's (low + high) >> 1 with w1's (`ReconstructSampleFrameToBuffer`,
frame_index 1), each saturated before the shift (InvertTemporalQuant16s,
`temporal.c:9676`); then the final level through
`transform.h26_inverse_to_row16u`.  The YUY2 output takes the 8-bit
models' relative lowpass offset and the final level through
`transform.h26_inverse_to_output` with the glibc rand() dither window of
the decoder's n-th emitted frame (`transform.decode_dither_rows`): one
`api.Decoder` playing GROUP then FRAME samples emits frame n with window
n (`DecodeSampleGroup`, `Codec/decoder.c:11180`, and `DecodeSampleFrame`,
`decoder.c:11482`).

A frozen copy of the JAX package's NumPy model (`ref/gop.py`,
`models/gop_host.decode_group_deep16`, `intra_host.pack_deep_output`,
`gop_host.decode_group`), cut to the progressive group and its v210, YU64
and YUY2 outputs; it imports neither that package nor the port.  Where it
departs from the SDK:

- peaks: a progressive group's encoder writes no peak table (only the
  interlaced HORZTEMP HL bands carry one), so none is read here; the
  JAX package's deep group decode, which the port follows, would leave
  a table's peaks unsubstituted in any case (ROADMAP, Queue F);
- interlaced groups and v210 rows with a partial 6-pixel group are not
  modelled (ValueError).
"""

from __future__ import annotations

import numpy as np

from cfbench.reference import tags, transform, vlc
from cfbench.reference.production import quality_tables
from cfbench.reference.sample import lowpass_channel_offset

_I32 = np.int32

#: display scales a wavelet (`SetTransformScale`, FIELDPLUS case)
SCALES = {0: (4, 2, 2, 1), 1: (4, 2, 2, 1), 2: (8, 4), 3: (16, 8, 8, 4),
          4: (32, 16, 16, 8), 5: (128, 64, 64, 32)}
#: the lowpass prescale of each wavelet's input at 10-bit precision
PRESCALE = (0, 0, 0, 0, 2, 0)


def band_quant(quality: int, channel: int) -> dict:
    """Wavelet k -> its coded bands' quantizers: w0, w1, w4, w5 (LH, HL,
    HH), w3 (LL, LH, HL, HH).  The spatial wavelets take table[sb] *
    scale[band] >> 2, the frame wavelets table[sb] itself."""
    luma, chroma = quality_tables(quality, tags.PRECISION_10BIT,
                                  gop_length=2)
    t = chroma if channel > 0 else luma
    return {5: tuple((t[1 + b] * SCALES[5][1 + b]) >> 2 for b in range(3)),
            4: tuple((t[4 + b] * SCALES[4][1 + b]) >> 2 for b in range(3)),
            3: (1,) + tuple((t[8 + b] * SCALES[3][1 + b]) >> 2
                            for b in range(3)),
            1: tuple(t[11 + b] for b in range(3)),
            0: tuple(t[14 + b] for b in range(3))}


def forward(plane0: np.ndarray, plane1: np.ndarray, quants: dict):
    """One channel's planes of frames 0 and 1 -> (lowpass, {k: coded
    bands}), quantized as the GROUP sample codes them."""
    ll0, b0 = transform.dwt2d_forward(plane0, PRESCALE[0], quants[0])
    ll1, b1 = transform.dwt2d_forward(plane1, PRESCALE[1], quants[1])
    tlow = transform.sat16(ll0 + ll1)
    thigh = transform.sat16(ll1 - ll0)
    # w3's input is band 1 of the reference's two-band temporal wavelet:
    # in the narrow-row quirk (`transform._h26_forward`) its row-0
    # overread lands on band 0's last two pixels where band 0's region
    # is exactly cache-line sized
    carry = tlow[-1, -2:] if (2 * thigh.size) % 64 == 0 else None
    ll3, h3 = transform.dwt2d_forward(thigh, PRESCALE[3], quants[3][1:],
                                      row0_prev=carry)
    ll4, w4 = transform.dwt2d_forward(tlow, PRESCALE[4], quants[4])
    ll5, w5 = transform.dwt2d_forward(ll4, PRESCALE[5], quants[5])
    return ll5, {0: b0, 1: b1, 3: (ll3,) + h3, 4: w4, 5: w5}


def decoded(lowpass: np.ndarray, bands: dict, quants: dict):
    """What a decoder reads back from the sample: the lowpass and w3's raw
    LL as stored (int16), every other band's codes through
    `vlc.decoded_values` (codeset 17)."""
    lp = transform.wrap16(lowpass)
    out = {k: tuple(vlc.decoded_values(b, q) for b, q in zip(bs, quants[k]))
           for k, bs in bands.items() if k != 3}
    out[3] = (transform.wrap16(bands[3][0]),) + tuple(
        vlc.decoded_values(b, q) for b, q in zip(bands[3][1:],
                                                 quants[3][1:]))
    return lp, out


def v26_inverse_stale_bottom(low: np.ndarray,
                             high: np.ndarray) -> np.ndarray:
    """`transform.v26_inverse` with the bottom border taps one row stale
    (5*L[-2] + 4*L[-3] - L[-4], high row -1): the lowpass pointer of
    `InvertSpatialQuantOverflowProtected16s` runs one row ahead of its
    border filter (`Codec/spatial.c:21114+690`)."""
    out = transform.v26_inverse(low, high)
    low, high = low.astype(_I32), high.astype(_I32)
    r = transform.ROUNDING
    tke = (5 * low[-2] + 4 * low[-3] - low[-4] + r) >> 3
    tko = (11 * low[-2] - 4 * low[-3] + low[-4] + r) >> 3
    out[-2] = transform.sat16((tke + high[-1]) >> 1)
    out[-1] = transform.sat16((tko - high[-1]) >> 1)
    return out


def dwt2d_inverse(ll, lh, hl, hh, descale: int = 1,
                  stale_bottom: bool = False) -> np.ndarray:
    """One inverse level; `stale_bottom` applies the stale taps to the
    (LL, HL) pair only: the (LH, HH) side reads a line buffer that holds
    the true last rows."""
    v26 = v26_inverse_stale_bottom if stale_bottom else transform.v26_inverse
    return transform.h26_inverse(v26(ll, hl), transform.v26_inverse(lh, hh),
                                 descale)


def half(x: np.ndarray) -> np.ndarray:
    """The control's rounding: int32 values through float16 and back."""
    return np.asarray(x).astype(np.float16).astype(_I32)


def strips(lowpass: np.ndarray, bands: dict, frame: int, offset: int,
           lossy: bool = False):
    """A channel's decoded (lowpass, bands), its lowpass `offset` added ->
    frame `frame`'s final-level (low, high) strips, the vertical inverse
    of its temporal field with its level-1 wavelet's bands.  `lossy`
    rounds the lowpass and each inverse level's output through float16."""
    r = half if lossy else (lambda x: x)
    ll4 = r(dwt2d_inverse(r(lowpass + offset), *bands[5], descale=1,
                          stale_bottom=True))
    tlow = r(dwt2d_inverse(ll4, *bands[4], descale=2))
    thigh = r(dwt2d_inverse(*bands[3], descale=1, stale_bottom=True))
    field = transform.sat16(tlow - thigh if frame == 0 else tlow + thigh) >> 1
    lh, hl, hh = bands[frame]
    return transform.v26_inverse(field, hl), transform.v26_inverse(lh, hh)


def deep_rows(lowpass: np.ndarray, bands: dict, frame: int,
              lossy: bool = False) -> np.ndarray:
    """Frame `frame`'s Row16u rows (H, W) of a channel for the deep YUV
    outputs: the absolute lowpass offset of a two-frame sample."""
    offset = lowpass_channel_offset(lowpass.shape[1], deep=True,
                                    num_frames=2)
    return transform.h26_inverse_to_row16u(
        *strips(lowpass, bands, frame, offset, lossy), tags.PRECISION_10BIT)


def yuy2_rows(lowpass: np.ndarray, bands: dict, frame: int, channel: int,
              row_draws: np.ndarray, lossy: bool = False) -> np.ndarray:
    """Frame `frame`'s 8-bit rows (H, W) of a channel, dithered by
    `row_draws` (`dither_rows`); the SSE output group is 16 for luma and
    8 for chroma, and a half-step remainder decodes undithered."""
    offset = lowpass_channel_offset(lowpass.shape[1], num_frames=2)
    low, high = strips(lowpass, bands, frame, offset, lossy)
    width, group = 2 * low.shape[-1], 16 if channel == 0 else 8
    tail = group if width % (2 * group) == group else 0
    return transform.h26_inverse_to_output(
        low, high, 2, transform.decode_dither_plane(row_draws, width, group),
        scalar_tail=tail)


def rand_bits(n: int) -> np.ndarray:
    """The first `n` of `rand() & 1` in glibc's default-seed stream:
    `glibc_random.glibc_rand_sequence(n) & 1`, on plain ints (the
    decoder's n-th frame draws past 16 H n earlier draws)."""
    word, ring = 1, [1] + [0] * 33
    for i in range(1, 31):
        q, lo = divmod(word, 127773)
        word = 16807 * lo - 2836 * q
        ring[i] = word + 2147483647 if word < 0 else word
    ring[31:34] = ring[0:3]
    bits = bytearray(n)
    for i in range(34, 344 + n):
        v = (ring[(i - 31) % 34] + ring[(i - 3) % 34]) & 0xFFFFFFFF
        ring[i % 34] = v
        if i >= 344:
            bits[i - 344] = (v >> 1) & 1
    return np.frombuffer(bytes(bits), np.uint8)


def dither_rows(height: int, window: int) -> np.ndarray:
    """`transform.decode_dither_rows(height, window)` on `rand_bits`: the
    decoder's n-th emitted frame's (H, 16) draws, its blocks on rows 0,
    1, H-2, H-1, 2, ..., H-3."""
    draws = rand_bits(16 * height * (window + 1))[16 * height * window:]
    order = [0, 1, height - 2, height - 1] + list(range(2, height - 2))
    rows = np.empty((height, 16), np.int64)
    rows[order] = draws.reshape(height, 16)
    return rows


def pack_yu64(y16: np.ndarray, c1: np.ndarray, c2: np.ndarray) -> bytes:
    """YU64: Y0 C1 Y1 C2, little-endian 16-bit."""
    h, w = y16.shape
    row = np.empty((h, 2 * w), np.uint16)
    row[:, 0::4] = y16[:, 0::2]
    row[:, 1::4] = c1
    row[:, 2::4] = y16[:, 1::2]
    row[:, 3::4] = c2
    return row.astype("<u2").tobytes()


def pack_v210(y16: np.ndarray, c1: np.ndarray, c2: np.ndarray) -> bytes:
    """v210: 6 pixels -> 4 little-endian words of three 10-bit slots, rows
    of ((W + 47) // 48) * 128 bytes (`ConvertPlanarYUVToV210`,
    `Codec/convert.c:13526`, the precision-16 branch).  The reference's
    writer swaps Cb and Cr against its own v210 reader: slot 0 carries
    channel 2."""
    h, w = y16.shape
    if w % 6:
        raise ValueError(f"no v210 rows of a partial group: width {w}")
    y, cb, cr = y16 >> 6, c2 >> 6, c1 >> 6
    g = w // 6
    yg = y.reshape(h, g, 6)
    cbg = cb.reshape(h, g, 3)
    crg = cr.reshape(h, g, 3)
    stream = np.zeros((h, ((w + 47) // 48) * 96), np.int64)
    stream[:, :12 * g] = np.stack(
        [cbg[..., 0], yg[..., 0], crg[..., 0], yg[..., 1],
         cbg[..., 1], yg[..., 2], crg[..., 1], yg[..., 3],
         cbg[..., 2], yg[..., 4], crg[..., 2], yg[..., 5]],
        axis=-1).reshape(h, 12 * g)
    words = stream[:, 0::3] | (stream[:, 1::3] << 10) | (stream[:, 2::3] << 20)
    return words.astype("<u4").tobytes()


PACKS = {"V210": pack_v210, "YU64": pack_yu64, "YUY2": transform.pack_yuy2}


def decode_pair(planes0, planes1, quality: int, frame: int, output: str,
                lossy: bool = False, window: int = 0) -> bytes:
    """[Y, V, U] planes of frames 0 and 1 -> frame `frame` of their GROUP
    sample decoded to `output` (an `api.PixelFormat` name of `PACKS`);
    YUY2 with the dither of the decoder's `window`-th emitted frame."""
    if output not in PACKS:
        raise ValueError(f"the GOP reference decodes to {sorted(PACKS)}, "
                         f"not {output!r}")
    draws = dither_rows(planes0[0].shape[0], window) \
        if output == "YUY2" else None
    rows = []
    for ch, (p0, p1) in enumerate(zip(planes0, planes1)):
        quants = band_quant(quality, ch)
        lowpass, bands = decoded(*forward(p0, p1, quants), quants)
        rows.append(deep_rows(lowpass, bands, frame, lossy) if draws is None
                    else yuy2_rows(lowpass, bands, frame, ch, draws, lossy))
    return PACKS[output](*rows)

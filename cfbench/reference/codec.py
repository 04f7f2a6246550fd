"""The plain reference's CFHD intra codec in NumPy, shared by the
configurations' formats.  Each format is a file of its own,
`reference/formats/<format>.py` (the configuration's `format`), with:

- `params(cfg)`: the encoder's parameters (`production.IntraParams`);
- `planes(cfg, frame)`: a frame (H, row bytes) uint8 -> the encoder's
  int32 input planes;
- `encode_sample(cfg, frame, frame_number, lossy)`: the frame's CFHD
  sample as the reference SDK's encoder writes it (the pools' samples are
  compared with it byte for byte);
- `decode_output(cfg, frame, output, lossy)`: what a decoder gives in
  the pixel format `output` for that frame's sample, worked out from the
  frame (H, row bytes) uint8: the sample's coefficients are the forward
  transform's, as the entropy code is lossless up to its value clamp,
  which `vlc.decoded_values` applies.

`lossy=True` is the control: every level's lowpass coefficients are held
in float16, a 16-bit type with 11 bits of significand, in place of the
codec's 16-bit integers, in the forward transform (`encode`) or in the
inverse (`yuv422_output`, `bayer_rg48_output`).  It is the step below the
codec's stated integer precision, and it has to fail the comparison.

Nothing here imports the JAX package or the port.
"""

from __future__ import annotations

import numpy as np

from cfbench.reference import demosaic, transform, vlc
from cfbench.reference.production import IntraParams
from cfbench.reference.sample import (
    EncodedChannel,
    EncoderMetadata,
    lowpass_channel_offset,
    write_sample,
)


def half(x: np.ndarray) -> np.ndarray:
    """The control's rounding: int32 values through float16 and back."""
    return np.asarray(x).astype(np.float16).astype(np.int32)


def forward(p: IntraParams, planes, lossy: bool = False):
    """Per channel (lowpass, bands, quants): the three forward levels with
    their quantizers; `lossy` rounds each level's lowpass through float16."""
    out = []
    for ch, plane in enumerate(planes):
        quants = p.band_quant(ch)
        ll, bands = plane, []
        for k in range(3):
            ll, highs = transform.dwt2d_forward(ll, p.prescale[k], quants[k])
            if lossy:
                ll = half(ll)
            bands.append(highs)
        out.append((ll, bands, quants))
    return out


def encode(p: IntraParams, planes, frame_number: int, lossy: bool = False,
           **sample) -> bytes:
    """The CFHD sample of the planes with FRAME_NUMBER `frame_number` and
    the default metadata block advanced to it, as the SDK's encoder
    advances its unique frame number and timecode each frame
    (`EncoderSDK/SampleEncoder.cpp:795-880`); `sample` are
    `write_sample`'s format arguments."""
    channels = [EncodedChannel(lowpass=ll, bands=bands, quants=quants)
                for ll, bands, quants in forward(p, planes, lossy)]
    meta = EncoderMetadata().advanced(frame_number - 1)
    return write_sample(channels, p, frame_number, meta, **sample)


def decoded(p: IntraParams, planes):
    """Per channel (lowpass, dequantized bands) as a decoder reads them
    from the planes' sample: the lowpass as stored (int16), each band's
    codes through `vlc.decoded_values`."""
    out = []
    for ll, bands, quants in forward(p, planes):
        lowpass = ((ll.astype(np.int64) + 32768) % 65536 - 32768)
        wb = [tuple(vlc.decoded_values(b, q) for b, q in zip(level, qs))
              for level, qs in zip(bands, quants)]
        out.append((lowpass.astype(np.int32), wb))
    return out


def inverse_16s(lowpass, wb, prescale, lossy: bool) -> np.ndarray:
    """The inverse through levels 3 and 2 (`inverse_channel_to_16s`),
    with the control's rounding after each where `lossy`."""
    ll = half(lowpass) if lossy else lowpass
    for k in (2, 1):
        descale = 2 if prescale[k] == 2 else 1
        ll = transform.dwt2d_inverse(ll, *wb[k], descale)
        if lossy:
            ll = half(ll)
    return ll


def yuv422_output(p: IntraParams, planes, height: int,
                  lossy: bool = False) -> np.ndarray:
    """A 4:2:2 sample decoded to 8-bit YUY2 (H, row bytes) uint8, with the
    dither of a decoder's first frame (`transform.decode_dither_rows`,
    frame index 0)."""
    chans = decoded(p, planes)
    row_draws = transform.decode_dither_rows(chans[0][0].shape[0] * 8, 0)
    out = []
    for ch, (lowpass, wb) in enumerate(chans):
        lp = lowpass + lowpass_channel_offset(lowpass.shape[1])
        ll = inverse_16s(lp, wb, p.prescale, lossy)
        lh, hl, hh = wb[0]
        low = transform.v26_inverse(ll, hl)
        high = transform.v26_inverse(lh, hh)
        width = low.shape[-1] * 2
        group = 16 if ch == 0 else 8
        tail = group if width % (2 * group) == group else 0
        dither = transform.decode_dither_plane(row_draws, width, group)
        out.append(transform.h26_inverse_to_output(
            low, high, 2, dither, scalar_tail=tail))
    yuy2 = transform.pack_yuy2(*out)
    return np.frombuffer(yuy2, np.uint8).reshape(height, -1)


def bayer_rg48_output(p: IntraParams, planes, height: int,
                      lossy: bool = False) -> np.ndarray:
    """A Bayer sample decoded to RG48 (little-endian uint16, R G B) as
    (H, row bytes) uint8, through the raw DemosaicRAW chain (no develop
    metadata in the sample)."""
    rows = []
    for lowpass, wb in decoded(p, planes):
        ll = inverse_16s(lowpass, wb, p.prescale, lossy)
        lh, hl, hh = wb[0]
        low = transform.v26_inverse(ll, hl)
        high = transform.v26_inverse(lh, hh)
        rows.append(transform.h26_inverse_to_row16u(low, high, p.precision))
    rgb = demosaic.demosaic_raw_rg48(*rows)
    return rgb.astype("<u2").view(np.uint8).reshape(height, -1)


def unsupported(cfg: dict, output: str):
    return ValueError(f"the reference decodes {cfg['format']} samples to no "
                      f"{output!r}")

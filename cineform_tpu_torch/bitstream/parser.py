"""CFHD sample parser: tag/value walk -> structured intra sample.

A copy of the JAX package's `bitstream/parser.py`.

Mirrors the reference decoder's header parse (`Codec/decoder.c:2140`
ParseSampleHeader and the tag loop of `DecodeSampleIntraFrame`
`Codec/decoder.c:11584`): walks 32-bit tag/value segments, skipping optional
chunks it does not understand, and collects the lowpass pixels plus the
entropy-coded payload of every subband.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from cineform_tpu_torch.spec import tags


@dataclass
class BandInfo:
    band: int
    width: int
    height: int
    subband: int
    encoding: int
    quantization: int
    scale: int
    coding_flags: int
    data: bytes          # entropy payload (incl. band-end code + padding)
    data_offset: int     # absolute byte offset of payload in the sample
    peak_level: int = 0  # PEAK_LEVEL (250 * quant) when peaks-coded
    peaks: np.ndarray | None = None   # int16 peak values (dequantized)
    truncated: bool = False  # chunk size extends past the sample end


@dataclass
class ChannelInfo:
    channel: int
    lowpass_width: int = 0
    lowpass_height: int = 0
    lowpass_quant: int = 1
    pixel_offset: int = 0
    bits_per_pixel: int = 16
    num_levels: int = 0
    lowpass: np.ndarray | None = None
    wavelets: list[dict] = field(default_factory=list)
    bands: list[BandInfo] = field(default_factory=list)


@dataclass
class IntraSample:
    sample_type: int = 0
    sample_end: int = 0          # end offset of the first video channel
    encoded_channels: int = 1    # 2 = stereo 3D dual-channel sample
    channel_number: int = 0
    transform_type: int = 0
    num_frames: int = 1
    num_channels: int = 0
    num_wavelets: int = 0
    num_subbands: int = 0
    num_spatial: int = 0
    first_wavelet: int = 0
    width: int = 0
    height: int = 0
    display_height: int = 0
    precision: int = tags.PRECISION_DEFAULT
    input_format: int = 0
    encoded_format: int = 0
    colorspace: int = 0
    quality: int = 0
    frame_number: int = 0
    prescale: list[int] = field(default_factory=lambda: [0] * 8)
    sample_flags: int = 0
    end_marker: int | None = None   # value of the last top-level MARKER tag
    channel_sizes: list[int] = field(default_factory=list)
    channels: list[ChannelInfo] = field(default_factory=list)
    metadata: list[bytes] = field(default_factory=list)

    @property
    def progressive(self) -> bool:
        return bool(self.sample_flags & tags.SAMPLE_FLAGS_PROGRESSIVE)


def parse_sample(data: bytes) -> IntraSample:
    """Parse one CFHD intra-frame sample."""
    s = IntraSample()
    pos = 0
    n = len(data)
    chan: ChannelInfo | None = None
    wavelet: dict | None = None
    band: dict = {}
    index_count = 0

    while pos + 4 <= n:
        tag, value = struct.unpack(">hH", data[pos:pos + 4])
        pos += 4
        at = abs(tag)

        # chunk classes
        if at >= tags.CUSTOM_CHUNK24BIT:
            size = (((at & 0xFF) << 16) | value) * 4
            pos += size
            continue
        if at >= tags.CHUNK:
            payload = data[pos:pos + value * 4]
            if at == tags.METADATA_CHUNK:
                s.metadata.append(payload)
            elif at == tags.PEAK_TABLE:
                # peaks table for the band just closed
                # (`Codec/encoder.c:6574`: chunk of raw LE int16
                # dequantized values written after the band trailer;
                # `Codec/decoder.c:23996` skips the chunk because the
                # OFFSET_L/H + PEAK_LEVEL tags before the band already
                # aimed peak_table.base at this data)
                if chan is not None and chan.bands:
                    chan.bands[-1].peaks = np.frombuffer(payload, "<i2")
            pos += value * 4
            continue
        if at >= tags.CHUNK24BIT:
            size = (((at & 0xFF) << 16) | value) * 4
            kind = at & 0xFF00
            if kind == tags.SUBBAND_SIZE:
                if band.get("pending_lowpass"):
                    # chunk = MARKER 0x0F0F + raw BE int16 pixels + MARKER 0x1B4B
                    assert chan is not None
                    w, h = chan.lowpass_width, chan.lowpass_height
                    pix = data[pos + 4: pos + 4 + 2 * w * h]
                    chan.lowpass = (
                        np.frombuffer(pix, dtype=">i2")
                        .astype(np.int32)
                        .reshape(h, w)
                    )
                    band.clear()
                else:
                    # chunk = BAND_HEADER pair + entropy bits + BAND_TRAILER
                    assert chan is not None and band
                    payload = data[pos + 4: pos + size]
                    chan.bands.append(BandInfo(
                        band=band.get("band", 0),
                        width=band.get("width", 0),
                        height=band.get("height", 0),
                        subband=band.get("subband", 0),
                        encoding=band.get("encoding", 0),
                        quantization=band.get("quantization", 1),
                        scale=band.get("scale", 0),
                        coding_flags=band.get("coding_flags", 0),
                        peak_level=band.get("peak_level", 0),
                        data=payload,
                        data_offset=pos + 4,
                        truncated=pos + size > n,
                    ))
                    band.clear()
                pos += size
            elif kind == tags.SAMPLE_SIZE:
                # record where this (eye's) sample ends; a stereo 3D sample
                # holds a second full sample 16-byte-aligned after it
                if s.sample_end == 0:
                    s.sample_end = pos + size
            elif kind == tags.LEVEL_SIZE:
                pass  # spans content we parse inline
            else:
                pos += size  # unknown sized chunk: skip
            continue

        # plain tags
        if at == tags.SAMPLE:
            s.sample_type = s.sample_type or value
        elif at == tags.INDEX:
            index_count = value
            for i in range(index_count):
                s.channel_sizes.append(
                    struct.unpack(">I", data[pos + 4 * i:pos + 4 * i + 4])[0])
            pos += 4 * index_count
            # channel 0 starts implicitly
        elif at == tags.TRANSFORM_TYPE:
            s.transform_type = value
        elif at == tags.NUM_FRAMES:
            s.num_frames = value
        elif at == tags.NUM_CHANNELS:
            s.num_channels = value
        elif at == tags.INPUT_FORMAT:
            s.input_format = value
        elif at == tags.ENCODED_FORMAT:
            s.encoded_format = value
        elif at == tags.ENCODED_COLORSPACE:
            s.colorspace = value
        elif at == tags.NUM_WAVELETS:
            s.num_wavelets = value
        elif at == tags.NUM_SUBBANDS:
            s.num_subbands = value
        elif at == tags.NUM_SPATIAL:
            s.num_spatial = value
        elif at == tags.FIRST_WAVELET:
            s.first_wavelet = value
        elif at == tags.FRAME_WIDTH:
            s.width = value
        elif at == tags.FRAME_HEIGHT:
            s.height = value
        elif at == tags.FRAME_NUMBER:
            s.frame_number = value
        elif at == tags.PRECISION:
            s.precision = value
        elif at == tags.FRAME_DISPLAY_HEIGHT:
            s.display_height = value
        elif at == tags.QUALITY_L:
            s.quality = (s.quality & ~0xFFFF) | value
        elif at == tags.QUALITY_H:
            s.quality = (s.quality & 0xFFFF) | (value << 16)
        elif at == tags.PRESCALE_TABLE:
            s.prescale = [(value >> (14 - 2 * i)) & 0x3 for i in range(8)]
        elif at == tags.SAMPLE_FLAGS:
            s.sample_flags = value
            # channel 0 content follows
            chan = ChannelInfo(channel=0)
            s.channels.append(chan)
        elif at == tags.CHANNEL:
            chan = ChannelInfo(channel=value)
            s.channels.append(chan)
        elif at == tags.LOWPASS_SUBBAND:
            if chan is None:  # sample without SAMPLE_FLAGS
                chan = ChannelInfo(channel=0)
                s.channels.append(chan)
            band["pending_lowpass"] = True
        elif at == tags.NUM_LEVELS:
            if chan is not None:
                chan.num_levels = value
        elif at == tags.LOWPASS_WIDTH:
            chan.lowpass_width = value
        elif at == tags.LOWPASS_HEIGHT:
            chan.lowpass_height = value
        elif at == tags.PIXEL_OFFSET:
            chan.pixel_offset = value
        elif at == tags.QUANTIZATION:
            chan.lowpass_quant = value
        elif at == tags.PIXEL_DEPTH:
            chan.bits_per_pixel = value
        elif at == tags.WAVELET_TYPE:
            wavelet = {"type": value}
            chan.wavelets.append(wavelet)
        elif at == tags.WAVELET_NUMBER:
            wavelet["number"] = value
        elif at == tags.WAVELET_LEVEL:
            wavelet["level"] = value
        elif at == tags.NUM_BANDS:
            wavelet["num_bands"] = value
        elif at == tags.HIGHPASS_WIDTH:
            wavelet["width"] = value
        elif at == tags.HIGHPASS_HEIGHT:
            wavelet["height"] = value
        elif at == tags.LOWPASS_SCALE:
            wavelet["lowpass_scale"] = value
        elif at == tags.BAND_NUMBER:
            band["band"] = value
        elif at == tags.BAND_CODING_FLAGS:
            band["coding_flags"] = value
        elif at == tags.BAND_WIDTH:
            band["width"] = value
        elif at == tags.BAND_HEIGHT:
            band["height"] = value
        elif at == tags.BAND_SUBBAND:
            band["subband"] = value
        elif at == tags.BAND_ENCODING:
            band["encoding"] = value
        elif at == tags.BAND_QUANTIZATION:
            band["quantization"] = value
        elif at == tags.BAND_SCALE:
            band["scale"] = value
        elif at == tags.PEAK_LEVEL:
            band["peak_level"] = value
        elif at == tags.ENCODED_CHANNELS:
            s.encoded_channels = value
        elif at == tags.ENCODED_CHANNEL_NUMBER:
            s.channel_number = value
        elif at == tags.MARKER:
            s.end_marker = value
        elif at == tags.FRAME_TRAILER:
            break
        # margins, borders, divisors, trailers: no state needed

    return s

"""The CFHD intra sample in plain NumPy: the band pitch, the encode-time
metadata block, the sample writer, and the decoder's lowpass bias.

A frozen copy of the port's `models/intra_host.py` (itself a copy of the
JAX package's), with its bands coded by `cfbench.reference.vlc` in place of
the C++ coder.  Sample layout contract: `Codec/encoder.c:7461-7885`
(EncodeQuantizedGroup, intra branch) + `Codec/codec.c:1369-1584`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from cfbench.reference import tags, vlc
from cfbench.reference.production import (
    IntraParams,
    pack_prescale_table,
    spatial_band_scales,
)
from cfbench.reference.writer import SampleWriter


def align16_pixels(width: int) -> int:
    """Wavelet band row pitch in pixels: ALIGN16(width * 2) / 2.

    The reference encodes each band row padded to this pitch with zeros
    (band buffers are allocated zeroed; `EncodeQuantLongRuns` walks the
    full pitch), so the entropy stream includes the zero pad columns.
    """
    return ((width * 2 + 15) // 16 * 16) // 2


@dataclass
class EncoderMetadata:
    """Global metadata block contents (`EncoderSDK/MetadataWriter.cpp:325`)."""

    guid: bytes = b"\xa5" * 16
    date: str = "2026-01-01"
    time: str = "00:00:00"
    timecode: str = "00:00:00:00"
    unique_frame: int = 0
    video_channels: int = 0      # VCHN: 2 = stereo 3D dual-channel

    def block(self) -> bytes:
        """FOURCC + 24-bit LE size + type char + payload, each padded to 4B
        (`Common/CFHDMetadataTags.h:79-85`)."""
        def tup(fourcc: bytes, typ: bytes, payload: bytes) -> bytes:
            size = len(payload)
            pad = (-size) % 4
            return fourcc + bytes([size & 0xFF, (size >> 8) & 0xFF,
                                   (size >> 16) & 0xFF]) + typ + payload + b"\0" * pad

        vchn = (tup(b"VCHN", b"\x00",
                    self.video_channels.to_bytes(4, "little"))
                if self.video_channels else b"")
        return (
            tup(b"GUID", b"G", self.guid)
            + vchn
            + tup(b"DATE", b"c", self.date.encode())
            + tup(b"TIME", b"c", self.time.encode())
            + tup(b"TIMC", b"c", self.timecode.encode())
            + tup(b"UFRM", b"L", self.unique_frame.to_bytes(4, "little"))
        )

    def advanced(self, k: int) -> "EncoderMetadata":
        """Metadata for the k-th frame after this one: the reference's
        CSampleEncoder auto-increments the unique frame number and the
        timecode (24 fps default base) on every EncodeSample
        (`EncoderSDK/SampleEncoder.cpp:795-880`)."""
        if k == 0:
            return self
        try:
            hh, mm, ss, ff = (int(x) for x in self.timecode.split(":"))
            total = ((hh * 60 + mm) * 60 + ss) * 24 + ff + k
            ff = total % 24
            ss = (total // 24) % 60
            mm = (total // (24 * 60)) % 60
            hh = (total // (24 * 3600)) % 24
            tc = f"{hh:02d}:{mm:02d}:{ss:02d}:{ff:02d}"
        except ValueError:
            tc = self.timecode
        return replace(self, unique_frame=self.unique_frame + k,
                       timecode=tc)


@dataclass
class EncodedChannel:
    lowpass: np.ndarray                      # int32 (h, w), raw 16-bit values
    bands: list                              # [(lh, hl, hh)] per wavelet, finest first
    quants: list                             # [(q_lh, q_hl, q_hh)] per wavelet
    # optional precomputed entropy payloads [(bytes, bytes, bytes)] per
    # wavelet (device entropy path); None entries fall back to host coding
    payloads: list | None = None


def encode_band_payload(values: np.ndarray, codeset: int = 17) -> bytes:
    """Zero-pad rows to the band pitch and entropy-encode."""
    h, w = values.shape
    pitchw = align16_pixels(w)
    padded = np.zeros((h, pitchw), dtype=np.int32)
    padded[:, :w] = values
    return vlc.encode_band_bytes(padded, codeset=codeset)


def write_sample(channels: list[EncodedChannel], params: IntraParams,
                 frame_number: int = 1,
                 metadata: EncoderMetadata | None = None,
                 input_format: int = tags.COLOR_FORMAT_YUYV,
                 encoded_format: int = tags.ENCODED_FORMAT_YUV_422,
                 colorspace: int | None = tags.COLOR_SPACE_BT_709,
                 quality_high: int = 0,
                 eye: int | None = None) -> bytes:
    """Assemble a complete CFHD intra sample.  The defaults write a YUY2
    frame (4:2:2, BT.709); `colorspace=None` writes no colourspace tag, as
    the RGB and Bayer formats do, and `quality_high` is ORed into the
    QUALITY_H tag (0x2000 for RGBA).  `eye` 0 or 1 writes one eye's
    bitstream of a stereo 3D sample."""
    w = SampleWriter()
    num_channels = len(channels)
    num_wavelets = params.num_wavelets
    scales = spatial_band_scales(params.num_spatial)

    # --- sample header (PutVideoIntraFrameHeader, codec.c:1369) -------------
    w.put_tag(tags.SAMPLE, tags.SAMPLE_TYPE_IFRAME)
    index_off = w.put_index_placeholder(num_channels)
    w.put_tag(tags.TRANSFORM_TYPE, tags.TRANSFORM_TYPE_SPATIAL)
    w.put_tag(tags.NUM_FRAMES, 1)
    w.put_tag(tags.NUM_CHANNELS, num_channels)
    if input_format >= 100:
        # formats >= COLOR_FORMAT_INPUT_FORMAT_TAG_REQUIRED (codec.c:1407)
        w.put_tag(tags.INPUT_FORMAT, input_format)
    else:
        w.put_tag_optional(tags.INPUT_FORMAT, input_format)
    w.put_tag(tags.ENCODED_FORMAT, encoded_format)
    if colorspace:
        w.put_tag_optional(tags.ENCODED_COLORSPACE, colorspace)
    w.put_tag(tags.NUM_WAVELETS, num_wavelets)
    w.put_tag(tags.NUM_SUBBANDS, 3 * num_wavelets + 1)
    w.put_tag(tags.NUM_SPATIAL, params.num_spatial)
    w.put_tag(tags.FIRST_WAVELET, tags.WAVELET_TYPE_SPATIAL)
    w.put_tag(tags.FRAME_WIDTH, params.width)
    w.put_tag(tags.FRAME_HEIGHT, params.height)
    w.put_tag_optional(tags.FRAME_NUMBER, frame_number)
    w.put_tag(tags.PRECISION, params.precision)
    w.put_tag_optional(tags.FRAME_DISPLAY_HEIGHT, params.height)
    w.put_tag_optional(tags.VERSION, tags.FILE_VERSION_CODE)
    w.put_tag_optional(tags.QUALITY_L, params.quality & 0xFFFF)
    w.put_tag_optional(tags.QUALITY_H,
                       ((params.quality >> 16) | quality_high) & 0xFFFF)
    if params.precision == tags.PRECISION_12BIT:
        # 12-bit prescales fail TestTransformPrescaleMatch -> required tag
        w.put_tag(tags.PRESCALE_TABLE, pack_prescale_table(params.prescale))
    else:
        w.put_tag_optional(tags.PRESCALE_TABLE,
                           pack_prescale_table(params.prescale))
    if eye is not None:
        # stereo 3D: both eyes share one sample (`Codec/encoder.c:7548-7556`)
        w.put_tag_optional(tags.ENCODED_CHANNELS, 2)
        w.put_tag_optional(tags.ENCODED_CHANNEL_NUMBER, eye)

    # --- sample size chunk + metadata + extension (encoder.c:7559-7621) -----
    w.push_chunk(tags.SAMPLE_SIZE)
    meta = (metadata or EncoderMetadata()).block()
    w.put_tag_optional(tags.METADATA_CHUNK, len(meta) // 4)
    w.put_bytes(meta)
    # FREE metadata space (encoder.c:7596-7613)
    free_size = 512
    w.put_tag_optional(tags.METADATA_CHUNK, free_size // 4)
    w.put_bytes(b"FREE" + (free_size - 8).to_bytes(4, "little") + b"\0" * (free_size - 8))
    # group extension (codec.c:1177)
    w.put_tag_optional(tags.INTERLACED_FLAGS, 0)
    w.put_tag_optional(tags.PROTECTION_FLAGS, 0)
    w.put_tag_optional(tags.PICTURE_ASPECT_X, 16)
    w.put_tag_optional(tags.PICTURE_ASPECT_Y, 9)
    w.put_tag(tags.SAMPLE_FLAGS, tags.SAMPLE_FLAGS_PROGRESSIVE)

    # --- per-channel content -------------------------------------------------
    channel_sizes = []
    for ch, enc in enumerate(channels):
        if ch > 0:
            w.pad_to_tag()
            w.put_tag(tags.SAMPLE, tags.SAMPLE_TYPE_CHANNEL)
            w.put_tag(tags.CHANNEL, ch)
        start = len(w.buf)

        # lowpass band (EncodeLowPassBand, encoder.c:4251)
        lp = enc.lowpass
        w.put_marker(tags.LOWPASS_START_CODE)
        w.put_tag(tags.LOWPASS_SUBBAND, 0)
        w.put_tag(tags.NUM_LEVELS, num_wavelets)
        w.put_tag(tags.LOWPASS_WIDTH, lp.shape[1])
        w.put_tag(tags.LOWPASS_HEIGHT, lp.shape[0])
        w.put_tag(tags.MARGIN_LEFT, 0)
        w.put_tag(tags.MARGIN_TOP, 0)
        w.put_tag(tags.MARGIN_RIGHT, 0)
        w.put_tag(tags.MARGIN_BOTTOM, 0)
        w.put_tag(tags.PIXEL_OFFSET, 0)
        w.put_tag(tags.QUANTIZATION, 1)
        w.put_tag(tags.PIXEL_DEPTH, 16)
        w.push_chunk(tags.SUBBAND_SIZE)
        w.put_marker(tags.COEFFICIENT_START_CODE)
        w.put_bytes(lp.astype(">i2").tobytes())
        w.put_marker(tags.LOWPASS_END_CODE)
        w.pop_chunk()

        # wavelets, deepest first (EncodeQuantizedFrameTransform, encoder.c:7889)
        subband = 1
        for k in range(num_wavelets - 1, -1, -1):
            bands = enc.bands[k]
            quants = enc.quants[k]
            wtype = (tags.WAVELET_TYPE_HORZTEMP if k == 0
                     else tags.WAVELET_TYPE_SPATIAL)
            bh, bw = bands[0].shape
            w.put_marker(tags.HIGHPASS_START_CODE)
            w.put_tag(tags.WAVELET_TYPE, wtype)
            w.put_tag(tags.WAVELET_NUMBER, k + 1)
            w.put_tag(tags.WAVELET_LEVEL, k + 1)
            w.put_tag(tags.NUM_BANDS, 4)
            w.put_tag(tags.HIGHPASS_WIDTH, bw)
            w.put_tag(tags.HIGHPASS_HEIGHT, bh)
            w.put_tag(tags.LOWPASS_BORDER, 0)
            w.put_tag(tags.HIGHPASS_BORDER, 0)
            w.put_tag(tags.LOWPASS_SCALE, scales[k][0])
            w.put_tag(tags.LOWPASS_DIVISOR, 0)
            w.push_chunk(tags.LEVEL_SIZE)
            for b in range(3):
                w.put_marker(tags.BAND_START_CODE)
                w.put_tag(tags.BAND_NUMBER, b + 1)
                w.put_tag(tags.BAND_CODING_FLAGS, 1)  # codebook 1 = cs17
                w.put_tag(tags.BAND_WIDTH, bw)
                w.put_tag(tags.BAND_HEIGHT, bh)
                w.put_tag(tags.BAND_SUBBAND, subband)
                w.put_tag(tags.BAND_ENCODING, tags.BAND_ENCODING_RUNLENGTHS)
                w.put_tag(tags.BAND_QUANTIZATION, quants[b])
                w.put_tag(tags.BAND_SCALE, scales[k][b + 1])
                w.push_chunk(tags.SUBBAND_SIZE)
                w.put_tag(tags.BAND_HEADER, 0)
                payload = (enc.payloads[k][b]
                           if enc.payloads is not None
                           and enc.payloads[k] is not None
                           and enc.payloads[k][b] is not None else None)
                w.put_bytes(payload if payload is not None
                            else encode_band_payload(bands[b]))
                w.pad_to_tag()
                w.put_tag(tags.BAND_TRAILER, 0)
                w.pop_chunk()
                subband += 1
            w.put_marker(tags.HIGHPASS_END_CODE)
            w.pop_chunk()
        w.pad_to_tag()
        channel_sizes.append(len(w.buf) - start)

    # --- trailer + patches ----------------------------------------------------
    w.put_tag(tags.FRAME_TRAILER, 0)
    w.pop_chunk()  # SAMPLE_SIZE
    w.patch_index(index_off, channel_sizes)
    return w.getvalue()


def lowpass_channel_offset(lowpass_width: int, deep: bool = False,
                           num_frames: int = 1) -> int:
    """The reference decoder's per-channel lowpass load bias
    (`DecodeLowPassBand`, `Codec/decoder.c:12258-12505`, precision 10),
    expressed RELATIVE to this codebase's pinned decode models.

    The reference adds `channeloffset` to every deepest-lowpass
    coefficient as it parses the band.  For EVEN lowpass widths (the
    16-bit fast path) the offset is format-dependent: +24 intra / +48
    two-frame GOP for 8-bit outputs, +4 / +14 for the deep YU64/YR16/v210
    outputs.  For ODD lowpass widths (chroma at w%32==16 frame widths,
    e.g. 144) the generic path applies +5 intra / +10 GOP for EVERY
    output format.  Even offsets propagate exactly through the inverse
    pyramid's shift arithmetic, so our byte-exact 8-bit models absorb the
    +24/+48 in their empirically pinned output-stage constants; odd
    offsets do not, which was the long-unexplained narrow-width chroma
    +-1.  Hence: 8-bit paths get 0 (even) or 5-24 / 10-48 (odd); deep
    paths get the reference values verbatim."""
    if lowpass_width % 2:
        base = 10 if num_frames == 2 else 5
        if deep:
            return base
        return base - (48 if num_frames == 2 else 24)
    if deep:
        return 14 if num_frames == 2 else 4
    return 0


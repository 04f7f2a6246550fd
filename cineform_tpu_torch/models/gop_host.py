"""Host (NumPy) side of the two-frame GOP (FIELDPLUS) GROUP sample: its
subband map and its writer.

A copy of the parts of the JAX package's `models/gop_host.py` that the GOP
codec and the API use: `SUBBAND_MAP`, the band-end marker, `write_group`
for a progressive or interlaced group, whose bands the C++ coder codes
(`intra_host.encode_band_payload`; an interlaced group's frame-wavelet
HL bands with codeset 18 and a peaks table), and the GOP stream's two
header samples (`sequence_header`, `frame_header_sample`).  Its samples
equal the reference encoder's byte for byte
(tests/golden/samples/gop_*.cfhd.f1, ilace_*.cfhd.f1).

The GROUP layout, captured from the reference: the SAMPLE=2 header, the
lowpass, then per channel the wavelets w5, w4, w3 (whose LL, subband 7, is
a raw big-endian 16-bit band followed by the band-end codeword), the
temporal wavelet's empty band entry (subband 255), w1 and w0, and the
GROUP trailer.
"""

from __future__ import annotations

import numpy as np

from cineform_tpu_torch.bitstream.writer import SampleWriter
from cineform_tpu_torch.models import intra_host
from cineform_tpu_torch.models.intra_host import EncoderMetadata
from cineform_tpu_torch.ref import gop as gxf
from cineform_tpu_torch.spec import codebooks as cb
from cineform_tpu_torch.spec import tags
from cineform_tpu_torch.spec.production import pack_prescale_table

# subband -> (wavelet index, band slot) (`Codec/decoder.c:11191`)
SUBBAND_MAP = {}
for _sb in (1, 2, 3):
    SUBBAND_MAP[_sb] = (5, _sb - 1)
for _sb in (4, 5, 6):
    SUBBAND_MAP[_sb] = (4, _sb - 4)
for _sb in (7, 8, 9, 10):
    SUBBAND_MAP[_sb] = (3, _sb - 7)
for _sb in (11, 12, 13):
    SUBBAND_MAP[_sb] = (1, _sb - 11)
for _sb in (14, 15, 16):
    SUBBAND_MAP[_sb] = (0, _sb - 14)


# codeset 17's band-end codeword, MSB-aligned and zero-padded to 32 bits
# (what the reference emits after an uncompressed 16-bit band)
_CS17 = cb.get_codeset(17)
BANDEND_MARKER = (_CS17.bandend_bits << (32 - _CS17.bandend_size)
                  ).to_bytes(4, "big")


def write_group(channels, width: int, height: int, quality: int,
                frame_number: int = 1,
                metadata: EncoderMetadata | None = None,
                progressive: bool = True) -> bytes:
    """Assemble a GROUP sample from per-channel (lowpass, bands, quants):
    bands[k] holds wavelet k's coded bands, w0/w1/w4/w5 (LH, HL, HH) and
    w3 (LL, LH, HL, HH), and quants[k] their quantizers
    (`ref.gop.fieldplus_band_quant`).  An interlaced group
    (`progressive=False`) writes no SAMPLE_FLAGS tag and codes the HL band
    of the frame wavelets w0 and w1, delta-coded, with codeset 18 and a
    peaks table."""
    scales = gxf.fieldplus_band_scales()
    prescale = gxf.FIELDPLUS_PRESCALE

    w = SampleWriter()
    w.put_tag(tags.SAMPLE, tags.SAMPLE_TYPE_GROUP)
    index_off = w.put_index_placeholder(3)
    w.put_tag(tags.TRANSFORM_TYPE, tags.TRANSFORM_TYPE_FIELDPLUS)
    w.put_tag(tags.NUM_FRAMES, 2)
    w.put_tag(tags.NUM_CHANNELS, 3)
    w.put_tag_optional(tags.INPUT_FORMAT, tags.COLOR_FORMAT_YUYV)
    w.put_tag_optional(tags.ENCODED_COLORSPACE, tags.COLOR_SPACE_BT_709)
    w.put_tag(tags.NUM_WAVELETS, 6)
    w.put_tag(tags.NUM_SUBBANDS, 17)
    w.put_tag(tags.NUM_SPATIAL, 3)
    w.put_tag(tags.FIRST_WAVELET, tags.WAVELET_TYPE_SPATIAL)
    w.put_tag(tags.FRAME_WIDTH, width)
    w.put_tag(tags.FRAME_HEIGHT, height)
    w.put_tag_optional(tags.FRAME_NUMBER, frame_number)
    w.put_tag(tags.PRECISION, tags.PRECISION_10BIT)
    w.put_tag_optional(tags.FRAME_DISPLAY_HEIGHT, height)
    w.put_tag_optional(tags.VERSION, tags.FILE_VERSION_CODE)
    w.put_tag_optional(tags.QUALITY_L, quality & 0xFFFF)
    w.put_tag_optional(tags.QUALITY_H, (quality >> 16) & 0xFFFF)
    w.put_tag_optional(tags.PRESCALE_TABLE, pack_prescale_table(prescale))
    w.push_chunk(tags.SAMPLE_SIZE)
    meta = (metadata or EncoderMetadata()).block()
    w.put_tag_optional(tags.METADATA_CHUNK, len(meta) // 4)
    w.put_bytes(meta)
    w.put_tag_optional(tags.METADATA_CHUNK, 512 // 4)
    w.put_bytes(b"FREE" + (504).to_bytes(4, "little") + b"\0" * 504)
    w.put_tag_optional(tags.INTERLACED_FLAGS, 0)
    w.put_tag_optional(tags.PROTECTION_FLAGS, 0)
    w.put_tag_optional(tags.PICTURE_ASPECT_X, 16)
    w.put_tag_optional(tags.PICTURE_ASPECT_Y, 9)
    if progressive:
        # interlaced groups omit the tag; the decoder's default is
        # interlaced (`PutVideoGroupHeader` emits it only when progressive)
        w.put_tag(tags.SAMPLE_FLAGS, tags.SAMPLE_FLAGS_PROGRESSIVE)

    channel_sizes = []
    for ch in range(3):
        if ch > 0:
            w.pad_to_tag()
            w.put_tag(tags.SAMPLE, tags.SAMPLE_TYPE_CHANNEL)
            w.put_tag(tags.CHANNEL, ch)
        start = len(w.buf)
        lowpass, bands, bq = channels[ch]

        # lowpass band (subband 0)
        w.put_marker(tags.LOWPASS_START_CODE)
        w.put_tag(tags.LOWPASS_SUBBAND, 0)
        w.put_tag(tags.NUM_LEVELS, 4)
        w.put_tag(tags.LOWPASS_WIDTH, lowpass.shape[1])
        w.put_tag(tags.LOWPASS_HEIGHT, lowpass.shape[0])
        for t in (tags.MARGIN_LEFT, tags.MARGIN_TOP, tags.MARGIN_RIGHT,
                  tags.MARGIN_BOTTOM, tags.PIXEL_OFFSET):
            w.put_tag(t, 0)
        w.put_tag(tags.QUANTIZATION, 1)
        w.put_tag(tags.PIXEL_DEPTH, 16)
        w.push_chunk(tags.SUBBAND_SIZE)
        w.put_marker(tags.COEFFICIENT_START_CODE)
        w.put_bytes(lowpass.astype(">i2").tobytes())
        w.put_marker(tags.LOWPASS_END_CODE)
        w.pop_chunk()

        def band_header(band_number, subband, bw, bh, quant, scale,
                        encoding=tags.BAND_ENCODING_RUNLENGTHS,
                        coding_flags=1, peak_off=None):
            w.put_marker(tags.BAND_START_CODE)
            w.put_tag(tags.BAND_NUMBER, band_number)
            w.put_tag(tags.BAND_CODING_FLAGS, coding_flags)
            w.put_tag(tags.BAND_WIDTH, bw)
            w.put_tag(tags.BAND_HEIGHT, bh)
            w.put_tag(tags.BAND_SUBBAND, subband)
            w.put_tag(tags.BAND_ENCODING, encoding)
            w.put_tag(tags.BAND_QUANTIZATION, quant)
            w.put_tag(tags.BAND_SCALE, scale)
            if peak_off is not None:
                # the peaks table's three placeholder tags, patched after
                # the band
                peak_off.append(len(w.buf))
                w.put_tag_optional(tags.PEAK_TABLE_OFFSET_L, 0)
                w.put_tag_optional(tags.PEAK_TABLE_OFFSET_H, 0)
                w.put_tag_optional(tags.PEAK_LEVEL, 0)
            w.push_chunk(tags.SUBBAND_SIZE)
            w.put_tag(tags.BAND_HEADER, 0)

        def put_band(band_number, subband, vals, quant, scale, raw=False,
                     peaks=False):
            bh, bw = vals.shape
            peak_off, peak_list = [] if peaks else None, None
            if peaks:
                # peaks coding (`Codec/encoder.c:6445` EncodeQuantLongRuns
                # PlusPeaks): values beyond PEAK_THRESHOLD=250 are clamped
                # to +/-251 in the stream and carried dequantized in a
                # PEAK_TABLE chunk after the band
                vals = np.asarray(vals, np.int32)
                mask = np.abs(vals) > 250
                peak_list = (vals[mask] * quant).astype(np.int16)
                vals = np.where(mask, np.sign(vals) * 251, vals)
            band_header(band_number, subband, bw, bh, quant, scale,
                        tags.BAND_ENCODING_16BIT if raw
                        else tags.BAND_ENCODING_RUNLENGTHS,
                        18 if peaks else 1, peak_off)
            if raw:
                # the temporal-high LL (subband 7): raw big-endian
                # coefficients and the codeset's band-end marker
                w.put_bytes(np.asarray(vals, dtype=">i2").tobytes())
                w.put_bytes(BANDEND_MARKER)
            else:
                w.put_bytes(intra_host.encode_band_payload(
                    vals, 18 if peaks else 17))
            w.pad_to_tag()
            w.put_tag(tags.BAND_TRAILER, 0)
            w.pop_chunk()
            if peaks and len(peak_list):
                n = len(peak_list)
                rounded = n + (n & 1)
                delta = len(w.buf) - peak_off[0]
                w.patch_tag_value(peak_off[0], delta & 0xFFFF)
                w.patch_tag_value(peak_off[0] + 4, delta >> 16)
                w.patch_tag_value(peak_off[0] + 8, (250 * quant) & 0xFFFF)
                w.put_tag_optional(tags.PEAK_TABLE, rounded // 2)
                w.put_bytes(peak_list.astype("<i2").tobytes()
                            + b"\x00\x00" * (rounded - n))

        def wavelet_header(wtype, number, level, nbands, bw, bh, lscale):
            w.put_marker(tags.HIGHPASS_START_CODE)
            w.put_tag(tags.WAVELET_TYPE, wtype)
            w.put_tag(tags.WAVELET_NUMBER, number)
            w.put_tag(tags.WAVELET_LEVEL, level)
            w.put_tag(tags.NUM_BANDS, nbands)
            w.put_tag(tags.HIGHPASS_WIDTH, bw)
            w.put_tag(tags.HIGHPASS_HEIGHT, bh)
            w.put_tag(tags.LOWPASS_BORDER, 0)
            w.put_tag(tags.HIGHPASS_BORDER, 0)
            w.put_tag(tags.LOWPASS_SCALE, lscale)
            w.put_tag(tags.LOWPASS_DIVISOR, 0)
            w.push_chunk(tags.LEVEL_SIZE)

        def wavelet_trailer():
            w.put_marker(tags.HIGHPASS_END_CODE)
            w.pop_chunk()

        # w5 (number 6, level 4): subbands 1-3; w4 (number 5, level 3):
        # subbands 4-6
        for k, number, level, first in ((5, 6, 4, 1), (4, 5, 3, 4)):
            bh, bw = bands[k][0].shape
            wavelet_header(tags.WAVELET_TYPE_SPATIAL, number, level, 4, bw,
                           bh, scales[k][0])
            for i in range(3):
                put_band(i + 1, first + i, bands[k][i], bq[k][i],
                         scales[k][i + 1])
            wavelet_trailer()
        # w3 (number 4, level 3): subbands 7-10 (band 0 = the raw LL)
        bh, bw = bands[3][0].shape
        wavelet_header(tags.WAVELET_TYPE_SPATIAL, 4, 3, 4, bw, bh,
                       scales[3][0])
        for i in range(4):
            put_band(i, i + 7, bands[3][i], bq[3][i], scales[3][i],
                     raw=i == 0)
        wavelet_trailer()
        # w2 (number 3, level 2): temporal, one empty band entry (the
        # temporal bands are rebuilt from w3/w4 on decode; the reference
        # still emits a placeholder band with subband 255 and no payload)
        chan_w = width if ch == 0 else width // 2
        th, tw = height // 2, chan_w // 2
        wavelet_header(tags.WAVELET_TYPE_TEMPORAL, 3, 2, 2, tw, th,
                       scales[2][0])
        band_header(1, 255, tw, th, 1, scales[2][1])
        w.put_tag(tags.BAND_TRAILER, 0)
        w.pop_chunk()
        wavelet_trailer()
        # w1 (number 2, level 1): subbands 11-13 (frame 1); w0 (number 1,
        # level 1): subbands 14-16 (frame 0).  Interlaced frame wavelets
        # difference-code the HL band and code it with codeset 18 (band
        # coding flags 18) and peaks.
        for k, number, first in ((1, 2, 11), (0, 1, 14)):
            bh, bw = bands[k][0].shape
            wavelet_header(tags.WAVELET_TYPE_HORZTEMP, number, 1, 4, bw, bh,
                           scales[k][0])
            for i in range(3):
                put_band(i + 1, first + i, bands[k][i], bq[k][i],
                         scales[k][i + 1], peaks=not progressive and i == 1)
            wavelet_trailer()
        w.pad_to_tag()
        channel_sizes.append(len(w.buf) - start)

    w.put_tag(tags.SAMPLE, tags.SAMPLE_TYPE_GROUP_TRAILER)
    w.put_tag(tags.GROUP_TRAILER, 0)
    w.pop_chunk()
    w.patch_index(index_off, channel_sizes)
    return w.getvalue()


def sequence_header(width: int, height: int) -> bytes:
    """The tiny sequence-header sample emitted for the first GOP frame of
    a YUY2 stream (`PutVideoSequenceHeader`, observed layout from the
    reference)."""
    w = SampleWriter()
    w.put_tag(tags.SAMPLE, tags.SAMPLE_TYPE_SEQUENCE_HEADER)
    w.put_tag(tags.VERSION_MAJOR, 0)
    w.put_tag(tags.VERSION_MINOR, 1)
    w.put_tag(tags.VERSION_REVISION, 0)
    w.put_tag(tags.VERSION_EDIT, 0)
    w.put_tag(tags.SEQUENCE_FLAGS, 0)
    w.put_tag(tags.FRAME_WIDTH, width)
    w.put_tag(tags.FRAME_HEIGHT, height)
    w.put_tag(tags.FRAME_FORMAT, 2)
    w.put_tag_optional(tags.INPUT_FORMAT, tags.COLOR_FORMAT_YUYV)
    return w.getvalue()


def frame_header_sample(width: int, height: int,
                        frame_number: int) -> bytes:
    """The 24-byte SAMPLE_TYPE_FRAME sample the encoder emits for the
    first submission of every group after the first (the reference emits
    the sequence header only for the stream's first frame,
    `Codec/encoder.c:3226-3229`).  In decode order this sample asks the
    decoder for the TRUE second frame of the group it currently holds
    (`DecodeSampleFrame`, `Codec/decoder.c:11482` ->
    `ReconstructSampleFrameToBuffer(frame_index=1)`).  Byte-exact vs the
    reference's 6-frame GOP stream (tests/test_gop.py).

    frame_number is the display number of that second frame (1-based
    stream position minus one: the sample emitted at submission 2k
    carries 2k-1)."""
    w = SampleWriter()
    w.put_tag(tags.SAMPLE, tags.SAMPLE_TYPE_FRAME)
    w.put_tag(tags.FRAME_TYPE, 2)
    w.put_tag(tags.FRAME_WIDTH, width)
    w.put_tag(tags.FRAME_HEIGHT, height)
    w.put_tag_optional(tags.FRAME_NUMBER, frame_number)
    w.put_tag(tags.FRAME_INDEX, 1)
    return w.getvalue()

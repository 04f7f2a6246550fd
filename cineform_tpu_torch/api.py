"""Public CFHD-shaped API on a torch device: the port of `cineform_tpu.api`.

The surface mirrors the reference's `CFHD_*` entry points
(`Common/CFHDEncoder.h:254-428`, `Common/CFHDDecoder.h:201-309`) as the JAX
package's API does:

    CFHD_OpenEncoder / CFHD_PrepareToEncode / CFHD_EncodeSample /
    CFHD_GetSampleData / CFHD_CloseEncoder            -> Encoder
    CFHD_OpenDecoder / CFHD_GetOutputFormats /
    CFHD_PrepareToDecode / CFHD_DecodeSample / ...    -> Decoder
    CFHD_CreateEncoderPool / CFHD_EncodeAsyncSample /
    CFHD_WaitForSample / ...                          -> pool.EncoderPool

Every encode and decode runs on one torch device, the card unless the
caller passes `device="cpu"`, through the port's codecs: intra frames
through `models.intra.IntraCodec` (`encode_batch_device`,
`decode_batch_device`; the encoder's custom quantization, LYUV/CV67 input
transform and V210 passthrough's fallback frames as `IntraCodec` options),
two-frame GOP groups, progressive and interlaced, through
`models.gop.GopCodec` and stereo samples through `models.stereo`; the
V210 passthrough's raw samples are written on the host, as the JAX API
writes them.  There is no host codec to fall back to: an error of a
kernel's build or launch reaches the caller.  What the JAX API does on
the host and no port codec does yet (the Bayer develop's LOOK, vignette,
BLSH and gamma stages, the 3D composite) raises
`CFHDError(BADFORMAT, "... not ported yet")`.

Errors raise CFHDError carrying the CFHD_ERROR_* code instead of returning
status ints (`Common/CFHDError.h:25-82`).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from cineform_tpu_torch.bitstream import parse_sample
from cineform_tpu_torch.models import active_metadata as am
from cineform_tpu_torch.models import (gop_host, intra_host, lens, stereo,
                                       thumbnail)
from cineform_tpu_torch.models.gop import GopCodec
from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.models.intra_host import EncoderMetadata
from cineform_tpu_torch.ops import scaler
from cineform_tpu_torch.ref.demosaic import compose_develop_matrix
from cineform_tpu_torch.spec import tags
from cineform_tpu_torch.spec.production import (custom_quant_tables,
                                                update_fs_rate_limiter)
from cineform_tpu_torch.utils import override_db


def _fourcc(s: str) -> int:
    b = s.encode()
    return (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]


class ErrorCode(enum.IntEnum):
    """CFHD_Error values (`Common/CFHDError.h:25-82`)."""

    OKAY = 0
    INVALID_ARGUMENT = 1
    OUTOFMEMORY = 2
    BADFORMAT = 3
    BADSCALING = 4
    BADSAMPLE = 5
    INTERNAL = 6
    METADATA_CLASS = 7
    METADATA_UNDEFINED = 8
    METADATA_END = 9
    UNEXPECTED = 10
    BAD_RESOLUTION = 11
    BAD_PIXEL_SIZE = 12
    NOT_FINISHED = 13
    ENCODING_NOT_STARTED = 14
    METADATA_ATTACHED = 15
    BAD_METADATA = 16
    THREAD_CREATE_FAILED = 17
    THREAD_WAIT_FAILED = 18
    UNKNOWN_TAG = 19
    LICENSING = 20
    CODEC_ERROR = 2048


class CFHDError(Exception):
    def __init__(self, code: ErrorCode, message: str = "") -> None:
        super().__init__(f"{code.name}: {message}" if message else code.name)
        self.code = code


class PixelFormat(enum.IntEnum):
    """CFHD_PixelFormat FOURCCs (`Common/CFHDTypes.h:112-178`)."""

    YUY2 = _fourcc("YUY2")
    UYVY = _fourcc("2vuy")
    BGRA = _fourcc("BGRA")
    RG24 = _fourcc("RG24")
    RG48 = _fourcc("RG48")
    B64A = _fourcc("b64a")
    V210 = _fourcc("v210")
    YU64 = _fourcc("YU64")
    BYR4 = _fourcc("BYR4")
    BYR5 = _fourcc("BYR5")
    DPX0 = _fourcc("DPX0")
    R210 = _fourcc("r210")
    RG30 = _fourcc("RG30")
    AB10 = _fourcc("AB10")
    AR10 = _fourcc("AR10")
    RG64 = _fourcc("RG64")
    NV12 = _fourcc("NV12")
    # decoder-only output formats (`Common/CFHDTypes.h:63-70`)
    YUYV = _fourcc("yuyv")
    BGRa = _fourcc("BGRa")
    R408 = _fourcc("R408")
    V408 = _fourcc("V408")
    WP13 = _fourcc("WP13")
    W13A = _fourcc("W13A")
    BYR2 = _fourcc("BYR2")
    # Avid CT family (`Common/CFHDTypes.h:79-84`)
    CT_UCHAR = _fourcc("avu8")
    CT_10BIT_2_8 = _fourcc("av28")
    CT_SHORT_2_14 = _fourcc("a214")
    CT_USHORT_10_6 = _fourcc("a106")
    CT_SHORT = _fourcc("av16")


class EncodedFormat(enum.IntEnum):
    """CFHD_EncodedFormat (`Common/CFHDTypes.h:231-240`)."""

    YUV_422 = 0
    RGB_444 = 1
    RGBA_4444 = 2
    BAYER = 3


class EncodingQuality(enum.IntEnum):
    """CFHD_EncodingQuality (`Common/CFHDTypes.h:200-221`)."""

    FIXED = 0
    LOW = 1
    MEDIUM = 2
    HIGH = 3
    FILMSCAN1 = 4
    FILMSCAN2 = 5
    FILMSCAN3 = 6
    DEFAULT = 4


class DecodedResolution(enum.IntEnum):
    """CFHD_DecodedResolution (`Common/CFHDTypes.h:451-470`)."""

    FULL = 1
    HALF = 2
    QUARTER = 3
    THUMBNAIL = 4


class EncodingFlags(enum.IntFlag):
    NONE = 0
    YUV_INTERLACED = 1 << 0      # CFHD_ENCODING_FLAGS_YUV_INTERLACED
    YUV_2FRAME_GOP = 1 << 1      # CFHD_ENCODING_FLAGS_YUV_2FRAME_GOP (`Common/CFHDTypes.h:254`)


class DecodingFlags(enum.IntFlag):
    NONE = 0


@dataclass
class SampleInfo:
    """CFHD_GetSampleInfo results (`DecoderSDK/CFHDDecoder.cpp`)."""

    width: int
    height: int
    display_height: int
    key_frame: bool
    encoded_format: EncodedFormat
    quality: int
    frame_number: int


def _not_ported(what: str) -> CFHDError:
    """The error of a route the JAX API takes on the host and no codec of
    the port takes yet."""
    return CFHDError(ErrorCode.BADFORMAT, f"{what} is not ported yet")


def check_bgra_source(width: int, chroma_lowpass: int) -> None:
    """Refuse a BGRA decode of a `width`-wide 4:2:2 sample whose chroma
    lowpass width (its last channel's, from `parse_sample` or the header
    walk) is odd: the JAX package's device and host BGRA decoders differ
    there (ROADMAP.md Queue 3), so the reference's bytes are an open
    question.  `Decoder` and `pool.DecoderPool` both refuse through this
    check."""
    if chroma_lowpass % 2:
        raise CFHDError(
            ErrorCode.BADFORMAT,
            f"BGRA decode of a {width}-wide source, whose chroma "
            f"lowpass width {chroma_lowpass} is odd: the reference's BGRA "
            "output there is an open question")


def bayer_develop(sample: bytes, parsed, output: str):
    """The develop matrix of a Bayer sample decoded to `output` (RG48,
    b64a, WP13, W13A or YUY2), or None for the raw chain, by the gating of
    the JAX API's host decoder (`intra_host.decode_sample_bayer_to`): the
    PRCS-gated parameters (`active_metadata.develop_params`) and the
    matrix NeedCube composes from them (`compose_develop_matrix`).

    YUY2 takes the matrix where it is active and nothing else.  The 16-bit
    outputs take, in the JAX order, the LOOK cube; then the matrix, the
    vignette or the BLSH sharpening; then the gamma or contrast tweaks;
    else the raw chain.  Those stages but the matrix are not ported: a
    sample that turns one on raises rather than decode without it."""
    p = am.develop_params(sample, parsed=parsed)
    m = compose_develop_matrix(
        p.matrix, p.saturation, p.exposure,
        p.wb if tuple(p.wb) != (1.0, 1.0, 1.0) else None)
    matrix_active = bool(np.any(m[:, :3] != np.eye(3)) or np.any(m[:, 3]))
    if output != "YUY2" and p.enabled:
        look = bool(p.flags & am.PROCESSING_LOOK_FILE) and p.look_crc
        gamma = (tuple(p.rgb_gamma) != (1.0, 1.0, 1.0)
                 or p.contrast != 1.0)
        if look or p.vignette_start != 0.0 or p.blur_sharpen != 0.0 \
                or (gamma and not matrix_active):
            raise _not_ported("the Bayer develop's vignette, BLSH "
                              "sharpening, LOOK cube and gamma stages")
    return m if p.enabled and matrix_active else None


# ---------------------------------------------------------------------------
# The codecs, one per configuration and device
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def intra_codec(width: int, height: int, quality: int, fmt: str,
                device: torch.device, fs_rate_limiter: int | None = None,
                custom_quant: tuple | None = None,
                convert: tuple[int, int] | None = None,
                quality_tag: int | None = None) -> IntraCodec:
    return IntraCodec(width, height, quality, device=device,
                      input_format=fmt, fs_rate_limiter=fs_rate_limiter,
                      custom_quant=custom_quant, convert=convert,
                      quality_tag=quality_tag)


@functools.lru_cache(maxsize=16)
def gop_codec(width: int, height: int, quality: int, device: torch.device,
              progressive: bool = True) -> GopCodec:
    return GopCodec(width, height, quality, device=device,
                    progressive=progressive)


#: the decoders' codec quality: a decode reads every quantizer from the
#: sample's band headers
DECODE_QUALITY = 4


# ---------------------------------------------------------------------------
# Encoder (CFHD_OpenEncoder .. CFHD_CloseEncoder)
# ---------------------------------------------------------------------------

class Encoder:
    """Synchronous sample encoder (`EncoderSDK/SampleEncoder.cpp:115-620`)
    on `device`."""

    INPUT_FORMATS = (PixelFormat.YUY2, PixelFormat.UYVY, PixelFormat.V210,
                     PixelFormat.YU64, PixelFormat.RG48, PixelFormat.B64A,
                     PixelFormat.R210, PixelFormat.DPX0, PixelFormat.RG30,
                     PixelFormat.AB10, PixelFormat.AR10, PixelFormat.BGRA,
                     PixelFormat.RG24, PixelFormat.RG64, PixelFormat.BYR4,
                     PixelFormat.BYR5, PixelFormat.CT_UCHAR,
                     PixelFormat.CT_10BIT_2_8, PixelFormat.CT_SHORT_2_14,
                     PixelFormat.CT_USHORT_10_6, PixelFormat.CT_SHORT,
                     PixelFormat.BGRa)
    #: the input formats, each as `IntraCodec` names it
    CODEC_FORMATS = {pf: pf.name for pf in INPUT_FORMATS}
    #: the input formats of each encoded format but 4:2:2, which takes any
    _FAMILIES = {EncodedFormat.RGB_444: (PixelFormat.RG48, PixelFormat.R210,
                                         PixelFormat.DPX0, PixelFormat.RG30,
                                         PixelFormat.AB10, PixelFormat.AR10,
                                         PixelFormat.BGRA, PixelFormat.RG24),
                 EncodedFormat.RGBA_4444: (PixelFormat.B64A,
                                           PixelFormat.RG64),
                 EncodedFormat.BAYER: (PixelFormat.BYR4, PixelFormat.BYR5)}
    #: the formats the FILMSCAN2/3 rate control applies to (the JAX API's
    #: 4:2:2 routes; its RGB and Bayer encoders keep the first frame's)
    _RATE_CONTROLLED = (PixelFormat.YUY2, PixelFormat.UYVY, PixelFormat.V210,
                        PixelFormat.YU64, PixelFormat.CT_UCHAR,
                        PixelFormat.CT_10BIT_2_8, PixelFormat.CT_SHORT_2_14,
                        PixelFormat.CT_USHORT_10_6, PixelFormat.CT_SHORT)

    def __init__(self, device: torch.device | str = "cuda") -> None:
        self.device = torch.device(device)
        self._prepared = False
        self._sample: bytes | None = None
        self._frame_number = 0
        self._fs_limiter = None
        self._custom_quant = None
        self._metadata = None

    # CFHD_GetInputFormats
    def get_input_formats(self) -> tuple[PixelFormat, ...]:
        return self.INPUT_FORMATS

    # CFHD_PrepareToEncode
    def prepare_to_encode(self, width: int, height: int,
                          pixel_format: PixelFormat,
                          encoded_format: EncodedFormat = EncodedFormat.YUV_422,
                          encoding_flags: EncodingFlags = EncodingFlags.NONE,
                          quality: EncodingQuality = EncodingQuality.FILMSCAN1,
                          ) -> None:
        if pixel_format not in self.INPUT_FORMATS:
            raise CFHDError(ErrorCode.BADFORMAT, f"{pixel_format!r}")
        # RGB/RGBA/Bayer inputs imply their natural encoded format (the
        # reference maps them the same way in CFHD_PrepareToEncode)
        if encoded_format != EncodedFormat.YUV_422 and \
                pixel_format not in self._FAMILIES.get(encoded_format, ()):
            raise CFHDError(ErrorCode.BADFORMAT, f"{encoded_format!r}")
        if width % 16 or height % 8 or width < 32 or height < 48:
            # dims must survive 3 halvings with filter-legal extents
            raise CFHDError(ErrorCode.INVALID_ARGUMENT,
                            f"unsupported dimensions {width}x{height}")
        if (encoding_flags & EncodingFlags.YUV_2FRAME_GOP) and \
                pixel_format != PixelFormat.YUY2:
            raise CFHDError(ErrorCode.BADFORMAT,
                            "2-frame GOP supports YUY2 input")
        if (encoding_flags & EncodingFlags.YUV_INTERLACED) and not \
                (encoding_flags & EncodingFlags.YUV_2FRAME_GOP):
            raise CFHDError(ErrorCode.BADFORMAT,
                            "interlaced encoding requires the 2-frame GOP")
        self.width = width
        self.height = height
        self.pixel_format = pixel_format
        self.encoded_format = encoded_format
        self.encoding_flags = encoding_flags
        self.quality = EncodingQuality(int(quality) & 0xFF)
        #: full quality word incl. the *_UNCOMPRESSED target bits 8-12
        #: (`Common/CFHDTypes.h:210-216`, `Codec/encoder.c:1979`)
        self.quality_word = int(quality)
        #: the input format's layout (its row bytes and header code)
        self._codec_format = IntraCodec(width, height, 4, device="cpu",
                                        input_format=self.CODEC_FORMATS[
                                            pixel_format])
        self.row_bytes = self._codec_format.row_bytes
        self._unc_last16 = [0] * 16
        #: True once a compressed frame has initialized the codec state
        #: (prescale table); uncompressed samples switch header form then
        self._compressed_encoded = False
        self._pending_gop_frame = None
        self._prepared = True

    # CFHD_MetadataAttach
    def attach_metadata(self, metadata) -> None:
        self._metadata = metadata

    def _encoder_overrides(self) -> dict:
        """Collect encoder setting overrides in the reference's priority
        order: attached metadata, then defaults.colr, then override.colr
        (`Codec/encoder.c:2070-2078`, `encoder.c:8792`)."""
        local = b""
        if self._metadata is not None and hasattr(self._metadata, "block"):
            try:
                local = self._metadata.block()
            except Exception:
                local = b""
        base, force = override_db.load_disk_blocks()
        ov = override_db.parse_overrides(local)
        if not ov.get("ignore_database"):
            ov.update(override_db.parse_overrides(base, force))
        return ov

    def set_custom_quantization(self, quant_y, quant_c=None) -> None:
        """Custom per-subband quantization (the low-level codec API's
        custom_quant struct, `Codec/encoder.c:1143`): 17-entry luma and
        chroma tables in place of the quality presets, with the
        reference's precision scaling and gop-length remap on top
        (`spec.production.custom_quant_tables`).  As in the JAX API, they
        apply to the plain YUY2 intra route only: the other formats, the
        LYUV/CV67 route and the 2-frame GOP ignore them."""
        self._custom_quant = tuple(map(tuple, custom_quant_tables(
            list(quant_y), list(quant_c if quant_c is not None else quant_y),
            tags.PRECISION_10BIT, gop_length=1)))

    # CFHD_EncodeSample
    def encode_sample(self, frame: bytes | np.ndarray,
                      pitch: int | None = None) -> None:
        if not self._prepared:
            raise CFHDError(ErrorCode.ENCODING_NOT_STARTED)
        row_bytes = self.row_bytes
        buf = (np.frombuffer(frame, dtype=np.uint8)
               if isinstance(frame, (bytes, bytearray)) else frame.view(np.uint8))
        if pitch is not None and pitch != row_bytes:
            buf = buf.reshape(-1, pitch)[:self.height, :row_bytes]
        buf = np.ascontiguousarray(buf).reshape(-1)
        if buf.size != self.height * row_bytes:
            raise CFHDError(ErrorCode.INVALID_ARGUMENT, "bad frame size")
        frames = buf.reshape(1, self.height, row_bytes)
        self._frame_number += 1
        # FILMSCAN2/3 rate control (`QuantizationSetQuality`,
        # quantize.c:236-310): the limiter advances each frame from the
        # previous sample's achieved compression
        if (int(self.quality) & 0xFF) >= 5 and not (self.quality_word & 0x1F00):
            if self._fs_limiter is None:
                self._fs_limiter = {5: 8, 6: 4}.get(int(self.quality) & 0xFF, 0)
            if self._sample is not None:
                self._fs_limiter = update_fs_rate_limiter(
                    self._fs_limiter, self.quality_word, len(self._sample),
                    self.width, self.height)
        if self.encoding_flags & EncodingFlags.YUV_2FRAME_GOP:
            self._sample = self._encode_gop(frames)
            self._compressed_encoded = True
            return
        quality, options = int(self.quality), {}
        if self.pixel_format == PixelFormat.YUY2:
            ov = self._encoder_overrides()
            if ov.get("limit_yuv") or ov.get("conv_601_709"):
                # LYUV/CV67 transform the input pixels during unpack
                # (`Codec/convert.c:5176-5290`); no custom quantization
                options["convert"] = (ov.get("limit_yuv", 0),
                                      ov.get("conv_601_709", 0))
            else:
                options["custom_quant"] = self._custom_quant
        elif self.pixel_format == PixelFormat.V210 and \
                (self.quality_word >> 8) & 0x1F:
            # uncompressed passthrough (`Codec/encoder.c:1971-2026`): the
            # frame rolls the per-frame decision; a frame not chosen is
            # quantized with the q5 tables and labelled quality 6
            if self._encode_uncompressed(buf):
                return
            quality, options["quality_tag"] = 5, 6
        limiter = (self._fs_limiter
                   if self.pixel_format in self._RATE_CONTROLLED else None)
        codec = intra_codec(self.width, self.height, quality,
                            self.CODEC_FORMATS[self.pixel_format],
                            self.device, limiter, **options)
        # per-frame metadata: the codec advances UFRM and the timecode to
        # the frame number, as the reference does on every EncodeSample
        # (`SampleEncoder.cpp:795-880`)
        self._sample = codec.encode_batch_device(
            frames, frame_numbers=[self._frame_number],
            metadata=[self._metadata])[0]
        # the codec state (prescale table) is initialized by the first
        # compressed frame
        self._compressed_encoded = True

    def _encode_uncompressed(self, buf: np.ndarray) -> bool:
        """Roll the uncompressed passthrough's decision for the frame
        `buf` (`intra_host.uncompressed_decision`, seeded from the frame's
        first word and the CRC32 of the frame's metadata block, as the
        codec advances it); where it is chosen, write its raw rows as the
        sample and return True."""
        _, (meta,) = self._codec_format._frame_meta(
            1, None, [self._frame_number], [self._metadata])
        head = int.from_bytes(buf[:4].tobytes(), "little")
        if not intra_host.uncompressed_decision(
                head, meta.block(), self.quality_word, self._unc_last16):
            return False
        self._sample = intra_host.write_sample_uncompressed(
            buf.tobytes(), self.width, self.height, self.quality_word,
            self._frame_number, meta,
            input_format=self._codec_format.input_format_code,
            later_form=self._compressed_encoded)
        return True

    def _encode_gop(self, frames: np.ndarray) -> bytes:
        """The 2-frame GOP streaming protocol (byte-exact against the
        reference's CFHD_EncodeSample over a 6-frame series): the stream's
        very first submission returns the tiny sequence-header sample
        (`EncodeFirstSample`, encoder.c:3226-3229); the first submission
        of every LATER pair returns a 24-byte SAMPLE_TYPE_FRAME sample
        that, on decode, emits the held group's true second frame; the
        second submission of each pair returns the GROUP sample."""
        if self._pending_gop_frame is None:
            self._pending_gop_frame = frames.copy()
            if self._frame_number == 1:
                return gop_host.sequence_header(self.width, self.height)
            return gop_host.frame_header_sample(self.width, self.height,
                                                self._frame_number - 2)
        first, self._pending_gop_frame = self._pending_gop_frame, None
        # the group's FRAME_NUMBER is the display number of its first
        # frame (1, 3, 5, ... across the stream)
        codec = gop_codec(self.width, self.height, int(self.quality),
                          self.device, not (self.encoding_flags
                                            & EncodingFlags.YUV_INTERLACED))
        return codec.encode_batch(first, frames, self._frame_number - 1,
                                  self._metadata)[0]

    # CFHD_GetSampleData
    def get_sample_data(self) -> bytes:
        if self._sample is None:
            raise CFHDError(ErrorCode.NOT_FINISHED)
        return self._sample

    # CFHD_GetEncodeThumbnail
    def get_encode_thumbnail(self, sample: bytes):
        return thumbnail.extract(sample)

    # CFHD_CloseEncoder
    def close(self) -> None:
        self._prepared = False
        self._sample = None


# ---------------------------------------------------------------------------
# Decoder (CFHD_OpenDecoder .. CFHD_CloseDecoder)
# ---------------------------------------------------------------------------

def _to_uyvy(out: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(out.reshape(-1, 4)[:, [1, 0, 3, 2]])


class Decoder:
    """Sample decoder (`DecoderSDK/SampleDecoder.cpp:387-1936`) on
    `device`.  `fallback_frames` counts the frames the device decoders
    left to their host-entropy route (`decode_batch`): a band with peaks,
    an unaligned payload or a device overflow."""

    OUTPUT_FORMATS = (PixelFormat.YUY2, PixelFormat.UYVY, PixelFormat.YU64,
                      PixelFormat.V210, PixelFormat.RG48, PixelFormat.BGRA,
                      PixelFormat.B64A, PixelFormat.NV12, PixelFormat.R210,
                      PixelFormat.DPX0, PixelFormat.RG30,
                      PixelFormat.BYR4, PixelFormat.BYR2, PixelFormat.YUYV,
                      PixelFormat.BGRa, PixelFormat.RG24, PixelFormat.R408,
                      PixelFormat.V408, PixelFormat.WP13, PixelFormat.W13A,
                      PixelFormat.CT_SHORT, PixelFormat.CT_USHORT_10_6,
                      PixelFormat.CT_SHORT_2_14, PixelFormat.CT_10BIT_2_8,
                      PixelFormat.CT_UCHAR)

    #: per source kind, the outputs the port decodes to, by the codec's
    #: names (`Codec/decoder.c:11584` format dispatch)
    _PORTED = {"YUV": {PixelFormat.YUY2: "YUY2", PixelFormat.UYVY: "YUY2",
                       PixelFormat.BGRA: "BGRA", PixelFormat.YU64: "YU64",
                       PixelFormat.V210: "v210", PixelFormat.RG48: "RG48",
                       PixelFormat.B64A: "b64a", PixelFormat.NV12: "NV12",
                       PixelFormat.R210: "r210", PixelFormat.DPX0: "DPX0",
                       PixelFormat.RG30: "RG30", PixelFormat.YUYV: "yuyv",
                       PixelFormat.BGRa: "BGRa", PixelFormat.RG24: "RG24",
                       PixelFormat.R408: "R408", PixelFormat.V408: "V408",
                       PixelFormat.WP13: "WP13", PixelFormat.W13A: "W13A",
                       PixelFormat.CT_SHORT: "av16",
                       PixelFormat.CT_USHORT_10_6: "a106",
                       PixelFormat.CT_SHORT_2_14: "a214",
                       PixelFormat.CT_10BIT_2_8: "av28"},
               "RGB": {PixelFormat.RG48: "RG48", PixelFormat.B64A: "b64a",
                       PixelFormat.WP13: "WP13", PixelFormat.W13A: "W13A",
                       PixelFormat.BGRA: "BGRA", PixelFormat.BGRa: "BGRa",
                       PixelFormat.RG24: "RG24"},
               "BAYER": {PixelFormat.BYR4: "BYR4", PixelFormat.BYR2: "BYR2",
                         PixelFormat.RG48: "RG48", PixelFormat.B64A: "b64a",
                         PixelFormat.WP13: "WP13", PixelFormat.W13A: "W13A",
                         PixelFormat.YUY2: "YUY2", PixelFormat.UYVY: "YUY2"},
               "GOP": {PixelFormat.YUY2: "YUY2", PixelFormat.UYVY: "YUY2",
                       PixelFormat.YU64: "YU64", PixelFormat.V210: "v210",
                       PixelFormat.RG48: "RG48", PixelFormat.BGRA: "BGRA",
                       PixelFormat.B64A: "b64a", PixelFormat.R210: "r210",
                       PixelFormat.DPX0: "DPX0", PixelFormat.RG30: "RG30"}}
    #: the outputs of a decode to another size than the sample's, which
    #: Lanczos-scales the YU64 decode (`ops.scaler.scale_yu64_to`)
    _SIZED = {PixelFormat.YUY2: "YUY2", PixelFormat.UYVY: "2vuy",
              PixelFormat.YU64: "YU64", PixelFormat.V210: "v210",
              PixelFormat.RG48: "RG48", PixelFormat.BGRA: "BGRA",
              PixelFormat.B64A: "b64a", PixelFormat.R210: "r210",
              PixelFormat.DPX0: "DPX0", PixelFormat.RG30: "RG30"}
    #: output row pitch in bytes as a function of width
    _ROW_BYTES = {PixelFormat.YUY2: lambda w: 2 * w,
                  PixelFormat.UYVY: lambda w: 2 * w,
                  PixelFormat.YU64: lambda w: 4 * w,
                  PixelFormat.V210: lambda w: ((w + 47) // 48) * 128,
                  PixelFormat.RG48: lambda w: 6 * w,
                  PixelFormat.BGRA: lambda w: 4 * w,
                  PixelFormat.B64A: lambda w: 8 * w,
                  PixelFormat.NV12: lambda w: 3 * w // 2,
                  PixelFormat.R210: lambda w: 4 * w,
                  PixelFormat.DPX0: lambda w: 4 * w,
                  PixelFormat.RG30: lambda w: 4 * w,
                  PixelFormat.BYR4: lambda w: 2 * w,
                  PixelFormat.BYR2: lambda w: 2 * w,
                  PixelFormat.YUYV: lambda w: 2 * w,
                  PixelFormat.BGRa: lambda w: 4 * w,
                  PixelFormat.RG24: lambda w: 3 * w,
                  PixelFormat.R408: lambda w: 4 * w,
                  PixelFormat.V408: lambda w: 4 * w,
                  PixelFormat.WP13: lambda w: 6 * w,
                  PixelFormat.W13A: lambda w: 8 * w,
                  PixelFormat.CT_SHORT: lambda w: 4 * w,
                  PixelFormat.CT_USHORT_10_6: lambda w: 4 * w,
                  PixelFormat.CT_SHORT_2_14: lambda w: 4 * w,
                  PixelFormat.CT_10BIT_2_8: lambda w: 5 * w // 2}
    #: the outputs of a reduced-resolution decode, which is YUY2 (the
    #: JAX API hands its YUY2 bytes to UYVY too: ROADMAP Queue 3)
    _SCALED = (PixelFormat.YUY2, PixelFormat.YUYV, PixelFormat.UYVY)
    #: the outputs the reference warps when a sample's lens metadata asks
    #: (`Codec/decoder.c:9230-9242`), by `models.lens`' names
    _WARPED = {PixelFormat.YUY2: "YUY2", PixelFormat.BGRA: "BGRA",
               PixelFormat.W13A: "W13A", PixelFormat.WP13: "WP13",
               PixelFormat.RG48: "RG48", PixelFormat.B64A: "b64a"}

    def __init__(self, device: torch.device | str = "cuda") -> None:
        self.device = torch.device(device)
        self._prepared = False
        self._channels_active = 1
        self._held_group = None
        self._warp_mesh_cache: dict = {}
        self.fallback_frames = 0

    # CFHD_GetOutputFormats
    def get_output_formats(self, sample: bytes | None = None) -> tuple[PixelFormat, ...]:
        return self.OUTPUT_FORMATS

    # CFHD_GetSampleInfo / CFHD_ParseSampleHeader
    def get_sample_info(self, sample: bytes) -> SampleInfo:
        try:
            s = parse_sample(sample)
            encoded_format = EncodedFormat(max(0, s.encoded_format - 1))
        except Exception as exc:
            raise CFHDError(ErrorCode.BADSAMPLE, str(exc)) from exc
        # the reference doubles the reported dimensions for Bayer sources
        # (`ParseSampleHeader`, Codec/decoder.c:2619-2623)
        mult = 2 if s.encoded_format == 2 else 1
        return SampleInfo(
            width=s.width * mult, height=s.height * mult,
            display_height=(s.display_height or s.height) * mult,
            key_frame=(s.sample_type == tags.SAMPLE_TYPE_IFRAME),
            encoded_format=encoded_format,
            quality=s.quality, frame_number=s.frame_number)

    # CFHD_PrepareToDecode
    def prepare_to_decode(self, width: int, height: int,
                          output_format: PixelFormat = PixelFormat.YUY2,
                          resolution: DecodedResolution = DecodedResolution.FULL,
                          decoding_flags: DecodingFlags = DecodingFlags.NONE,
                          sample: bytes | None = None,
                          ) -> tuple[int, int, PixelFormat]:
        if output_format not in self.OUTPUT_FORMATS:
            raise CFHDError(ErrorCode.BADFORMAT, f"{output_format!r}")
        if sample is not None and (width == 0 or height == 0):
            # 0x0 = decode at the native coded size
            # (`DecoderSDK/SampleDecoder.cpp:1593-1597`)
            info = self.get_sample_info(sample)
            width, height = info.width, info.height
        if resolution == DecodedResolution.HALF:
            width, height = width // 2, height // 2
        elif resolution == DecodedResolution.QUARTER:
            width, height = width // 4, height // 4
        elif resolution == DecodedResolution.THUMBNAIL:
            width, height = width // 8, height // 8
        self.width = width
        self.height = height
        self.output_format = output_format
        self.resolution = resolution
        self._prepared = True
        return width, height, output_format

    # CFHD_SetActiveMetadata(TAG_CHANNELS_ACTIVE) analog
    def set_channels_active(self, mask: int) -> None:
        """Select the video channel(s) of stereo 3D samples: 1 = left,
        2 = right (`Codec/decoder.c:10310-10340` channel_mask); 3, both
        eyes composited, is not ported yet and raises at decode."""
        if int(mask) not in (1, 2, 3):
            raise CFHDError(
                ErrorCode.INVALID_ARGUMENT,
                f"channel mask {mask}: supported masks are 1 (left), "
                "2 (right), 3 (both eyes composited)")
        self._channels_active = int(mask)

    # CFHD_SetActiveMetadata(TAG_BLEND_TYPE) analog
    def set_channel_blend(self, mode: int) -> None:
        """The 3D display compositing of mask-3 decodes (`Do3DWork`,
        `Codec/bayer.c:10761`)."""
        raise _not_ported("the 3D composite's blend modes")

    # --- per-sample-kind decode handlers -------------------------------------

    def _output(self, kind: str) -> str:
        """The codec's name of the prepared output for a `kind` source."""
        out = self._PORTED[kind].get(self.output_format)
        if out is not None:
            return out
        raise CFHDError(ErrorCode.BADFORMAT,
                        f"{kind} decode to {self.output_format!r}")

    def _yuy2_or_uyvy(self, out: np.ndarray) -> np.ndarray:
        return _to_uyvy(out) if self.output_format == PixelFormat.UYVY \
            else out

    def _route_stereo(self, sample: bytes):
        """(the sample to decode, its parse or None): for dual-channel
        samples the active eye's bitstream (`Codec/decoder.c:10086-10104`
        stereo channel logic).  Parse errors fall through to the main
        dispatch (which reports them)."""
        try:
            info = parse_sample(sample)
            if info.encoded_channels < 2:
                return sample, info
            eyes = stereo.split_3d(sample)
        except Exception:
            return sample, None
        if self._channels_active == 3 and len(eyes) > 1:
            raise _not_ported("the 3D composite of both eyes (channel "
                              "mask 3)")
        eye = eyes[1] if self._channels_active == 2 and len(eyes) > 1 \
            else eyes[0]
        return eye, None

    def _gop_frames(self, sample: bytes, reference_compatible: bool,
                    dither_base: int):
        info = parse_sample(sample)
        codec = gop_codec(info.width, info.height, DECODE_QUALITY,
                          self.device)
        f0, f1, fallback = codec.decode_batch_device(
            [sample], reference_compatible, dither_base)
        self.fallback_frames += len(fallback)
        return f0[0], f1[0]

    def _gop_output(self, sample: bytes, info, what: str, frame: int,
                    then=None) -> np.ndarray:
        """Frame `frame` of a group to a deep or RGB output (YU64, v210,
        RG48, BGRA, b64a, r210, DPX0, RG30: `GopCodec.inverse_to`), `then`
        on the device before the download."""
        out = self._PORTED["GOP"].get(self.output_format)
        if out is None:
            raise CFHDError(ErrorCode.BADFORMAT,
                            f"{what} decode to {self.output_format!r}")
        codec = gop_codec(info.width, info.height, DECODE_QUALITY,
                          self.device)
        frames, fallback = codec.decode_batch_device_to([sample], out, frame,
                                                        then)
        self.fallback_frames += len(fallback)
        return frames[0]

    def _decode_frame_sample(self, then=None) -> np.ndarray:
        """24-byte SAMPLE_TYPE_FRAME sample: emit the TRUE second frame of
        the group this decoder holds (`DecodeSampleFrame` ->
        ReconstructSampleFrameToBuffer(frame_index=1),
        decoder.c:11482/11546), with the second dither window, or scaled
        to the prepared size.  `then`: the warp of the deep and RGB
        outputs, on the device."""
        held = self._held_group
        if held is None:
            raise CFHDError(ErrorCode.BADSAMPLE,
                            "FRAME sample without a decoded group")
        info = parse_sample(held)
        if (self.width, self.height) != (info.width, info.height):
            return self._decode_to_size(held, info, frame=1, then=then)
        if self.output_format not in (PixelFormat.YUY2, PixelFormat.UYVY):
            return self._gop_output(held, info, "FRAME sample", 1, then)
        # the rand() dither stream persists across samples in one
        # decoder instance: this frame takes the NEXT window after
        # everything already emitted
        base = getattr(self, "_gop_dither_count", 1) - 1
        self._gop_dither_count = base + 2
        _, out = self._gop_frames(held, False, base)
        return self._yuy2_or_uyvy(out)

    def _decode_group(self, sample: bytes, info0, then=None) -> np.ndarray:
        """GROUP (2-frame GOP) sample: decode frame 1 and hold the group
        for a following SAMPLE_TYPE_FRAME sample; consecutive calls on the
        same group return frame 1 then frame 1 with the next dither
        window, like the reference decoder.  At another size than the
        group's, consecutive calls on the same group alternate its frames
        0 and 1, each scaled; the deep and RGB outputs are frame 0's, and
        `then` their warp on the device."""
        self._held_group = sample
        if self.resolution != DecodedResolution.FULL:
            raise CFHDError(ErrorCode.BADFORMAT,
                            "scaled GOP decode is not supported")
        if (self.width, self.height) != (info0.width, info0.height):
            key = hashlib.sha256(sample).digest()
            cache = getattr(self, "_gop_scale_cache", None)
            idx = cache[1] if cache is not None and cache[0] == key else 0
            self._gop_scale_cache = (key, 1 - idx)
            return self._decode_to_size(sample, info0, frame=idx, then=then)
        if self.output_format not in (PixelFormat.YUY2, PixelFormat.UYVY):
            return self._gop_output(sample, info0, "GOP", 0, then)
        base = getattr(self, "_gop_dither_count", 0)
        self._gop_dither_count = base + 1
        out, _ = self._gop_frames(sample, True, base)
        return self._yuy2_or_uyvy(out)

    def _decode_intra(self, sample: bytes, info0, kind: str, fmt: str,
                      scale: int = 1, develop=None,
                      output: str | None = None, then=None) -> np.ndarray:
        """An intra sample of a `kind` source through the device decoder of
        an `fmt` codec (`scale` 2: a Bayer sample's mosaic, `develop` its
        develop matrix or None) to the prepared output, at the prepared
        resolution; `output` names it where the caller has checked it,
        `then` runs on the decoded frame on the device."""
        codec = intra_codec(info0.width * scale, info0.height * scale,
                            DECODE_QUALITY, fmt, self.device)
        out, fallback = codec.decode_batch_device(
            [sample], output=output or self._output(kind),
            develop=None if develop is None else develop[None],
            resolution=int(self.resolution), then=then)
        self.fallback_frames += len(fallback)
        return out[0]

    def _decode_yuv_source(self, sample: bytes, info0,
                           then=None) -> np.ndarray:
        """YUV 4:2:2 intra sample at its coded size."""
        if self._output("YUV") in ("BGRA", "BGRa"):
            check_bgra_source(info0.width, info0.channels[-1].lowpass_width)
        return self._yuy2_or_uyvy(self._decode_intra(
            sample, info0, "YUV", "YUY2", then=then))

    def _decode_to_size(self, sample: bytes, info, frame: int = 0,
                        then=None) -> np.ndarray:
        """A 4:2:2 intra sample, or frame `frame` of a group, decoded to YU64
        on the device and Lanczos-scaled there to the prepared size
        (`ops.scaler.scale_yu64_to`: the reference's 8.8 fixed-point
        CLanczosScaler, ConvertLib/ImageScaler.cpp, which the JAX API
        applies to its byte-exact YU64 reconstruction), then `then`."""
        fourcc = self._SIZED.get(self.output_format)
        if fourcc is None:
            raise CFHDError(ErrorCode.BADFORMAT,
                            f"scaled decode to {self.output_format!r}")

        def scale(yu64: torch.Tensor) -> torch.Tensor:
            out = scaler.scale_yu64_to(
                yu64.to(torch.int32) & 0xFFFF, info.width, info.height,
                self.width, self.height, fourcc)
            return out if then is None else then(out)

        if info.sample_type == tags.SAMPLE_TYPE_GROUP:
            codec = gop_codec(info.width, info.height, DECODE_QUALITY,
                              self.device)
            out, fallback = codec.decode_batch_device_to(
                [sample], "YU64", frame, scale)
        else:
            codec = intra_codec(info.width, info.height, DECODE_QUALITY,
                                "YUY2", self.device)
            out, fallback = codec.decode_batch_device([sample],
                                                      output="YU64",
                                                      then=scale)
        self.fallback_frames += len(fallback)
        return out[0]

    def _decode_scaled(self, sample: bytes, info0) -> np.ndarray:
        """A 4:2:2 intra sample at half, quarter or thumbnail resolution:
        YUY2 (UYVY its pair swap) from the bands of the levels it reads
        (`intra_host.decode_sample_scaled`).  The JAX API's scaled decode
        packs YUY2 for every source, so an RGB or Bayer sample, or another
        output, fails its size check there: the same BADSAMPLE here."""
        if info0.encoded_format in (2, 3, 4):
            raise CFHDError(ErrorCode.BADSAMPLE,
                            "a reduced-resolution decode takes a 4:2:2 "
                            "sample")
        if self.output_format not in self._SCALED:
            raise CFHDError(ErrorCode.BADSAMPLE,
                            f"a reduced-resolution decode outputs YUY2, "
                            f"not {self.output_format!r}")
        return self._yuy2_or_uyvy(self._decode_intra(
            sample, info0, "YUV", "YUY2", output="YUY2"))

    def _decode_bayer_source(self, sample: bytes, info0,
                             then=None) -> np.ndarray:
        """Bayer (RAW) intra sample at its mosaic's size: BYR4 and BYR2
        undifferenced, the other outputs demosaiced through the develop
        matrix its metadata asks for (`bayer_develop`)."""
        out = self._output("BAYER")
        develop = None if out in ("BYR4", "BYR2") else \
            bayer_develop(sample, info0, out)
        return self._yuy2_or_uyvy(self._decode_intra(
            sample, info0, "BAYER", "BYR4", 2, develop, then=then))

    def _lens(self, sample: bytes, parsed=None):
        """(the lens parameters, the warp's format name) where the sample's
        lens metadata asks the reference to warp the prepared output
        (`WarpFrame`, `Codec/decoder.c:11140`), else None."""
        fourcc = self._WARPED.get(self.output_format)
        if fourcc is None:
            return None
        params = lens.parse_lens_metadata(sample, parsed)
        return None if params is None else (params, fourcc)

    def _warp(self, params, fourcc: str):
        """The warp of the decoded frames on the device (`then` of the
        decodes): the frames as bytes through `lens.warp_output`."""
        def then(out: torch.Tensor) -> torch.Tensor:
            return lens.warp_output(
                params, out.contiguous().view(torch.uint8).reshape(
                    out.shape[0], -1), self.width, self.height, fourcc,
                self._warp_mesh_cache)
        return then

    def _warp_decode(self, sample: bytes, info0, params,
                     fourcc: str) -> np.ndarray:
        """The YUY2 and WP13 outputs' warp (`lens.warp_decode`): the
        sample's WP13 decode warped on the device, converted to YUY2 where
        asked."""
        def then(wp13: torch.Tensor) -> torch.Tensor:
            return lens.warp_decode(params, wp13.contiguous().view(
                torch.uint8), self.width, self.height, fourcc,
                self._warp_mesh_cache)
        return self._decode_intra(sample, info0, "YUV", "YUY2",
                                  output="WP13", then=then)

    def _takes_warp_decode(self, info0) -> bool:
        """Whether the WP13 detour of `lens.warp_decode` takes the sample:
        a 4:2:2 intra sample decoded whole at its coded size.  On any other
        (a group, an RGB or Bayer source, another size or resolution) the
        JAX package's detour fails in its intra WP13 decode or its reshape
        to the prepared size: BADSAMPLE."""
        return (info0.sample_type == tags.SAMPLE_TYPE_IFRAME
                and info0.encoded_format not in (2, 3, 4)
                and self.resolution == DecodedResolution.FULL
                and (self.width, self.height) == (info0.width, info0.height))

    # CFHD_DecodeSample
    def decode_sample(self, sample: bytes) -> np.ndarray | None:
        if not self._prepared:
            raise CFHDError(ErrorCode.UNEXPECTED, "not prepared")
        if len(sample) % 4:
            # the tag/value stream is a sequence of 32-bit pairs; a
            # partial trailing pair is a bitstream error
            raise CFHDError(ErrorCode.BADSAMPLE,
                            f"sample size {len(sample)} not 32-bit aligned")
        sample, info0 = self._route_stereo(sample)
        try:
            if sample[:4] == b"\x00\x01\x00\x07":
                # video sequence header: ignored by the decoder, no frame
                # (`DecodeSample` SAMPLE_TYPE_SEQUENCE_HEADER,
                # decoder.c:11023-11026)
                return None
            if sample[:4] == b"\x00\x01\x00\x01":
                # FRAME samples carry no pixel data; the held group's
                # warp metadata applies, with no size check
                held = self._held_group
                warp = None if held is None else self._lens(held)
                detour = warp is not None and warp[1] in ("YUY2", "WP13")
                out = self._decode_frame_sample(
                    None if warp is None or detour else self._warp(*warp))
                if detour:
                    raise self._no_warp_decode()
                return np.ascontiguousarray(out).view(np.uint8).reshape(
                    self.height, -1)
            if info0 is None:
                info0 = parse_sample(sample)
            if not info0.channels:
                raise CFHDError(ErrorCode.BADSAMPLE, "no coded channel")
            warp = self._lens(sample, info0)
            # the YUY2 and WP13 outputs warp through the WP13 detour, the
            # others their own output
            detour = warp is not None and warp[1] in ("YUY2", "WP13")
            if detour and self._takes_warp_decode(info0):
                out = self._warp_decode(sample, info0, *warp)
            else:
                out = self._decode_route(
                    sample, info0,
                    None if warp is None or detour else self._warp(*warp))
            row_bytes = self._ROW_BYTES[self.output_format](self.width)
            out = np.ascontiguousarray(out).view(np.uint8)
            if out.size != self.height * row_bytes:
                raise CFHDError(
                    ErrorCode.BADSAMPLE,
                    f"decoded {out.size} bytes, expected "
                    f"{self.height * row_bytes}")
            if detour and not self._takes_warp_decode(info0):
                raise self._no_warp_decode()
            return out.reshape(self.height, row_bytes)
        except CFHDError:
            raise
        except Exception as exc:
            raise CFHDError(ErrorCode.BADSAMPLE, str(exc)) from exc

    def _decode_route(self, sample: bytes, info0, then=None) -> np.ndarray:
        """The decode of an intra or GROUP sample by its kind, the
        prepared output, size and resolution, with `then` (the warp) on
        the device where the route takes it."""
        if info0.sample_type == tags.SAMPLE_TYPE_GROUP:
            return self._decode_group(sample, info0, then)
        if self.resolution != DecodedResolution.FULL:
            return self._decode_scaled(sample, info0)
        if info0.encoded_format in (3, 4):
            return self._decode_intra(
                sample, info0, "RGB",
                "B64A" if info0.encoded_format == 4 else "RG48", then=then)
        if info0.encoded_format == 2:
            return self._decode_bayer_source(sample, info0, then)
        if (self.width, self.height) != (info0.width, info0.height):
            # decoded size != requested size: the Lanczos scaler, as the
            # reference's ConvertLib path (`SampleDecoder.cpp:1669-1725`)
            return self._decode_to_size(sample, info0, then=then)
        return self._decode_yuv_source(sample, info0, then)

    @staticmethod
    def _no_warp_decode() -> CFHDError:
        return CFHDError(ErrorCode.BADSAMPLE,
                         "the lens warp of a YUY2 or WP13 output decodes "
                         "the WP13 of a 4:2:2 intra sample at its coded "
                         "size")

    # CFHD_CloseDecoder
    def close(self) -> None:
        self._prepared = False


# --- C-style aliases (1:1 with the reference entry points) -------------------

def CFHD_OpenEncoder(device: torch.device | str = "cuda") -> Encoder:
    return Encoder(device)


def CFHD_OpenDecoder(device: torch.device | str = "cuda") -> Decoder:
    return Decoder(device)


def CFHD_CreateEncoderPool(thread_count: int, queue_length: int,
                           device: torch.device | str = "cuda"):
    from cineform_tpu_torch.pool import EncoderPool

    return EncoderPool(thread_count, queue_length, device)


@dataclass
class _AttachedMetadata(EncoderMetadata):
    """Metadata that every frame of a stereo stream carries as attached:
    the JAX API's `StereoEncoder` advances neither UFRM nor the timecode
    (the codec advances metadata through `advanced`)."""

    def advanced(self, k: int) -> EncoderMetadata:
        return self


class StereoEncoder:
    """Dual-channel stereoscopic 3D encoder on `device`: both eyes in ONE
    sample.

    The reference encodes 3D by looping EncodeSample over the video
    channels, appending each eye's bitstream 16-byte-aligned into one
    sample with ENCODED_CHANNELS/ENCODED_CHANNEL_NUMBER header tags and a
    VCHN metadata tuple (`Codec/encoder.c:3407-3438`, `7548-7556`)."""

    def __init__(self, device: torch.device | str = "cuda") -> None:
        self.device = torch.device(device)
        self._prepared = False
        self._frame_number = 0
        self._metadata = None
        self._sample: bytes | None = None

    def prepare_to_encode(self, width: int, height: int,
                          pixel_format: PixelFormat,
                          encoded_format: EncodedFormat = EncodedFormat.YUV_422,
                          quality: EncodingQuality = EncodingQuality.FILMSCAN1,
                          ) -> None:
        if pixel_format != PixelFormat.YUY2 or \
                encoded_format != EncodedFormat.YUV_422:
            raise CFHDError(ErrorCode.BADFORMAT,
                            "stereo 3D supports YUY2 4:2:2")
        probe = Encoder(self.device)
        probe.prepare_to_encode(width, height, pixel_format, encoded_format,
                                EncodingFlags.NONE, quality)
        self.width, self.height = width, height
        self.quality = probe.quality
        self._prepared = True

    def attach_metadata(self, metadata) -> None:
        self._metadata = metadata

    def encode_sample(self, left: bytes | np.ndarray,
                      right: bytes | np.ndarray) -> bytes:
        """Encode one stereo pair into a single dual-channel sample."""
        if not self._prepared:
            raise CFHDError(ErrorCode.ENCODING_NOT_STARTED)
        eyes = []
        for f in (left, right):
            buf = np.frombuffer(np.ascontiguousarray(f).tobytes()
                                if isinstance(f, np.ndarray) else bytes(f),
                                np.uint8)
            if buf.size != self.height * 2 * self.width:
                raise CFHDError(ErrorCode.INVALID_ARGUMENT, "bad frame size")
            eyes.append(buf.reshape(1, self.height, 2 * self.width))
        self._frame_number += 1
        meta = _AttachedMetadata(**dataclasses.asdict(
            self._metadata or EncoderMetadata()))
        codec = intra_codec(self.width, self.height, int(self.quality),
                            "YUY2", self.device)
        self._sample = stereo.encode_batch_3d(codec, *eyes,
                                              self._frame_number, meta)[0]
        return self._sample

    def get_sample_data(self) -> bytes:
        if self._sample is None:
            raise CFHDError(ErrorCode.NOT_FINISHED)
        return self._sample

    def close(self) -> None:
        self._prepared = False
        self._sample = None

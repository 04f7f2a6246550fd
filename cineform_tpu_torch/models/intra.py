"""CFHD intra codec on a torch device: 4:2:2 (YUY2, UYVY, YU64, V210 and
the Avid CT family), RGB 4:4:4 (RG48, the packed 10-bit R210, DPX0, RG30,
AB10, AR10 and the 8-bit BGRA, BGRa, RG24), RGBA 4:4:4:4 (B64A, RG64) and
Bayer (BYR4, BYR5) encode and decode.

Port of `cineform_tpu.models.intra.IntraCodec`.  The split between device
and host is the JAX package's:

- encode: the 3-level production DWT with quantization, one launch a
  level for all the channels, the bands written in the entropy coder's
  layout (kernels `ops.dwt_forward`; YUY2's level 1 reads the frames'
  bytes, the other formats' the planes that the plain `unpack_*` builds on
  the device, as does a YUY2 frame through the LYUV/CV67 input transform
  `limit_convert_yuy2`), then per (wavelet level, channel group) the band
  entropy encoder (`entropy.device.encode_band_arrays`, kernels
  `ops.chunk_pack` and `ops.merge_network`) on the device; the host
  appends band-end codes (`finish_band_bytes`) and writes the CFHD sample
  (`intra_host.write_sample`).  A band that overflows its device capacity
  is re-encoded, byte-exactly, by the host C++ coder from the coefficients
  the device computed.
- decode on the device (`decode_batch_device`): the host walks the sample
  headers and copies the band payloads into pinned row buffers
  (`bitstream.fastwalk`); on the device the band entropy decoder
  (`entropy.device_decode.decode_band_rows`, kernels
  `ops.merge_network.merge_network_tgt` and `merge_network_highfirst`),
  then the inverse DWT and the output: for 4:2:2 sources YUY2 with the
  reference's glibc output dither, BGRA, and every deep and 8-bit output
  of the JAX package's host decoder (YU64, v210, NV12, the RGB family,
  WP13, R408, RG24, the Avid CT family: `ops.yuv_output` on the Row16u
  planes), or at half, quarter or thumbnail resolution YUY2 from the
  bands of the levels it reads (the others are not entropy-decoded);
  the 16-bit RG48 and b64a rows of the RGB formats, and their WP13, W13A,
  BGRA, BGRa and RG24; for Bayer sources the 16-bit BYR4 and BYR2
  mosaics, and the demosaiced RG48, b64a, WP13, W13A and YUY2 outputs
  (`ops.demosaic`, optionally through a per-frame develop matrix).  A
  frame the device route does not take (wrong dimensions, a band with
  peaks or unaligned payload, a device overflow flag) takes the host
  entropy decode instead (`decode_checked`, the one per-frame fallback,
  which the pools and `active_metadata.decode_bayer_developed` use too).
- decode with host entropy (`decode_batch`): the host C++ entropy decoder
  (`entropy.native`, as the reference decodes on the CPU), then the same
  inverse and output on the device.

The samples equal the reference SDK's byte for byte (tests/golden).  Each
stage runs eagerly, once per call; there is no tracing or staging.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from cineform_tpu_torch.bitstream import fastwalk, parse_sample
from cineform_tpu_torch.entropy import device as edev
from cineform_tpu_torch.entropy import device_decode as ddec
from cineform_tpu_torch.entropy import native as entropy_native
from cineform_tpu_torch.models import intra_host
from cineform_tpu_torch.ops import bgra
from cineform_tpu_torch.ops import demosaic as dmops
from cineform_tpu_torch.ops import intra_transform as ops
from cineform_tpu_torch.ops import yuv_output as yout
from cineform_tpu_torch.ops.dwt_forward import (dwt_forward_groups,
                                                dwt_forward_planes,
                                                dwt_forward_yuy2)
from cineform_tpu_torch.ref.demosaic import (bayer_yuyv_parity,
                                             curve2linear_lut,
                                             linear2curve_lut, log2lin_lut,
                                             log90_inverse_lut)
from cineform_tpu_torch.ref.intra import byr4_log90_curve, rg24_dither
from cineform_tpu_torch.spec import tags
from cineform_tpu_torch.spec.production import IntraParams
from cineform_tpu_torch.state import CodecTables, codec_tables

# The input formats the port encodes, by `api.PixelFormat`'s names: the
# COLOR_FORMAT code of the sample header, the bytes of a frame row, the
# encoded format (`Codec/encoder.c:2109-2135`), and the QUALITY_H bits the
# reference writes for the 8-bit RGB inputs:
#   YUV       = 10-bit 4:2:2, 3 channels (W, W/2, W/2)
#   RGB       = 12-bit 4:4:4, 3 full-width channels [G, R, B],
#               chroma_full_res
#   RGBA      = 12-bit 4:4:4:4 [G, R, B, A] (b64a: chroma tables stay
#               chroma)
#   RGBA_FULL = RG64 (chroma_full_res like RGB)
#   BAYER     = 12-bit quarter-res difference planes [G, RG, BG, DG],
#               rgb_quality=3 (`Codec/encoder.c:2637`)
_DEVICE_FORMATS = {
    "YUY2": {"code": 2, "row_bytes": lambda w: 2 * w, "encoded": "YUV"},
    "UYVY": {"code": 1, "row_bytes": lambda w: 2 * w, "encoded": "YUV"},
    "YU64": {"code": 12, "row_bytes": lambda w: 4 * w, "encoded": "YUV"},
    "V210": {"code": 10, "row_bytes": lambda w: ((w + 47) // 48) * 128,
             "encoded": "YUV"},
    "RG48": {"code": 120, "row_bytes": lambda w: 6 * w, "encoded": "RGB"},
    "B64A": {"code": 30, "row_bytes": lambda w: 8 * w, "encoded": "RGBA"},
    "RG64": {"code": 121, "row_bytes": lambda w: 8 * w,
             "encoded": "RGBA_FULL"},
    "BYR4": {"code": 104, "row_bytes": lambda w: 2 * w, "encoded": "BAYER"},
    "BYR5": {"code": 105, "row_bytes": lambda w: 3 * w // 2,
             "encoded": "BAYER"},
    **{fmt: {"code": code, "row_bytes": lambda w: 4 * w, "encoded": "RGB"}
       for fmt, code in (("R210", 123), ("DPX0", 128), ("RG30", 122),
                         ("AB10", 125), ("AR10", 124))},
    "BGRA": {"code": 32, "row_bytes": lambda w: 4 * w, "encoded": "RGB",
             "quality_high": 0x09A0},
    "BGRa": {"code": 9, "row_bytes": lambda w: 4 * w, "encoded": "RGB",
             "quality_high": 0x09A0},
    "RG24": {"code": 7, "row_bytes": lambda w: 3 * w, "encoded": "RGB",
             "quality_high": 0x09A0},
    # the Avid CT family (`Codec/color.h:104-108`); av28's frame is two
    # planes, 5W/2 bytes a row on average
    "CT_UCHAR": {"code": 65, "row_bytes": lambda w: 2 * w, "encoded": "YUV"},
    "CT_SHORT": {"code": 66, "row_bytes": lambda w: 4 * w, "encoded": "YUV"},
    "CT_10BIT_2_8": {"code": 67, "row_bytes": lambda w: 5 * w // 2,
                     "encoded": "YUV"},
    "CT_SHORT_2_14": {"code": 68, "row_bytes": lambda w: 4 * w,
                      "encoded": "YUV"},
    "CT_USHORT_10_6": {"code": 69, "row_bytes": lambda w: 4 * w,
                       "encoded": "YUV"},
}
#: the plain unpacks of the formats above that take nothing but the frames
_UNPACKS = {
    **{fmt: lambda f, c=fourcc: ops.unpack_rgb10(f, c)
       for fmt, fourcc in (("R210", "r210"), ("DPX0", "DPX0"),
                           ("RG30", "RG30"), ("AB10", "AB10"),
                           ("AR10", "AR10"))},
    "BGRA": ops.unpack_bgra,
    "BGRa": lambda f: ops.unpack_bgra(f, top_down=True),
    "RG24": ops.unpack_rg24,
    "RG48": ops.unpack_rg48, "B64A": ops.unpack_b64a, "RG64": ops.unpack_rg64,
    "YU64": ops.unpack_yu64,
    "CT_UCHAR": ops.unpack_avu8, "CT_SHORT": ops.unpack_av16,
    "CT_USHORT_10_6": ops.unpack_av16, "CT_SHORT_2_14": ops.unpack_a214,
    "CT_10BIT_2_8": ops.unpack_av28,
}

#: the 8-bit and 13-bit outputs of the RGB formats (`decode_sample_rgb`)
_RGB_OUTPUTS = ("WP13", "W13A", "BGRA", "BGRa", "RG24")
#: the decode outputs of each encoded format, the default first, by the
#: JAX package's fourcc names (`intra_host.decode_sample_to`); a 4:2:2
#: source's every output but avu8, which the reference rejects at decode
_DECODE_OUTPUTS = {"YUV": ("YUY2", "BGRA", "BGRa", "yuyv",
                           *yout.OUTPUTS_422),
                   "RGB": ("RG48", "b64a", *_RGB_OUTPUTS),
                   "RGBA": ("b64a", "RG48", *_RGB_OUTPUTS),
                   "RGBA_FULL": ("b64a", "RG48", *_RGB_OUTPUTS),
                   "BAYER": ("BYR4", "RG48", "b64a", "WP13", "W13A", "BYR2",
                             "YUY2")}
#: the reduced resolutions of a 4:2:2 decode (CFHD_DECODED_RESOLUTION_*):
#: the inverse levels each runs; the band row classes k >= resolution - 1
#: are the ones it reads
_SCALED_LEVELS = {2: 2, 3: 1, 4: 0}


@lru_cache(maxsize=None)
def _table(table, device: torch.device) -> torch.Tensor:
    """The host table `table()` of the reference (the BYR4 encode curve,
    the BYR4 decode's log-to-linear restore, the develop's curve tables)
    as int32 on `device`."""
    return torch.from_numpy(table().astype(np.int32)).to(device)


@lru_cache(maxsize=None)
def _yuyv_parity(height: int, device: torch.device) -> torch.Tensor:
    """`bayer_yuyv_parity(height)`, the Bayer YUY2 output's dither parity
    of each row, on `device`."""
    return torch.from_numpy(bayer_yuyv_parity(height)).to(device)


@lru_cache(maxsize=None)
def _rg24_dither(width: int, height: int,
                 device: torch.device) -> torch.Tensor:
    """`rg24_dither(width, height)`, the RG24 output's per-pixel draws, on
    `device`: built once a size (2,073,600 glibc draws at 1080p)."""
    return torch.from_numpy(rg24_dither(width, height)).to(device)


def _download(t: torch.Tensor) -> np.ndarray:
    """A decoded batch on the device -> numpy: uint8 YUY2, or the 16-bit
    outputs' int16 bit patterns as little-endian uint16."""
    a = t.cpu().numpy()
    return a.view("<u2") if a.dtype == np.int16 else a


def sample_metadata(sample: bytes) -> intra_host.EncoderMetadata:
    """The encode-time metadata (GUID, date, time, timecode, unique frame
    number) of a CFHD sample, so that a re-encode of its frame reproduces
    the sample byte for byte."""
    blob = parse_sample(sample).metadata[0]
    vals = {}
    pos = 0
    while pos + 8 <= len(blob):            # tag, 24-bit size, type; padded
        size = int.from_bytes(blob[pos + 4:pos + 7], "little")
        vals[blob[pos:pos + 4].decode()] = blob[pos + 8:pos + 8 + size]
        pos += 8 + size + ((-size) % 4)
    return intra_host.EncoderMetadata(
        guid=vals["GUID"],
        date=vals["DATE"].rstrip(b"\0").decode(),
        time=vals["TIME"].rstrip(b"\0").decode(),
        timecode=vals["TIMC"].rstrip(b"\0").decode(),
        unique_frame=int.from_bytes(vals["UFRM"], "little"),
    )


@dataclass(frozen=True)
class IntraCodec:
    """An intra codec for one (width, height, quality, input format) config
    on one torch device: the card unless the caller asks for another.
    `fs_rate_limiter` is the FILMSCAN2/3 rate control's state for the
    frames it encodes (`spec.production.update_fs_rate_limiter`; None, the
    first frame's).  The encoder's options: `custom_quant`, the (luma,
    chroma) 17-entry tables of `spec.production.custom_quant_tables` in
    place of the quality presets, in the quantizers and the band headers;
    `convert`, a YUY2 codec's (limit_yuv, conv_601_709) LYUV/CV67 input
    transform; `quality_tag`, the QUALITY_L its samples are labelled
    with in place of `quality` (`intra_host.relabel_quality`)."""

    width: int
    height: int
    quality: int
    device: torch.device | str = "cuda"
    input_format: str = "YUY2"
    fs_rate_limiter: int | None = None
    custom_quant: tuple | None = None
    convert: tuple[int, int] | None = None
    quality_tag: int | None = None

    def __post_init__(self):
        if self.input_format not in _DEVICE_FORMATS:
            raise ValueError(f"input format {self.input_format!r}: the "
                             f"codec encodes {', '.join(_DEVICE_FORMATS)}")
        if self.convert is not None and self.input_format != "YUY2":
            raise ValueError("the LYUV/CV67 input transform takes YUY2 "
                             f"frames, not {self.input_format}")
        object.__setattr__(self, "device", torch.device(self.device))
        if self.custom_quant is not None:
            object.__setattr__(self, "custom_quant", tuple(
                tuple(int(q) for q in t) for t in self.custom_quant))
        if self.convert is not None:
            object.__setattr__(self, "convert",
                               tuple(int(c) for c in self.convert))

    @property
    def encoded(self) -> str:
        return _DEVICE_FORMATS[self.input_format]["encoded"]

    @property
    def params(self) -> IntraParams:
        """The transform's parameters; a Bayer codec transforms the
        mosaic's quarter-res planes."""
        common = dict(quality=self.quality,
                      fs_rate_limiter=self.fs_rate_limiter,
                      custom_quant=self.custom_quant)
        if self.encoded == "YUV":
            return IntraParams(width=self.width, height=self.height, **common)
        if self.encoded == "BAYER":
            return IntraParams(width=self.width // 2, height=self.height // 2,
                               precision=tags.PRECISION_12BIT,
                               chroma_full_res=True, rgb_quality=3, **common)
        return IntraParams(width=self.width, height=self.height,
                           precision=tags.PRECISION_12BIT,
                           chroma_full_res=self.encoded != "RGBA", **common)

    @property
    def num_channels(self) -> int:
        return 3 if self.encoded in ("YUV", "RGB") else 4

    @property
    def groups(self) -> tuple[tuple[int, ...], ...]:
        """The channels by group of equal plane shape, each group one call
        of the DWT and of the entropy coder a level: 4:2:2's Y, then V and
        U; all the channels of RGB, RGBA and Bayer."""
        if self.encoded == "YUV":
            return ((0,), (1, 2))
        return (tuple(range(self.num_channels)),)

    def plane_width(self, ch: int) -> int:
        if self.encoded == "YUV" and ch > 0:
            return self.width // 2
        return self.params.width

    @property
    def _write_sample_kwargs(self) -> dict:
        if self.encoded == "YUV":
            return {"input_format": self.input_format_code}
        common = {"input_format": self.input_format_code, "colorspace": None}
        if self.encoded == "RGB":
            fmt = _DEVICE_FORMATS[self.input_format]
            return {**common, "encoded_format": tags.ENCODED_FORMAT_RGB_444,
                    **({"quality_high": fmt["quality_high"]}
                       if "quality_high" in fmt else {})}
        if self.encoded == "BAYER":
            return {**common, "encoded_format": tags.ENCODED_FORMAT_BAYER}
        return {**common, "encoded_format": tags.ENCODED_FORMAT_RGBA_4444,
                "quality_high": 0x2000}

    @property
    def row_bytes(self) -> int:
        return _DEVICE_FORMATS[self.input_format]["row_bytes"](self.width)

    @property
    def input_format_code(self) -> int:
        return _DEVICE_FORMATS[self.input_format]["code"]

    def _unpack(self, frames: torch.Tensor):
        """(B, H, row_bytes) uint8 frames -> the channel planes, each (B, h,
        w) int32 (plain PyTorch): 10-bit 4:2:2's Y, V, U, the RGB
        formats' 12-bit [G, R, B(, A)], Bayer's quarter-res 12-bit [G, RG,
        BG, DG]."""
        fmt = self.input_format
        if fmt in _UNPACKS:
            return _UNPACKS[fmt](frames)
        if fmt == "YUY2":
            return ops.limit_convert_yuy2(frames, *(self.convert or (0, 0)))
        if fmt == "UYVY":
            return ops.unpack_uyvy(frames, self.params.precision)
        if fmt == "V210":
            return ops.unpack_v210(frames, self.width)
        if fmt == "BYR4":
            return ops.unpack_byr4(frames, _table(byr4_log90_curve,
                                                  frames.device))
        # BYR5's rows are quarter-res rows of 3W bytes
        return ops.unpack_byr5(frames.reshape(
            frames.shape[0], self.height // 2, 3 * self.width))

    def level1_input(self, frames: torch.Tensor):
        """(B, H, row_bytes) uint8 frames on the device -> what the first
        DWT launch reads, built by the plain unpack: the 4:2:2 formats'
        group buffers, Y (B, 1, H, W) and V, U (B, 2, H, W/2); the other
        formats' (B, G, h, w) planes.  YUY2's level 1 reads the frames
        themselves and has none, unless the LYUV/CV67 transform
        (`convert`) unpacks them."""
        planes = self._unpack(frames)
        if self.encoded == "YUV":
            # V210's luma is a view cut to the width from whole 6-pixel
            # groups; the kernel takes contiguous buffers
            return (planes[0][:, None].contiguous(),
                    torch.stack(planes[1:], dim=1))
        return torch.stack(planes, dim=1)

    def tables(self, frame_index: int = 0) -> CodecTables:
        p = self.params
        return codec_tables(p.width, p.height, self.quality,
                            frame_index, device=self.device,
                            precision=p.precision,
                            chroma_full_res=p.chroma_full_res,
                            rgb_quality=p.rgb_quality,
                            num_channels=self.num_channels,
                            fs_rate_limiter=p.fs_rate_limiter,
                            custom_quant=p.custom_quant)

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        """(B, H, row_bytes) uint8 host frames -> a tensor on the device."""
        if frames.shape[1:] != (self.height, self.row_bytes):
            raise ValueError(f"frames of shape {frames.shape}: expected "
                             f"(B, {self.height}, {self.row_bytes}) "
                             f"{self.input_format}")
        return torch.from_numpy(np.array(frames, np.uint8)).to(self.device)

    # --- encode ------------------------------------------------------------

    def forward_levels(self, frames: torch.Tensor):
        """(B, H, row_bytes) uint8 frames on the device -> per level,
        finest first, (lows, highs) by channel group (`groups`): lows
        (B, G, h, w) the lowpass planes, highs (B, G, 3, h, pitch) the
        quantized (LH, HL, HH) bands in the entropy coder's layout.  On a
        card, one launch a level: YUY2's level 1 reads the frames' bytes,
        the other formats' (and a YUY2 frame through `convert`) the
        unpacked planes (`level1_input`)."""
        t = self.tables()

        def quants(k):
            return [t.band_quant[ch][k] for ch in range(self.num_channels)]

        if self.encoded == "YUV":
            if self.input_format == "YUY2" and self.convert is None:
                first = dwt_forward_yuy2(frames, self.params.precision,
                                         t.prescale[0], quants(0))
            else:
                first = dwt_forward_groups(self.level1_input(frames),
                                           t.prescale[0], quants(0))
            levels = [first]
            for k in (1, 2):
                levels.append(dwt_forward_groups(levels[-1][0],
                                                 t.prescale[k], quants(k)))
            return levels
        x = self.level1_input(frames)
        levels = []
        for k in range(3):
            x, highs = dwt_forward_planes(x, t.prescale[k], quants(k))
            levels.append(((x,), (highs,)))
        return levels

    def _channels(self, levels):
        """`forward_levels`' buffers -> per-channel (lowpass, [(LH, HL, HH)]
        finest first), views into them."""
        out = [None] * self.num_channels
        for g, grp in enumerate(self.groups):
            for i, ch in enumerate(grp):
                bands = []
                for lows, highs in levels:
                    w = lows[g].shape[-1]
                    bands.append(tuple(highs[g][:, i, b, :, :w]
                                       for b in range(3)))
                out[ch] = (levels[-1][0][g][:, i], bands)
        return out

    def forward(self, frames: torch.Tensor):
        """(B, H, row_bytes) uint8 frames on the device -> per-channel
        (lowpass, [(LH, HL, HH)] finest first), int32."""
        return self._channels(self.forward_levels(frames))

    @staticmethod
    def group_bands(highs: torch.Tensor) -> torch.Tensor:
        """A level's bands of a channel group, (B, G, 3, h, pitch), as the
        entropy coder's input: (B, G, 3, h * pitch) int32."""
        return highs.flatten(-2)

    def forward_packed(self, frames: torch.Tensor, cap_bits: int = 8):
        """(B, H, row_bytes) uint8 frames on the device -> per-channel
        (lowpass, [(words, total_bits, overflow, bands)] per level): the
        complete CFHD band bitstreams (without band-end codes) on the
        device, words, total_bits and overflow each (B, 3, ...), one call
        of the entropy coder a level and group, and the level's quantized
        (LH, HL, HH) coefficients, each (B, h, w), which the host re-encodes
        where a band overflowed."""
        levels = self.forward_levels(frames)
        coeffs = self._channels(levels)
        packed_by_ch: list[list] = [[] for _ in coeffs]
        for k, (_, highs) in enumerate(levels):
            for grp, bands in zip(self.groups, highs):
                words, nbits, ovf = edev.encode_band_arrays(
                    self.group_bands(bands), codeset=17,
                    cap_bits_per_elem=cap_bits)
                for gi, ch in enumerate(grp):
                    packed_by_ch[ch].append((words[:, gi], nbits[:, gi],
                                             ovf[:, gi], coeffs[ch][1][k]))
        return [(coeffs[ch][0], packed_by_ch[ch]) for ch in range(len(coeffs))]

    def _frame_meta(self, batch, first_frame_number, frame_numbers, metadata):
        if frame_numbers is None:
            frame_numbers = [first_frame_number + i for i in range(batch)]
        if not isinstance(metadata, (list, tuple)):
            metadata = [metadata] * batch
        # per-frame metadata advance (UFRM + timecode), as the reference
        # bumps both on every EncodeSample
        # (`EncoderSDK/SampleEncoder.cpp:795-880`)
        out = []
        for fn, m in zip(frame_numbers, metadata):
            base = m if m is not None else intra_host.EncoderMetadata()
            out.append(base.advanced(fn - 1) if fn >= 1 else base)
        return frame_numbers, out

    def _write_sample(self, channels, frame_number: int, metadata,
                      eye: int | None = None) -> bytes:
        """One frame's CFHD sample from its channels, labelled with
        `quality_tag` where the codec has one."""
        sample = intra_host.write_sample(channels, self.params, frame_number,
                                         metadata, **self._write_sample_kwargs,
                                         eye=eye)
        if self.quality_tag is None:
            return sample
        return intra_host.relabel_quality(sample, self.quality,
                                          self.quality_tag)

    def write_samples(self, frames: np.ndarray, packed,
                      first_frame_number: int = 1, metadata=None,
                      frame_numbers: list[int] | None = None) -> list[bytes]:
        """Host tail of the device encode: fetch `forward_packed`'s output,
        finish each band's bytes and write the samples.  A band that
        overflowed its device capacity is re-encoded on the host by the
        C++ coder, from its coefficients as `forward_packed` computed them
        on the device (only those bands are downloaded)."""
        p = self.params
        result = [(lowpass.cpu().numpy(),
                   [(w.cpu().numpy(), n.cpu().numpy(), o.cpu().numpy(), bands)
                    for w, n, o, bands in levels])
                  for lowpass, levels in packed]
        batch = frames.shape[0]
        frame_numbers, metadata = self._frame_meta(
            batch, first_frame_number, frame_numbers, metadata)
        samples = []
        for i in range(batch):
            channels = []
            for ch, (lowpass, levels) in enumerate(result):
                payloads, bands = [], []
                for k, (words, nbits, ovf, coeffs) in enumerate(levels):
                    payloads.append(tuple(
                        None if ovf[i, b]             # host re-encode
                        else edev.finish_band_bytes(words[i, b],
                                                    int(nbits[i, b]), 17)
                        for b in range(3)))
                    # write_sample reads a band only for its shape, unless
                    # its payload is None
                    shape = (p.height >> (k + 1),
                             self.plane_width(ch) >> (k + 1))
                    bands.append(tuple(
                        coeffs[b][i].cpu().numpy() if ovf[i, b]
                        else np.broadcast_to(np.int32(0), shape)
                        for b in range(3)))
                channels.append(intra_host.EncodedChannel(
                    lowpass=lowpass[i], bands=bands,
                    quants=p.band_quant(ch), payloads=payloads))
            samples.append(self._write_sample(channels, frame_numbers[i],
                                              metadata[i]))
        return samples

    def encode_batch_device(self, frames: np.ndarray,
                            first_frame_number: int = 1, metadata=None,
                            cap_bits: int = 8,
                            frame_numbers: list[int] | None = None
                            ) -> list[bytes]:
        """Encode (B, H, row_bytes) uint8 frames to CFHD samples with the
        transform and the entropy coding on the device.  `metadata` may be
        one EncoderMetadata or one per frame."""
        packed = self.forward_packed(self._upload(frames), cap_bits)
        return self.write_samples(frames, packed, first_frame_number,
                                  metadata, frame_numbers)

    def encode_batch(self, frames: np.ndarray, first_frame_number: int = 1,
                     metadata=None, frame_numbers: list[int] | None = None,
                     eye: int | None = None) -> list[bytes]:
        """Encode with the transform on the device and the entropy coding
        on the host (C++ coder).  `eye` 0 or 1 writes each frame as that
        eye's bitstream of a stereo 3D sample (`models.stereo`)."""
        coeffs = [(lowpass.cpu().numpy(),
                   [tuple(b.cpu().numpy() for b in bs) for bs in bands])
                  for lowpass, bands in self.forward(self._upload(frames))]
        p = self.params
        batch = frames.shape[0]
        frame_numbers, metadata = self._frame_meta(
            batch, first_frame_number, frame_numbers, metadata)
        samples = []
        for i in range(batch):
            channels = [intra_host.EncodedChannel(
                lowpass=lowpass[i], bands=[tuple(b[i] for b in bs)
                                           for bs in bands],
                quants=p.band_quant(ch))
                for ch, (lowpass, bands) in enumerate(coeffs)]
            samples.append(self._write_sample(channels, frame_numbers[i],
                                              metadata[i], eye))
        return samples

    # --- decode ------------------------------------------------------------

    def dequantize(self, coeffs):
        """Per-channel (lowpass, [(LH, HL, HH)]) quantized coefficients ->
        the same with the bands dequantized, as the entropy decoder folds
        it into its tables (`ops.dequantize` with each band's quantizer)."""
        p = self.params
        return [(lowpass, [tuple(ops.dequantize(b, q)
                                 for b, q in zip(bs, p.band_quant(ch)[k]))
                           for k, bs in enumerate(bands)])
                for ch, (lowpass, bands) in enumerate(coeffs)]

    def inverse(self, coeffs, frame_index: int = 0) -> torch.Tensor:
        """Per-channel (lowpass, bands) -> (B, H, 2W) uint8 YUY2 frames.

        Applies the reference decoder's output dither for the given frame
        index of the decode process (the rand stream advances per decoded
        frame; every frame in the batch shares the index)."""
        t = self.tables(frame_index)
        dy = ops.expand_dither_rows(t.dither_rows, self.width, 16)
        dc = ops.expand_dither_rows(t.dither_rows, self.width // 2, 8)
        planes = [ops.inverse_channel_to_8bit(
            lowpass, bands, t.prescale, dither=dy if ch == 0 else dc)
            for ch, (lowpass, bands) in enumerate(coeffs)]
        return ops.pack_yuy2(*planes)

    def inverse_bgra(self, coeffs, output: str = "BGRA") -> torch.Tensor:
        """4:2:2 coefficients -> (B, H, W, 4) uint8 BGRA rows, bottom row
        first, or BGRa rows, top row first: the fused final-level inverse
        and YUV->RGB conversion (`ops.bgra`), fed the strips with the
        default +24 lowpass channel offset (+5 at odd lowpass widths,
        `Codec/decoder.c:12258`).  BGRA adds it on top of the 8-bit bias
        the lowpass carries, as the JAX package's device decode does
        (ROADMAP Queue 3); BGRa, the JAX host decoder's output, in place
        of it."""
        p = self.params

        def offset(w):
            off = intra_host.lowpass_offset_absolute(w, False)
            if output == "BGRa":
                off -= intra_host.lowpass_channel_offset(w)
            return off

        (yl, yh), (c1l, c1h), (c2l, c2h) = [ops.inverse_channel_strips(
            lowpass + offset(lowpass.shape[-1]), bands, p.prescale)
            for lowpass, bands in coeffs]
        out = bgra.strip_to_bgra(yl, yh, c2l, c2h, c1l, c1h, p.precision)
        return out.flip(-3) if output == "BGRA" else out

    def _row16u_planes(self, coeffs, deep_yuv: bool | None = None):
        """Per-channel Row16u reconstruction: (B, H, W) int32 planes of
        uint16 values.  The deep RGB and Bayer paths take no lowpass
        offset (`decoder.c:12296-12319`); a 4:2:2 source's outputs
        (`deep_yuv` True for YU64, v210 and NV12, False for the others)
        take the absolute offset of `_decode_row16u_planes` in place of the
        8-bit bias its lowpass carries: +4 or +24, +5 at odd widths."""
        p = self.params
        planes = []
        for lowpass, bands in coeffs:
            if deep_yuv is not None:
                w = lowpass.shape[-1]
                lowpass = lowpass + (
                    intra_host.lowpass_offset_absolute(w, deep_yuv)
                    - intra_host.lowpass_channel_offset(w))
            planes.append(ops.h26_inverse_to_row16u(
                *ops.inverse_channel_strips(lowpass, bands, p.prescale),
                p.precision))
        return planes

    def inverse_rg48(self, coeffs) -> torch.Tensor:
        """RGB or RGBA coefficients (channels G, R, B[, A]) -> (B, H, 3W)
        int32 RG48 rows of uint16 values (alpha dropped), as
        `intra_host.decode_sample_rgb(..., 'RG48')` writes them."""
        g, r, b = self._row16u_planes(coeffs[:3])
        return torch.stack([r, g, b], dim=-1).flatten(-2)

    def inverse_b64a(self, coeffs) -> torch.Tensor:
        """RGB or RGBA coefficients -> (B, H, 4W) int32 ARGB (b64a) rows
        of uint16 values, as `intra_host.decode_sample_rgb(..., 'b64a')`
        writes them: a 4-channel source's alpha decompanded, a 3-channel
        source's colours capped at 65520 except the right-border pair, and
        its alpha 65520."""
        planes = self._row16u_planes(coeffs)
        g, r, b = planes[:3]
        if len(planes) == 4:
            a = (((planes[3] - 4096).clamp(min=0) * 9400) >> 13).clamp(
                0, 65535)
        else:
            def cap(x):
                q = x.clamp(max=65520)
                q[..., -2:] = x[..., -2:]
                return q

            g, r, b = cap(g), cap(r), cap(b)
            a = torch.full_like(g, 65520)
        return torch.stack([a, r, g, b], dim=-1).flatten(-2)

    def inverse_byr(self, coeffs, output: str = "BYR4") -> torch.Tensor:
        """Bayer coefficients (G, RG, BG, GD difference planes) -> (B, H,
        W) int32 mosaic rows of uint16 values: GenerateBYR2's
        un-difference (`Codec/bayer.c:13237`), for BYR4 through the
        BYR4LinearRestore log-to-linear table, for BYR2 with the low bit
        masked instead (`bayer.c:13322-13328`)."""
        g, rg, bg, gd = self._row16u_planes(coeffs)
        r = (((rg - 32768) << 1) + g).clamp(0, 0xFFFF)
        b = (((bg - 32768) << 1) + g).clamp(0, 0xFFFF)
        gd = gd - 32768
        g1 = (g + gd).clamp(0, 0xFFFF)
        g2 = (g - gd).clamp(0, 0xFFFF)
        if output == "BYR4":
            lut = _table(log2lin_lut, g.device)
            r, g1, g2, b = (lut[(x >> 2).long()] for x in (r, g1, g2, b))
        else:
            r, g1, g2, b = (x & 0xFFFE for x in (r, g1, g2, b))
        return dmops.interleave_sites(r, g1, g2, b)

    def inverse_bayer_rgb(self, coeffs, output: str,
                          develop=None) -> torch.Tensor:
        """Bayer coefficients -> a demosaiced output, as the JAX package's
        `intra_host.decode_sample_bayer_to` writes it, a frame at a time
        (the chain's temporaries at 4K are a few hundred MB a frame):

        - RG48 (B, H, 3W), b64a (B, H, 4W: alpha 0xFFFF first), WP13
          (B, H, 3W: RG48 >> 3) and W13A (B, H, 4W: alpha 8191 last), int32
          of 16-bit values: `ops.demosaic.demosaic_raw`, or with a matrix
          its `develop_1d` stored << 3;
        - YUY2 (B, H, 2W) uint8: the bilinear demosaic, then the YUYV
          conversion at whitepoint 16, or with a matrix the develop's
          13-bit values at whitepoint 13, the dither by mosaic row pair.

        `develop`: None (the raw chain), or (B, 3, 4) float develop
        matrices, one a frame (`ref.demosaic.compose_develop_matrix`)."""
        planes = self._row16u_planes(coeffs)
        dev = planes[0].device
        lcm = None
        if develop is not None:
            lcm = dmops.develop_matrix_lcm(develop, dev)
            if lcm.shape[0] != planes[0].shape[0]:
                raise ValueError(f"{lcm.shape[0]} develop matrices for a "
                                 f"batch of {planes[0].shape[0]}")
            c2l = _table(curve2linear_lut, dev)
            l2c = _table(linear2curve_lut, dev)
        if output == "YUY2":
            parity = _yuyv_parity(self.height, dev)
        frames = []
        for i in range(planes[0].shape[0]):
            one = [p[i:i + 1] for p in planes]
            m = None if lcm is None else lcm[i:i + 1]
            if output == "YUY2":
                rgb = dmops.demosaic_bilinear_rgb(*one)
                if m is None:
                    frames.append(dmops.convert_rgb16_to_yuyv(rgb, parity))
                else:
                    out13 = dmops.develop_1d(rgb.clamp(0, 65535), m, c2l,
                                             l2c)
                    frames.append(dmops.convert_rgb16_to_yuyv(
                        out13, parity, whitepoint=13))
                continue
            rgb = dmops.demosaic_raw(*one)
            if m is not None:
                rgb = (dmops.develop_1d(rgb, m, c2l, l2c) << 3).clamp(0, 65535)
            if output in ("WP13", "W13A"):
                rgb = rgb >> 3
            fill = {"b64a": 0xFFFF, "W13A": 8191}.get(output)
            if fill is not None:
                alpha = torch.full_like(rgb[..., :1], fill)
                rgb = torch.cat([alpha, rgb] if output == "b64a"
                                else [rgb, alpha], dim=-1)
            frames.append(rgb.flatten(-2))
        return torch.cat(frames)

    def inverse_bayer_linear(self, coeffs) -> torch.Tensor:
        """Bayer coefficients -> (B, h, w, 3) int32 quarter-res 12-bit
        linear RGB, as the JAX package's `intra_host.decode_sample_bayer`
        builds it: the production inverse of the G, RG, BG planes, their
        un-difference, and the inverse of the LOG-90 curve."""
        prescale = self.params.prescale
        planes = []
        for lowpass, bands in coeffs[:3]:
            ll = lowpass
            for k in (2, 1):
                ll = ops.dwt2d_inverse(ll, *bands[k],
                                       2 if prescale[k] == 2 else 1)
            planes.append(ops.dwt2d_inverse(ll, *bands[0], 1))
        g = planes[0].clamp(0, 4095)
        r = (((planes[1] - 2048) << 1) + g).clamp(0, 4095)
        b = (((planes[2] - 2048) << 1) + g).clamp(0, 4095)
        inv = _table(log90_inverse_lut, g.device)
        return torch.stack([inv[x.long()] for x in (r, g, b)], dim=-1)

    def decode_output(self, output: str | None, resolution: int = 1) -> str:
        """The decode output `output` names, checked, or the format's
        default: YUY2 for 4:2:2 sources, RG48 for RGB, b64a for RGBA, BYR4
        for Bayer (`_DECODE_OUTPUTS` lists each format's outputs).  A
        reduced `resolution` (2 half, 3 quarter, 4 thumbnail) is a 4:2:2
        source's, and outputs YUY2."""
        outputs = _DECODE_OUTPUTS[self.encoded]
        if resolution != 1:
            if resolution not in _SCALED_LEVELS or self.encoded != "YUV":
                raise ValueError(
                    f"resolution {resolution}: a 4:2:2 source decodes at 1 "
                    f"(full), 2, 3 or 4, a {self.input_format} source at 1")
            if output not in (None, "YUY2"):
                raise ValueError(f"decode output {output!r}: a "
                                 "reduced-resolution decode outputs YUY2")
            return "YUY2"
        if output is None:
            return outputs[0]
        if output not in outputs:
            raise ValueError(f"decode output {output!r}: a {self.input_format}"
                             f" source decodes to {', '.join(outputs)}")
        return output

    def inverse_output(self, coeffs, frame_index: int = 0,
                       output: str | None = None,
                       develop=None, resolution: int = 1) -> torch.Tensor:
        """Per-channel (lowpass, bands) -> the decoded batch on the device,
        the `output` of `decode_output`'s list: (B, H, 2W) uint8 YUY2 with
        the output dither of `frame_index`, (B, H, W, 4) uint8 BGRA, the
        other 8-bit outputs as (B, H, row_bytes) uint8, the 16-bit ones
        (RG48, b64a, BYR4, YU64, WP13, ...) as int16 bit patterns; Bayer
        sources' outputs as `inverse_byr` and `inverse_bayer_rgb` give
        them, the latter through the per-frame `develop` matrices where
        given.  At a reduced `resolution` the bands of the levels it skips
        may be None: (B, H >> (r - 1), 2W >> (r - 1)) uint8 YUY2."""
        output = self.decode_output(output, resolution)
        if develop is not None and (self.encoded != "BAYER"
                                    or output in ("BYR4", "BYR2")):
            raise ValueError(f"a develop matrix applies to a Bayer source's "
                             f"RGB and YUY2 outputs, not {output} of "
                             f"{self.input_format}")
        if output in ("BYR4", "BYR2"):
            return yout.u16(self.inverse_byr(coeffs, output))
        if self.encoded == "BAYER":
            out = self.inverse_bayer_rgb(coeffs, output, develop)
            return out if output == "YUY2" else yout.u16(out)
        if resolution != 1:
            levels = _SCALED_LEVELS[resolution]
            return ops.pack_yuy2(*(ops.inverse_channel_scaled(
                lowpass, bands, self.params.prescale, levels)
                for lowpass, bands in coeffs))
        if self.encoded != "YUV":
            if output == "b64a":
                return yout.u16(self.inverse_b64a(coeffs))
            rgb = self.inverse_rg48(coeffs)
            if output == "RG48":
                return yout.u16(rgb)
            rgb = rgb.unflatten(-1, (-1, 3))
            if output in ("WP13", "W13A"):
                return yout.wp13_pack(rgb >> 3, output)
            return yout.rgb16_to_8bit(*rgb.unbind(-1), output)
        if output in ("YUY2", "yuyv"):
            return self.inverse(coeffs, frame_index)
        if output in ("BGRA", "BGRa"):
            return self.inverse_bgra(coeffs, output)
        planes = self._row16u_planes(coeffs, output in yout.DEEP_YUV)
        dither = (_rg24_dither(self.width, self.height, planes[0].device)
                  if output == "RG24" else None)
        return yout.pack(output, *planes, rg24_dither=dither)

    def host_entropy_decode(self, samples: list[bytes],
                            resolution: int = 1):
        """Parse the samples and entropy-decode every band on the host (C++
        decoder); returns the batched per-channel (lowpass, bands) int32
        tensors on the device.  A reduced `resolution` decodes only the
        bands of the levels k >= resolution - 1, as the JAX package's
        `decode_sample_scaled` does, and gives None for the others."""
        kmin = resolution - 1
        per_frame = []
        for sample in samples:
            s = parse_sample(sample)
            chans = []
            for c in s.channels:
                bands: list[dict] = [dict() for _ in range(3)]
                for b in c.bands:
                    widx = 2 - (b.subband - 1) // 3
                    if widx < kmin:
                        continue
                    pitchw = intra_host.align16_pixels(b.width)
                    vals, _ = entropy_native.decode_band(
                        b.data, pitchw * b.height, codeset=17,
                        quant=b.quantization)
                    bands[widx][b.band] = vals.reshape(
                        b.height, pitchw)[:, :b.width]
                # the reference's lowpass load bias at odd lowpass widths
                # of the 8-bit output (`Codec/decoder.c:12479`), as the
                # host oracle and the JAX device decoder apply it; the deep
                # RGB paths take none (`decoder.c:12296-12319`)
                lowpass = c.lowpass.astype(np.int32)
                if self.encoded == "YUV":
                    lowpass += intra_host.lowpass_channel_offset(
                        c.lowpass.shape[1])
                chans.append((lowpass,
                              [(bands[k][1], bands[k][2], bands[k][3])
                               if k >= kmin else None for k in range(3)]))
            per_frame.append(chans)

        def batched(arrays):
            return torch.from_numpy(
                np.stack(arrays).astype(np.int32)).to(self.device)

        return [(batched([f[ch][0] for f in per_frame]),
                 [None if k < kmin else
                  tuple(batched([f[ch][1][k][b] for f in per_frame])
                        for b in range(3)) for k in range(3)])
                for ch in range(self.num_channels)]

    def decode_batch(self, samples: list[bytes], frame_index: int = 0,
                     output: str | None = None,
                     develop=None, resolution: int = 1) -> np.ndarray:
        """Decode CFHD samples with the host C++ entropy decoder, then the
        inverse and the output on the device: the `output` of
        `decode_output`'s list (by default the source format's) as
        `inverse_output` gives it, downloaded (the 16-bit outputs as
        uint16 rows); a Bayer source's RG48, b64a, WP13, W13A and YUY2
        through the develop matrices `develop` ((B, 3, 4), or None for the
        raw chain).  A 4:2:2 source also decodes at `resolution` 2 (half),
        3 (quarter) or 4 (thumbnail) to YUY2.

        frame_index positions the YUY2 output dither within the decoder
        process's rand stream (a sequential decoder passes 0, 1, 2, ...)."""
        output = self.decode_output(output, resolution)
        coeffs = self.host_entropy_decode(samples, resolution)
        return _download(self.inverse_output(coeffs, frame_index, output,
                                             develop, resolution))

    # --- decode on the device: entropy + inverse transform -----------------

    @property
    def _DECODE_CLASSES(self):
        """Band row classes (wavelet index k, plane channels); k indexes
        band dims plane >> (k + 1).  4:2:2 luma and chroma differ in width,
        so they decode as separate classes; the other formats' channels
        share one class a level."""
        return tuple((k, planes) for k in range(3) for planes in self.groups)

    def decode_classes(self, resolution: int = 1):
        """The band row classes a decode at `resolution` reads, as (index
        into `_DECODE_CLASSES`, k, planes): k >= resolution - 1 (k = 0 is
        the finest level); none at thumbnail."""
        return [(ci, k, planes)
                for ci, (k, planes) in enumerate(self._DECODE_CLASSES)
                if k >= resolution - 1]

    #: floor of a class's row capacity in 32-bit chunks; capacities double
    #: from here to fit the class's longest band payload
    MIN_ROW_CHUNKS = 256

    def _class_dims(self, k: int, planes: tuple[int, ...]):
        bh = self.params.height >> (k + 1)
        bw = self.plane_width(planes[0]) >> (k + 1)
        return bh, bw, intra_host.align16_pixels(bw)

    def _class_reshape(self, co: torch.Tensor, ovf: torch.Tensor, ci: int,
                       batch: int):
        k, planes = self._DECODE_CLASSES[ci]
        bh, bw, pitch = self._class_dims(k, planes)
        co = co.reshape(batch, len(planes), 3, bh, pitch)[..., :bw]
        return co, ovf.reshape(batch, -1).any(dim=1)

    def _decode_class_program(self, pay, nch, qn, lin, ci: int):
        """One band row class (pay (R, S*4) uint8, rows (frame, channel,
        band)) -> ((B, planes, 3, bh, bw) int32 coefficients, (B,)
        overflow flags)."""
        k, planes = self._DECODE_CLASSES[ci]
        bh, _, pitch = self._class_dims(k, planes)
        co, ovf = ddec.decode_band_rows(pay, nch, qn, lin, nout=bh * pitch)
        batch = pay.shape[0] // (len(planes) * 3)
        return self._class_reshape(co, ovf, ci, batch)

    def decode_coefficients(self, pays, nchs, qns, lins, lowpass,
                            resolution: int = 1):
        """Per-class band payload rows on the device, one entry a class of
        `decode_classes(resolution)` -> (per-channel (lowpass, bands) as
        `inverse_output` takes them, the bands of the classes not read
        None, (B,) overflow flags)."""
        coeffs_by = {}
        ovf = torch.zeros(lowpass[0].shape[0], dtype=torch.bool,
                          device=lowpass[0].device)
        for (ci, k, planes), pay, nch, qn, lin in zip(
                self.decode_classes(resolution), pays, nchs, qns, lins):
            co, class_ovf = self._decode_class_program(pay, nch, qn, lin, ci)
            for pi, ch in enumerate(planes):
                coeffs_by[(ch, k)] = tuple(co[:, pi, b] for b in range(3))
            ovf = ovf | class_ovf
        coeffs = [(lowpass[ch], [coeffs_by.get((ch, k)) for k in range(3)])
                  for ch in range(self.num_channels)]
        return coeffs, ovf

    def _decode_rows_host(self, samples: list[bytes], walks=None,
                          resolution: int = 1):
        """Host header walk: samples -> per-class row tensors on the host
        (pinned when the codec's device is CUDA).  `walks`: the samples'
        `fastwalk.walk` results where the caller has them already.  The
        bands of the classes a `resolution` does not read are neither
        checked nor copied.

        Returns (pays, nchs, qns, lins, lowpass, fallback): tuples of
        (R, S*4) uint8 / (R,) int32 tensors, one per class of
        `decode_classes(resolution)` (rows ordered frame, channel, band),
        the lowpass planes (B, lh, lw) int32 with the decoder's lowpass
        bias, and the set of frame indices the device route does not take
        (wrong dimensions, a band outside subbands 1-9, with peaks or with
        an unaligned payload); those frames get empty rows.  The native
        walker finds the bands in one C pass per sample and copies their
        payloads straight into the row buffers."""
        batch = len(samples)
        pin = self.device.type == "cuda"
        nch = self.num_channels
        p = self.params
        kmin = resolution - 1
        lh = p.height >> 3
        lws = tuple(self.plane_width(ch) >> 3 for ch in range(nch))
        #: (ch, k, band, i) -> (data_off, data_len, quant, lin)
        parts: dict = {}
        fallback = set()
        if walks is None:
            walks = [fastwalk.walk(sample) for sample in samples]
        for i, r in enumerate(walks):
            if r is None or (r.width, r.height) != (p.width, p.height) \
                    or r.nchannels != nch or 0 in r.lowpass_off \
                    or r.lowpass_h != (lh,) * nch or r.lowpass_w != lws:
                fallback.add(i)
                continue
            for (ch, bandno, subband), (off, ln, q, lin, fl) in \
                    r.bands.items():
                k = 2 - (subband - 1) // 3
                if 1 <= subband <= 9 and k < kmin:
                    continue
                if not 1 <= subband <= 9 or fl & 1 or ln % 4:
                    fallback.add(i)
                    break
                parts[(ch, k, bandno, i)] = (off, ln, q, lin)
            if i not in fallback and any(
                    (ch, k, band, i) not in parts for ch in range(nch)
                    for k in range(kmin, 3) for band in (1, 2, 3)):
                fallback.add(i)
        live = [i for i in range(batch) if i not in fallback]

        pays, nchs, qns, lins = [], [], [], []
        for _, k, planes in self.decode_classes(resolution):
            rows = [(0, 0, 1, 0) if i in fallback else parts[(ch, k, band, i)]
                    for i in range(batch) for ch in planes
                    for band in (1, 2, 3)]
            cap = self.MIN_ROW_CHUNKS
            while cap < max(ln for _, ln, _, _ in rows) // 4:
                cap *= 2
            meta = torch.tensor([(ln // 4, q, lin) for _, ln, q, lin in rows],
                                dtype=torch.int32).t().contiguous()
            if pin:
                meta = meta.pin_memory()
            pay = torch.zeros((len(rows), cap * 4), dtype=torch.uint8,
                              pin_memory=pin)
            per_frame = len(rows) // batch
            for i in live:
                sl = rows[i * per_frame:(i + 1) * per_frame]
                fastwalk.fill_rows(
                    pay.numpy(), samples[i],
                    np.asarray([o for o, _, _, _ in sl], np.int64),
                    np.asarray([ln for _, ln, _, _ in sl], np.int64),
                    np.arange(i * per_frame, (i + 1) * per_frame))
            pays.append(pay)
            nchs.append(meta[0])
            qns.append(meta[1])
            lins.append(meta[2])

        lowpass = []
        for ch in range(nch):
            w = lws[ch]
            arr = torch.zeros((batch, lh, w), dtype=torch.int32,
                              pin_memory=pin)
            # the 4:2:2 outputs' bias; the deep RGB and Bayer paths take
            # none
            bias = (intra_host.lowpass_channel_offset(w)
                    if self.encoded == "YUV" else 0)
            for i in live:
                fastwalk.lowpass_i32(samples[i], walks[i].lowpass_off[ch],
                                     lh, w, bias, arr[i].numpy())
            lowpass.append(arr)
        return (tuple(pays), tuple(nchs), tuple(qns), tuple(lins),
                tuple(lowpass), fallback)

    def _upload_rows(self, rows):
        """`_decode_rows_host`'s tensors -> the device (asynchronous copies
        from pinned memory on CUDA); the fallback set passes through."""
        *groups, fallback = rows
        return (*(tuple(t.to(self.device, non_blocking=True) for t in g)
                  for g in groups), fallback)

    def _decode_rows_args(self, samples: list[bytes], resolution: int = 1):
        """`_decode_rows_host` with its tensors uploaded to the device."""
        return self._upload_rows(self._decode_rows_host(
            samples, resolution=resolution))

    def decode_checked(self, samples: list[bytes], finish, rows=None,
                       resolution: int = 1):
        """The device route's one per-frame fallback: entropy-decode the
        samples on the device and run `finish(coeffs, frames)` (a batched
        device computation of `frames`' coefficients, `frames` a slice or
        a list of batch indices) on them; the frames the device route does
        not take (wrong dimensions, a band outside subbands 1-9, with
        peaks or an unaligned payload) or that overflow their device band
        region get `finish` of their host-decoded coefficients
        (`host_entropy_decode`) instead.  `finish` is queued before the
        overflow flags are read, so the device runs on while the host
        waits.  `rows`: the samples' `_decode_rows_args`, where the caller
        has uploaded them already.  Both entropy decodes read only the
        bands of `decode_classes(resolution)`.

        Returns (the downloaded result, fallback): fallback is the sorted
        tuple of the frame indices that took the host entropy decode."""
        batch = len(samples)
        *rows, fallback = rows or self._decode_rows_args(samples, resolution)
        fallback = set(fallback)
        if len(fallback) == batch:
            return (_download(finish(self.host_entropy_decode(
                samples, resolution), slice(None))), tuple(range(batch)))
        coeffs, ovf = self.decode_coefficients(*rows, resolution)
        out = _download(finish(coeffs, slice(None)))
        fallback |= {int(i) for i in torch.nonzero(ovf.cpu()).flatten()}
        fallback = tuple(sorted(fallback))
        if fallback:
            host = self.host_entropy_decode([samples[i] for i in fallback],
                                            resolution)
            out[list(fallback)] = _download(finish(host, list(fallback)))
        return out, fallback

    def decode_batch_device(self, samples: list[bytes], frame_index: int = 0,
                            output: str | None = None, develop=None,
                            resolution: int = 1, then=None):
        """Decode CFHD samples with the band entropy decode, the inverse
        DWT and the output on the device; the host only walks sample
        headers and copies payloads.  The output, `develop` and
        `resolution` are `decode_batch`'s; a reduced resolution
        entropy-decodes only the bands it reads.  `then`, where given, is
        a function of the decoded batch on the device (as `inverse_output`
        gives it) that runs there before the download: the decoder's
        geometry stage (a scale or a warp).

        Returns (frames, fallback): fallback is the sorted tuple of the
        frame indices that `decode_checked` decoded on the host entropy
        route instead (streams the device route does not take, or that
        overflow their device band region), byte-identical by the codec's
        own semantics."""
        output = self.decode_output(output, resolution)
        if develop is not None:
            develop = np.asarray(develop, np.float64).reshape(len(samples),
                                                              3, 4)

        def finish(coeffs, frames):
            out = self.inverse_output(
                coeffs, frame_index, output,
                None if develop is None else develop[frames], resolution)
            return out if then is None else then(out)

        return self.decode_checked(samples, finish, resolution=resolution)

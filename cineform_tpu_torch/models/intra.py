"""CFHD intra codec on a torch device: YUY2 4:2:2, RGB 4:4:4 (RG48) and
RGBA 4:4:4:4 (B64A, RG64) encode and decode.

Port of `cineform_tpu.models.intra.IntraCodec` on those paths.  The split
between device and host is the JAX package's:

- encode: the 3-level production DWT with quantization, one launch a
  level for all the channels, the bands written in the entropy coder's
  layout (kernels `ops.dwt_forward`; YUY2's level 1 reads the frames'
  bytes, the RGB formats' the planes that the plain `unpack_*` builds on
  the device), then per (wavelet level, channel group) the band entropy
  encoder (`entropy.device.encode_band_arrays`, kernels
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
  then the inverse DWT and the output: YUY2 with the reference's glibc
  output dither, or the 16-bit RG48 and b64a rows of the RGB formats.  A
  frame the device route does not take (wrong dimensions, a band with
  peaks or unaligned payload, a device overflow flag) is decoded by
  `decode_batch`, per frame.
- decode with host entropy (`decode_batch`): the host C++ entropy decoder
  (`entropy.native`, as the reference decodes on the CPU), then the same
  inverse and output on the device.

The samples equal the reference SDK's byte for byte (tests/golden).  Each
stage runs eagerly, once per call; there is no tracing or staging.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cineform_tpu_torch.bitstream import fastwalk, parse_sample
from cineform_tpu_torch.entropy import device as edev
from cineform_tpu_torch.entropy import device_decode as ddec
from cineform_tpu_torch.entropy import native as entropy_native
from cineform_tpu_torch.models import intra_host
from cineform_tpu_torch.ops import intra_transform as ops
from cineform_tpu_torch.ops.dwt_forward import (dwt_forward_groups,
                                                dwt_forward_planes,
                                                dwt_forward_yuy2)
from cineform_tpu_torch.spec import tags
from cineform_tpu_torch.spec.production import IntraParams
from cineform_tpu_torch.state import CodecTables, codec_tables

# The input formats the port encodes: the COLOR_FORMAT code of the sample
# header, the bytes of a frame row, and the encoded format
# (`Codec/encoder.c:2109-2135`):
#   YUV       = 10-bit 4:2:2, 3 channels (W, W/2, W/2)
#   RGB       = 12-bit 4:4:4, 3 full-width channels [G, R, B],
#               chroma_full_res
#   RGBA      = 12-bit 4:4:4:4 [G, R, B, A] (b64a: chroma tables stay
#               chroma)
#   RGBA_FULL = RG64 (chroma_full_res like RGB)
_DEVICE_FORMATS = {
    "YUY2": {"code": 2, "row_bytes": lambda w: 2 * w, "encoded": "YUV"},
    "RG48": {"code": 120, "row_bytes": lambda w: 6 * w, "encoded": "RGB"},
    "B64A": {"code": 30, "row_bytes": lambda w: 8 * w, "encoded": "RGBA"},
    "RG64": {"code": 121, "row_bytes": lambda w: 8 * w,
             "encoded": "RGBA_FULL"},
}

#: the decode outputs of each encoded format, the default first
_DECODE_OUTPUTS = {"YUV": ("YUY2",), "RGB": ("RG48", "b64a"),
                   "RGBA": ("b64a", "RG48"), "RGBA_FULL": ("b64a", "RG48")}


def _u16(x: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65535] -> int16 of the same bit patterns (the
    CPU build of torch lacks most uint16 ops; `_download` views them as
    uint16)."""
    return torch.where(x >= 32768, x - 65536, x).to(torch.int16)


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
    on one torch device: the card unless the caller asks for another."""

    width: int
    height: int
    quality: int
    device: torch.device | str = "cuda"
    input_format: str = "YUY2"

    def __post_init__(self):
        if self.input_format not in _DEVICE_FORMATS:
            raise NotImplementedError(
                f"input format {self.input_format!r}: the port encodes "
                f"{', '.join(_DEVICE_FORMATS)}; the other device formats "
                "are ROADMAP.md Queue 1 item 9")
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def encoded(self) -> str:
        return _DEVICE_FORMATS[self.input_format]["encoded"]

    @property
    def params(self) -> IntraParams:
        if self.encoded == "YUV":
            return IntraParams(width=self.width, height=self.height,
                               quality=self.quality)
        return IntraParams(width=self.width, height=self.height,
                           quality=self.quality,
                           precision=tags.PRECISION_12BIT,
                           chroma_full_res=self.encoded != "RGBA")

    @property
    def num_channels(self) -> int:
        return 3 if self.encoded in ("YUV", "RGB") else 4

    @property
    def groups(self) -> tuple[tuple[int, ...], ...]:
        """The channels by group of equal plane shape, each group one call
        of the DWT and of the entropy coder a level: 4:2:2's Y, then V and
        U; all the channels of RGB and RGBA."""
        if self.encoded == "YUV":
            return ((0,), (1, 2))
        return (tuple(range(self.num_channels)),)

    def plane_width(self, ch: int) -> int:
        if self.encoded == "YUV" and ch > 0:
            return self.width // 2
        return self.width

    @property
    def _write_sample_kwargs(self) -> dict:
        if self.encoded == "YUV":
            return {"input_format": self.input_format_code}
        common = {"input_format": self.input_format_code, "colorspace": None}
        if self.encoded == "RGB":
            return {**common, "encoded_format": tags.ENCODED_FORMAT_RGB_444}
        return {**common, "encoded_format": tags.ENCODED_FORMAT_RGBA_4444,
                "quality_high": 0x2000}

    @property
    def row_bytes(self) -> int:
        return _DEVICE_FORMATS[self.input_format]["row_bytes"](self.width)

    @property
    def input_format_code(self) -> int:
        return _DEVICE_FORMATS[self.input_format]["code"]

    def _unpack(self, frames: torch.Tensor):
        """(B, H, row_bytes) uint8 RGB frames -> the 12-bit channel
        planes, each (B, H, W) int32 (plain PyTorch)."""
        return {"RG48": ops.unpack_rg48, "B64A": ops.unpack_b64a,
                "RG64": ops.unpack_rg64}[self.input_format](frames)

    def tables(self, frame_index: int = 0) -> CodecTables:
        p = self.params
        return codec_tables(self.width, self.height, self.quality,
                            frame_index, device=self.device,
                            precision=p.precision,
                            chroma_full_res=p.chroma_full_res,
                            num_channels=self.num_channels)

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
        the RGB formats' the unpacked planes."""
        t = self.tables()

        def quants(k):
            return [t.band_quant[ch][k] for ch in range(self.num_channels)]

        if self.encoded == "YUV":
            levels = [dwt_forward_yuy2(frames, self.params.precision,
                                       t.prescale[0], quants(0))]
            for k in (1, 2):
                levels.append(dwt_forward_groups(levels[-1][0],
                                                 t.prescale[k], quants(k)))
            return levels
        x = torch.stack(self._unpack(frames), dim=1)
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
            samples.append(intra_host.write_sample(
                channels, p, frame_numbers[i], metadata[i],
                **self._write_sample_kwargs))
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
                     metadata=None, frame_numbers: list[int] | None = None
                     ) -> list[bytes]:
        """Encode with the transform on the device and the entropy coding
        on the host (C++ coder)."""
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
            samples.append(intra_host.write_sample(
                channels, p, frame_numbers[i], metadata[i],
                **self._write_sample_kwargs))
        return samples

    # --- decode ------------------------------------------------------------

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

    def _row16u_planes(self, coeffs):
        """Per-channel Row16u reconstruction (the deep paths take no
        lowpass offset, `decoder.c:12296-12319`): (B, H, W) int32 planes
        of uint16 values."""
        p = self.params
        return [ops.h26_inverse_to_row16u(
            *ops.inverse_channel_strips(lowpass, bands, p.prescale),
            p.precision) for lowpass, bands in coeffs]

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

    def decode_output(self, output: str | None) -> str:
        """The decode output `output` names, checked, or the format's
        default: YUY2 for YUY2 sources, RG48 for RGB, b64a for RGBA."""
        outputs = _DECODE_OUTPUTS[self.encoded]
        if output is None:
            return outputs[0]
        if output not in outputs:
            raise ValueError(f"decode output {output!r}: a {self.input_format}"
                             f" source decodes to {', '.join(outputs)}")
        return output

    def inverse_output(self, coeffs, frame_index: int = 0,
                       output: str | None = None) -> torch.Tensor:
        """Per-channel (lowpass, bands) -> the decoded batch on the device:
        (B, H, 2W) uint8 YUY2 with the output dither of `frame_index`, or
        the 16-bit RG48 (B, H, 3W) and b64a (B, H, 4W) rows as int16 bit
        patterns."""
        output = self.decode_output(output)
        if output == "YUY2":
            return self.inverse(coeffs, frame_index)
        if output == "RG48":
            return _u16(self.inverse_rg48(coeffs))
        return _u16(self.inverse_b64a(coeffs))

    def host_entropy_decode(self, samples: list[bytes]):
        """Parse the samples and entropy-decode every band on the host (C++
        decoder); returns the batched per-channel (lowpass, bands) int32
        tensors on the device."""
        per_frame = []
        for sample in samples:
            s = parse_sample(sample)
            chans = []
            for c in s.channels:
                bands: list[dict] = [dict() for _ in range(3)]
                for b in c.bands:
                    widx = 2 - (b.subband - 1) // 3
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
                               for k in range(3)]))
            per_frame.append(chans)

        def batched(arrays):
            return torch.from_numpy(
                np.stack(arrays).astype(np.int32)).to(self.device)

        return [(batched([f[ch][0] for f in per_frame]),
                 [tuple(batched([f[ch][1][k][b] for f in per_frame])
                        for b in range(3)) for k in range(3)])
                for ch in range(self.num_channels)]

    def decode_batch(self, samples: list[bytes], frame_index: int = 0,
                     output: str | None = None) -> np.ndarray:
        """Decode CFHD samples with the host C++ entropy decoder, then the
        inverse and the output on the device: (B, H, 2W) uint8 YUY2, or
        (B, H, 3W) RG48 or (B, H, 4W) b64a uint16 rows (`output`, by
        default the source format's).

        frame_index positions the YUY2 output dither within the decoder
        process's rand stream (a sequential decoder passes 0, 1, 2, ...)."""
        output = self.decode_output(output)
        coeffs = self.host_entropy_decode(samples)
        return _download(self.inverse_output(coeffs, frame_index, output))

    # --- decode on the device: entropy + inverse transform -----------------

    @property
    def _DECODE_CLASSES(self):
        """Band row classes (wavelet index k, plane channels); k indexes
        band dims plane >> (k + 1).  4:2:2 luma and chroma differ in width,
        so they decode as separate classes; the RGB formats' channels
        share one class a level."""
        return tuple((k, planes) for k in range(3) for planes in self.groups)

    #: floor of a class's row capacity in 32-bit chunks; capacities double
    #: from here to fit the class's longest band payload
    MIN_ROW_CHUNKS = 256

    def _class_dims(self, k: int, planes: tuple[int, ...]):
        bh = self.height >> (k + 1)
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

    def decode_coefficients(self, pays, nchs, qns, lins, lowpass):
        """Per-class band payload rows on the device -> (per-channel
        (lowpass, bands) as `inverse` takes them, (B,) overflow flags)."""
        coeffs_by = {}
        ovfs = []
        for ci, (k, planes) in enumerate(self._DECODE_CLASSES):
            co, ovf = self._decode_class_program(pays[ci], nchs[ci], qns[ci],
                                                 lins[ci], ci)
            for pi, ch in enumerate(planes):
                coeffs_by[(ch, k)] = tuple(co[:, pi, b] for b in range(3))
            ovfs.append(ovf)
        coeffs = [(lowpass[ch], [coeffs_by[(ch, k)] for k in range(3)])
                  for ch in range(self.num_channels)]
        return coeffs, torch.stack(ovfs).any(dim=0)

    def _decode_device_program(self, pays, nchs, qns, lins, lowpass,
                               frame_index: int = 0,
                               output: str | None = None):
        """Per-class band payload rows on the device -> (the decoded batch
        as `inverse_output` gives it, (B,) overflow flags), all on the
        device: band entropy decode feeding the inverse DWT and the output
        (`Codec/decoder.c:11584` DecodeSampleIntraFrame)."""
        coeffs, ovf = self.decode_coefficients(pays, nchs, qns, lins, lowpass)
        return self.inverse_output(coeffs, frame_index, output), ovf

    def _decode_rows_host(self, samples: list[bytes]):
        """Host header walk: samples -> per-class row tensors on the host
        (pinned when the codec's device is CUDA).

        Returns (pays, nchs, qns, lins, lowpass, fallback): 6-tuples of
        (R, S*4) uint8 / (R,) int32 tensors, one per _DECODE_CLASSES class
        (rows ordered frame, channel, band), the lowpass planes (B, lh, lw)
        int32 with the decoder's lowpass bias, and the set of frame
        indices the device route does not take (wrong dimensions, a band
        outside subbands 1-9, with peaks or with an unaligned payload);
        those frames get empty rows.  The native walker finds the bands in
        one C pass per sample and copies their payloads straight into the
        row buffers."""
        batch = len(samples)
        pin = self.device.type == "cuda"
        nch = self.num_channels
        lh = self.height >> 3
        lws = tuple(self.plane_width(ch) >> 3 for ch in range(nch))
        #: (ch, k, band, i) -> (data_off, data_len, quant, lin)
        parts: dict = {}
        walks: list = [None] * batch
        fallback = set()
        for i, sample in enumerate(samples):
            r = fastwalk.walk(sample)
            if r is None or (r.width, r.height) != (self.width, self.height) \
                    or r.nchannels != nch or 0 in r.lowpass_off \
                    or r.lowpass_h != (lh,) * nch or r.lowpass_w != lws:
                fallback.add(i)
                continue
            walks[i] = r
            for (ch, bandno, subband), (off, ln, q, lin, fl) in \
                    r.bands.items():
                if not 1 <= subband <= 9 or fl & 1 or ln % 4:
                    fallback.add(i)
                    break
                parts[(ch, 2 - (subband - 1) // 3, bandno, i)] = \
                    (off, ln, q, lin)
            if i not in fallback and any(
                    (ch, k, band, i) not in parts for ch in range(nch)
                    for k in range(3) for band in (1, 2, 3)):
                fallback.add(i)
        live = [i for i in range(batch) if i not in fallback]

        pays, nchs, qns, lins = [], [], [], []
        for k, planes in self._DECODE_CLASSES:
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
            # the 8-bit YUY2 output's bias; the deep RGB paths take none
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

    def _decode_rows_args(self, samples: list[bytes]):
        """`_decode_rows_host` with its tensors uploaded to the device."""
        return self._upload_rows(self._decode_rows_host(samples))

    def decode_batch_device(self, samples: list[bytes], frame_index: int = 0,
                            output: str | None = None):
        """Decode CFHD samples with the band entropy decode, the inverse
        DWT and the output on the device; the host only walks sample
        headers and copies payloads.  The output is `decode_batch`'s.

        Returns (frames, fallback): fallback is the sorted tuple of the
        frame indices that `decode_batch` decoded instead (streams the
        device route does not take, or that overflow their device band
        region), byte-identical by the codec's own semantics."""
        output = self.decode_output(output)
        batch = len(samples)
        *rows, fallback = self._decode_rows_args(samples)
        if len(fallback) == batch:
            return (self.decode_batch(samples, frame_index, output),
                    tuple(range(batch)))
        out, ovf = self._decode_device_program(*rows, frame_index, output)
        out = _download(out)
        fallback |= {int(i) for i in torch.nonzero(ovf.cpu()).flatten()}
        fallback = tuple(sorted(fallback))
        if fallback:
            host = self.decode_batch([samples[i] for i in fallback],
                                     frame_index, output)
            for j, i in enumerate(fallback):
                out[i] = host[j]
        return out, fallback

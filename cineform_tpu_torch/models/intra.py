"""CFHD intra codec on a torch device: YUY2 4:2:2 encode and decode.

Port of `cineform_tpu.models.intra.IntraCodec` on its YUY2 path.  The
split between device and host is the JAX package's:

- encode: YUY2 unpack and the 3-level production DWT with quantization
  (kernel `ops.dwt_forward`), then per (wavelet level, channel group) the
  band entropy encoder (`entropy.device.encode_band_arrays`, kernels
  `ops.chunk_pack` and `ops.merge_network`) on the device; the host
  appends band-end codes (`finish_band_bytes`) and writes the CFHD sample
  (`intra_host.write_sample`).  A band that overflows its device capacity
  is re-encoded on the host, byte-exactly.
- decode: the host C++ entropy decoder (`entropy.native`, as the reference
  decodes on the CPU), then on the device the inverse DWT with the
  reference's glibc output dither and the YUY2 pack.

The samples equal the reference SDK's byte for byte (tests/golden).  Each
stage runs eagerly, once per call; there is no tracing or staging.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from cineform_tpu.bitstream import parse_sample
from cineform_tpu.models import intra_host
from cineform_tpu.spec import tags
from cineform_tpu.spec.production import IntraParams
from cineform_tpu_torch.entropy import device as edev
from cineform_tpu_torch.ops import intra_transform as ops
from cineform_tpu_torch.ops.dwt_forward import dwt_forward_level
from cineform_tpu_torch.state import CodecTables, codec_tables


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
    """An intra codec for one (width, height, quality) YUY2 config on one
    torch device."""

    width: int
    height: int
    quality: int
    device: torch.device
    input_format: str = "YUY2"

    def __post_init__(self):
        if self.input_format != "YUY2":
            raise NotImplementedError(
                f"input format {self.input_format!r}: the port encodes YUY2 "
                "only; the other device formats are ROADMAP.md Queue 1 "
                "item 9")
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def params(self) -> IntraParams:
        return IntraParams(width=self.width, height=self.height,
                           quality=self.quality)

    def plane_width(self, ch: int) -> int:
        return self.width // 2 if ch > 0 else self.width

    @property
    def _write_sample_kwargs(self) -> dict:
        return {"input_format": tags.COLOR_FORMAT_YUYV}

    def tables(self, frame_index: int = 0) -> CodecTables:
        return codec_tables(self.width, self.height, self.quality,
                            frame_index, device=self.device)

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        """(B, H, 2W) uint8 host frames -> a tensor on the device."""
        if frames.shape[1:] != (self.height, 2 * self.width):
            raise ValueError(f"frames of shape {frames.shape}: expected "
                             f"(B, {self.height}, {2 * self.width}) YUY2")
        return torch.from_numpy(np.array(frames, np.uint8)).to(self.device)

    # --- encode ------------------------------------------------------------

    def forward(self, frames: torch.Tensor):
        """(B, H, 2W) uint8 YUY2 on the device -> per-channel (lowpass,
        [(LH, HL, HH)] finest first), int32."""
        t = self.tables()
        out = []
        for ch, plane in enumerate(ops.unpack_yuy2(frames,
                                                   self.params.precision)):
            ll = plane.contiguous()
            bands = []
            for k in range(3):
                ll, highs = dwt_forward_level(ll, t.prescale[k],
                                              t.band_quant[ch][k])
                bands.append(highs)
            out.append((ll, bands))
        return out

    def _band_groups(self, coeffs) -> list[list[int]]:
        """Group channels of equal band shape (the chroma pair of 4:2:2) so
        each distinct band shape runs the entropy coder once."""
        groups: list[list[int]] = []
        for ch in range(len(coeffs)):
            shape = coeffs[ch][1][0][0].shape[-2:]
            if groups and coeffs[groups[-1][0]][1][0][0].shape[-2:] == shape:
                groups[-1].append(ch)
            else:
                groups.append([ch])
        return groups

    @staticmethod
    def group_bands(coeffs, k: int, grp: list[int]) -> torch.Tensor:
        """The level-k bands of a channel group as the entropy coder's
        input: (B, G, 3, h * pitch) int32, each band's rows zero-padded to
        the band pitch the reference entropy-codes."""
        h, w = coeffs[grp[0]][1][k][0].shape[-2:]
        pitch = intra_host.align16_pixels(w)
        trios = torch.stack([torch.stack(coeffs[ch][1][k], dim=1)
                             for ch in grp], dim=1)
        trios = F.pad(trios, (0, pitch - w))
        return trios.reshape(trios.shape[0], len(grp), 3, h * pitch)

    def forward_packed(self, frames: torch.Tensor, cap_bits: int = 8):
        """(B, H, 2W) uint8 YUY2 on the device -> per-channel (lowpass,
        [(words, total_bits, overflow)] per level, each (B, 3, ...)): the
        complete CFHD band bitstreams (without band-end codes) on the
        device."""
        coeffs = self.forward(frames)
        groups = self._band_groups(coeffs)
        packed_by_ch: list[list] = [[] for _ in coeffs]
        for k in range(3):
            for grp in groups:
                words, nbits, ovf = edev.encode_band_arrays(
                    self.group_bands(coeffs, k, grp), codeset=17,
                    cap_bits_per_elem=cap_bits)
                for gi, ch in enumerate(grp):
                    packed_by_ch[ch].append((words[:, gi], nbits[:, gi],
                                             ovf[:, gi]))
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
        finish each band's bytes and write the samples.  Frames with an
        overflowed band have their coefficients recomputed on the host for
        the C++ coder."""
        from cineform_tpu.ref import intra as xf

        p = self.params
        result = [(lowpass.cpu().numpy(),
                   [(w.cpu().numpy(), n.cpu().numpy(), o.cpu().numpy())
                    for w, n, o in levels])
                  for lowpass, levels in packed]
        batch = frames.shape[0]
        frame_numbers, metadata = self._frame_meta(
            batch, first_frame_number, frame_numbers, metadata)
        samples = []
        for i in range(batch):
            fallback = None
            channels = []
            for ch, (lowpass, levels) in enumerate(result):
                payloads = []
                for words, nbits, ovf in levels:
                    payloads.append(tuple(
                        None if ovf[i, b]             # host re-encode below
                        else edev.finish_band_bytes(words[i, b],
                                                    int(nbits[i, b]), 17)
                        for b in range(3)))
                plane_w = self.plane_width(ch)
                bands = [tuple(np.broadcast_to(
                    np.int32(0), (p.height >> (k + 1), plane_w >> (k + 1)))
                    for _ in range(3)) for k in range(len(levels))]
                if any(t is None for tr in payloads for t in tr):
                    # capacity overflow: recompute this frame's coefficients
                    # on the host for the C++ fallback coder
                    if fallback is None:
                        planes = xf.unpack_yuy2(
                            np.ascontiguousarray(frames[i]).tobytes(),
                            self.width, self.height, p.precision)
                        fallback = [intra_host.transform_channel(pl, p, c)
                                    for c, pl in enumerate(planes)]
                    bands = fallback[ch].bands
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
        """Encode (B, H, 2W) uint8 YUY2 frames to CFHD samples with the
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

    def host_entropy_decode(self, samples: list[bytes]):
        """Parse the samples and entropy-decode every band on the host (C++
        decoder); returns the batched per-channel (lowpass, bands) int32
        tensors on the device."""
        from cineform_tpu.entropy import native as entropy_native

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
                # (`Codec/decoder.c:12479`), as the host oracle and the
                # JAX device decoder apply it
                lowpass = c.lowpass.astype(np.int32) + \
                    intra_host.lowpass_channel_offset(c.lowpass.shape[1])
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
                for ch in range(3)]

    def decode_batch(self, samples: list[bytes],
                     frame_index: int = 0) -> np.ndarray:
        """Decode CFHD samples to (B, H, 2W) uint8 YUY2 frames.

        frame_index positions the output dither within the decoder
        process's rand stream (a sequential decoder passes 0, 1, 2, ...)."""
        coeffs = self.host_entropy_decode(samples)
        return self.inverse(coeffs, frame_index).cpu().numpy()

"""Two-frame GOP (FIELDPLUS) codec on a torch device: YUY2 frame pairs to
CFHD GROUP samples and back.

Port of `cineform_tpu.models.gop.GopCodec`.  The split between device and
host is the JAX package's, but for the decode of the temporal-high LL:

- encode: level 1 of each frame from the YUY2 bytes (`dwt_forward_yuy2`,
  one launch a frame for Y, V, U), the 2-2 temporal pair between the two
  lowpass buffers (plain PyTorch), then one `dwt_forward_groups` launch
  for each of the three spatial wavelets of the group: w3 of the temporal
  high with the narrow-row quirk's row-0 carry, w4 of the temporal low
  with prescale 2, w5 of w4's LL.  Five DWT launches a batch.  An
  interlaced codec (`progressive=False`) takes w0 and w1 from the
  HORZTEMP frame wavelet of each frame instead (`ops.intra_transform.
  frame_wavelet_forward`, plain PyTorch: the row-pair temporal, the
  horizontal 2-6, the delta-coded HL), with the interlaced quantizers;
  three DWT launches a batch.  The host codes the bands with the C++
  coder and writes the GROUP samples (`gop_host.write_group`).
- decode (`decode`): a group's coefficients, then each frame and output
  from them.  The device route: the host walks the sample headers and
  copies the band payloads into row buffers, and reads the temporal-high
  LL (subband 7, a raw 16-bit band) as it reads the lowpass; on the
  device the band entropy decoder (`entropy.device_decode.
  decode_band_rows`, kernels `merge_network_tgt` and
  `merge_network_highfirst`) decodes the other fifteen bands in six row
  classes.  The JAX function sends every frame that holds a 16-bit band
  to the host, so none of the reference's groups decodes on its device.
  The host route (`host_coefficients`): the host C++ entropy decoder
  (codesets 17 and 18), the peaks substitution and the raw 16-bit bands.
  From either, `inverse` makes frame 0 or 1: the FIELDPLUS pyramid (w5
  and w3 with the stale bottom taps, w4 with descale 2) and the temporal
  combine, then the 8-bit YUY2 output with the reference's glibc dither
  (an interlaced group's through the HORZTEMP frame-wavelet inverse) or
  a deep or RGB output.

A group the device route does not take (wrong dimensions, interlaced, not
10-bit, a band with peaks or an unaligned payload, a 16-bit band in a
subband other than 7, a device overflow flag) takes the host route and is
listed in the fallback `decode` returns.  Each output equals the JAX
package's `gop_host.decode_group` or `decode_group_to` byte for byte, and
the samples equal the reference encoder's.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from cineform_tpu_torch.bitstream import parse_sample
from cineform_tpu_torch.entropy import device_decode as ddec
from cineform_tpu_torch.entropy import native as entropy_native
from cineform_tpu_torch.models import gop_host, intra_host
from cineform_tpu_torch.models.intra import _download
from cineform_tpu_torch.ops import bgra
from cineform_tpu_torch.ops import intra_transform as ops
from cineform_tpu_torch.ops import yuv_output as yout
from cineform_tpu_torch.ops.dwt_forward import (dwt_forward_groups,
                                                dwt_forward_yuy2,
                                                group_layout)
from cineform_tpu_torch.ref import gop as gxf
from cineform_tpu_torch.spec import tags
from cineform_tpu_torch.state import dither_rows
from cineform_tpu_torch.utils import timing

#: the channels by group of equal plane shape: Y, then V and U
GROUPS = ((0,), (1, 2))
#: a group's deep and RGB outputs (`gop_host.decode_group_to`), by the
#: JAX package's fourcc names; `inverse` also makes YUY2
OUTPUTS = ("YU64", "v210", "RG48", "BGRA", "b64a", "r210", "DPX0", "RG30")


@lru_cache(maxsize=16)
def _dither(height: int, frame_index: int, interlaced: bool,
            device: torch.device) -> torch.Tensor:
    """The output dither draws of the n-th decoded frame on `device`: (H,
    16) per row, or (H/2, 16) per row pair for an interlaced group."""
    rows = (gxf.interlaced_dither_rows(height, frame_index) if interlaced
            else dither_rows(height, frame_index))
    return torch.from_numpy(rows.astype(np.int32)).to(device)


def _raw16(band) -> np.ndarray:
    """A raw 16-bit band's big-endian values times its quantization."""
    raw = np.frombuffer(band.data[:band.width * band.height * 2], ">i2")
    return raw.reshape(band.height, band.width).astype(np.int32) \
        * band.quantization


@dataclass(frozen=True)
class Coefficients:
    """A batch of groups' coefficients on the device, as `GopCodec.inverse`
    takes them: per channel (lowpass with the progressive load bias,
    {wavelet k: bands by slot}, w3's LL first among its bands), and the
    groups' scan and precision."""

    channels: list
    progressive: bool = True
    precision: int = tags.PRECISION_10BIT


@dataclass(frozen=True)
class GopCodec:
    """A FIELDPLUS group codec for one (width, height, quality) on one
    torch device: the card unless the caller asks for another.
    `progressive` is the encode's: False encodes interlaced pairs; a
    decode reads it from each sample."""

    width: int
    height: int
    quality: int = 4
    device: torch.device | str = "cuda"
    progressive: bool = True

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))

    def band_quant(self, channel: int) -> dict:
        return gxf.fieldplus_band_quant(self.quality, tags.PRECISION_10BIT,
                                        channel, self.progressive)

    def _quants(self, k: int):
        """Wavelet k's (LH, HL, HH) quantizers of Y, V, U."""
        return [self.band_quant(ch)[k][-3:] for ch in range(3)]

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        shape = (self.height, 2 * self.width)
        if frames.shape[1:] != shape:
            raise ValueError(f"frames of shape {frames.shape}: expected "
                             f"(B, {shape[0]}, {shape[1]}) YUY2")
        return torch.from_numpy(np.array(frames, np.uint8)).to(self.device)

    # --- encode ------------------------------------------------------------

    def forward_levels(self, frames0: torch.Tensor, frames1: torch.Tensor):
        """(B, H, 2W) uint8 YUY2 pairs on the device -> {wavelet k: (lows,
        highs)} by channel group (Y, then V and U): lows (B, G, h, w),
        highs (B, G, 3, h, pitch) the quantized (LH, HL, HH) in the
        entropy coder's layout.  w3's lows are its coded LL (quantizer 1,
        the identity)."""
        pre = tags.PRECISION_10BIT
        level1 = dwt_forward_yuy2 if self.progressive else \
            self._frame_wavelets
        levels = {k: level1(f, pre, 0, self._quants(k))
                  for k, f in ((0, frames0), (1, frames1))}
        (l0, _), (l1, _) = levels[0], levels[1]
        tlow = tuple(ops.sat16(a + b) for a, b in zip(l0, l1))
        thigh = tuple(ops.sat16(b - a) for a, b in zip(l0, l1))
        levels[3] = dwt_forward_groups(thigh, 0, self._quants(3),
                                       self.row0_carry(tlow, thigh))
        levels[4] = dwt_forward_groups(tlow, 2, self._quants(4))
        levels[5] = dwt_forward_groups(levels[4][0], 0, self._quants(5))
        return levels

    @staticmethod
    def _frame_wavelets(frames, precision, prescale, quants):
        """An interlaced group's frame wavelet w0 or w1 of (B, H, 2W) uint8
        YUY2 frames, as `dwt_forward_yuy2` lays out a spatial level 1:
        (lows, highs) by channel group (`ops.frame_wavelet_forward` of Y,
        V and U, the HL band delta-coded)."""
        outs = [ops.frame_wavelet_forward(p, q) for p, q in zip(
            ops.unpack_yuy2(frames, precision), quants)]
        lows = (outs[0][0][:, None],
                torch.stack([outs[1][0], outs[2][0]], dim=1))
        return lows, (group_layout([outs[0][1]]),
                      group_layout([outs[1][1], outs[2][1]]))

    @staticmethod
    def row0_carry(tlow, thigh):
        """w3's row-0 carry for each group: w3's input is band 1 of the
        reference's two-band temporal wavelet, so in the narrow-row quirk
        (widths <= 16 that are multiples of 8, the only planes that read
        it) its row-0 overread lands on band 0's (the temporal lowpass')
        last two pixels, where band 0's region is exactly cache-line
        sized, and on zeros elsewhere (None)."""
        return tuple(lo[:, :, -1, -2:].contiguous()
                     if hi.shape[-1] <= 16 and hi.shape[-1] % 8 == 0
                     and (2 * hi.shape[-1] * hi.shape[-2]) % 64 == 0
                     else None for lo, hi in zip(tlow, thigh))

    @staticmethod
    def _channels(levels):
        """`forward_levels`' buffers (tensors or arrays) -> per-channel
        (lowpass, bands): bands[k] w0/w1/w4/w5 (LH, HL, HH), w3 (LL, LH,
        HL, HH), views into the buffers."""
        out = []
        for g, grp in enumerate(GROUPS):
            for i in range(len(grp)):
                bands = {}
                for k, (lows, highs) in levels.items():
                    w = lows[g].shape[-1]
                    bands[k] = tuple(highs[g][:, i, b, :, :w]
                                     for b in range(3))
                bands[3] = (levels[3][0][g][:, i],) + bands[3]
                out.append((levels[5][0][g][:, i], bands))
        return out

    def forward(self, frames0: torch.Tensor, frames1: torch.Tensor):
        """(B, H, 2W) uint8 YUY2 pairs on the device -> per-channel
        (lowpass, bands dict), as the JAX `GopCodec.forward` gives them."""
        return self._channels(self.forward_levels(frames0, frames1))

    def write_groups(self, levels, first_frame_number: int = 1,
                     metadata=None,
                     frame_numbers: list[int] | None = None) -> list[bytes]:
        """Host tail of the encode: download `forward_levels`' buffers,
        code the bands with the C++ coder and write the GROUP samples.
        `metadata` may be one EncoderMetadata or one per group."""
        host = {k: tuple(tuple(t.cpu().numpy() for t in part)
                         for part in level) for k, level in levels.items()}
        coeffs = self._channels(host)
        batch = coeffs[0][0].shape[0]
        if frame_numbers is None:
            frame_numbers = [first_frame_number + i for i in range(batch)]
        if not isinstance(metadata, (list, tuple)):
            metadata = [metadata] * batch
        quants = [self.band_quant(ch) for ch in range(3)]
        return [gop_host.write_group(
            [(lowpass[i], {k: tuple(b[i] for b in bs)
                           for k, bs in bands.items()}, quants[ch])
             for ch, (lowpass, bands) in enumerate(coeffs)],
            self.width, self.height, self.quality, frame_numbers[i],
            metadata[i], self.progressive) for i in range(batch)]

    def encode_batch(self, frames0: np.ndarray, frames1: np.ndarray,
                     first_frame_number: int = 1, metadata=None,
                     frame_numbers: list[int] | None = None) -> list[bytes]:
        """Encode (B, H, 2W) uint8 YUY2 frame pairs to GROUP samples, the
        transform on the device and the entropy coding on the host."""
        return self.write_groups(
            self.forward_levels(self._upload(frames0),
                                self._upload(frames1)),
            first_frame_number, metadata, frame_numbers)

    # --- decode: the coefficients, then the frames from them --------------

    def _is_group(self, s) -> bool:
        """Whether a parsed sample is a GROUP sample of the codec's size."""
        return ((s.width, s.height) == (self.width, self.height)
                and len(s.channels) == 3
                and s.transform_type == tags.TRANSFORM_TYPE_FIELDPLUS)

    def _parse(self, sample: bytes):
        s = parse_sample(sample)
        if not self._is_group(s):
            raise ValueError(f"not a {self.width}x{self.height} GROUP "
                             "sample of three channels")
        return s

    @staticmethod
    def _lowpass(c) -> np.ndarray:
        """A channel's lowpass with the decoder's load bias of the
        progressive 8-bit models (`inverse` adds the other outputs')."""
        return c.lowpass.astype(np.int32) + intra_host.lowpass_channel_offset(
            c.lowpass.shape[1], num_frames=2)

    @staticmethod
    def _host_bands(c, peaks: bool) -> dict:
        """A channel's bands, entropy-decoded and dequantized on the host
        (C++ decoder, codesets 17 and 18), the peaks substituted where
        `peaks` (the deep outputs' decode, as the JAX package's, leaves
        them), the raw 16-bit bands read: {wavelet k: bands by slot}."""
        bands: dict[int, dict] = {0: {}, 1: {}, 3: {}, 4: {}, 5: {}}
        for b in c.bands:
            if b.subband in (0, 255):
                continue
            widx, slot = gop_host.SUBBAND_MAP[b.subband]
            if b.encoding == tags.BAND_ENCODING_16BIT:
                bands[widx][slot] = _raw16(b)
                continue
            pitch = intra_host.align16_pixels(b.width)
            vals, _ = entropy_native.decode_band(
                b.data, pitch * b.height,
                codeset=18 if b.coding_flags == 18 else 17,
                quant=b.quantization)
            vals = vals.reshape(b.height, pitch)[:, :b.width]
            if peaks and b.peaks is not None and b.peak_level:
                # peaks substitution (`Codec/decoder.c:19808`
                # DecodeBandFSM16sNoGapWithPeaks): decoded values beyond
                # PEAK_LEVEL take the next value of the band's peak table,
                # in raster order, as (peak / quant) * quant with C
                # truncating division; a truncated table bounds the count
                mask = np.abs(vals) > b.peak_level
                flat = vals[mask]
                n = min(flat.size, b.peaks.size)
                q = b.quantization
                pk = b.peaks[:n].astype(np.int32)
                flat[:n] = (np.abs(pk) // q) * np.sign(pk) * q
                vals = vals.copy()
                vals[mask] = flat
            bands[widx][slot] = vals
        return {k: tuple(v[i] for i in sorted(v)) for k, v in bands.items()}

    def host_coefficients(self, samples: list[bytes], output: str = "YUY2"):
        """GROUP samples -> their coefficients on the device by the host
        route: the C++ entropy decoder, the raw 16-bit bands, the peaks
        substituted for YUY2 (the reference's 8-bit decode) and left for
        the deep and RGB outputs (as the JAX package's deep decode leaves
        them).  Returns [(indices, Coefficients)], one entry for each scan
        and precision among the samples, in the order of their first
        sample."""
        parsed = [self._parse(x) for x in samples]
        parts = []
        for key in dict.fromkeys((s.progressive, s.precision)
                                 for s in parsed):
            idx = [i for i, s in enumerate(parsed)
                   if (s.progressive, s.precision) == key]
            per_group = [[(self._lowpass(c), self._host_bands(
                c, output == "YUY2")) for c in parsed[i].channels]
                for i in idx]

            def batched(arrays):
                return torch.from_numpy(np.stack(arrays)).to(self.device)

            channels = [(batched([g[ch][0] for g in per_group]),
                         {k: tuple(batched([g[ch][1][k][s]
                                            for g in per_group])
                                   for s in range(len(bs)))
                          for k, bs in per_group[0][ch][1].items()})
                        for ch in range(3)]
            parts.append((idx, Coefficients(channels, *key)))
        return parts

    #: band-row classes of the 17-subband map (`Codec/decoder.c:11191`):
    #: entries (wavelet index, slot) as gop_host.SUBBAND_MAP gives them,
    #: level the band dims' shift (H >> level).  w3's LL (subband 7) is a
    #: raw band, read by the host walk.
    _LEVEL_ENTRIES = {
        1: ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)),
        2: ((3, 1), (3, 2), (3, 3), (4, 0), (4, 1), (4, 2)),
        3: ((5, 0), (5, 1), (5, 2)),
    }
    _DECODE_CLASSES = tuple((lvl, planes) for lvl in (1, 2, 3)
                            for planes in GROUPS)

    def _class_dims(self, lvl: int, planes: tuple[int, ...]):
        plane_w = self.width if planes == (0,) else self.width // 2
        bw = plane_w >> lvl
        return self.height >> lvl, bw, intra_host.align16_pixels(bw)

    def _decode_rows_host(self, samples: list[bytes]):
        """Host header walk: GROUP samples -> per-class row tensors on the
        host (pinned when the codec's device is CUDA).

        Returns (pays, nchs, qns, lins, lowpass, ll3, fallback): 6-tuples
        of (R, S*4) uint8 / (R,) int32 tensors, one per _DECODE_CLASSES
        class (rows ordered frame, channel, entry), the lowpass planes (B,
        lh, lw) with the decoder's load bias and w3's raw LL (B, h, w)
        int32 by channel, and the set of frame indices the device route
        does not take (another size, interlaced, not of the 10-bit
        precision the deep outputs assume, a band it cannot decode);
        those frames get empty rows."""
        batch = len(samples)
        pin = self.device.type == "cuda"
        parts: dict = {}
        lowpass = [[None] * batch for _ in range(3)]
        ll3 = [[None] * batch for _ in range(3)]
        fallback = set()
        for i, sample in enumerate(samples):
            s = parse_sample(sample)
            if not self._is_group(s) or not s.progressive or \
                    s.precision != tags.PRECISION_10BIT:
                fallback.add(i)
                continue
            for ch, c in enumerate(s.channels):
                lowpass[ch][i] = self._lowpass(c)
                for b in c.bands:
                    if b.subband in (0, 255):
                        continue
                    raw = b.encoding == tags.BAND_ENCODING_16BIT
                    if b.subband == 7 and raw:
                        ll3[ch][i] = _raw16(b)
                        continue
                    if raw or b.peaks is not None or len(b.data) % 4:
                        fallback.add(i)
                        continue
                    widx, slot = gop_host.SUBBAND_MAP[b.subband]
                    parts[(ch, widx, slot, i)] = (
                        b.data, b.quantization,
                        1 if b.coding_flags == 18 else 0)
            if i not in fallback and any(
                    ll3[ch][i] is None or (ch, widx, slot, i) not in parts
                    for ch in range(3)
                    for entries in self._LEVEL_ENTRIES.values()
                    for widx, slot in entries):
                fallback.add(i)
        live = [i for i in range(batch) if i not in fallback]

        classes = []
        for lvl, planes in self._DECODE_CLASSES:
            rows = [(b"", 1, 0) if i in fallback
                    else parts[(ch, widx, slot, i)]
                    for i in range(batch) for ch in planes
                    for widx, slot in self._LEVEL_ENTRIES[lvl]]
            bufs = ddec.row_buffers([(len(d), q, li) for d, q, li in rows],
                                    pin)
            buf = bufs[0].numpy()
            for r, (d, _, _) in enumerate(rows):
                buf[r, :len(d)] = np.frombuffer(d, np.uint8)
            classes.append(bufs)

        def planes_of(arrays, h, w):
            t = torch.zeros((batch, h, w), dtype=torch.int32, pin_memory=pin)
            for i in live:
                t[i] = torch.from_numpy(arrays[i])
            return t

        lws = (self.width >> 3, self.width >> 4)
        lp = tuple(planes_of(lowpass[ch], self.height >> 3, lws[ch > 0])
                   for ch in range(3))
        w3 = tuple(planes_of(ll3[ch], self.height >> 2,
                             (self.width >> 2) if ch == 0
                             else (self.width >> 3)) for ch in range(3))
        return (*zip(*classes), lp, w3, fallback)

    def _decode_rows_args(self, samples: list[bytes]):
        """`_decode_rows_host` with its tensors uploaded to the device."""
        with timing.span("gop.decode_rows_host", len(samples)):
            rows = self._decode_rows_host(samples)
        with timing.span("gop.upload_rows"):
            return ddec.upload_rows(rows, self.device)

    def decode_coefficients(self, pays, nchs, qns, lins, lowpass, ll3):
        """Per-class band payload rows on the device -> (the groups'
        Coefficients, (B,) overflow flags)."""
        bands_by = {}
        ovfs = []
        batch = lowpass[0].shape[0]
        with timing.span("gop.decode_coefficients", batch):
            for ci, (lvl, planes) in enumerate(self._DECODE_CLASSES):
                entries = self._LEVEL_ENTRIES[lvl]
                bh, bw, pitch = self._class_dims(lvl, planes)
                co, ovf = ddec.decode_band_rows(pays[ci], nchs[ci], qns[ci],
                                                lins[ci], nout=bh * pitch)
                co = co.reshape(batch, len(planes), len(entries), bh,
                                pitch)[..., :bw]
                for pi, ch in enumerate(planes):
                    for ei, (widx, slot) in enumerate(entries):
                        bands_by[(ch, widx, slot)] = co[:, pi, ei]
                ovfs.append(ovf.reshape(batch, -1).any(dim=1))
        channels = []
        for ch in range(3):
            b = {k: tuple(bands_by[(ch, k, s)] for s in range(3))
                 for k in (0, 1, 4, 5)}
            b[3] = (ll3[ch],) + tuple(bands_by[(ch, 3, s)] for s in (1, 2, 3))
            channels.append((lowpass[ch], b))
        return Coefficients(channels), torch.stack(ovfs).any(dim=0)

    @staticmethod
    def _pyramid(lowpass, b, frame: int):
        """One channel's lowpass and bands -> frame `frame`'s level-1 (LL,
        (LH, HL, HH)): w5 and w3 invert with the stale bottom taps
        (InvertSpatialQuantOverflowProtected16s), w4 with the standard
        ones and descale 2; the temporal combine saturates before its >> 1
        (InvertTemporalQuant16s, temporal.c:9676): frame 0 the temporal
        low minus the high with w0's bands, frame 1 the sum with w1's."""
        ll4 = ops.dwt2d_inverse(lowpass, *b[5], descale=1, bottom_shift=True)
        tlow = ops.dwt2d_inverse(ll4, *b[4], descale=2)
        thigh = ops.dwt2d_inverse(*b[3], descale=1, bottom_shift=True)
        return ops.sat16(tlow + thigh if frame else tlow - thigh) >> 1, \
            b[frame]

    def inverse(self, coeffs: Coefficients, output: str = "YUY2",
                frame: int = 0, dither: int = 0) -> torch.Tensor:
        """Groups' coefficients on the device -> frame `frame` (0 or 1) of
        each as `output`, on the device: the GOP pyramid (`_pyramid`),
        then

        - YUY2: the 8-bit output with the reference's glibc dither, the
          decoder's `dither`-th window (`Codec/decoder.c:11180`
          DecodeSampleGroup), through the final v26 strips and the 2-6
          horizontal inverse of a progressive group or the HORZTEMP frame
          wavelet's inverse of an interlaced one, packed (B, H, 2W) uint8;
        - `OUTPUTS` (`gop_host.decode_group_deep16`): every group through
          the progressive pyramid, the lowpass with the absolute offset
          (+14 for YU64 and v210, +48 for the others, +10 at odd widths),
          the v26 strips' Row16u rows (`h26_inverse_to_row16u`) at the
          groups' precision packed as `ops.yuv_output.pack` packs a 4:2:2
          intra frame's, or BGRA through `ops.bgra.strip_to_bgra`
          (`gop_host.decode_group_bgra`), rows bottom-up.  The 16-bit
          outputs as int16 bit patterns (B, H, row_bytes / 2), the others
          as uint8 rows, BGRA (B, H, W, 4).

        `coeffs` is left as it was."""
        yuy2 = output == "YUY2"
        if not yuy2 and output not in OUTPUTS:
            raise ValueError(f"a group decodes to YUY2, {', '.join(OUTPUTS)}"
                             f", not {output!r}")
        interlaced = yuy2 and not coeffs.progressive
        if yuy2:
            rows = _dither(self.height, dither, interlaced, self.device)
        planes = []
        for ch, (lowpass, b) in enumerate(coeffs.channels):
            if not yuy2 or interlaced:
                w = lowpass.shape[-1]
                lowpass = lowpass + (
                    intra_host.lowpass_offset_absolute(
                        w, output in yout.DEEP_YUV, num_frames=2)
                    - intra_host.lowpass_channel_offset(w, num_frames=2))
            ll, (lh, hl, hh) = self._pyramid(lowpass, b, frame)
            if interlaced:
                planes.append(ops.frame_wavelet_inverse(ll, lh, hl, hh, rows,
                                                        ch))
                continue
            low, high = ops.v26_inverse(ll, hl), ops.v26_inverse(lh, hh)
            if yuy2:
                width = 2 * ll.shape[-1]
                group = 16 if ch == 0 else 8
                planes.append(ops.h26_inverse_to_output(
                    low, high, 2, ops.expand_dither_rows(rows, width, group),
                    scalar_tail=group if width % (2 * group) == group
                    else 0))
            elif output == "BGRA":
                planes.append((low, high))
            else:
                planes.append(ops.h26_inverse_to_row16u(low, high,
                                                        coeffs.precision))
        if yuy2:
            return ops.pack_yuy2(*planes)
        if output == "BGRA":
            (yl, yh), (c1l, c1h), (c2l, c2h) = planes
            return bgra.strip_to_bgra(yl, yh, c2l, c2h, c1l, c1h,
                                      coeffs.precision).flip(-3)
        return yout.pack(output, *planes)

    def output_frame(self, coeffs: Coefficients, output: str = "YUY2",
                     frame: int = 0, dither: int = 0,
                     then=None) -> np.ndarray:
        """`inverse`, then `then` (a function of the frames on the device,
        or None) there, then the download.  `coeffs` is left as it was, so
        one decode serves both frames of its groups."""
        with timing.span("gop.inverse_to", coeffs.channels[0][0].shape[0]):
            frames = self.inverse(coeffs, output, frame, dither)
        return _download(frames if then is None else then(frames))

    def decode(self, samples: list[bytes], output: str = "YUY2",
               frame: int = 0, dither: int = 0, then=None):
        """Decode GROUP samples to frame `frame` as `output`, as
        `output_frame` makes it.  The groups the device route takes have
        their bands entropy-decoded on the device (the host only walks
        sample headers and copies payloads); the others, and those that
        overflow their device band region, take `host_coefficients`.

        Returns (frames, fallback, coeffs): fallback the sorted tuple of
        the indices of the groups that took the host route, coeffs the
        Coefficients the frames were made from where one route's made them
        all (always so for one group), else None."""
        batch = len(samples)
        out = held = None
        with timing.span("gop.decode", batch):
            *rows, fallback = self._decode_rows_args(samples)
            if len(fallback) < batch:
                held, ovf = self.decode_coefficients(*rows)
                out = self.output_frame(held, output, frame, dither, then)
                # read after the output's launches: no sync comes first
                fallback |= set(torch.nonzero(ovf.cpu()).flatten().tolist())
            fallback = tuple(sorted(fallback))
            parts = self.host_coefficients([samples[i] for i in fallback],
                                           output)
            for idx, coeffs in parts:
                frames = self.output_frame(coeffs, output, frame, dither,
                                           then)
                if out is None:
                    out = np.empty((batch, *frames.shape[1:]), frames.dtype)
                out[[fallback[i] for i in idx]] = frames
            if fallback:
                held = parts[0][1] if len(parts) == 1 and \
                    len(fallback) == batch else None
            # an event even at 0, so that a window reads 0.0
            timing.count("gop.group_decodes", batch)
            timing.count("gop.fallback_groups", len(fallback))
        return out, fallback, held

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
- decode on the device (`decode_batch_device`): the host walks the sample
  headers and copies the band payloads into row buffers, and reads the
  temporal-high LL (subband 7, a raw 16-bit band) as it reads the
  lowpass; on the device the band entropy decoder
  (`entropy.device_decode.decode_band_rows`, kernels
  `merge_network_tgt` and `merge_network_highfirst`) decodes the other
  fifteen bands in six row classes, then the FIELDPLUS pyramid (w5 and w3
  with the stale bottom taps, w4 with descale 2), the temporal combine
  and the 8-bit output with the reference's glibc dither, and the YUY2
  pack.  The JAX function sends every frame that holds a 16-bit band to
  the host, so none of the reference's groups decodes on its device.
- decode with host entropy (`decode_batch`): the host C++ entropy decoder
  (codesets 17 and 18), the peaks substitution and the raw 16-bit bands,
  then the same inverse on the device; interlaced groups take this route
  and end in the HORZTEMP frame-wavelet inverse.

A frame the device route does not take (wrong dimensions, interlaced, a
band with peaks or an unaligned payload, a 16-bit band in a subband other
than 7, a device overflow flag) is decoded by `decode_batch` and listed in
the fallback the route returns.  Each output equals the JAX package's
`gop_host.decode_group` byte for byte, and the samples equal the
reference encoder's.
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
#: JAX package's fourcc names; YUY2 and UYVY are `inverse`'s
OUTPUTS = ("YU64", "v210", "RG48", "BGRA", "b64a", "r210", "DPX0", "RG30")


@lru_cache(maxsize=16)
def _dither(height: int, frame_index: int, interlaced: bool,
            device: torch.device) -> torch.Tensor:
    """The output dither draws of the n-th decoded frame on `device`: (H,
    16) per row, or (H/2, 16) per row pair for an interlaced group."""
    rows = (gxf.interlaced_dither_rows(height, frame_index) if interlaced
            else dither_rows(height, frame_index))
    return torch.from_numpy(rows.astype(np.int32)).to(device)


def _count_groups(decoded: int, fallback: int) -> None:
    """The tracer's GOP counters of one device-route call: the groups it
    decoded and, of them, those `decode_batch` or `decode_batch_to`
    decoded instead (an event even at 0, so a window reads 0.0)."""
    timing.count("gop.group_decodes", decoded)
    timing.count("gop.fallback_groups", fallback)


def _raw16(band) -> np.ndarray:
    """A raw 16-bit band's big-endian values times its quantization."""
    raw = np.frombuffer(band.data[:band.width * band.height * 2], ">i2")
    return raw.reshape(band.height, band.width).astype(np.int32) \
        * band.quantization


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

    # --- decode: the inverse on the device ---------------------------------

    def inverse(self, coeffs, reference_compatible: bool = True,
                dither_base: int = 0, progressive: bool = True):
        """Per-channel (lowpass, bands) on the device, the bands
        dequantized, w3's LL included -> ((B, H, 2W) uint8 YUY2 frame 0,
        frame 1): the w5/w4/w3 pyramid, the temporal combine and the 8-bit
        output with the dither windows `dither_base` and `dither_base +
        1` (`Codec/decoder.c:11180` DecodeSampleGroup).

        reference_compatible replicates the reference decoder, whose frame
        1 is frame 0's reconstruction with the next dither window; False
        reconstructs frame 1 from its own temporal field and w1's bands,
        as the reference's SAMPLE_TYPE_FRAME path does."""
        dithers = [_dither(self.height, dither_base + f, not progressive,
                           self.device) for f in (0, 1)]
        frames = ([], [])
        for ch, (lowpass, b) in enumerate(coeffs):
            # w5 and w3 invert with the stale bottom taps
            # (InvertSpatialQuantOverflowProtected16s), w4 with the standard
            # ones and descale 2; the temporal combine saturates before its
            # >> 1 (InvertTemporalQuant16s, temporal.c:9676)
            ll4 = ops.dwt2d_inverse(lowpass, *b[5], descale=1,
                                    bottom_shift=True)
            tlow = ops.dwt2d_inverse(ll4, *b[4], descale=2)
            thigh = ops.dwt2d_inverse(*b[3], descale=1, bottom_shift=True)
            fields = [(ops.sat16(tlow - thigh) >> 1, b[0])]
            fields.append(fields[0] if reference_compatible
                          else (ops.sat16(tlow + thigh) >> 1, b[1]))
            for f, ((ll, (lh, hl, hh)), dither) in enumerate(zip(fields,
                                                                 dithers)):
                if not progressive:
                    frames[f].append(ops.frame_wavelet_inverse(
                        ll, lh, hl, hh, dither, ch))
                    continue
                width = 2 * ll.shape[-1]
                group = 16 if ch == 0 else 8
                frames[f].append(ops.h26_inverse_to_output(
                    ops.v26_inverse(ll, hl), ops.v26_inverse(lh, hh), 2,
                    ops.expand_dither_rows(dither, width, group),
                    scalar_tail=group if width % (2 * group) == group
                    else 0))
        return ops.pack_yuy2(*frames[0]), ops.pack_yuy2(*frames[1])

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
    def _lowpass(c, progressive: bool) -> np.ndarray:
        """A channel's lowpass with the decoder's load bias: relative to
        the progressive 8-bit models, absolute for the interlaced frame
        inverse (+48, +10 at odd widths)."""
        w = c.lowpass.shape[1]
        off = (intra_host.lowpass_channel_offset(w, num_frames=2)
               if progressive else
               intra_host.lowpass_offset_absolute(w, False, num_frames=2))
        return c.lowpass.astype(np.int32) + off

    @staticmethod
    def _host_bands(c, peaks: bool = True) -> dict:
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

    def decode_batch(self, samples: list[bytes],
                     reference_compatible: bool = True,
                     dither_base: int = 0):
        """Decode GROUP samples with the host C++ entropy decoder, then the
        inverse on the device -> ((B, H, 2W) uint8 frame 0, frame 1).
        Progressive and interlaced groups may share a batch."""
        parsed = [self._parse(x) for x in samples]
        shape = (len(samples), self.height, 2 * self.width)
        out = (np.empty(shape, np.uint8), np.empty(shape, np.uint8))
        for progressive in (True, False):
            idx = [i for i, s in enumerate(parsed)
                   if s.progressive == progressive]
            if not idx:
                continue
            per_frame = [[(self._lowpass(c, progressive), self._host_bands(c))
                          for c in parsed[i].channels] for i in idx]

            def batched(arrays):
                return torch.from_numpy(np.stack(arrays)).to(self.device)

            coeffs = [(batched([f[ch][0] for f in per_frame]),
                       {k: tuple(batched([f[ch][1][k][s] for f in per_frame])
                                 for s in range(len(bs)))
                        for k, bs in per_frame[0][ch][1].items()})
                      for ch in range(3)]
            frames = self.inverse(coeffs, reference_compatible, dither_base,
                                  progressive)
            for o, f in zip(out, frames):
                o[idx] = f.cpu().numpy()
        return out

    # --- decode on the device: entropy + FIELDPLUS inverse -----------------

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

    #: floor of a class's row capacity in 32-bit chunks; capacities double
    #: from here to fit the class's longest band payload
    MIN_ROW_CHUNKS = 256

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
                lowpass[ch][i] = self._lowpass(c, True)
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

        pays, nchs, qns, lins = [], [], [], []
        for lvl, planes in self._DECODE_CLASSES:
            rows = [(b"", 1, 0) if i in fallback
                    else parts[(ch, widx, slot, i)]
                    for i in range(batch) for ch in planes
                    for widx, slot in self._LEVEL_ENTRIES[lvl]]
            cap = self.MIN_ROW_CHUNKS
            while cap < max(len(d) for d, _, _ in rows) // 4:
                cap *= 2
            pay = torch.zeros((len(rows), cap * 4), dtype=torch.uint8,
                              pin_memory=pin)
            buf = pay.numpy()
            for r, (d, _, _) in enumerate(rows):
                buf[r, :len(d)] = np.frombuffer(d, np.uint8)
            meta = torch.tensor([(len(d) // 4, q, li) for d, q, li in rows],
                                dtype=torch.int32).t().contiguous()
            if pin:
                meta = meta.pin_memory()
            pays.append(pay)
            nchs.append(meta[0])
            qns.append(meta[1])
            lins.append(meta[2])

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
        return (tuple(pays), tuple(nchs), tuple(qns), tuple(lins), lp, w3,
                fallback)

    def _upload_rows(self, rows):
        """`_decode_rows_host`'s tensors -> the device (asynchronous copies
        from pinned memory on CUDA); the fallback set passes through."""
        *groups, fallback = rows
        return (*(tuple(t.to(self.device, non_blocking=True) for t in g)
                  for g in groups), fallback)

    def _decode_rows_args(self, samples: list[bytes]):
        """`_decode_rows_host` with its tensors uploaded to the device."""
        with timing.span("gop.decode_rows_host", len(samples)):
            rows = self._decode_rows_host(samples)
        with timing.span("gop.upload_rows"):
            return self._upload_rows(rows)

    def decode_coefficients(self, pays, nchs, qns, lins, lowpass, ll3):
        """Per-class band payload rows on the device -> (per-channel
        (lowpass, bands) as `inverse` takes them, (B,) overflow flags)."""
        bands_by = {}
        ovfs = []
        for ci, (lvl, planes) in enumerate(self._DECODE_CLASSES):
            entries = self._LEVEL_ENTRIES[lvl]
            bh, bw, pitch = self._class_dims(lvl, planes)
            co, ovf = ddec.decode_band_rows(pays[ci], nchs[ci], qns[ci],
                                            lins[ci], nout=bh * pitch)
            batch = pays[ci].shape[0] // (len(planes) * len(entries))
            co = co.reshape(batch, len(planes), len(entries), bh,
                            pitch)[..., :bw]
            for pi, ch in enumerate(planes):
                for ei, (widx, slot) in enumerate(entries):
                    bands_by[(ch, widx, slot)] = co[:, pi, ei]
            ovfs.append(ovf.reshape(batch, -1).any(dim=1))
        coeffs = []
        for ch in range(3):
            b = {k: tuple(bands_by[(ch, k, s)] for s in range(3))
                 for k in (0, 1, 4, 5)}
            b[3] = (ll3[ch],) + tuple(bands_by[(ch, 3, s)] for s in (1, 2, 3))
            coeffs.append((lowpass[ch], b))
        return coeffs, torch.stack(ovfs).any(dim=0)

    def decode_batch_device(self, samples: list[bytes],
                            reference_compatible: bool = True,
                            dither_base: int = 0):
        """Decode GROUP samples with the band entropy decode, the FIELDPLUS
        inverse and the output on the device; the host only walks sample
        headers and copies payloads.  The output is `decode_batch`'s.

        Returns (frames 0, frames 1, fallback): fallback is the sorted
        tuple of the frame indices that `decode_batch` decoded instead."""
        batch = len(samples)
        *rows, fallback = self._decode_rows_args(samples)
        if len(fallback) == batch:
            _count_groups(batch, batch)
            return (*self.decode_batch(samples, reference_compatible,
                                       dither_base), tuple(range(batch)))
        coeffs, ovf = self.decode_coefficients(*rows)
        f0, f1 = (f.cpu().numpy() for f in self.inverse(
            coeffs, reference_compatible, dither_base))
        fallback |= {int(i) for i in torch.nonzero(ovf.cpu()).flatten()}
        fallback = tuple(sorted(fallback))
        if fallback:
            h0, h1 = self.decode_batch([samples[i] for i in fallback],
                                       reference_compatible, dither_base)
            f0[list(fallback)] = h0
            f1[list(fallback)] = h1
        _count_groups(batch, len(fallback))
        return f0, f1, fallback

    # --- decode to the deep and RGB outputs --------------------------------

    def inverse_to(self, coeffs, output: str, frame: int = 0,
                   precision: int = tags.PRECISION_10BIT) -> torch.Tensor:
        """Per-channel (lowpass with the progressive load bias, bands) on
        the device -> frame `frame` of the groups as `output` (one of
        `OUTPUTS`): the GOP pyramid down to the final v26 strips
        (`gop_host.decode_group_deep16`: frame 0 the temporal low minus
        the high with w0's bands, frame 1 the sum with w1's; the lowpass
        with the absolute offset, +14 for YU64 and v210, +48 for the
        others, +10 at odd widths), then the Row16u rows
        (`h26_inverse_to_row16u`) packed as `ops.yuv_output.pack` packs a
        4:2:2 intra frame's, or BGRA through `ops.bgra.strip_to_bgra`
        (`gop_host.decode_group_bgra`), rows bottom-up.  Returns the
        16-bit outputs as int16 bit patterns (B, H, row_bytes / 2), the
        others as uint8 rows, BGRA (B, H, W, 4)."""
        if output not in OUTPUTS:
            raise ValueError(f"a group decodes to {', '.join(OUTPUTS)}, "
                             f"not {output!r}")
        deep_yuv = output in yout.DEEP_YUV
        strips = []
        for lowpass, b in coeffs:
            w = lowpass.shape[-1]
            lowpass = lowpass + (
                intra_host.lowpass_offset_absolute(w, deep_yuv, num_frames=2)
                - intra_host.lowpass_channel_offset(w, num_frames=2))
            ll4 = ops.dwt2d_inverse(lowpass, *b[5], descale=1,
                                    bottom_shift=True)
            tlow = ops.dwt2d_inverse(ll4, *b[4], descale=2)
            thigh = ops.dwt2d_inverse(*b[3], descale=1, bottom_shift=True)
            if frame == 0:
                ll, (lh, hl, hh) = ops.sat16(tlow - thigh) >> 1, b[0]
            else:
                ll, (lh, hl, hh) = ops.sat16(tlow + thigh) >> 1, b[1]
            strips.append((ops.v26_inverse(ll, hl), ops.v26_inverse(lh, hh)))
        if output == "BGRA":
            (yl, yh), (c1l, c1h), (c2l, c2h) = strips
            return bgra.strip_to_bgra(yl, yh, c2l, c2h, c1l, c1h,
                                      precision).flip(-3)
        planes = [ops.h26_inverse_to_row16u(low, high, precision)
                  for low, high in strips]
        return yout.pack(output, *planes)

    def decode_batch_to(self, samples: list[bytes], output: str,
                        frame: int = 0, then=None) -> np.ndarray:
        """Decode GROUP samples to frame `frame` as `output` with the host
        C++ entropy decoder (the peaks not substituted, as the JAX
        package's deep decode leaves them; every group through the
        progressive pyramid, at its own precision), a group at a time,
        then `inverse_to` on the device, and `then` (a function of the
        frames on the device, or None) before the download."""
        out = []
        for sample in samples:
            s = self._parse(sample)
            coeffs = [(torch.from_numpy(self._lowpass(c, True)[None])
                       .to(self.device),
                       {k: tuple(torch.from_numpy(b[None]).to(self.device)
                                 for b in bs)
                        for k, bs in self._host_bands(c, False).items()})
                      for c in s.channels]
            frames = self.inverse_to(coeffs, output, frame, s.precision)
            out.append(_download(frames if then is None else then(frames)))
        return np.concatenate(out)

    def decode_batch_device_to(self, samples: list[bytes], output: str,
                               frame: int = 0, then=None):
        """Decode GROUP samples to frame `frame` as `output` with the band
        entropy decode, the pyramid and the packing on the device, and
        `then` before the download, as `decode_batch_to` does.

        Returns (frames, fallback): fallback is the sorted tuple of the
        frame indices that `decode_batch_to` decoded instead (a group the
        device route does not take, of another precision than 10 bits, or
        that overflows its device band region)."""
        out, fallback, _ = self._decode_device_to(samples, output, frame,
                                                  then)
        return out, fallback

    def decode_group_device_to(self, sample: bytes, output: str,
                               frame: int = 0, then=None):
        """`decode_batch_device_to` of one GROUP sample that also returns
        the group's coefficients on the device: (frames, fallback, coeffs),
        coeffs the per-channel (lowpass, bands) that `coefficients_to`
        takes for the group's other frame, None where the group fell
        back."""
        out, fallback, coeffs = self._decode_device_to([sample], output,
                                                       frame, then)
        return out, fallback, None if fallback else coeffs

    def coefficients_to(self, coeffs, output: str, frame: int = 0,
                        then=None) -> np.ndarray:
        """Device coefficients of groups (`decode_coefficients`' first
        return) -> frame `frame` as `output` on the host: `inverse_to`,
        then `then` on the device, then the download.  `coeffs` is left
        as it was, so one decode serves both frames."""
        with timing.span("gop.inverse_to", coeffs[0][0].shape[0]):
            frames = self.inverse_to(coeffs, output, frame)
        return _download(frames if then is None else then(frames))

    def _decode_device_to(self, samples: list[bytes], output: str,
                          frame: int, then):
        """`decode_batch_device_to` and the device coefficients it decoded
        (None where every group fell back)."""
        batch = len(samples)
        with timing.span("gop.decode_batch_device_to", batch):
            *rows, fallback = self._decode_rows_args(samples)
            if len(fallback) == batch:
                _count_groups(batch, batch)
                return (self.decode_batch_to(samples, output, frame, then),
                        tuple(range(batch)), None)
            with timing.span("gop.decode_coefficients", batch):
                coeffs, ovf = self.decode_coefficients(*rows)
            out = self.coefficients_to(coeffs, output, frame, then)
            fallback |= {int(i) for i in torch.nonzero(ovf.cpu()).flatten()}
            fallback = tuple(sorted(fallback))
            if fallback:
                out[list(fallback)] = self.decode_batch_to(
                    [samples[i] for i in fallback], output, frame, then)
            _count_groups(batch, len(fallback))
        return out, fallback, coeffs

"""Stereo 3D dual-channel samples: two eyes in one CFHD sample, on the
port's `IntraCodec`.

Port of the device route of `cineform_tpu.models.stereo` (`split_3d`,
`decode_batch_device_3d`) and of its encoder's sample layout
(`encode_sample_3d`), here on the codec's own transform.  The reference
encodes 3D by looping EncodeSample over the video channels, appending each
eye's complete bitstream 16-byte aligned into one sample
(`Codec/encoder.c:3407-3438`), with ENCODED_CHANNELS and
ENCODED_CHANNEL_NUMBER tags in each eye's header (`Codec/encoder.c:
7548-7556`) and a VCHN metadata tuple; the decoder picks an eye by its
TAG_CHANNELS_ACTIVE mask (`Codec/decoder.c:10086-10104`).  With both eyes
active (mask 3) the decoder composites them for 3D display: `blend_eyes`,
the JAX package's compositing of two decoded YUY2 eyes, here on the
device.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from cineform_tpu_torch.bitstream import parse_sample
from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.models.intra_host import EncoderMetadata


def _align16(data: bytes) -> bytes:
    return data + b"\0" * (-len(data) % 16)


def encode_batch_3d(codec: IntraCodec, left: np.ndarray, right: np.ndarray,
                    first_frame_number: int = 1,
                    metadata: EncoderMetadata | None = None) -> list[bytes]:
    """Encode left/right batches of frames (`codec.encode_batch`'s input)
    into dual-channel 3D samples, one a frame pair."""
    meta = replace(metadata or EncoderMetadata(), video_channels=2)
    eyes = [codec.encode_batch(frames, first_frame_number, meta, eye=eye)
            for eye, frames in enumerate((left, right))]
    return [_align16(_align16(a) + b) for a, b in zip(*eyes)]


def split_3d(sample: bytes) -> list[bytes]:
    """Split a dual-channel sample into its per-eye bitstreams."""
    s = parse_sample(sample)
    if s.encoded_channels < 2 or not s.sample_end:
        return [sample]
    end = (s.sample_end + 15) & ~15
    return [sample[:end], sample[end:]]


def decode_batch_device_3d(samples: list[bytes], eye: int,
                           codec: IntraCodec):
    """Decode one eye (0 = left, 1 = right) of a batch of 3D samples on the
    device: split each sample into its per-eye bitstreams on the host and
    decode the eye's complete sub-samples with `codec.decode_batch_device`.
    Either eye takes the decoder's first dither window, as a fresh decoder
    decoding that eye does.  Returns `decode_batch_device`'s (frames,
    fallback)."""
    eye_samples = []
    for sample in samples:
        eyes = split_3d(sample)
        if eye >= len(eyes):
            raise ValueError(f"sample has {len(eyes)} video channels")
        eye_samples.append(eyes[eye])
    return codec.decode_batch_device(eye_samples)


# ---------------------------------------------------------------------------
# 3D blend modes (`Do3DWork` / `ProcessLine3D`, `Codec/bayer.c:10761`;
# mode enum `Codec/codec.h:1261-1278`)
# ---------------------------------------------------------------------------

BLEND_NONE = 0
BLEND_STACKED_ANAMORPHIC = 1     # half height, left on top
BLEND_SIDEBYSIDE_ANAMORPHIC = 2  # half width, left on the left
BLEND_LINE_INTERLEAVED = 3
BLEND_ONION = 4                  # 50/50 mix
BLEND_DIFFERENCE = 5             # |L-R| around mid grey
BLEND_FREEVIEW = 7               # side-by-side for cross-eyed viewing
BLEND_ANAGLYPH_RC = 16           # red/cyan
BLEND_ANAGLYPH_RC_BW = 17
BLEND_ANAGLYPH_AB = 18           # amber/blue
BLEND_ANAGLYPH_AB_BW = 19
BLEND_ANAGLYPH_GM = 20           # green/magenta
BLEND_ANAGLYPH_GM_BW = 21

_GEOMETRIC = (BLEND_NONE, BLEND_STACKED_ANAMORPHIC,
              BLEND_SIDEBYSIDE_ANAMORPHIC, BLEND_LINE_INTERLEAVED,
              BLEND_ONION, BLEND_DIFFERENCE, BLEND_FREEVIEW)


def blend_format(mode: int) -> str:
    """The output `blend_eyes` gives in `mode`: YUY2 for the geometric
    modes, BGRA for the anaglyph family; ValueError for another mode."""
    if mode in _GEOMETRIC:
        return "YUY2"
    if BLEND_ANAGLYPH_RC <= mode <= BLEND_ANAGLYPH_GM_BW:
        return "BGRA"
    raise ValueError(f"unsupported blend mode {mode}")


def _yuy2_planes(frames: torch.Tensor):
    """(..., H, 2W) uint8 YUY2 -> int32 Y (..., H, W), U and V (..., H,
    W/2)."""
    a = frames.reshape(*frames.shape[:-1], -1, 4).to(torch.int32)
    y = torch.stack([a[..., 0], a[..., 2]], dim=-1).flatten(-2)
    return y, a[..., 1], a[..., 3]


def _pack_yuy2(y, u, v) -> torch.Tensor:
    out = torch.stack([y[..., 0::2], u, y[..., 1::2], v], dim=-1)
    return out.clamp(0, 255).to(torch.uint8).flatten(-2)


def _yuy2_to_rgb(frames: torch.Tensor):
    """8-bit CG709 conversion (the blend paths run at display precision)."""
    y, u, v = _yuy2_planes(frames)
    yy = (y - 16).clamp(min=0)
    uu = torch.repeat_interleave(u - 128, 2, dim=-1)
    vv = torch.repeat_interleave(v - 128, 2, dim=-1)
    r = ((149 * yy + 230 * vv + 64) >> 7).clamp(0, 255)
    g = ((298 * yy - 137 * vv - 55 * uu + 128) >> 8).clamp(0, 255)
    b = ((149 * yy + 270 * uu + 64) >> 7).clamp(0, 255)
    return r, g, b


def blend_eyes(left: torch.Tensor, right: torch.Tensor,
               mode: int) -> tuple[torch.Tensor, str]:
    """Composite two decoded eyes per the CFHD 3D blend mode, as the JAX
    package's `models.stereo.blend_eyes` does, on their device.

    left, right: (..., H, 2W) uint8 YUY2 frames.  Returns (frames, fourcc):
    (..., H, 2W) uint8 YUY2 for the geometric modes (0, the left eye; 1
    stacked and 2 and 7 side by side, each eye averaged to half size; 3
    line interleaved; 4 onion; 5 difference), (..., H, W, 4) uint8 BGRA
    rows top first for the anaglyph family (16-21, composited in 8-bit
    RGB).  ValueError for another mode."""
    fmt = blend_format(mode)
    if mode == BLEND_NONE:
        return left, fmt
    if fmt == "BGRA":
        lr, lg, lb = _yuy2_to_rgb(left)
        rr, rg, rb = _yuy2_to_rgb(right)
        if mode in (BLEND_ANAGLYPH_RC_BW, BLEND_ANAGLYPH_AB_BW,
                    BLEND_ANAGLYPH_GM_BW):
            # luminance-only anaglyph
            def lum(r, g, b):
                return (54 * r + 183 * g + 19 * b) >> 8
            lr = lg = lb = lum(lr, lg, lb)
            rr = rg = rb = lum(rr, rg, rb)
        if mode in (BLEND_ANAGLYPH_RC, BLEND_ANAGLYPH_RC_BW):
            r, g, b = lr, rg, rb          # red from left, cyan from right
        elif mode in (BLEND_ANAGLYPH_AB, BLEND_ANAGLYPH_AB_BW):
            r, g, b = lr, lg, rb          # amber (R+G) left, blue right
        else:
            r, g, b = rr, lg, rb          # green left, magenta right
        return torch.stack([b, g, r, torch.full_like(r, 255)],
                           dim=-1).to(torch.uint8), fmt
    ly, lu, lv = _yuy2_planes(left)
    ry, ru, rv = _yuy2_planes(right)
    if mode == BLEND_STACKED_ANAMORPHIC:
        def squash(p):
            return (p[..., 0::2, :] + p[..., 1::2, :] + 1) >> 1
        planes = [torch.cat([squash(a), squash(b)], dim=-2)
                  for a, b in ((ly, ry), (lu, ru), (lv, rv))]
    elif mode in (BLEND_SIDEBYSIDE_ANAMORPHIC, BLEND_FREEVIEW):
        def thin(p):
            return (p[..., 0::2] + p[..., 1::2] + 1) >> 1
        planes = [torch.cat([thin(a), thin(b)], dim=-1)
                  for a, b in ((ly, ry), (lu, ru), (lv, rv))]
    elif mode == BLEND_LINE_INTERLEAVED:
        odd = (torch.arange(ly.shape[-2], device=ly.device) % 2 == 1)[:, None]
        planes = [torch.where(odd, b, a)
                  for a, b in ((ly, ry), (lu, ru), (lv, rv))]
    elif mode == BLEND_ONION:
        planes = [(a + b + 1) >> 1 for a, b in ((ly, ry), (lu, ru), (lv, rv))]
    else:  # BLEND_DIFFERENCE
        planes = [(128 + (ly - ry)).clamp(0, 255), torch.full_like(lu, 128),
                  torch.full_like(lv, 128)]
    return _pack_yuy2(*planes), fmt

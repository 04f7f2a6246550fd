"""Forward DWT: the CUDA kernels of `csrc/dwt_forward.cu` and their wrappers.

- `dwt_forward_yuy2(frames, precision, prescale, quants)`: level 1 of the
  YUY2 encode, read from the frames' bytes, for all three channels in one
  launch.
- `dwt_forward_groups(lows, prescale, quants)`: the next level of all
  three channels, in one launch.
- `dwt_forward_level(x, prescale, quant)`: one level of one int32 plane.

The first two hold the channels in their groups, `GROUPS`: Y, then V and
U, whose 4:2:2 planes share a shape.  They return `(lows, highs)`, one
tensor per group each: lows (B, G, h, w) the lowpass planes, highs
(B, G, 3, h, pitch) the quantized LH, HL and HH bands, each row padded
with zeros to the band pitch (`intra_host.align16_pixels`), as the entropy
coder reads them.  `quants` holds one (LH, HL, HH) quantizer triple per
channel, in the order Y, V, U.

Each wrapper equals its plain version bit for bit: `unpack_yuy2` and
`plain_groups` for the first, `plain_groups` for the second,
`intra_transform.dwt2d_forward` for the third.  For a tensor on the CPU
it runs that plain version; for a CUDA tensor it launches its kernel, or
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cineform_tpu_torch import _build
from cineform_tpu_torch.models.intra_host import align16_pixels
from cineform_tpu_torch.ops import intra_transform

#: channel groups of 4:2:2: Y, then V(Cr) and U(Cb)
GROUPS = ((0,), (1, 2))

# src (frames, or the Y and VU lowpass buffers), ll_y, ll_c, bands_y,
# bands_c; batch, h, w, pitch_y, pitch_c, (shift,) prescale, 9 quantizers
_YUY2_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 16
_GROUPS_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 15
# x, ll, bands; batch, h, w, prescale, q0, q1, q2
_LEVEL_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 7


def group_layout(trios) -> torch.Tensor:
    """[(LH, HL, HH)] of a group's channels, each (B, h, w) -> (B, G, 3, h,
    pitch), each row zero-padded to the band pitch."""
    t = torch.stack([torch.stack(tuple(bands), dim=1) for bands in trios],
                    dim=1)
    w = t.shape[-1]
    return F.pad(t, (0, align16_pixels(w) - w))


def plain_groups(planes, prescale: int, quants):
    """The plain version of one level of the three channel planes (Y, V,
    U), each (B, H, W) int32: `dwt2d_forward` on each, then the groups'
    layout."""
    lows, highs = [], []
    for grp in GROUPS:
        outs = [intra_transform.dwt2d_forward(planes[ch], prescale,
                                              tuple(quants[ch]))
                for ch in grp]
        lows.append(torch.stack([ll for ll, _ in outs], dim=1))
        highs.append(group_layout([bands for _, bands in outs]))
    return tuple(lows), tuple(highs)


def _check_quants(name: str, quants):
    if len(quants) != 3 or any(len(q) != 3 for q in quants):
        raise ValueError(f"{name}: expected one quantizer triple for each "
                         "of Y, V, U")


def _group_outputs(device, batch: int, ho: int, wo: int):
    """Empty (lows, highs) of the groups for luma output width wo."""
    lows, highs = [], []
    for grp, w in zip(GROUPS, (wo, wo // 2)):
        lows.append(torch.empty((batch, len(grp), ho, w), dtype=torch.int32,
                                device=device))
        highs.append(torch.empty((batch, len(grp), 3, ho, align16_pixels(w)),
                                 dtype=torch.int32, device=device))
    return tuple(lows), tuple(highs)


def dwt_forward_yuy2(frames: torch.Tensor, precision: int, prescale: int,
                     quants):
    """(B, H, 2W) uint8 YUY2 -> level 1 of Y, V, U as (lows, highs) by
    group: `unpack_yuy2(frames, precision)`, then `dwt2d_forward` of each
    plane with `prescale` and its quantizers.

    W must be a multiple of 4 and at least 12, H even and at least 6."""
    if frames.dtype != torch.uint8:
        raise TypeError(f"dwt_forward_yuy2: expected uint8, got "
                        f"{frames.dtype}")
    _check_quants("dwt_forward_yuy2", quants)
    if frames.dim() != 3:
        raise ValueError("dwt_forward_yuy2: expected (B, H, 2W) frames")
    batch, h, w2 = frames.shape
    if h < 6 or h % 2 or w2 < 24 or w2 % 8:
        raise ValueError(f"dwt_forward_yuy2: frames {h}x{w2 // 2} need an "
                         "even height of at least 6 and a width that is a "
                         "multiple of 4, at least 12")
    if not _build.uses_kernel("dwt_forward_yuy2", frames):
        return plain_groups(intra_transform.unpack_yuy2(frames, precision),
                            prescale, quants)
    if frames.data_ptr() % 4:
        raise ValueError("dwt_forward_yuy2: frames must start on a 4-byte "
                         "boundary (the kernel copies 4 or 16 bytes at once)")
    w = w2 // 2
    lows, highs = _group_outputs(frames.device, batch, h // 2, w // 2)
    _build.launch(dwt_forward_yuy2, "dwt_forward", "cf_dwt_forward_yuy2",
                  _YUY2_ARGTYPES, frames, *lows, *highs, batch, h, w,
                  highs[0].shape[-1], highs[1].shape[-1], precision - 8,
                  prescale, *(q for qs in quants for q in qs))
    return lows, highs


def dwt_forward_groups(lows, prescale: int, quants):
    """The next level of the three channels held in their groups' lowpass
    buffers, Y (B, 1, H, W) and V, U (B, 2, H, W/2) int32 -> (lows, highs)
    by group.

    W must be a multiple of 4 and at least 12, H even and at least 6."""
    _check_quants("dwt_forward_groups", quants)
    if len(lows) != 2:
        raise ValueError("dwt_forward_groups: expected the Y and the V, U "
                         "lowpass buffers")
    y, c = lows
    for t in lows:
        if t.dtype != torch.int32:
            raise TypeError(f"dwt_forward_groups: expected int32, got "
                            f"{t.dtype}")
    batch, _, h, w = y.shape
    if y.shape[1] != 1 or c.shape != (batch, 2, h, w // 2) or h < 6 \
            or h % 2 or w < 12 or w % 4:
        raise ValueError(f"dwt_forward_groups: lowpass buffers "
                         f"{tuple(y.shape)} and {tuple(c.shape)} are not Y "
                         "(B, 1, H, W) and V, U (B, 2, H, W/2) with H even "
                         "and at least 6, W a multiple of 4, at least 12")
    if not _build.uses_kernel("dwt_forward_groups", y):
        return plain_groups((y[:, 0], c[:, 0], c[:, 1]), prescale, quants)
    out_lows, highs = _group_outputs(y.device, batch, h // 2, w // 2)
    _build.launch(dwt_forward_groups, "dwt_forward", "cf_dwt_forward_groups",
                  _GROUPS_ARGTYPES, y, c, *out_lows, *highs, batch, h, w,
                  highs[0].shape[-1], highs[1].shape[-1], prescale,
                  *(q for qs in quants for q in qs))
    return out_lows, highs


def dwt_forward_level(x: torch.Tensor, prescale: int = 0,
                      quant: tuple[int, int, int] | None = None):
    """(..., H, W) int32 -> (LL, (LH, HL, HH)), each (..., H/2, W/2) int32.

    H and W must be even and at least 6 (the 2-6 border taps read six
    rows or columns)."""
    if x.dtype != torch.int32:
        raise TypeError(f"dwt_forward_level: expected int32, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError("dwt_forward_level: expected (..., H, W)")
    *lead, h, w = x.shape
    if h < 6 or w < 6 or h % 2 or w % 2:
        raise ValueError(f"dwt_forward_level: plane {h}x{w} must have even "
                         "sides of at least 6")
    if not _build.uses_kernel("dwt_forward_level", x):
        return intra_transform.dwt2d_forward(x, prescale, quant)
    q0, q1, q2 = quant if quant is not None else (1, 1, 1)
    batch = 1
    for d in lead:
        batch *= d
    ll = torch.empty((*lead, h // 2, w // 2), dtype=torch.int32,
                     device=x.device)
    bands = torch.empty((3, *lead, h // 2, w // 2), dtype=torch.int32,
                        device=x.device)
    _build.launch(dwt_forward_level, "dwt_forward", "cf_dwt_forward_level",
                  _LEVEL_ARGTYPES, x, ll, bands, batch, h, w, prescale, q0,
                  q1, q2)
    return ll, (bands[0], bands[1], bands[2])


#: kernel launches since the last reset (the CPU path does not count)
dwt_forward_yuy2.launches = 0
dwt_forward_groups.launches = 0
dwt_forward_level.launches = 0

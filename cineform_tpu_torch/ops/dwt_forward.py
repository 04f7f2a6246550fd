"""Forward DWT: the CUDA kernels of `csrc/dwt_forward.cu` and their wrappers.

- `dwt_forward_yuy2(frames, precision, prescale, quants)`: level 1 of the
  YUY2 encode, read from the frames' bytes, for all three channels in one
  launch.
- `dwt_forward_groups(lows, prescale, quants)`: the next level of the
  three YUY2 channels, in one launch.
- `dwt_forward_planes(x, prescale, quants)`: one level of a group of
  equal-size int32 planes (the 3 or 4 channels of RGB 4:4:4 and RGBA
  4:4:4:4), in one launch.
- `dwt_forward_level(x, prescale, quant)`: one level of one int32 plane.

The first three return `(lows, highs)` by channel group: lows (B, G, h, w)
the lowpass planes, highs (B, G, 3, h, pitch) the quantized LH, HL and HH
bands, each row padded with zeros to the band pitch
(`intra_host.align16_pixels`), as the entropy coder reads them.  The YUY2
pair holds 4:2:2's two groups, Y, then V and U, whose planes share a shape,
as a tuple of two tensors each; `dwt_forward_planes` one group, as
tensors.  `quants` holds one (LH, HL, HH) quantizer triple per channel, in
the planes' order (YUY2: Y, V, U).

Each wrapper equals its plain version bit for bit: `unpack_yuy2` and
`plain_groups` for the first, `plain_groups` for the second, `plain_planes`
for the third, `intra_transform.dwt2d_forward` for the fourth.  For a
tensor on the CPU it runs that plain version; for a CUDA tensor it
launches its kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cineform_tpu_torch import _build
from cineform_tpu_torch.models.intra_host import align16_pixels
from cineform_tpu_torch.ops import intra_transform

#: the most planes `dwt_forward_planes` takes in one launch
MAX_PLANES = 4

# src (frames, or the Y and VU lowpass buffers), ll_y, ll_c, bands_y,
# bands_c; batch, h, w, pitch_y, pitch_c, (shift,) prescale, 9 quantizers
_YUY2_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 16
_GROUPS_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 15
# x, ll, bands; batch, planes, h, w, pitch, prescale, 12 quantizers
_PLANES_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 18
# x, ll, bands; batch, h, w, prescale, q0, q1, q2
_LEVEL_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 7


def group_layout(trios) -> torch.Tensor:
    """[(LH, HL, HH)] of a group's channels, each (B, h, w) -> (B, G, 3, h,
    pitch), each row zero-padded to the band pitch."""
    t = torch.stack([torch.stack(tuple(bands), dim=1) for bands in trios],
                    dim=1)
    w = t.shape[-1]
    return F.pad(t, (0, align16_pixels(w) - w))


def plain_planes(x: torch.Tensor, prescale: int, quants):
    """The plain version of one level of a group of planes, (B, G, H, W)
    int32: `dwt2d_forward` on each, then the group's layout."""
    outs = [intra_transform.dwt2d_forward(x[:, g], prescale, tuple(q))
            for g, q in enumerate(quants)]
    return (torch.stack([ll for ll, _ in outs], dim=1),
            group_layout([bands for _, bands in outs]))


def plain_groups(planes, prescale: int, quants):
    """The plain version of one level of the three 4:2:2 channel planes
    (Y, V, U), each (B, H, W) int32: `plain_planes` of the Y group and of
    the V, U group."""
    y, v, u = planes
    (ly, hy), (lc, hc) = (plain_planes(y[:, None], prescale, quants[:1]),
                          plain_planes(torch.stack((v, u), dim=1), prescale,
                                       quants[1:]))
    return (ly, lc), (hy, hc)


def _check_quants(name: str, quants, planes: int = 3):
    if len(quants) != planes or any(len(q) != 3 for q in quants):
        raise ValueError(f"{name}: expected one quantizer triple for each "
                         f"of the {planes} planes")


def _outputs(device, batch: int, planes: int, ho: int, wo: int):
    """Empty (lows, highs) of a group of `planes` planes."""
    return (torch.empty((batch, planes, ho, wo), dtype=torch.int32,
                        device=device),
            torch.empty((batch, planes, 3, ho, align16_pixels(wo)),
                        dtype=torch.int32, device=device))


def _group_outputs(device, batch: int, ho: int, wo: int):
    """Empty (lows, highs) of the 4:2:2 groups for luma output width wo."""
    (ly, hy), (lc, hc) = (_outputs(device, batch, 1, ho, wo),
                          _outputs(device, batch, 2, ho, wo // 2))
    return (ly, lc), (hy, hc)


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


def dwt_forward_planes(x: torch.Tensor, prescale: int, quants):
    """One level of a group of G equal-size int32 planes, (B, G, H, W) with
    G <= 4, each with its quantizer triple -> (lows (B, G, H/2, W/2), highs
    (B, G, 3, H/2, pitch)).

    H and W must be even and at least 6."""
    if x.dtype != torch.int32:
        raise TypeError(f"dwt_forward_planes: expected int32, got {x.dtype}")
    if x.dim() != 4 or not 1 <= x.shape[1] <= MAX_PLANES:
        raise ValueError(f"dwt_forward_planes: expected (B, G, H, W) with "
                         f"1 <= G <= {MAX_PLANES}, got {tuple(x.shape)}")
    batch, planes, h, w = x.shape
    _check_quants("dwt_forward_planes", quants, planes)
    if h < 6 or w < 6 or h % 2 or w % 2:
        raise ValueError(f"dwt_forward_planes: planes {h}x{w} must have "
                         "even sides of at least 6")
    if not _build.uses_kernel("dwt_forward_planes", x):
        return plain_planes(x, prescale, quants)
    lows, highs = _outputs(x.device, batch, planes, h // 2, w // 2)
    qs = [q for qs in quants for q in qs]
    _build.launch(dwt_forward_planes, "dwt_forward", "cf_dwt_forward_planes",
                  _PLANES_ARGTYPES, x, lows, highs, batch, planes, h, w,
                  highs.shape[-1], prescale,
                  *qs, *[1] * (3 * MAX_PLANES - len(qs)))
    return lows, highs


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
dwt_forward_planes.launches = 0
dwt_forward_level.launches = 0

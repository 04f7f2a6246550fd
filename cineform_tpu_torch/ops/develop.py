"""The float RAW develop stages on a torch device: port of the JAX
package's `ops/develop.py` (the Active Metadata engine's stages,
`Codec/bayer.c`, `Codec/DemoasicFrames.cpp`).

Each stage is a batched op over (..., H, W, C) float32 planes in [0, 1]:
a bilinear demosaic of the four quarter-res planes, white balance, the
color matrix, the gamma and log curves, the trilinear 3D LUT, vignette,
an unsharp mask, the histogram, waveform and vectorscope, and the
integer WP13 scopes.  Its callers are `models.active_metadata.
decode_bayer_developed` and the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Demosaic
# ---------------------------------------------------------------------------

def demosaic_bilinear(g, rg, bg, dg) -> torch.Tensor:
    """Bilinear demosaic of the CFHD Bayer channel set to full resolution
    (the layout math of `DebayerLine`, `DemoasicFrames.cpp:88`, in its
    bilinear mode): the four photosites of each cell from G, the R-G and
    B-G differences (offset 2048, halved) and the G1-G2 difference, then
    each colour plane interpolated to the mosaic grid.  (..., H, W) ->
    (..., 2H, 2W, 3) float32 linear RGB over 4095."""
    g = g.to(torch.float32)
    r = (rg.to(torch.float32) - 2048.0) * 2.0 + g
    b = (bg.to(torch.float32) - 2048.0) * 2.0 + g
    d = dg.to(torch.float32) * 2.0 - 4096.0
    g1 = g + d / 2.0
    g2 = g - d / 2.0
    *lead, h, w = g.shape

    def up2(x):
        return x.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)

    def bilerp(x):
        """The half-pixel-shifted bilinear interpolation, edges
        replicated: phase (0, 0) on site, the others their neighbours'
        means."""
        flat = x.reshape(-1, 1, h, w)
        xp = F.pad(flat, (1, 1, 1, 1), mode="replicate").reshape(
            *lead, h + 2, w + 2)
        c = xp[..., 1:-1, 1:-1]
        rt = xp[..., 1:-1, 2:]
        dn = xp[..., 2:, 1:-1]
        dr = xp[..., 2:, 2:]
        out = torch.stack([torch.stack([c, (c + rt) / 2], dim=-1),
                           torch.stack([(c + dn) / 2,
                                        (c + rt + dn + dr) / 4], dim=-1)],
                          dim=-2)
        return out.transpose(-3, -2).reshape(*lead, 2 * h, 2 * w)

    return torch.stack([bilerp(r), up2((g1 + g2) / 2), bilerp(b)],
                       dim=-1) / 4095.0


# ---------------------------------------------------------------------------
# Active Metadata stages (float32 [0, 1] RGB)
# ---------------------------------------------------------------------------

def white_balance(rgb: torch.Tensor, gains) -> torch.Tensor:
    """Per-channel gains (WBAL/WBRG tags, `bayer.c` ComputeCube)."""
    return rgb * _f32(gains, rgb)


def color_matrix(rgb: torch.Tensor, matrix) -> torch.Tensor:
    """3x3 (or 3x4 with offsets) color matrix (COLM tag)."""
    m = _f32(matrix, rgb)
    out = torch.einsum("...c,dc->...d", rgb, m[:, :3])
    if m.shape[1] == 4:
        out = out + m[:, 3]
    return out


def gamma_curve(rgb: torch.Tensor, power: float = 1.0 / 2.2) -> torch.Tensor:
    """Simple power-law display curve (GAMT tag family)."""
    return torch.pow(rgb.clamp(min=0.0), power)


def log_curve(rgb: torch.Tensor, base: float = 90.0) -> torch.Tensor:
    """Encode-curve companion (CURVE_LIN2LOG, AVIExtendedHeader.h:153)."""
    base = _f32(base, rgb)
    return torch.log(rgb.clamp(min=0.0) * (base - 1.0) + 1.0) / torch.log(base)


def apply_lut3d(rgb: torch.Tensor, lut) -> torch.Tensor:
    """Trilinear 3D LUT (the LOOK cube, `bayer.c:4720` BuildCube): lut
    (N, N, N, 3) indexed [r][g][b]."""
    lut = _f32(lut, rgb)
    n = lut.shape[0]
    x = rgb.clamp(0.0, 1.0) * (n - 1)
    i0 = torch.floor(x).to(torch.int64).clamp(0, n - 2)
    f = x - i0
    r0, g0, b0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]

    def at(dr, dg, db):
        return lut[r0 + dr, g0 + dg, b0 + db]

    c00 = at(0, 0, 0) * (1 - fr) + at(1, 0, 0) * fr
    c01 = at(0, 0, 1) * (1 - fr) + at(1, 0, 1) * fr
    c10 = at(0, 1, 0) * (1 - fr) + at(1, 1, 0) * fr
    c11 = at(0, 1, 1) * (1 - fr) + at(1, 1, 1) * fr
    c0 = c00 * (1 - fg) + c10 * fg
    c1 = c01 * (1 - fg) + c11 * fg
    return c0 * (1 - fb) + c1 * fb


def vignette(rgb: torch.Tensor, strength: float = 0.0) -> torch.Tensor:
    """Radial gain falloff correction (`bayer.c` vignette tags)."""
    if strength == 0.0:
        return rgb
    h, w = rgb.shape[-3:-1]
    yy = (torch.arange(h, dtype=torch.float32, device=rgb.device) / (h - 1)
          - 0.5) * 2
    xx = (torch.arange(w, dtype=torch.float32, device=rgb.device) / (w - 1)
          - 0.5) * 2
    r2 = yy[:, None] ** 2 + xx[None, :] ** 2
    gain = 1.0 + strength * r2
    return rgb * gain[..., None]


def sharpen(rgb: torch.Tensor, amount: float = 0.0) -> torch.Tensor:
    """Unsharp mask with a 3x3 blur, the cheap equivalent of
    `FastSharpeningBlurVWP13` (`DemoasicFrames.cpp:1361`)."""
    if amount == 0.0:
        return rgb
    k = torch.tensor([1.0, 2.0, 1.0], dtype=torch.float32,
                     device=rgb.device) / 4.0
    xp = torch.cat([rgb[..., :1, :, :], rgb, rgb[..., -1:, :, :]], dim=-3)
    blur_v = (xp[..., :-2, :, :] * k[0] + xp[..., 1:-1, :, :] * k[1]
              + xp[..., 2:, :, :] * k[2])
    xp = torch.cat([blur_v[..., :, :1, :], blur_v, blur_v[..., :, -1:, :]],
                   dim=-2)
    blur = (xp[..., :, :-2, :] * k[0] + xp[..., :, 1:-1, :] * k[1]
            + xp[..., :, 2:, :] * k[2])
    return (rgb + amount * (rgb - blur)).clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# Scopes (histogram / waveform / vectorscope, `Codec/bayer.c` ToolsHandle)
# ---------------------------------------------------------------------------

def _counts(index: torch.Tensor, size: int) -> torch.Tensor:
    return torch.bincount(index.reshape(-1), minlength=size).to(torch.int32)


def histogram(rgb: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """(3, bins) per-channel histogram (HistogramRender, draw.c:67)."""
    q = (rgb * (bins - 1)).to(torch.int32).clamp(0, bins - 1)
    return torch.stack([_counts(q[..., c].long(), bins) for c in range(3)])


def waveform(rgb: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """(W, bins) luma waveform: column histograms of Rec.709 luma."""
    luma = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    q = (luma * (bins - 1)).to(torch.int32).clamp(0, bins - 1).long()
    w = q.shape[-1]
    cols = torch.arange(w, device=q.device).expand_as(q)
    return _counts(cols * bins + q, w * bins).reshape(w, bins)


def vectorscope(rgb: torch.Tensor, bins: int = 128) -> torch.Tensor:
    """(bins, bins) Cb/Cr occupancy map."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    cb = -0.1146 * r - 0.3854 * g + 0.5 * b
    cr = 0.5 * r - 0.4542 * g - 0.0458 * b
    qx = ((cb + 0.5) * (bins - 1)).to(torch.int32).clamp(0, bins - 1).long()
    qy = ((cr + 0.5) * (bins - 1)).to(torch.int32).clamp(0, bins - 1).long()
    return _counts(qy * bins + qx, bins * bins).reshape(bins, bins)


# ---------------------------------------------------------------------------
# Full develop step
# ---------------------------------------------------------------------------

def develop(g, rg, bg, dg, *, wb=(1.0, 1.0, 1.0), matrix=None, lut=None,
            gamma: float = 1.0, vignette_strength: float = 0.0,
            sharpen_amount: float = 0.0) -> torch.Tensor:
    """Demosaic + the Active Metadata chain (`ApplyActiveMetaData`,
    `bayer.c:7427`); returns float32 RGB in [0, 1]."""
    rgb = demosaic_bilinear(g, rg, bg, dg)
    rgb = white_balance(rgb, wb)
    if matrix is not None:
        rgb = color_matrix(rgb, matrix)
    if lut is not None:
        rgb = apply_lut3d(rgb, lut)
    if gamma != 1.0:
        rgb = gamma_curve(rgb, gamma)
    rgb = vignette(rgb, vignette_strength)
    rgb = sharpen(rgb, sharpen_amount)
    return rgb.clamp(0.0, 1.0)


def tools_scopes_wp13(rgb13: torch.Tensor):
    """HistogramLine's WP13 tools collection, integer-exact
    (`Codec/decoder.c:6314-6400`): the column step doubles until
    width/step <= 360; R/G/B = clip(v13 >> 5, 0, 255) into per-channel
    histograms and per-column waveforms; the vectorscope's U/V through
    the integer matrices U = ((-827R - 2769G + 3596B) >> 13) + 128,
    V = ((3596R - 3269G - 328B) >> 13) + 128, clamped to [0, 255].

    Returns (hist (3, 256) int32, wave (wfw, 3, 256) int32, scope
    (256, 256) int32, waveform_width)."""
    w = rgb13.shape[1]
    step = 1
    while w // step > 360:
        step *= 2
    wfw = w // step
    v = rgb13[:, ::step][:, :wfw].to(torch.int32)
    rgb8 = (v >> 5).clamp(0, 255).long()
    r8, g8, b8 = rgb8[..., 0], rgb8[..., 1], rgb8[..., 2]
    hist = torch.stack([_counts(c, 256) for c in (r8, g8, b8)])
    pos = torch.arange(wfw, device=v.device).expand_as(r8)
    wave = torch.stack([_counts(pos * 256 + c, wfw * 256).reshape(wfw, 256)
                        for c in (r8, g8, b8)], dim=1)
    u = (((-827 * r8 - 2769 * g8 + 3596 * b8) >> 13) + 128).clamp(0, 255)
    vv = (((3596 * r8 - 3269 * g8 - 328 * b8) >> 13) + 128).clamp(0, 255)
    scope = _counts(u * 256 + vv, 256 * 256).reshape(256, 256)
    return hist, wave, scope, wfw

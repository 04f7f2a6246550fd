"""The fused BGRA output: the final horizontal inverse with the YUV->RGB
conversion, as PyTorch tensor functions.

Port of `cineform_tpu.ops.bgra_jax`, bit-exact against it and therefore
against the reference's `InvertHorizontalStripYUV16sToPackedRGB32`
(`Codec/spatial.c:29577`): the final-level horizontal 2-6 inverse fused
with the 8-bit CG 709 YUV->RGB conversion.  The three regimes of the
reference's row (saturating SSE lanes, the plain scalar middle, the border
bracket) are computed everywhere and selected with masks.  The SSE lanes'
unsigned 16-bit arithmetic (`subs_epu16`, logical shifts) runs in int32
with explicit masks: the CPU build of torch has no uint16 shifts.
"""

from __future__ import annotations

import torch


def _sat16(v: torch.Tensor) -> torch.Tensor:
    return v.clamp(-32768, 32767)


def _subs_epu16(x: torch.Tensor, y: int) -> torch.Tensor:
    """Unsigned saturating 16-bit subtract of the constant `y`."""
    return ((x & 0xFFFF) - y).clamp(min=0)


def _as_i16(v: torch.Tensor) -> torch.Tensor:
    """The low 16 bits as a signed value."""
    return ((v + 32768) & 0xFFFF) - 32768


def _stream(low: torch.Tensor, high: torch.Tensor, post: int,
            descale: int) -> torch.Tensor:
    """Per-pair (even, odd) value stream with the three regimes:
    low/high (..., h, n) -> (..., h, 2n) int32."""
    n = low.shape[-1]
    lm1, l0, lp1 = low[..., :-2], low[..., 1:-1], low[..., 2:]
    h0 = high[..., 1:-1]

    # SSE regime (saturating lanes, logical descale)
    e = _sat16(_sat16(_sat16(lm1 - lp1) + 4) >> 3)
    e = _sat16(e + l0)
    e_sse = _subs_epu16(_sat16(_sat16(e + 2048) + h0), 2048) >> 1
    o = _sat16(_sat16(_sat16(lp1 - lm1) + 4) >> 3)
    o = _sat16(o + l0)
    o_sse = _subs_epu16(_sat16(_sat16(o + 2048) - h0), 2048) >> 1
    e_sse = (e_sse & 0xFFFF) >> descale
    o_sse = (o_sse & 0xFFFF) >> descale

    # scalar regime (plain integer)
    e_scl = ((((lm1 - lp1 + 4) >> 3) + l0 + h0) >> 1) >> descale
    o_scl = ((((lp1 - lm1 + 4) >> 3) + l0 - h0) >> 1) >> descale

    use_sse = torch.arange(1, n - 1, device=low.device) < post
    ev = torch.where(use_sse, e_sse, e_scl)
    od = torch.where(use_sse, o_sse, o_scl)

    # borders
    be = ((((11 * low[..., 0] - 4 * low[..., 1] + low[..., 2] + 4) >> 3)
           + high[..., 0]) >> 1) >> descale
    bo = ((((5 * low[..., 0] + 4 * low[..., 1] - low[..., 2] + 4) >> 3)
           - high[..., 0]) >> 1) >> descale
    re = ((((5 * low[..., -1] + 4 * low[..., -2] - low[..., -3] + 4) >> 3)
           + high[..., -1]) >> 1) >> descale
    ro = ((((11 * low[..., -1] - 4 * low[..., -2] + low[..., -3] + 4) >> 3)
           - high[..., -1]) >> 1) >> descale

    even = torch.cat([be[..., None], ev, re[..., None]], dim=-1)
    odd = torch.cat([bo[..., None], od, ro[..., None]], dim=-1)
    return torch.stack([even, odd], dim=-1).flatten(-2)


def strip_to_bgra(y_low, y_high, u_low, u_high, v_low, v_high,
                  precision: int = 10) -> torch.Tensor:
    """The final-level (low, high) strips of Y, U and V, int32 (..., h, n)
    for Y and (..., h, n/2) for U, V -> (..., h, 2n, 4) uint8 BGRA rows
    (not flipped)."""
    descale = precision - 8
    ymult, r_vmult, g_vmult, g_umult, b_umult = 19072, 230, 137, 55, 135

    width = y_low.shape[-1]
    last_column = width - 2
    post = width - (width % 16)
    while post > last_column - 2:
        post -= 16

    yv = _stream(y_low, y_high, post, descale)
    uu = _stream(u_low, u_high, post // 2, descale).repeat_interleave(2, -1)
    vx = _stream(v_low, v_high, post // 2, descale).repeat_interleave(2, -1)

    y16, u16, v16 = _as_i16(yv), _as_i16(uu), _as_i16(vx)
    lim = 0x7FFF - 0xFF
    yy = _subs_epu16(_sat16(_sat16(y16 - 16) + lim), lim)
    uc = _sat16(_subs_epu16(_sat16(u16 + lim), lim) - 128)
    vc = _sat16(_subs_epu16(_sat16(v16 + lim), lim) - 128)
    yy = _as_i16(yy << 7)
    yy = ((yy * ymult) >> 16) << 1

    def mullo(a, c):
        return _as_i16(a * c)

    r_sse = _sat16(_sat16(yy + (mullo(vc, r_vmult) >> 1)) + 32) >> 6
    g_sse = _sat16(_sat16(_sat16(yy - (mullo(vc, g_vmult) >> 2))
                          - (mullo(uc, g_umult) >> 2)) + 32) >> 6
    b_sse = _sat16(_sat16(yy + mullo(uc, b_umult)) + 32) >> 6

    ys = ((yv - 16) * ymult) >> 7
    us, vs = uu - 128, vx - 128
    r_scl = (ys + r_vmult * vs + 64) >> 7
    g_scl = (2 * ys - g_umult * us - g_vmult * vs + 128) >> 8
    b_scl = (ys + 2 * b_umult * us + 64) >> 7

    sse_px = torch.arange(2 * width, device=yv.device) < 2 * post
    r = torch.where(sse_px, r_sse, r_scl)
    g = torch.where(sse_px, g_sse, g_scl)
    b = torch.where(sse_px, b_sse, b_scl)
    return torch.stack([b.clamp(0, 255), g.clamp(0, 255), r.clamp(0, 255),
                        torch.full_like(r, 255)], dim=-1).to(torch.uint8)

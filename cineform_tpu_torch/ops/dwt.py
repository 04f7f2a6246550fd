"""Batched 2-6 wavelet transforms on a torch device: port of the JAX
package's `ops/dwt.py` (the demo pyramid's transforms, bit-exact vs its
scalar model `ref/scalar.py`).

Every op takes int32 tensors of any leading shape (frames, channels) and
computes in int32 with arithmetic right shifts, as C does; horizontal
filters deinterleave the last axis by a reshape to (..., W/2, 2), vertical
ones take strided rows.  Behavioral contract: `Example/WaveletDemo/
utils.c:251-401` (the production SSE2 kernels in `Codec/spatial.c`
implement the same math; the codec's saturating forms are in
`ops.intra_transform`).
"""

from __future__ import annotations

import torch

from cineform_tpu_torch.spec.wavelet import ROUNDING

_R = ROUNDING


def _split_even_odd_last(x: torch.Tensor):
    """(..., W) -> even, odd each (..., W/2)."""
    pairs = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return pairs[..., 0], pairs[..., 1]


def _interleave_last(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    return torch.stack([even, odd], dim=-1).flatten(-2)


def h26_forward(x: torch.Tensor):
    """Forward 2-6 DWT along the last axis. x: (..., W) int32, W even >= 6.

    Returns (low, high), each (..., W/2)."""
    even, odd = _split_even_odd_last(x)
    low = even + odd
    diff = even - odd
    # interior: ((-low[k-1] + low[k+1] + 4) >> 3) + diff[k]
    interior = ((-low[..., :-2] + low[..., 2:] + _R) >> 3) + diff[..., 1:-1]
    first = (
        5 * even[..., 0] - 11 * odd[..., 0]
        + 4 * even[..., 1] + 4 * odd[..., 1]
        - even[..., 2] - odd[..., 2] + _R
    ) >> 3
    last = (
        11 * even[..., -1] - 5 * odd[..., -1]
        - 4 * odd[..., -2] - 4 * even[..., -2]
        + odd[..., -3] + even[..., -3] + _R
    ) >> 3
    high = torch.cat([first[..., None], interior, last[..., None]], dim=-1)
    return low, high


def h26_inverse(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Inverse 2-6 DWT along the last axis. Returns (..., 2*half)."""
    te = (low[..., :-2] - low[..., 2:] + _R) >> 3
    to = (-low[..., :-2] + low[..., 2:] + _R) >> 3
    even_i = (te + low[..., 1:-1] + high[..., 1:-1]) >> 1
    odd_i = (to + low[..., 1:-1] - high[..., 1:-1]) >> 1
    t0e = (11 * low[..., 0] - 4 * low[..., 1] + low[..., 2] + _R) >> 3
    t0o = (5 * low[..., 0] + 4 * low[..., 1] - low[..., 2] + _R) >> 3
    even_f = (t0e + high[..., 0]) >> 1
    odd_f = (t0o - high[..., 0]) >> 1
    tke = (5 * low[..., -1] + 4 * low[..., -2] - low[..., -3] + _R) >> 3
    tko = (11 * low[..., -1] - 4 * low[..., -2] + low[..., -3] + _R) >> 3
    even_l = (tke + high[..., -1]) >> 1
    odd_l = (tko - high[..., -1]) >> 1
    even = torch.cat([even_f[..., None], even_i, even_l[..., None]], dim=-1)
    odd = torch.cat([odd_f[..., None], odd_i, odd_l[..., None]], dim=-1)
    return _interleave_last(even, odd)


def v26_forward(x: torch.Tensor):
    """Forward 2-6 DWT along the second-to-last axis (rows)."""
    return tuple(t.transpose(-1, -2) for t in
                 h26_forward(x.transpose(-1, -2).contiguous()))


def v26_inverse(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Inverse 2-6 DWT along the second-to-last axis."""
    return h26_inverse(low.transpose(-1, -2),
                       high.transpose(-1, -2)).transpose(-1, -2)


def v22_forward(x: torch.Tensor):
    """2-2 Haar along the second-to-last axis (temporal/interlaced,
    `Codec/temporal.c:71`)."""
    a, b = x[..., 0::2, :], x[..., 1::2, :]
    return a + b, a - b


def v22_inverse(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    a = (low + high) >> 1
    b = (low - high) >> 1
    return torch.stack([a, b], dim=-2).flatten(-3, -2)


def t22_forward(f0: torch.Tensor, f1: torch.Tensor):
    """2-2 Haar between two GOP frames (`Codec/temporal.c:71`)."""
    return f0 + f1, f0 - f1


def t22_inverse(low: torch.Tensor, high: torch.Tensor):
    return (low + high) >> 1, (low - high) >> 1


def dwt2d_forward(x: torch.Tensor):
    """One 2D level: horizontal then vertical (`wavelets.c:214-215`).

    Returns (LL, LH, HL, HH) where LH = horizontal-high/vertical-low,
    HL = horizontal-low/vertical-high, HH = both-high, the reference's
    quadrant naming (qh quantizes LH, qv HL, qd HH)."""
    low, high = h26_forward(x)
    ll, hl = v26_forward(low)
    lh, hh = v26_forward(high)
    return ll, lh, hl, hh


def dwt2d_inverse(ll: torch.Tensor, lh: torch.Tensor, hl: torch.Tensor,
                  hh: torch.Tensor) -> torch.Tensor:
    """Inverse of one 2D level: vertical then horizontal."""
    low = v26_inverse(ll, hl)
    high = v26_inverse(lh, hh)
    return h26_inverse(low, high)

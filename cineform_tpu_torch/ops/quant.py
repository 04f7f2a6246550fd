"""Dead-zone quantization and cubic companding on a torch device: port of
the JAX package's `ops/quant.py` (the demo pyramid's quantizer).

The compander is computed arithmetically, as the JAX ops compute it, not
by the reference's 1 KiB tables (`Example/WaveletDemo/utils.c:617-640`):
the forward map

    code(m) = max{ i : i + (3*i^3 >> 16) <= m }

by a 9-step binary search, and the inverse in closed form,

    inv(c) = min(mag(c+1) - 1, 1023),  mag(i) = i + (3*i^3 >> 16).

Quantizer contract (`utils.c:29-131`, production `Codec/quantize.c`):
    multiplier = 65536 // q ; midpoint = max(q//2 - 1, 0)
    mag  = ((|v| + midpoint) * multiplier) >> 16
"""

from __future__ import annotations

import torch

from cineform_tpu_torch.spec.quant import quant_midpoint, quant_multiplier


def _compand_mag(i: torch.Tensor) -> torch.Tensor:
    """mag(i) = i + (3*i^3 >> 16) for i in [0, 257] (fits int32)."""
    return i + ((3 * i * i * i) >> 16)


def compand_forward(mag: torch.Tensor) -> torch.Tensor:
    """Quantized magnitude (0..1024) -> 8-bit companded code (0..256): the
    binary search for max{c : mag(c) <= m} over c in [0, 256] (9 compare
    steps; mag(0) = 0 and mag(257) = 1034 bound it)."""
    lo = torch.zeros_like(mag)
    hi = torch.full_like(mag, 257)
    for _ in range(9):  # 2^9 = 512 > 257
        mid = (lo + hi) >> 1
        ok = _compand_mag(mid) <= mag
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return lo


def compand_inverse(code: torch.Tensor) -> torch.Tensor:
    """8-bit code -> magnitude (the reference's inverse table: the largest
    magnitude that maps to the code)."""
    return (_compand_mag(code + 1) - 1).clamp(max=1023)


def quantize_band(vals: torch.Tensor, q: int) -> torch.Tensor:
    """Dead-zone quantize + compand; int32 in and out, codes in
    [-255, 255]."""
    if q == 1:
        # no dead zone: the magnitude is |v|
        mag = vals.abs()
    else:
        mag = ((vals.abs() + quant_midpoint(q)) * quant_multiplier(q)) >> 16
    code = compand_forward(mag.clamp(max=1024)).clamp(max=255)
    return torch.where(vals < 0, -code, code)


def dequantize_band(codes: torch.Tensor, q: int) -> torch.Tensor:
    """Inverse compand then multiply by q (`utils.c:134-156`)."""
    mag = compand_inverse(codes.abs())
    mag = torch.where(codes == 0, 0, mag)
    return torch.where(codes < 0, -mag, mag) * q


def prescale_lowpass(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Lowpass inter-level scaling (`utils.c:405-422`)."""
    if shift == 0:
        return x
    if shift < 0:
        s = -shift
        return (x + (1 << (s - 1))) >> s
    return x << shift

"""Forward DWT level: the CUDA kernel `csrc/dwt_forward.cu` and its wrapper.

`dwt_forward_level(x, prescale, quant)` equals
`ops.intra_transform.dwt2d_forward(x, prescale, quant)` bit for bit.  For
a tensor on the CPU it runs that plain version; for a CUDA tensor it
launches the kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cineform_tpu_torch import _build
from cineform_tpu_torch.ops import intra_transform

# x, ll, lh, hl, hh; batch, h, w, prescale, q0, q1, q2
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7


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
    outs = [torch.empty((*lead, h // 2, w // 2), dtype=torch.int32,
                        device=x.device) for _ in range(4)]
    _build.launch(dwt_forward_level, "dwt_forward", "cf_dwt_forward_level",
                  _ARGTYPES, x, *outs, batch, h, w, prescale, q0, q1, q2)
    ll, lh, hl, hh = outs
    return ll, (lh, hl, hh)


#: kernel launches since the last reset (the CPU path does not count)
dwt_forward_level.launches = 0

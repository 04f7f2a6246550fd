"""Across-chunk compaction: the CUDA kernel `csrc/merge_network.cu` and its
wrapper.

`merge_network(val, rem)` returns the settled (val, rem) of the encoder's
low-bit-first monotone-displacement network, `entropy.device.
_settle_network`, bit for bit.  For tensors on the CPU it runs that plain
version; for CUDA tensors it launches the kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cineform_tpu_torch import _build

# val, rem, out_val, out_rem, tmp_val, tmp_rem; rows, n
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong, ctypes.c_int)


def merge_network(val: torch.Tensor, rem: torch.Tensor):
    """val: (..., N) int32 uint32 bit patterns; rem: (..., N) int32
    displacements.  Returns the settled (val, rem)."""
    from cineform_tpu_torch.entropy.device import _settle_network

    for name, t in (("val", val), ("rem", rem)):
        if t.dtype != torch.int32:
            raise TypeError(f"merge_network: {name} must be int32, "
                            f"got {t.dtype}")
    if val.shape != rem.shape or val.dim() < 1 or val.shape[-1] == 0:
        raise ValueError(f"merge_network: shapes {tuple(val.shape)} and "
                         f"{tuple(rem.shape)} differ")
    if not _build.uses_kernel("merge_network", val):
        return _settle_network(val, rem)
    n = val.shape[-1]
    out_val, tmp_val = torch.empty_like(val), torch.empty_like(val)
    out_rem, tmp_rem = torch.empty_like(rem), torch.empty_like(rem)
    _build.launch(merge_network, "merge_network", "cf_merge_network",
                  _ARGTYPES, val, rem, out_val, out_rem, tmp_val, tmp_rem,
                  val.numel() // n, n)
    return out_val, out_rem


#: kernel launches since the last reset (the CPU path does not count)
merge_network.launches = 0

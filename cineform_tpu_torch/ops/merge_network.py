"""Displacement merge networks: the CUDA kernels of `csrc/merge_network.cu`
and their wrappers.

- `merge_network(val, rem)`: the encoder's low-bit-first network,
  `entropy.device._settle_network`;
- `merge_network_tgt(val, rem, tgt)`: the same network carrying a third
  array merged by max, the decoder's slot compaction,
  `entropy.device._settle_network_tgt`;
- `merge_network_highfirst(val, rem)`: the high-bit-first network,
  `entropy.device._settle_network_highfirst`, which the decoder's spread
  runs on mirrored rows.

Each returns its plain version's settled arrays bit for bit.  For tensors
on the CPU it runs that plain version; for CUDA tensors it launches its
kernel, or raises.  Each counts its own launches.
"""

from __future__ import annotations

import ctypes

import torch

from cineform_tpu_torch import _build

_P = ctypes.c_void_p
_ROWS_N = (ctypes.c_longlong, ctypes.c_int)
# val, rem, out_val, out_rem, tmp_val, tmp_rem; rows, n
_ARGTYPES = (_P,) * 6 + _ROWS_N
# val, rem, tgt, out_*, tmp_* (three each); rows, n
_ARGTYPES_TGT = (_P,) * 9 + _ROWS_N


def _check(name: str, *arrays: tuple[str, torch.Tensor]) -> None:
    for what, t in arrays:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
    shapes = {tuple(t.shape) for _, t in arrays}
    t = arrays[0][1]
    if len(shapes) != 1 or t.dim() < 1 or t.shape[-1] == 0:
        raise ValueError(f"{name}: shapes {sorted(shapes)} differ or are "
                         "empty")


def _run(wrapper, symbol: str, argtypes: tuple, *arrays: torch.Tensor):
    """Launch `symbol` on (arrays, outputs, scratch, rows, n)."""
    n = arrays[0].shape[-1]
    outs = [torch.empty_like(a) for a in arrays]
    tmps = [torch.empty_like(a) for a in arrays]
    _build.launch(wrapper, "merge_network", symbol, argtypes, *arrays,
                  *outs, *tmps, arrays[0].numel() // n, n)
    return tuple(outs)


def merge_network(val: torch.Tensor, rem: torch.Tensor):
    """val: (..., N) int32 uint32 bit patterns; rem: (..., N) int32
    displacements.  Returns the settled (val, rem) of the low-bit-first
    network."""
    from cineform_tpu_torch.entropy.device import _settle_network

    _check("merge_network", ("val", val), ("rem", rem))
    if not _build.uses_kernel("merge_network", val):
        return _settle_network(val, rem)
    return _run(merge_network, "cf_merge_network", _ARGTYPES, val, rem)


def merge_network_tgt(val: torch.Tensor, rem: torch.Tensor,
                      tgt: torch.Tensor):
    """The low-bit-first network on (val, rem, tgt), each (..., N) int32,
    tgt merged by max.  Returns the settled (val, rem, tgt)."""
    from cineform_tpu_torch.entropy.device import _settle_network_tgt

    _check("merge_network_tgt", ("val", val), ("rem", rem), ("tgt", tgt))
    if not _build.uses_kernel("merge_network_tgt", val):
        return _settle_network_tgt(val, rem, tgt)
    return _run(merge_network_tgt, "cf_merge_network_tgt", _ARGTYPES_TGT,
                val, rem, tgt)


def merge_network_highfirst(val: torch.Tensor, rem: torch.Tensor):
    """The high-bit-first network on (val, rem), each (..., N) int32.
    Returns the settled (val, rem)."""
    from cineform_tpu_torch.entropy.device import _settle_network_highfirst

    _check("merge_network_highfirst", ("val", val), ("rem", rem))
    if not _build.uses_kernel("merge_network_highfirst", val):
        return _settle_network_highfirst(val, rem)
    return _run(merge_network_highfirst, "cf_merge_network_highfirst",
                _ARGTYPES, val, rem)


#: kernel launches since the last reset (the CPU path does not count)
merge_network.launches = 0
merge_network_tgt.launches = 0
merge_network_highfirst.launches = 0

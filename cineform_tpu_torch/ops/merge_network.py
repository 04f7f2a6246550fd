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

Each form runs in two branches on the card: a one-pass placement that
also checks, per row, the condition under which the network equals it
(plain versions: `entropy.device._concat_guard` with `_place_concat`,
`_compact_guard` with `_place_compact`, `_spread_guard` with
`_place_spread`), and the network itself, which returns at once on the
rows that passed.  The device counts the rows that failed in
`<wrapper>.flagged[device]`, with no host synchronisation;
`<wrapper>.branch_launches` counts each branch's launches.
"""

from __future__ import annotations

import ctypes

import torch

from cineform_tpu_torch import _build

_P = ctypes.c_void_p
_ROWS_N = (ctypes.c_longlong, ctypes.c_int)
# val, rem, out_val, out_rem, tmp_val, tmp_rem, flags, flagged; rows, n
_ARGTYPES = (_P,) * 8 + _ROWS_N
# val, rem, tgt, out_*, tmp_* (three each), flags, flagged; rows, n
_ARGTYPES_TGT = (_P,) * 11 + _ROWS_N


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
    """Launch `symbol` on (arrays, outputs, scratch, flags, flagged, rows,
    n)."""
    n = arrays[0].shape[-1]
    rows = arrays[0].numel() // n
    outs = [torch.empty_like(a) for a in arrays]
    tmps = [torch.empty_like(a) for a in arrays]
    dev = arrays[0].device
    if dev not in wrapper.flagged:
        wrapper.flagged[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    flags = torch.zeros(rows, dtype=torch.int32, device=dev)
    _build.launch(wrapper, "merge_network", symbol, argtypes, *arrays,
                  *outs, *tmps, flags, wrapper.flagged[dev], rows, n)
    for branch in wrapper.branch_launches:
        wrapper.branch_launches[branch] += 1
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


for _w in (merge_network, merge_network_tgt, merge_network_highfirst):
    #: kernel launches since the last reset (the CPU path does not count)
    _w.launches = 0
    #: launches of each branch since the last reset
    _w.branch_launches = {"placement": 0, "network": 0}
    #: per CUDA device, a (1,) int32 tensor: rows that failed the guard
    #: and ran the network, since the last reset
    _w.flagged = {}


def reset_counts() -> None:
    """Set every launch count and flagged-row count of the module to 0."""
    for w in (merge_network, merge_network_tgt, merge_network_highfirst):
        w.launches = 0
        w.branch_launches = dict.fromkeys(w.branch_launches, 0)
        for t in w.flagged.values():
            t.zero_()

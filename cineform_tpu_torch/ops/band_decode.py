"""Stages 1-5 of the band entropy decoder: the CUDA kernels of
`csrc/band_decode.cu` and their launcher.

`band_kernels(payload, nchunks, quant, linear, nout, bounds, leaves)`
returns the per-chunk slots (ctgt, cval, nval, ovf) of
`entropy.device_decode.plain_band_slots` bit for bit, for CUDA tensors
only: the transfers inside the tracer span `entropy.chunk_transfers`, the
row scan inside `entropy.scan_entries_rows`, the final walk with the slot
emission inside `entropy.final_walk`.  It counts its own launches, and
once all three have launched, the rows they decoded in the counter
`entropy.band_rows_kernel`.  `entropy.device_decode.band_slots` is the
wrapper that picks it or the plain stages by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from cineform_tpu_torch import _build
from cineform_tpu_torch.utils import timing

#: chunks a tile of the kernels (`kTile`); a transfer's entries, phases
#: 0..27 (`kFun`); slots a chunk (`NSLOT`)
TILE = 64
NFUN = 28
NSLOT = 12

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# payload, nchunks, bounds, leaves, chunk_f, chunk_c, agg_f, agg_c; rows,
# s, nlut
_TRANSFERS = (_P,) * 8 + (_LL, _LL, _I)
# agg_f, agg_c, nchunks, tile_e, tile_b; rows, s
_SCAN = (_P,) * 5 + (_LL, _LL)
# payload, chunk_f, chunk_c, tile_e, tile_b, nchunks, quant, linear,
# bounds, leaves, ctgt, cval, nval, ovf; rows, s, nlut, nout
_WALK = (_P,) * 14 + (_LL, _LL, _I, _I)


def check(payload, nchunks, quant, linear, nout) -> None:
    """Raises unless the arguments are what the kernels read."""
    if payload.dtype != torch.uint8:
        raise TypeError(f"band_kernels: payload must be uint8, got "
                        f"{payload.dtype}")
    if payload.dim() != 2 or payload.shape[1] % 4:
        raise ValueError(f"band_kernels: payload of shape "
                         f"{tuple(payload.shape)} is not (rows, 4 chunks)")
    for what, t in (("nchunks", nchunks), ("quant", quant),
                    ("linear", linear)):
        if t.dtype != torch.int32:
            raise TypeError(f"band_kernels: {what} must be int32, got "
                            f"{t.dtype}")
        if t.shape != payload.shape[:1]:
            raise ValueError(f"band_kernels: {what} of shape {tuple(t.shape)} "
                             f"for payload rows {tuple(payload.shape)}")
    if not 0 <= nout < 1 << 31:
        raise ValueError(f"band_kernels: region size {nout} out of int32")


def band_kernels(payload: torch.Tensor, nchunks: torch.Tensor,
                 quant: torch.Tensor, linear: torch.Tensor, nout: int,
                 bounds: torch.Tensor, leaves: torch.Tensor):
    """payload: (R, S*4) uint8 band rows; nchunks, quant, linear: (R,)
    int32; nout: the region size; bounds, leaves: codeset 17's interval
    table (`entropy.device_decode._interval_lut`), all on one CUDA
    device.  Returns (ctgt (R, S, NSLOT) int32, cval (R, S, NSLOT) int32,
    nval (R, S) int32, ovf (R, S) bool)."""
    check(payload, nchunks, quant, linear, nout)
    if not _build.uses_kernel("band_kernels", payload):
        raise ValueError("band_kernels: the kernels take CUDA tensors; "
                         "the plain stages run on the CPU")
    rows, s = payload.shape[0], payload.shape[1] // 4
    dev = payload.device
    out = (torch.empty((rows, s, NSLOT), dtype=torch.int32, device=dev),
           torch.empty((rows, s, NSLOT), dtype=torch.int32, device=dev),
           torch.empty((rows, s), dtype=torch.int32, device=dev),
           torch.empty((rows, s), dtype=torch.bool, device=dev))
    if rows * s == 0:           # rows of no chunks: the empty slots
        timing.count("entropy.band_rows_kernel", rows)
        return out
    if payload.data_ptr() % 4:
        raise ValueError("band_kernels: payload must start on a 4-byte "
                         "boundary (the kernels load it in words)")
    nt = -(-s // TILE)
    nlut = bounds.numel()
    chunk_f = torch.empty((rows, s, NFUN), dtype=torch.uint8, device=dev)
    chunk_c = torch.empty((rows, s, NFUN), dtype=torch.int16, device=dev)
    agg_f = torch.empty((rows, nt, NFUN), dtype=torch.uint8, device=dev)
    agg_c = torch.empty((rows, nt, NFUN), dtype=torch.int32, device=dev)
    tile_e = torch.empty((rows, nt), dtype=torch.int32, device=dev)
    tile_b = torch.empty((rows, nt), dtype=torch.int32, device=dev)
    with timing.span("entropy.chunk_transfers"):
        _build.launch(band_kernels, "band_decode", "cf_band_transfers",
                      _TRANSFERS, payload, nchunks, bounds, leaves, chunk_f,
                      chunk_c, agg_f, agg_c, rows, s, nlut)
    with timing.span("entropy.scan_entries_rows"):
        _build.launch(band_kernels, "band_decode", "cf_band_scan", _SCAN,
                      agg_f, agg_c, nchunks, tile_e, tile_b, rows, s)
    with timing.span("entropy.final_walk"):
        _build.launch(band_kernels, "band_decode", "cf_band_walk", _WALK,
                      payload, chunk_f, chunk_c, tile_e, tile_b, nchunks,
                      quant, linear, bounds, leaves, *out, rows, s, nlut,
                      nout)
    timing.count("entropy.band_rows_kernel", rows)
    return out


#: kernel launches since the last reset, three a call
band_kernels.launches = 0

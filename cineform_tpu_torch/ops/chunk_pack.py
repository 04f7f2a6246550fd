"""Within-chunk bit packing: the CUDA kernel `csrc/chunk_pack.cu` and its
wrapper.

`chunk_pack(bits, sizes, max_code_bits, cap_bits_per_elem)` equals
`entropy.device.tree_pack` over the last axis of 256-element chunks, bit
for bit.  For tensors on the CPU it runs that plain version; for CUDA
tensors it launches the kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cineform_tpu_torch import _build

CHUNK = 256
# bits, sizes, words, lens, ovf; nchunks, schedule
_ARGTYPES = ((ctypes.c_void_p,) * 5
             + (ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)))


def chunk_pack(bits: torch.Tensor, sizes: torch.Tensor,
               max_code_bits: int = 27, cap_bits_per_elem: int = 12):
    """bits/sizes: (..., T, 256) int32 per-element codes.  Returns (words
    (..., T, W) int32 uint32 bit patterns, lens (..., T) int32, overflow
    (..., T) bool)."""
    from cineform_tpu_torch.entropy.device import pack_schedule, tree_pack

    for name, t in (("bits", bits), ("sizes", sizes)):
        if t.dtype != torch.int32:
            raise TypeError(f"chunk_pack: {name} must be int32, got {t.dtype}")
    if bits.shape != sizes.shape or bits.dim() < 1 or bits.shape[-1] != CHUNK:
        raise ValueError(f"chunk_pack: expected equal (..., {CHUNK}) shapes, "
                         f"got {tuple(bits.shape)} and {tuple(sizes.shape)}")
    if not _build.uses_kernel("chunk_pack", bits):
        return tree_pack(bits, sizes, max_code_bits, cap_bits_per_elem)
    lead = bits.shape[:-1]
    nchunks = bits.numel() // CHUNK
    levels = pack_schedule(max_code_bits, cap_bits_per_elem, CHUNK)
    schedule = (ctypes.c_int * (3 * len(levels)))(
        *(int(v) for level in levels for v in level))
    w_final = levels[-1][0]
    dev = bits.device
    words = torch.empty((*lead, w_final), dtype=torch.int32, device=dev)
    lens = torch.empty(lead, dtype=torch.int32, device=dev)
    ovf = torch.empty(lead, dtype=torch.bool, device=dev)
    _build.launch(chunk_pack, "chunk_pack", "cf_chunk_pack", _ARGTYPES,
                  bits, sizes, words, lens, ovf, nchunks, schedule)
    return words, lens, ovf


#: kernel launches since the last reset (the CPU path does not count)
chunk_pack.launches = 0

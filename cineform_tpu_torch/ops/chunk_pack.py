"""Within-chunk bit packing: the CUDA kernel `csrc/chunk_pack.cu` and its
wrapper.

`chunk_pack(bits, sizes, max_code_bits, cap_bits_per_elem)` equals
`entropy.device.tree_pack` over the last axis of 256-element chunks, bit
for bit.  For tensors on the CPU it runs that plain version; for CUDA
tensors it launches the kernel, or raises.

On the card a chunk that fits its tree's words (plain versions:
`entropy.device._pack_fits`, `_pack_direct`) is packed by a prefix sum of
its code sizes, and any other chunk by the tree; the device counts the
latter in `chunk_pack.tree_chunks[device]`, with no host synchronisation.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from cineform_tpu_torch import _build

CHUNK = 256
# bits, sizes, words, lens, ovf, tree_chunks; nchunks, schedule
_ARGTYPES = ((ctypes.c_void_p,) * 6
             + (ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)))


@lru_cache(maxsize=None)
def _schedule(max_code_bits: int, cap_bits_per_elem: int):
    """(the packing tree's schedule as the kernel takes it, 3 ints a level;
    words per chunk of the last level)."""
    from cineform_tpu_torch.entropy.device import pack_schedule

    levels = pack_schedule(max_code_bits, cap_bits_per_elem, CHUNK)
    array = (ctypes.c_int * (3 * len(levels)))(
        *(int(v) for level in levels for v in level))
    return array, levels[-1][0]


def chunk_pack(bits: torch.Tensor, sizes: torch.Tensor,
               max_code_bits: int = 27, cap_bits_per_elem: int = 12):
    """bits/sizes: (..., T, 256) int32 per-element codes.  Returns (words
    (..., T, W) int32 uint32 bit patterns, lens (..., T) int32, overflow
    (..., T) bool)."""
    from cineform_tpu_torch.entropy.device import tree_pack

    for name, t in (("bits", bits), ("sizes", sizes)):
        if t.dtype != torch.int32:
            raise TypeError(f"chunk_pack: {name} must be int32, got {t.dtype}")
    if bits.shape != sizes.shape or bits.dim() < 1 or bits.shape[-1] != CHUNK:
        raise ValueError(f"chunk_pack: expected equal (..., {CHUNK}) shapes, "
                         f"got {tuple(bits.shape)} and {tuple(sizes.shape)}")
    if not _build.uses_kernel("chunk_pack", bits):
        return tree_pack(bits, sizes, max_code_bits, cap_bits_per_elem)
    if (bits.data_ptr() | sizes.data_ptr()) % 16:
        raise ValueError("chunk_pack: bits and sizes must start on a 16-byte "
                         "boundary (the kernel loads them in 16-byte vectors)")
    lead = bits.shape[:-1]
    nchunks = bits.numel() // CHUNK
    schedule, w_final = _schedule(max_code_bits, cap_bits_per_elem)
    dev = bits.device
    if dev not in chunk_pack.tree_chunks:
        chunk_pack.tree_chunks[dev] = torch.zeros(1, dtype=torch.int32,
                                                  device=dev)
    words = torch.empty((*lead, w_final), dtype=torch.int32, device=dev)
    lens = torch.empty(lead, dtype=torch.int32, device=dev)
    ovf = torch.empty(lead, dtype=torch.bool, device=dev)
    _build.launch(chunk_pack, "chunk_pack", "cf_chunk_pack", _ARGTYPES,
                  bits, sizes, words, lens, ovf, chunk_pack.tree_chunks[dev],
                  nchunks, schedule)
    return words, lens, ovf


#: kernel launches since the last reset (the CPU path does not count)
chunk_pack.launches = 0
#: per CUDA device, a (1,) int32 tensor: chunks that ran the tree
chunk_pack.tree_chunks = {}

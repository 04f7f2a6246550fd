"""uint32 words carried in signed torch integer tensors.

PyTorch has no usable uint32 arithmetic on the CPU (`>>`, `<<`, `+`,
`maximum`, `scatter_` raise), while the CFHD bit packer works on uint32
words.  The port therefore keeps words in two forms:

- at interfaces (kernel arguments, stage outputs): int32 tensors holding
  the uint32 bit pattern, which the CUDA kernels read as `uint32_t`;
- where words are shifted: int64 tensors holding the uint32 value in
  [0, 2^32), so that `>>` is a logical shift and `<<` cannot overflow for
  shifts below 32.  Every left shift is masked back to 32 bits.

The bytes are reinterpreted as uint32 only on the host, in
`entropy.device.finish_band_bytes`.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or small non-negative ints) -> int64 uint32 value."""
    return x.to(torch.int64) & MASK32


def bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 value -> int32 bit pattern (two's-complement wrap)."""
    return (x & MASK32).to(torch.int32)

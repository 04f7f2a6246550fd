"""cineform_tpu_torch — the CFHD intra codec in PyTorch, with CUDA kernels
written by hand for NVIDIA Hopper (sm_90a).

A port of `cineform_tpu` (JAX/Pallas) on its YUY2 intra path.  The device
code is re-expressed in PyTorch; the host pieces that path needs (format
constants, the sample writer, parser and native header walk, the C++ band
coder, the output dither) are the package's own copies of the JAX
package's modules, trimmed to that path.  Its outputs equal the JAX
package's bit for bit, and the CFHD samples it writes equal the reference
SDK's.

Layout (mirrors `cineform_tpu`):
  ops/      — the intra transform as tensor functions, and the wrappers of
              the three kernels (forward DWT level, chunk bit-pack, merge
              network), each beside its plain PyTorch version.
  entropy/  — the band entropy encoder and decoder on tensors, and the
              host C++ band coder (`native`).
  models/   — `IntraCodec`: 1080p-class YUY2 intra encode and decode, and
              `intra_host`, the sample writer.
  spec/, bitstream/, ref/, utils/, native/ — the host copies.
  csrc/     — the CUDA C++ kernel sources, built with nvcc at first use.
  state.py  — the codec's constant tables as tensors on a device.

This package imports `torch` and never `jax` nor `cineform_tpu`.
"""

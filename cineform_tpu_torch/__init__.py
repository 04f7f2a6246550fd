"""cineform_tpu_torch — the CFHD intra codec in PyTorch, with CUDA kernels
written by hand for NVIDIA Hopper (sm_90a).

A port of the device half of `cineform_tpu` (JAX/Pallas).  The host layers
of `cineform_tpu` (spec/, ref/, bitstream/, entropy/native and host,
models/intra_host) hold no JAX and are imported as they are; this package
re-expresses only the device code.  Its outputs equal the JAX package's bit
for bit, and the CFHD samples it writes equal the reference SDK's.

Layout (mirrors `cineform_tpu`):
  ops/      — the intra transform as tensor functions, and the wrappers of
              the three kernels (forward DWT level, chunk bit-pack, merge
              network), each beside its plain PyTorch version.
  entropy/  — the band entropy encoder (run geometry, codes, packing).
  models/   — `IntraCodec`: 1080p-class YUY2 intra encode and decode.
  csrc/     — the CUDA C++ kernel sources, built with nvcc at first use.
  state.py  — the codec's constant tables as tensors on a device.

This package imports `torch` and never `jax`.
"""

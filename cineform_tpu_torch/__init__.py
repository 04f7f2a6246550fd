"""cineform_tpu_torch — the CFHD codec in PyTorch, with CUDA kernels
written by hand for NVIDIA Hopper (sm_90a).

A port of `cineform_tpu` (JAX/Pallas) on its intra paths (4:2:2 YUY2,
UYVY, YU64, V210; RGB 4:4:4 RG48; RGBA 4:4:4:4 B64A, RG64; Bayer BYR4,
BYR5), its two-frame GOP codec, its stereo 3D device route, and its public
API and pools on them.  The
device code is re-expressed in PyTorch; the host pieces those paths need
(format constants, the sample writers, parser and native header walk, the
C++ band coder, the output dither) are the package's own copies of the
JAX package's modules, trimmed to those paths.  Its outputs equal the JAX
package's bit for bit, and the CFHD samples it writes equal the reference
SDK's.

Layout (mirrors `cineform_tpu`):
  ops/      — the intra transform and the input unpacks as tensor
              functions, and the wrappers of the three kernels (forward
              DWT, chunk bit-pack, merge network), each beside its plain
              PyTorch version.
  entropy/  — the band entropy encoder and decoder on tensors, and the
              host C++ band coder (`native`).
  models/   — `IntraCodec`: 1080p-class intra encode and decode of every
              format above; `GopCodec`: two-frame GOP (FIELDPLUS) groups
              of YUY2 pairs; `stereo`: 3D samples on `IntraCodec`; and
              the sample writers `intra_host` and `gop_host`.
  spec/, bitstream/, ref/, utils/, native/ — the host copies.
  csrc/     — the CUDA C++ kernel sources, built with nvcc at first use.
  state.py  — the codec's constant tables as tensors on a device.
  api.py    — the public CFHD API (`Encoder`, `Decoder`, `StereoEncoder`,
              the `CFHD_*` aliases) on those codecs, on one device.
  pool.py   — `EncoderPool` and `DecoderPool`: batches of 8 frames on
              the device, harvested in submission order.

This package imports `torch` and never `jax` nor `cineform_tpu`.
"""

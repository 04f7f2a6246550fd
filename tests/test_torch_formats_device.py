"""The port's new formats against the JAX `IntraCodec`'s own device
routes, on the CPU: `encode_batch_device` of a Bayer format, and
`decode_batch_device` to BGRA.

Apart from tests/test_torch_formats.py because the JAX device routes
compile their programs on first use (10-40 s each on one CPU core).  The
10-bit 4:2:2 encodes are held against the JAX package's host encoder
there, which its own (slow) tests hold the JAX device encode to.  Every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from cineform_tpu.models.intra import IntraCodec as JaxIntraCodec
from cineform_tpu_torch.models.intra import IntraCodec
from tests.test_torch_formats import _random_frames

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("fmt", ["BYR4"])
def test_encode_matches_jax_device_encode(fmt):
    """Both encode routes of the port on seeded 96x48 mosaics (48x24
    planes at `rgb_quality` 3) against the JAX
    `IntraCodec.encode_batch_device`."""
    w, h = 96, 48
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    frames = _random_frames(fmt, w, h, 7 + len(fmt))
    want = JaxIntraCodec(width=w, height=h, quality=4,
                         input_format=fmt).encode_batch_device(frames, 2)
    assert codec.encode_batch_device(frames, 2) == want
    assert codec.encode_batch(frames, 2) == want


def test_bgra_device_decode_matches_jax_device_decode():
    """A batch of 2 seeded UYVY frames at 144x32 decoded to BGRA on the
    port's device route equals the JAX `decode_batch_device`.  The chroma
    lowpass is 9 wide there, where the JAX device decode adds the odd-width
    offset on top of the 4:2:2 load bias and so differs from the JAX host
    decoder `decode_sample_bgra` (ROADMAP.md Queue 3); the port follows
    the JAX device decode, on both its routes."""
    w, h = 144, 32
    codec = IntraCodec(w, h, 4, device=CPU, input_format="UYVY")
    samples = codec.encode_batch(_random_frames("UYVY", w, h, w))
    want = JaxIntraCodec(width=w, height=h, quality=4,
                         input_format="UYVY").decode_batch_device(
        samples, output="BGRA")
    got, fallback = codec.decode_batch_device(samples, output="BGRA")
    assert fallback == () and got.shape == (2, h, w, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        codec.decode_batch(samples, output="BGRA"), want)

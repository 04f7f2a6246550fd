"""The port's demo pyramid (`cineform_tpu_torch.ops.dwt`, `ops.quant`,
`ops.pyramid`) on the CPU against the JAX package's (`cineform_tpu.ops.
dwt`, `quant`, `pyramid`), at the shapes of `tests/test_jax_ops.py` (up
to 540x960), every quantizer that file takes and the exhaustive compand
ranges.  Every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (forces CPU platform before jax import)
import jax.numpy as jnp

from cineform_tpu.ops import dwt as jdwt
from cineform_tpu.ops import pyramid as jpyramid
from cineform_tpu.ops import quant as jquant
from cineform_tpu.spec.quant import demo_quant_tables
from cineform_tpu_torch.ops import dwt, pyramid, quant

torch.set_num_threads(1)


def _rand(shape, lo=-20000, hi=20000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=shape, dtype=np.int32)


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got = got.numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def _both(fn, jfn, *arrays):
    _same(fn(*(torch.from_numpy(a) for a in arrays)),
          jfn(*(jnp.asarray(a) for a in arrays)))


@pytest.mark.parametrize("shape", [(8, 16), (34, 64), (135, 240), (540, 960),
                                   (3, 2, 32, 64)])
def test_h26_forward_matches_jax(shape):
    _both(dwt.h26_forward, jdwt.h26_forward, _rand(shape))


@pytest.mark.parametrize("shape", [(8, 16), (34, 64), (135, 240)])
def test_h26_inverse_matches_jax(shape):
    _both(dwt.h26_inverse, jdwt.h26_inverse, _rand(shape, seed=1),
          _rand(shape, -5000, 5000, seed=2))


@pytest.mark.parametrize("shape", [(16, 24), (64, 48), (270, 480),
                                   (2, 16, 24)])
def test_v26_matches_jax(shape):
    x = _rand(shape, seed=3)
    _both(dwt.v26_forward, jdwt.v26_forward, x)
    low, high = (np.array(a) for a in jdwt.v26_forward(jnp.asarray(x)))
    _both(dwt.v26_inverse, jdwt.v26_inverse, low, high)


@pytest.mark.parametrize("shape", [(16, 24), (64, 48)])
def test_haar_matches_jax(shape):
    x = _rand(shape, seed=4)
    y = _rand(shape, seed=5)
    _both(dwt.v22_forward, jdwt.v22_forward, x)
    half = shape[0] // 2
    _both(dwt.v22_inverse, jdwt.v22_inverse, x[:half], y[:half])
    _both(dwt.t22_forward, jdwt.t22_forward, x, y)
    _both(dwt.t22_inverse, jdwt.t22_inverse, x, y)


@pytest.mark.parametrize("shape", [(8, 16), (64, 48), (270, 480)])
def test_dwt2d_matches_jax(shape):
    x = _rand(shape, 0, 4096, seed=6)
    _both(dwt.dwt2d_forward, jdwt.dwt2d_forward, x)
    bands = [np.array(b) for b in jdwt.dwt2d_forward(jnp.asarray(x))]
    _both(dwt.dwt2d_inverse, jdwt.dwt2d_inverse, *bands)


def test_compand_forward_exhaustive():
    _both(quant.compand_forward, jquant.compand_forward,
          np.arange(1025, dtype=np.int32))


def test_compand_inverse_exhaustive():
    _both(quant.compand_inverse, jquant.compand_inverse,
          np.arange(256, dtype=np.int32))


@pytest.mark.parametrize("q", [1, 6, 12, 24, 48, 72, 255])
def test_quantize_and_dequantize_match_jax(q):
    vals = _rand((64, 96), -3000, 3000, seed=q)
    codes = quant.quantize_band(torch.from_numpy(vals), q)
    _same(codes, jquant.quantize_band(jnp.asarray(vals), q))
    _same(quant.dequantize_band(codes, q),
          jquant.dequantize_band(jnp.asarray(codes.numpy()), q))


@pytest.mark.parametrize("shift", [-2, -1, 0, 1, 2])
def test_prescale_lowpass_matches_jax(shift):
    x = _rand((16, 24), seed=8)
    _same(quant.prescale_lowpass(torch.from_numpy(x), shift),
          jquant.prescale_lowpass(jnp.asarray(x), shift))


@pytest.mark.parametrize("depth,shape", [(12, (96, 160)), (10, (64, 128)),
                                         (8, (48, 64))])
def test_pyramid_matches_jax(depth, shape):
    """3 fused levels forward, then the inverse, subband by subband."""
    x = _rand(shape, 0, 1 << depth, seed=7)
    qt, ps = demo_quant_tables(depth)
    pyr = pyramid.forward_intra(torch.from_numpy(x), 3, qt, ps)
    jpyr = jpyramid.forward_intra(jnp.asarray(x), 3, qt, ps)
    _same(pyr.lowpass, jpyr.lowpass)
    for got, want in zip(pyr.highs, jpyr.highs):
        _same(got, tuple(want))
    for dc in (None, 4):
        _same(pyramid.inverse_intra(pyr, qt, ps, depth, dc),
              jpyramid.inverse_intra(jpyr, qt, ps, depth, dc))

"""The port's intra transform (cineform_tpu_torch.ops.intra_transform) vs
the JAX package's, and the plain forward level vs the Pallas kernels in
interpret mode.

Inputs are made with numpy from a seed and fed to both sides as numpy
arrays; the codec is integer and bit-exact, so every comparison is exact
(tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cineform_tpu.ops import intra_transform as jops
from cineform_tpu.ops.pallas_dwt import dwt2d_forward_pallas
from cineform_tpu.ops.pallas_dwt2 import dwt2d_forward_pallas2
from cineform_tpu_torch.ops import intra_transform as tops

torch.set_num_threads(1)

#: the parametrizations of tests/test_pallas_dwt.py
PALLAS_CASES = [
    (64, 128, 0, (24, 24, 36)),
    (64, 128, 2, (6, 6, 3)),
    (270, 960, 0, (24, 24, 12)),
    (30, 128, 0, (1, 1, 1)),
]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _rand(seed, shape, lo=-1200, hi=1200):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32)


def test_sat16_wrap16_on_negatives():
    x = np.array([-70000, -32769, -32768, -1, 0, 1, 32767, 32768, 70000],
                 np.int32)
    _eq(tops.sat16(_t(x)), jops.sat16(jnp.asarray(x)))
    _eq(tops.wrap16(_t(x)), jops.wrap16(jnp.asarray(x)))


@pytest.mark.parametrize("w", [8, 12, 14, 16, 24, 64])
@pytest.mark.parametrize("prescale", [0, 2])
def test_h26_forward_matches_jax(w, prescale):
    # widths <= 16 take the narrow-row quirk (prev-row overread at w%8==0)
    x = _rand(w + prescale, (2, 10, w))
    for got, want in zip(tops.h26_forward(_t(x), prescale),
                         jops.h26_forward(jnp.asarray(x), prescale)):
        _eq(got, want)


@pytest.mark.parametrize("h", [6, 12, 30])
def test_v26_forward_matches_jax(h):
    x = _rand(h, (2, h, 20), -40000, 40000)
    for got, want in zip(tops.v26_forward(_t(x)),
                         jops.v26_forward(jnp.asarray(x))):
        _eq(got, want)


@pytest.mark.parametrize("q", [0, 1, 2, 3, 6, 24, 36, 255])
def test_quantize_matches_jax(q):
    x = _rand(q, (4000,), -32768, 32768)
    _eq(tops.quantize(_t(x), q), jops.quantize(jnp.asarray(x), q))


@pytest.mark.parametrize("h,w,prescale,quant", PALLAS_CASES)
def test_dwt2d_forward_matches_jax_and_pallas(h, w, prescale, quant):
    x = _rand(3 * h + w, (2, h, w))
    ll, highs = tops.dwt2d_forward(_t(x), prescale, quant)
    jll, jhighs = jax.jit(lambda v: jops.dwt2d_forward(v, prescale, quant))(
        jnp.asarray(x))
    p1ll, p1highs = dwt2d_forward_pallas(jnp.asarray(x), prescale, quant,
                                         interpret=True)
    p2ll, p2highs = dwt2d_forward_pallas2(jnp.asarray(x), prescale, quant,
                                          tile_out=64, interpret=True)
    for want in (jll, p1ll, p2ll):
        _eq(ll, want)
    for wants in (jhighs, p1highs, p2highs):
        for got, want in zip(highs, wants):
            _eq(got, want)


@pytest.mark.parametrize("h,w", [(12, 8), (12, 14), (12, 16), (24, 32)])
@pytest.mark.parametrize("prescale,quant", [(0, (24, 24, 36)),
                                            (2, (6, 6, 3))])
def test_dwt2d_forward_narrow_rows(h, w, prescale, quant):
    """Widths <= 16 reach the narrow-row quirk that the Pallas kernels
    skip; the port must follow the JAX transform there."""
    x = _rand(h * w, (3, h, w), 0, 1024)
    ll, highs = tops.dwt2d_forward(_t(x), prescale, quant)
    jll, jhighs = jax.jit(lambda v: jops.dwt2d_forward(v, prescale, quant))(
        jnp.asarray(x))
    _eq(ll, jll)
    for got, want in zip(highs, jhighs):
        _eq(got, want)


@pytest.mark.parametrize("h,w", [(48, 64), (48, 56)])
def test_forward_channel_matches_jax(h, w):
    x = _rand(h + w, (2, h, w), 0, 1024)
    quants = [(24, 24, 36), (12, 12, 6), (6, 6, 3)]
    prescale = [0, 2, 0]
    lp, bands = tops.forward_channel(_t(x), quants, prescale)
    jlp, jbands = jax.jit(lambda v: jops.forward_channel(v, quants,
                                                         prescale))(
        jnp.asarray(x))
    _eq(lp, jlp)
    for bs, jbs in zip(bands, jbands):
        for got, want in zip(bs, jbs):
            _eq(got, want)


@pytest.mark.parametrize("h", [6, 16, 30])
def test_v26_inverse_matches_jax(h):
    lo, hi = _rand(h, (2, h, 24)), _rand(h + 1, (2, h, 24))
    _eq(tops.v26_inverse(_t(lo), _t(hi)),
        jops.v26_inverse(jnp.asarray(lo), jnp.asarray(hi)))


@pytest.mark.parametrize("descale", [1, 2])
def test_h26_inverse_matches_jax(descale):
    lo, hi = _rand(descale, (2, 8, 30)), _rand(descale + 7, (2, 8, 30))
    _eq(tops.h26_inverse(_t(lo), _t(hi), descale),
        jops.h26_inverse(jnp.asarray(lo), jnp.asarray(hi), descale))


@pytest.mark.parametrize("width,group", [(64, 16), (32, 8), (56, 8),
                                         (112, 16), (40, 8)])
def test_expand_dither_rows_matches_jax(width, group):
    rows = np.random.default_rng(width).integers(0, 2, (10, 16)).astype(
        np.uint8)
    _eq(tops.expand_dither_rows(_t(rows), width, group),
        jops.expand_dither_rows(jnp.asarray(rows), width, group))


@pytest.mark.parametrize("dithered", [False, True])
def test_h26_inverse_to_output_matches_jax(dithered):
    # wide ranges reach the +2048 SSE-lane wrap for sums below -2048
    lo = _rand(11, (2, 12, 32), -6000, 9000)
    hi = _rand(12, (2, 12, 32), -6000, 6000)
    d = (np.random.default_rng(13).integers(0, 2, (12, 64)).astype(np.int32)
         if dithered else None)
    got = tops.h26_inverse_to_output(
        _t(lo), _t(hi), dither=None if d is None else _t(d))
    want = jops.h26_inverse_to_output(
        jnp.asarray(lo), jnp.asarray(hi),
        dither=None if d is None else jnp.asarray(d))
    assert got.dtype == torch.uint8
    _eq(got, want)


def test_inverse_channel_to_8bit_matches_jax():
    rng = np.random.default_rng(5)
    lp = rng.integers(0, 8000, (2, 6, 8)).astype(np.int32)
    bands = [tuple(rng.integers(-300, 300, (2, 6 << (2 - k), 8 << (2 - k)))
                   .astype(np.int32) for _ in range(3)) for k in range(3)]
    dither = rng.integers(0, 2, (48, 64)).astype(np.int32)
    got = tops.inverse_channel_to_8bit(
        _t(lp), [tuple(_t(b) for b in bs) for bs in bands], [0, 2, 0],
        dither=_t(dither))
    want = jax.jit(lambda lp_, bs_, d: jops.inverse_channel_to_8bit(
        lp_, bs_, [0, 2, 0], dither=d))(
        jnp.asarray(lp), [tuple(jnp.asarray(b) for b in bs) for bs in bands],
        jnp.asarray(dither))
    _eq(got, want)


def test_unpack_and_pack_yuy2_match_jax():
    frame = np.random.default_rng(6).integers(0, 256, (2, 8, 32)).astype(
        np.uint8)
    for got, want in zip(tops.unpack_yuy2(_t(frame)),
                         jops.unpack_yuy2(jnp.asarray(frame))):
        _eq(got, want)
    planes = [np.random.default_rng(s).integers(0, 256, shape).astype(np.int32)
              for s, shape in ((7, (2, 8, 16)), (8, (2, 8, 8)), (9, (2, 8, 8)))]
    got = tops.pack_yuy2(*(_t(p) for p in planes))
    assert got.dtype == torch.uint8
    _eq(got, jops.pack_yuy2(*(jnp.asarray(p) for p in planes)))

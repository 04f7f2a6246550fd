"""The port's float develop stages (`cineform_tpu_torch.ops.develop`) and
`models.active_metadata.decode_bayer_developed` on the CPU, against the
JAX package's `ops/develop.py` and `models/active_metadata.py`.

The inputs are made from a seed with numpy.  The integer stages (the
scopes, `tools_scopes_wp13`) are held exactly; the float stages within an
absolute tolerance of 1e-6 on values in [0, 1] (XLA and torch need not
round float32 the same way: the runs here differ by at most 1.2e-7);
`decode_bayer_developed` within 1 uint16 LSB of the JAX function on the
WBAL and COLM goldens (they agree exactly here), on the device entropy
decode, and on a sample that overflows it and takes the host's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cineform_tpu.models import active_metadata as jam
from cineform_tpu.models import intra_host as jhost
from cineform_tpu.ops import develop as jdv
from cineform_tpu.ref import intra as jref
from cineform_tpu.spec import tags as jtags
from cineform_tpu.spec.production import IntraParams as JParams
from cineform_tpu_torch.models import active_metadata as tam
from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.ops import develop as tdv

torch.set_num_threads(1)

SAMPLES = os.path.join(os.path.dirname(__file__), "golden", "samples")
ATOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _rgb(shape=(2, 6, 10, 3), seed=0, lo=-0.1, hi=1.1):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _planes(seed=1, shape=(2, 5, 7)):
    rng = _rng(seed)
    return [rng.integers(0, 4096, shape).astype(np.int32) for _ in range(4)]


def _lut(n=5, seed=4):
    return _rng(seed).uniform(0, 1, (n, n, n, 3)).astype(np.float32)


FLOAT_STAGES = {
    "demosaic_bilinear": lambda m: m.demosaic_bilinear(
        *[_arg(m, p) for p in _planes()]),
    "white_balance": lambda m: m.white_balance(_arg(m, _rgb()),
                                               (1.5, 1.0, 0.7)),
    "color_matrix_3x3": lambda m: m.color_matrix(
        _arg(m, _rgb()), _rng(2).uniform(-1, 1, (3, 3))),
    "color_matrix_3x4": lambda m: m.color_matrix(
        _arg(m, _rgb()), _rng(3).uniform(-1, 1, (3, 4))),
    "gamma_curve": lambda m: m.gamma_curve(_arg(m, _rgb()), 1 / 2.2),
    "log_curve": lambda m: m.log_curve(_arg(m, _rgb()), 90.0),
    "apply_lut3d": lambda m: m.apply_lut3d(_arg(m, _rgb()), _arg(m, _lut())),
    "vignette": lambda m: m.vignette(_arg(m, _rgb()), 0.3),
    "vignette_off": lambda m: m.vignette(_arg(m, _rgb()), 0.0),
    "sharpen": lambda m: m.sharpen(_arg(m, _rgb()), 0.8),
    "develop_plain": lambda m: m.develop(*[_arg(m, p) for p in _planes()]),
    "develop_every_stage": lambda m: m.develop(
        *[_arg(m, p) for p in _planes(5)], wb=(1.2, 1.0, 0.9),
        matrix=_rng(6).uniform(-0.2, 1.0, (3, 4)), lut=_arg(m, _lut()),
        gamma=0.8, vignette_strength=0.2, sharpen_amount=0.5),
}


def _arg(mod, x):
    """numpy -> the module's array type."""
    return torch.from_numpy(x) if mod is tdv else jnp.asarray(x)


@pytest.mark.parametrize("stage", list(FLOAT_STAGES))
def test_float_stage_matches_jax(stage):
    got = FLOAT_STAGES[stage](tdv)
    assert got.dtype == torch.float32
    _close(got, FLOAT_STAGES[stage](jdv))


SCOPES = {
    "histogram": lambda m, x: m.histogram(x, 256),
    "histogram_64": lambda m, x: m.histogram(x, 64),
    "waveform": lambda m, x: m.waveform(x, 256),
    "vectorscope": lambda m, x: m.vectorscope(x, 128),
}


@pytest.mark.parametrize("scope", list(SCOPES))
def test_scope_matches_jax_exactly(scope):
    """The counts on seeded RGB (within and past [0, 1]) are equal."""
    x = _rgb((12, 40, 3), seed=9, lo=-0.05, hi=1.05)
    got = SCOPES[scope](tdv, torch.from_numpy(x))
    want = np.asarray(SCOPES[scope](jdv, jnp.asarray(x)))
    assert got.dtype == torch.int32 and (got.numpy() == want).all()


@pytest.mark.parametrize("w", [200, 720, 1000])
def test_tools_scopes_wp13_matches_jax_exactly(w):
    """The WP13 scopes, one column step (w <= 360) and two doubled."""
    x = _rng(w).integers(-200, 8400, (10, w, 3)).astype(np.int32)
    got = tdv.tools_scopes_wp13(torch.from_numpy(x))
    want = jdv.tools_scopes_wp13(jnp.asarray(x))
    assert got[3] == want[3]
    for g, wa in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32 and (g.numpy() == np.asarray(wa)).all()


class _LookDB:
    """A duck-typed LOOK database: `.load(crc)` -> an object with `.lut`."""

    class _Look:
        lut = _lut(9, 11)

    def load(self, crc):
        return self._Look()


@pytest.mark.parametrize("name", ["byr4_wbal_320x240_q4",
                                  "byr4_colm_320x240_q4",
                                  "byr4_320x240_q4_p1"])
def test_decode_bayer_developed_matches_jax(name):
    """Within 1 uint16 LSB of the JAX function."""
    with open(os.path.join(SAMPLES, name + ".cfhd"), "rb") as f:
        sample = f.read()
    want = jam.decode_bayer_developed(sample)
    got, fallback = tam.decode_bayer_developed(sample, device="cpu")
    assert fallback == ()
    assert got.dtype == np.uint16 and got.shape == want.shape
    assert np.abs(got.astype(np.int64) - want).max() <= 1


def _bayer_overflow_sample(w=64, h=48):
    """A seeded BYR4 sample whose coarsest G band holds four times the
    band's coefficients (as `tests/test_torch_pool.overflow_sample` builds
    its YUY2 one): the device decoder's overflow flag sends it to the
    host entropy decode."""
    frame = _rng(48).integers(0, 65536, (h, w)).astype("<u2").tobytes()
    params = JParams(width=w // 2, height=h // 2, quality=4,
                     precision=jtags.PRECISION_12BIT, chroma_full_res=True,
                     rgb_quality=3)
    chans = [jhost.transform_channel(p, params, c) for c, p in
             enumerate(jref.unpack_byr4(frame, w, h, 0))]
    coarse = chans[0].bands[2][0]
    oversize = np.ones((coarse.shape[0] * 4, coarse.shape[1]), np.int32)
    chans[0].payloads = [None, None,
                         (jhost.encode_band_payload(oversize), None, None)]
    return jhost.write_sample(chans, params, 1, jhost.EncoderMetadata(),
                              input_format=104,
                              encoded_format=jtags.ENCODED_FORMAT_BAYER,
                              colorspace=None)


def test_decode_bayer_developed_falls_back_and_says_so():
    """A sample that overflows the device decoder takes the host entropy
    decode, through `IntraCodec.decode_checked` as `decode_batch_device`
    does, returns that fallback, and stays within 1 LSB of the JAX
    function."""
    sample = _bayer_overflow_sample()
    codec = IntraCodec(64, 48, 4, device="cpu", input_format="BYR4")
    *_, fallback = codec._decode_rows_args([sample])
    assert fallback == set()      # the walk takes it; the overflow does not
    want = jam.decode_bayer_developed(sample)
    got, fallback = tam.decode_bayer_developed(sample, device="cpu")
    assert fallback == (0,)
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int64) - want).max() <= 1


def test_decode_bayer_developed_with_a_look_and_gamma_matches_jax():
    """A database item that turns on every stage (PRCS with the LOOK and
    gamma bits, a LOOK CRC, GAMT) through the duck-typed LOOK database."""
    from cineform_tpu.metadata import MetadataItem as JItem
    from cineform_tpu_torch.metadata import MetadataItem as TItem

    with open(os.path.join(SAMPLES, "byr4_wbal_320x240_q4.cfhd"), "rb") as f:
        sample = f.read()
    items = [("PRCS", b"L", (1 | 2 | 4 | 8 | 32).to_bytes(4, "little")),
             ("LCRC", b"L", (1234).to_bytes(4, "little")),
             ("GAMT", b"f", np.float32(1.4).tobytes())]
    want = jam.decode_bayer_developed(sample, [JItem(*i) for i in items],
                                      _LookDB())
    got, fallback = tam.decode_bayer_developed(
        sample, [TItem(*i) for i in items], _LookDB(), device="cpu")
    assert fallback == ()
    assert np.abs(got.astype(np.int64) - want).max() <= 1

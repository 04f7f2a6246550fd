"""The port's 3D composite of both eyes (`cineform_tpu_torch.models.stereo.
blend_eyes`, the API's channel mask 3 and `set_channel_blend`), on the
CPU, against the JAX package's `models.stereo.blend_eyes` and its API on
the host route (`CINEFORM_API_DEVICE=0`).

Every blend mode at 320x240 and 64x48, the format refusals, and the modes
that are not blend modes (which the JAX API decodes as if there were no
composite: the port gives the same bytes).  Every comparison is exact
(tolerance 0).
"""

import numpy as np
import pytest
import torch

from cineform_tpu import api as japi
from cineform_tpu.models import stereo as jstereo
from cineform_tpu_torch import api
from cineform_tpu_torch import testframes as tframes
from cineform_tpu_torch.models import stereo

torch.set_num_threads(1)

#: every blend mode, then modes the JAX function refuses
MODES = [0, 1, 2, 3, 4, 5, 7, 16, 17, 18, 19, 20, 21]
UNKNOWN = [6, 8, 22]
SIZES = [(320, 240), (64, 48)]
_SAMPLES = {}


def _stereo_sample(w, h):
    if (w, h) not in _SAMPLES:
        enc = api.StereoEncoder("cpu")
        enc.prepare_to_encode(w, h, api.PixelFormat.YUY2)
        _SAMPLES[w, h] = enc.encode_sample(tframes.yuy2_frame(w, h, 1),
                                           tframes.yuy2_frame(w, h, 2))
    return _SAMPLES[w, h]


@pytest.fixture
def jax_host(monkeypatch):
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    return japi


def _composite(mod, kw, sample, mode, fmt):
    dec = mod.Decoder(**kw)
    dec.prepare_to_decode(0, 0, mod.PixelFormat[fmt], sample=sample)
    dec.set_channels_active(3)
    if mode is not None:
        dec.set_channel_blend(mode)
    out = dec.decode_sample(sample)
    return out, dec


def _fmt(mode):
    return "BGRA" if 16 <= mode <= 21 else "YUY2"


@pytest.mark.parametrize("size", SIZES, ids=["320x240", "64x48"])
@pytest.mark.parametrize("mode", MODES + UNKNOWN)
def test_mask3_matches_the_jax_api(jax_host, mode, size):
    """The composite (the right eye with the second dither window), and for
    the unknown modes the plain decode of the whole dual-channel sample,
    byte- and shape-equal to the JAX API's.  No eye of a composite falls
    back; the whole sample takes the host entropy decode (the device
    route's header walk takes one eye's bitstream)."""
    sample = _stereo_sample(*size)
    got, dec = _composite(api, {"device": "cpu"}, sample, mode, _fmt(mode))
    want, _ = _composite(japi, {}, sample, mode, _fmt(mode))
    assert dec.fallback_frames == (mode in UNKNOWN)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_the_default_mode_is_stacked(jax_host):
    sample = _stereo_sample(64, 48)
    got, _ = _composite(api, {"device": "cpu"}, sample, None, "YUY2")
    want, _ = _composite(api, {"device": "cpu"}, sample, 1, "YUY2")
    assert got.tobytes() == want.tobytes() == _composite(
        japi, {}, sample, None, "YUY2")[0].tobytes()


@pytest.mark.parametrize("mode,fmt", [(1, "BGRA"), (16, "YUY2"),
                                      (0, "BGRA"), (3, "RG48"),
                                      (21, "UYVY")])
def test_format_refusals_match_the_jax_api(jax_host, mode, fmt):
    sample = _stereo_sample(64, 48)
    errors = []
    for mod, kw in ((api, {"device": "cpu"}), (japi, {})):
        with pytest.raises(mod.CFHDError) as e:
            _composite(mod, kw, sample, mode, fmt)
        errors.append((int(e.value.code), str(e.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] == int(api.ErrorCode.BADFORMAT)


@pytest.mark.parametrize("shape", [(48, 64), (8, 24), (6, 12)],
                         ids=["64x48", "24x8", "12x6"])
@pytest.mark.parametrize("mode", MODES)
def test_blend_eyes_matches_jax(mode, shape):
    """`blend_eyes` on seeded YUY2 eyes: the composite's bytes and format
    equal the JAX function's (at a chroma width that is odd too)."""
    h, w = shape
    rng = np.random.default_rng(mode)
    left, right = (rng.integers(0, 256, size=(h, 2 * w), dtype=np.uint8)
                   for _ in range(2))
    want, wfmt = jstereo.blend_eyes(left.tobytes(), right.tobytes(), w, h,
                                    mode)
    got, fmt = stereo.blend_eyes(torch.from_numpy(left),
                                 torch.from_numpy(right), mode)
    assert fmt == wfmt
    assert got.numpy().tobytes() == want


def test_blend_eyes_refuses_what_jax_refuses():
    left = torch.zeros((8, 48), dtype=torch.uint8)
    for mode in UNKNOWN:
        with pytest.raises(ValueError):
            jstereo.blend_eyes(left.numpy().tobytes(),
                               left.numpy().tobytes(), 24, 8, mode)
        with pytest.raises(ValueError):
            stereo.blend_eyes(left, left, mode)
    assert stereo.BLEND_ANAGLYPH_GM_BW == jstereo.BLEND_ANAGLYPH_GM_BW


@pytest.mark.parametrize("where", ["blend", "eye_decode"])
def test_a_failure_of_the_composite_reaches_the_caller(monkeypatch, where):
    """An error of the eyes' decode on the device or of the blend (a
    kernel's build or launch, the card's memory) is not taken for a parse
    error: it reaches the caller, and no other decode stands in for the
    composite."""
    from cineform_tpu_torch.models.intra import IntraCodec

    def fail(*args, **kwargs):
        raise RuntimeError("the composite failed")

    if where == "blend":
        monkeypatch.setattr(stereo, "blend_eyes", fail)
    else:
        monkeypatch.setattr(IntraCodec, "decode_batch_device", fail)
    sample = _stereo_sample(64, 48)
    with pytest.raises(RuntimeError, match="the composite failed"):
        _composite(api, {"device": "cpu"}, sample, 1, "YUY2")

"""The port's GOP outputs (`GopCodec.inverse`, on the device route's and
the host route's coefficients) and the API's GOP geometry routes on the CPU,
against the JAX package's `gop_host.decode_group_to` and `api.Decoder`
and the reference's GOP output goldens.

The same GROUP samples (the 320x240 goldens, the `gopstream` series, the
interlaced group whose bands carry peaks) go through both; every
comparison is exact (tolerance 0).
"""

import os

import numpy as np
import pytest
import torch

from cineform_tpu import api as japi
from cineform_tpu.models import gop_host
from cineform_tpu_torch import api
from cineform_tpu_torch.models.gop import OUTPUTS, GopCodec

torch.set_num_threads(1)

SAMPLES = os.path.join(os.path.dirname(__file__), "golden", "samples")
GROUPS = ("gop_320x240_q4_p1.cfhd.f1", "gop2_320x240_q4_p100.cfhd.f1",
          "gopstream_320x240_q4.s3")
STREAM = [f"gopstream_320x240_q4.s{i}" for i in range(6)]


def _golden(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def codec():
    return GopCodec(320, 240, 4, device="cpu")


def _host(codec, samples, output, frame):
    """The host route's frames of `samples`: `host_coefficients`, then
    `output_frame` of each part, in the samples' order."""
    out = [None] * len(samples)
    for idx, coeffs in codec.host_coefficients(samples, output):
        for i, f in zip(idx, codec.output_frame(coeffs, output, frame),
                        strict=True):
            out[i] = f
    return out


@pytest.mark.parametrize("frame", (0, 1))
@pytest.mark.parametrize("output", OUTPUTS)
def test_decode_group_to_matches_jax(codec, output, frame):
    """Each output of a group, both frames, on the device route (0
    fallback) and the host-entropy route, equal to `decode_group_to`."""
    samples = [_golden(n) for n in GROUPS]
    want = [gop_host.decode_group_to(s, output, frame) for s in samples]
    got, fallback, _ = codec.decode(samples, output, frame)
    assert fallback == ()
    host = _host(codec, samples, output, frame)
    for i, w in enumerate(want):
        assert got[i].tobytes() == w
        assert host[i].tobytes() == w


@pytest.mark.parametrize("output", ("YU64", "RG48", "BGRA"))
def test_interlaced_group_with_peaks_falls_back_as_jax(codec, output):
    """The interlaced group, whose bands carry peaks: the device route
    sends it to the host-entropy route, which (as the JAX deep decode)
    runs the progressive pyramid and leaves the peaks unsubstituted."""
    sample = _golden("ilace_320x240_q4_p1.cfhd.f1")
    got, fallback, _ = codec.decode([_golden(GROUPS[0]), sample], output,
                                    1)
    assert fallback == (1,)
    assert got[1].tobytes() == gop_host.decode_group_to(sample, output, 1)
    assert got[0].tobytes() == gop_host.decode_group_to(_golden(GROUPS[0]),
                                                        output, 1)


@pytest.mark.parametrize("sample,frame,output,ext", [
    ("gop_320x240_q4_p1.cfhd.f1", 0, "YU64", "gop_320x240_q4_p1.yu64out"),
    ("gop_320x240_q4_p1.cfhd.f1", 0, "RG48", "gop_320x240_q4_p1.rg48out"),
    ("gop_320x240_q4_p1.cfhd.f1", 0, "BGRA", "gop_320x240_q4_p1.bgraout"),
    ("gopstream_320x240_q4.s1", 1, "YU64",
     "gopstream_320x240_q4.f1true.yu64out"),
    ("gopstream_320x240_q4.s1", 1, "RG48",
     "gopstream_320x240_q4.f1true.rg48out")])
def test_gop_output_goldens(codec, sample, frame, output, ext):
    got, fallback, _ = codec.decode([_golden(sample)], output, frame)
    assert fallback == ()
    assert got[0].tobytes() == _golden(ext)


def test_then_runs_on_the_decoded_batch(codec):
    """`then` sees the decoded batch on the device before the download."""
    seen = []

    def then(frames):
        seen.append(tuple(frames.shape))
        return frames

    got, _, _ = codec.decode([_golden(GROUPS[0])], "RG48", 0, then=then)
    assert seen == [(1, 240, 960)]
    assert got[0].tobytes() == _golden("gop_320x240_q4_p1.rg48out")


def test_inverse_to_refuses_other_outputs(codec):
    with pytest.raises(ValueError, match="a group decodes to"):
        _host(codec, [_golden(GROUPS[0])], "NV12", 0)


# ---------------------------------------------------------------------------
# The API's GOP routes against the JAX API
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_host(monkeypatch):
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")


def _decode(mod, kw, samples, fmt, w=0, h=0):
    dec = mod.Decoder(**kw)
    dec.prepare_to_decode(w, h, mod.PixelFormat[fmt], sample=samples[1])
    out = []
    for s in samples:
        try:
            o = dec.decode_sample(s)
            out.append(None if o is None else o.tobytes())
        except mod.CFHDError as e:
            out.append(e.code.name)
    return out


@pytest.mark.parametrize("fmt", ("YU64", "V210", "RG48", "BGRA", "B64A",
                                 "R210", "DPX0", "RG30", "NV12"))
def test_api_gop_stream_outputs_match_jax(jax_host, fmt):
    """The gopstream series (sequence header, groups, FRAME samples) to
    every GOP output: the groups give frame 0, the FRAME samples the true
    second frame; NV12 is no GOP output (BADFORMAT)."""
    samples = [_golden(n) for n in STREAM]
    assert _decode(api, {"device": "cpu"}, samples, fmt) == \
        _decode(japi, {}, samples, fmt)


@pytest.mark.parametrize("fmt,size", [("YUY2", (200, 150)),
                                      ("UYVY", (480, 360)),
                                      ("RG48", (211, 157)),
                                      ("V210", (200, 150)),
                                      ("WP13", (200, 150))])
def test_api_gop_to_another_size_matches_jax(jax_host, fmt, size):
    """A GOP stream decoded to another size: each GROUP sample scales its
    frame 0, a repeat of the same group its frame 1 (the JAX alternation),
    each FRAME sample its held group's frame 1; WP13 is no scaled output
    (BADFORMAT)."""
    s = [_golden(n) for n in STREAM]
    samples = [s[0], s[1], s[1], s[2], s[3], s[4], s[5]]
    assert _decode(api, {"device": "cpu"}, samples, fmt, *size) == \
        _decode(japi, {}, samples, fmt, *size)

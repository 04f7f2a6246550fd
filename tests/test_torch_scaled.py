"""The port's reduced-resolution decodes (half, quarter, thumbnail) on the
CPU, against the JAX package's `intra_host.decode_sample_scaled`, its API
and the reference goldens.

Both decode routes of the port's `IntraCodec` (`decode_batch`, host
entropy; `decode_batch_device`, the device entropy decoder's plain
versions) entropy-decode only the bands of the levels a resolution reads;
every comparison is byte for byte.
"""

import functools
import os

import numpy as np
import pytest
import torch

from cineform_tpu import api as japi
from cineform_tpu.models import intra_host as jhost
from cineform_tpu.ref import intra as jref
from cineform_tpu.spec import tags as jtags
from cineform_tpu.spec.production import IntraParams as JParams
from cineform_tpu_torch import api
from cineform_tpu_torch import testframes as tframes
from cineform_tpu_torch.entropy import device_decode
from cineform_tpu_torch.models.intra import IntraCodec

torch.set_num_threads(1)

CPU = torch.device("cpu")
SAMPLES = os.path.join(os.path.dirname(__file__), "golden", "samples")
SIZES = [(64, 48), (144, 96), (320, 240)]
RESOLUTIONS = {"half": 2, "quarter": 3, "thumbnail": 4}


def _golden(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def _samples(w: int, h: int) -> tuple[bytes, ...]:
    """Two YUY2 samples at w x h, encoded by the port from seeded frames
    (test patterns 1 and 2 with seeded noise of +/-8)."""
    rng = np.random.default_rng(w + h)
    frames = []
    for pattern in (1, 2):
        f = np.frombuffer(tframes.yuy2_frame(w, h, pattern),
                          np.uint8).astype(np.int32)
        f = f + rng.integers(-8, 9, f.shape)
        frames.append(np.clip(f, 0, 255).astype(np.uint8).reshape(h, 2 * w))
    return tuple(IntraCodec(w, h, 4, device=CPU).encode_batch(
        np.stack(frames)))


def _oversized_sample(w: int, h: int, k: int) -> bytes:
    """A YUY2 sample whose luma band LH of level k (0 the finest) holds four
    times the band's coefficients: the device decoder's overflow flag sends
    it to the host-entropy route wherever the decode reads that level."""
    params = JParams(width=w, height=h, quality=4)
    planes = jref.unpack_yuy2(tframes.yuy2_frame(w, h, 1), w, h,
                              params.precision)
    chans = [jhost.transform_channel(p, params, c)
             for c, p in enumerate(planes)]
    band = chans[0].bands[k][0]
    oversize = np.ones((band.shape[0] * 4, band.shape[1]), np.int32)
    chans[0].payloads = [None] * 3
    chans[0].payloads[k] = (jhost.encode_band_payload(oversize), None, None)
    return jhost.write_sample(chans, params, 1, jhost.EncoderMetadata(),
                              input_format=jtags.COLOR_FORMAT_YUYV)


@pytest.mark.parametrize("res", list(RESOLUTIONS.values()),
                         ids=list(RESOLUTIONS))
@pytest.mark.parametrize("w,h", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_scaled_decode_matches_jax(w, h, res):
    samples = _samples(w, h)
    codec = IntraCodec(w, h, 4, device=CPU)
    want = [jhost.decode_sample_scaled(s, res) for s in samples]
    host = codec.decode_batch(samples, resolution=res)
    dev, fallback = codec.decode_batch_device(samples, resolution=res)
    assert fallback == ()
    assert host.shape == (2, h >> (res - 1), 2 * w >> (res - 1))
    assert [f.tobytes() for f in host] == want
    assert [f.tobytes() for f in dev] == want


@pytest.mark.parametrize("k", [0, 2])
@pytest.mark.parametrize("res", list(RESOLUTIONS.values()),
                         ids=list(RESOLUTIONS))
def test_scaled_fallback_reads_the_same_bands(res, k):
    """A frame falls back to the host entropy decode only where the
    resolution reads its overflowing band, and decodes as the JAX package
    does either way."""
    w, h = 64, 48
    bad = _oversized_sample(w, h, k)
    samples = [_samples(w, h)[0], bad]
    codec = IntraCodec(w, h, 4, device=CPU)
    dev, fallback = codec.decode_batch_device(samples, resolution=res)
    assert fallback == ((1,) if k >= res - 1 else ())
    assert [f.tobytes() for f in dev] == \
        [jhost.decode_sample_scaled(s, res) for s in samples]


@pytest.mark.parametrize("res", list(RESOLUTIONS.values()),
                         ids=list(RESOLUTIONS))
def test_device_route_decodes_only_the_levels_it_reads(res, monkeypatch):
    """The header walk builds rows only for the band row classes k >=
    res - 1 (k = 0 the finest level), and the device entropy decoder runs
    only on those: none at half is of k = 0, none at all at thumbnail."""
    w, h = 64, 48
    codec = IntraCodec(w, h, 4, device=CPU)
    samples = list(_samples(w, h))
    kept = codec.decode_classes(res)
    assert [k for _, k, _ in kept] == [k for k in range(3) if k >= res - 1
                                       for _ in codec.groups]
    rows = codec._decode_rows_host(samples, resolution=res)
    assert len(rows[0]) == len(kept)
    for pay, (_, k, planes) in zip(rows[0], kept):
        assert pay.shape[0] == len(samples) * len(planes) * 3
    decoded = []
    real = device_decode.decode_band_rows

    def counting(payload, nchunks, quant, linear, nout):
        decoded.append(nout)
        return real(payload, nchunks, quant, linear, nout)

    monkeypatch.setattr(device_decode, "decode_band_rows", counting)
    codec.decode_batch_device(samples, resolution=res)
    want = [codec._class_dims(k, planes) for _, k, planes in kept]
    assert decoded == [bh * pitch for bh, _, pitch in want]
    if res == 2:
        assert all(k > 0 for _, k, _ in kept)
    if res == 4:
        assert decoded == []


#: the reduced-resolution goldens of the reference binary
SCALED_GOLDENS = [(name, ext) for name in ("s_320x240_q4_p1",
                                           "s_640x360_q5_p1")
                  for ext in ("half", "quarter")]


def _api_scaled(mod, device_kw, sample, fmt, res):
    dec = mod.Decoder(**device_kw)
    dec.prepare_to_decode(0, 0, mod.PixelFormat[fmt],
                          resolution=mod.DecodedResolution(res),
                          sample=sample)
    return dec, dec.decode_sample(sample).tobytes()


@pytest.mark.parametrize("name,ext", SCALED_GOLDENS,
                         ids=[f"{n}-{e}" for n, e in SCALED_GOLDENS])
def test_scaled_golden_through_the_api(name, ext, monkeypatch):
    """The half and quarter goldens through the port's `api.Decoder`: equal
    to the JAX API, and the half goldens byte for byte.  The JAX package's
    quarter decode is the truncated two-level inverse, not the reference's
    quarter path (STATUS.md), and differs from the quarter goldens; the
    port follows the JAX decode there (ROADMAP Queue 3)."""
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    sample = _golden(name + ".cfhd")
    res = RESOLUTIONS[ext]
    dec, got = _api_scaled(api, {"device": "cpu"}, sample, "YUY2", res)
    assert dec.fallback_frames == 0
    assert got == _api_scaled(japi, {}, sample, "YUY2", res)[1]
    assert got == jhost.decode_sample_scaled(sample, res)
    if ext == "half":
        assert got == _golden(f"{name}.{ext}.yuy2")


def test_uyvy_at_half_resolution_is_the_pair_swap():
    """The JAX API hands the YUY2 bytes of its scaled decode to a UYVY
    output unchanged (ROADMAP Queue 3); the port swaps the pairs, as its
    full-resolution UYVY does, and YUYV is the YUY2 bytes on both."""
    sample = _golden("s_320x240_q4_p1.cfhd")
    yuy2 = _golden("s_320x240_q4_p1.half.yuy2")
    swapped = np.frombuffer(yuy2, np.uint8).reshape(-1, 4)[:, [1, 0, 3, 2]]
    assert _api_scaled(japi, {}, sample, "UYVY", 2)[1] == yuy2
    assert _api_scaled(api, {"device": "cpu"}, sample, "UYVY", 2)[1] == \
        swapped.tobytes()
    for mod, kw in ((japi, {}), (api, {"device": "cpu"})):
        assert _api_scaled(mod, kw, sample, "YUYV", 2)[1] == yuy2


#: (sample, output, resolution) -> the JAX API's error code, which the
#: port gives too
SCALED_ERRORS = [
    ("rgb444_320x240_q4.cfhd", "RG48", 2, "BADSAMPLE"),
    ("rgba4444_320x240_q4.cfhd", "YUY2", 3, "BADSAMPLE"),
    ("byr4_320x240_q4_p1.cfhd", "YUY2", 2, "BADSAMPLE"),
    ("s_320x240_q4_p1.cfhd", "YU64", 2, "BADSAMPLE"),
    ("s_320x240_q4_p1.cfhd", "BGRA", 4, "BADSAMPLE"),
    ("gop_320x240_q4_p1.cfhd.f1", "YUY2", 2, "BADFORMAT"),
]


@pytest.mark.parametrize("name,fmt,res,code", SCALED_ERRORS,
                         ids=[f"{e[0].split('_')[0]}-{e[1]}-{e[2]}"
                              for e in SCALED_ERRORS])
def test_reduced_resolution_refusals_match_jax(name, fmt, res, code,
                                               monkeypatch):
    """An RGB or Bayer sample, another output than YUY2, or a GOP sample
    at a reduced resolution: the JAX API's error code, no bytes."""
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    sample = _golden(name)
    for mod, kw in ((japi, {}), (api, {"device": "cpu"})):
        with pytest.raises(mod.CFHDError) as e:
            _api_scaled(mod, kw, sample, fmt, res)
        assert e.value.code.name == code


def test_byr4_of_a_422_sample_at_half_resolution_is_refused():
    """The JAX API hands the scaled decode's YUY2 bytes to any output of
    the same row pitch, BYR4 too (ROADMAP Queue 3); the port refuses."""
    sample = _golden("s_320x240_q4_p1.cfhd")
    assert _api_scaled(japi, {}, sample, "BYR4", 2)[1] == \
        _golden("s_320x240_q4_p1.half.yuy2")
    with pytest.raises(api.CFHDError) as e:
        _api_scaled(api, {"device": "cpu"}, sample, "BYR4", 2)
    assert e.value.code == api.ErrorCode.BADSAMPLE


def test_codec_refuses_reduced_resolution_of_other_sources():
    with pytest.raises(ValueError, match="resolution"):
        IntraCodec(64, 48, 4, device=CPU, input_format="RG48").decode_output(
            None, 2)
    with pytest.raises(ValueError, match="outputs YUY2"):
        IntraCodec(64, 48, 4, device=CPU).decode_output("YU64", 2)

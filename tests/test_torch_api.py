"""The port's public API (`cineform_tpu_torch.api`) on the CPU, against the
JAX package's API on its host route (`CINEFORM_API_DEVICE=0`) and the
reference goldens.

The same inputs, the repository's test frames or the goldens, go through
both APIs; every comparison is exact (tolerance 0).  The goldens' GUID,
DATE and TIME are random per reference run, so each encode attaches the
golden's own metadata on both sides.  Every decode route of the JAX API
is ported (and every encode route: `tests/test_torch_encoder_inputs.py`
and `test_torch_encoder_options.py`): the geometry routes (a decode to
another size, the lens warp, a group's deep and RGB outputs) decode as
the JAX API decodes them, and every Bayer RG48 golden, its develop stages
included, byte for byte (the stages themselves and the 3D composite in
`tests/test_torch_develop_stages.py` and `test_torch_stereo_blend.py`).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cineform_tpu import api as japi
from cineform_tpu.utils import testframes as jframes
from cineform_tpu_torch import api
from cineform_tpu_torch import testframes as tframes
from cineform_tpu_torch.models.intra import sample_metadata
from cineform_tpu_torch.models.intra_host import EncoderMetadata
from tests.test_gop import _metadata_from

torch.set_num_threads(1)

CPU = torch.device("cpu")
SAMPLES = os.path.join(os.path.dirname(__file__), "golden", "samples")
W, H = 320, 240
#: the encode goldens: input format, golden, the port's frame maker
#: (pattern 1 of the format's test frame, the raw fill for RG64 and BYR5)
ENCODE_GOLDENS = [
    ("YUY2", "s_320x240_q4_p1.cfhd", tframes.yuy2_frame),
    ("UYVY", "uyvy_320x240_q4_p1.cfhd", tframes.uyvy_frame),
    ("V210", "v210_320x240_q4_p1.cfhd", tframes.v210_frame),
    ("YU64", "yu64_320x240_q4_p1.cfhd", tframes.yu64_frame),
    ("RG48", "rg48_320x240_q4_p1.cfhd", tframes.rg48_frame),
    ("B64A", "b64a_320x240_q4_p1.cfhd", tframes.b64a_frame),
    ("RG64", "raw_RG64.cfhd", lambda w, h, p: tframes.raw_fill(w * h * 8, p)),
    ("BYR4", "byr4_320x240_q4_p1.cfhd", tframes.byr4_frame),
    ("BYR5", "raw_BYR5.cfhd",
     lambda w, h, p: tframes.raw_fill(w * h * 3 // 2, p)),
]
#: the decode goldens: sample, output format, golden output
DECODE_GOLDENS = [
    ("s_320x240_q4_p1.cfhd", "YUY2", "s_320x240_q4_p1.yuy2"),
    ("s_320x240_q4_p1.cfhd", "UYVY", "s_320x240_q4_p1.2vuy"),
    ("s_320x240_q4_p1.cfhd", "BGRA", "s_320x240_q4_p1.bgraout"),
    ("rgb444_320x240_q4.cfhd", "RG48", "rgb444_320x240_q4.rg48out"),
    ("rgb444_320x240_q4.cfhd", "B64A", "rgb444_320x240_q4.b64aout"),
    ("rgba4444_320x240_q4.cfhd", "RG48", "rgba4444_320x240_q4.rg48out"),
    ("rgba4444_320x240_q4.cfhd", "B64A", "rgba4444_320x240_q4.b64aout"),
    ("byr4_320x240_q4_p1.cfhd", "BYR4", "byr4_320x240_q4_p1.byr4out"),
]


def _golden(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


@pytest.fixture
def jax_host(monkeypatch):
    """The JAX API on its host route."""
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    return japi


def _encode(mod, device_kw, w, h, fmt, frames, quality=4, flags=0,
            metadata=None):
    """Each frame through one `mod.Encoder` -> the samples."""
    enc = mod.Encoder(**device_kw)
    enc.prepare_to_encode(w, h, mod.PixelFormat[fmt],
                          encoding_flags=mod.EncodingFlags(flags),
                          quality=mod.EncodingQuality(quality))
    out = []
    for i, frame in enumerate(frames):
        if metadata is not None:
            enc.attach_metadata(metadata(i))
        enc.encode_sample(frame)
        out.append(enc.get_sample_data())
    return out


def _decode(mod, device_kw, samples, fmt, mask=None, w=0, h=0):
    """The samples through one `mod.Decoder` prepared on the first ->
    the frames' bytes (None for a sequence header)."""
    dec = mod.Decoder(**device_kw)
    dec.prepare_to_decode(w, h, mod.PixelFormat[fmt], sample=samples[0])
    if mask is not None:
        dec.set_channels_active(mask)
    out = [dec.decode_sample(s) for s in samples]
    return [None if o is None else o.tobytes() for o in out]


# ---------------------------------------------------------------------------
# The copied surface
# ---------------------------------------------------------------------------

def test_api_defaults_to_the_card():
    assert api.Encoder().device == torch.device("cuda")
    assert api.Decoder().device == torch.device("cuda")
    assert api.StereoEncoder().device == torch.device("cuda")
    assert api.CFHD_OpenEncoder("cpu").device == CPU
    assert api.CFHD_OpenDecoder("cpu").device == CPU


def test_sample_info_matches_jax():
    for name in ("s_320x240_q4_p1.cfhd", "byr4_320x240_q4_p1.cfhd",
                 "rgba4444_320x240_q4.cfhd", "gop_320x240_q4_p1.cfhd.f1"):
        sample = _golden(name)
        got = api.Decoder("cpu").get_sample_info(sample)
        want = japi.Decoder().get_sample_info(sample)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name


def test_argument_errors_match_jax():
    for mod, kw in ((api, {"device": "cpu"}), (japi, {})):
        enc = mod.Encoder(**kw)
        with pytest.raises(mod.CFHDError) as e:
            enc.encode_sample(b"")
        assert e.value.code == mod.ErrorCode.ENCODING_NOT_STARTED
        with pytest.raises(mod.CFHDError) as e:
            enc.prepare_to_encode(33, 17, mod.PixelFormat.YUY2)
        assert e.value.code == mod.ErrorCode.INVALID_ARGUMENT
        with pytest.raises(mod.CFHDError) as e:
            enc.prepare_to_encode(320, 240, mod.PixelFormat.RG48,
                                  encoded_format=mod.EncodedFormat.BAYER)
        assert e.value.code == mod.ErrorCode.BADFORMAT
        enc.prepare_to_encode(64, 48, mod.PixelFormat.YUY2)
        with pytest.raises(mod.CFHDError) as e:
            enc.encode_sample(b"\0" * 100)
        assert e.value.code == mod.ErrorCode.INVALID_ARGUMENT
        dec = mod.Decoder(**kw)
        with pytest.raises(mod.CFHDError) as e:
            dec.decode_sample(b"\0" * 64)
        assert e.value.code == mod.ErrorCode.UNEXPECTED
        dec.prepare_to_decode(320, 240)
        for bad in (b"\x00" * 64, b"\x00" * 6):
            with pytest.raises(mod.CFHDError) as e:
                dec.decode_sample(bad)
            assert e.value.code == mod.ErrorCode.BADSAMPLE
        with pytest.raises(mod.CFHDError):
            dec.set_channels_active(4)


# ---------------------------------------------------------------------------
# Intra encode and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,name,make", ENCODE_GOLDENS,
                         ids=[g[0] for g in ENCODE_GOLDENS])
def test_encode_matches_jax_and_golden(jax_host, fmt, name, make):
    gold = _golden(name)
    frame = make(W, H, 1)
    got = _encode(api, {"device": "cpu"}, W, H, fmt, [frame],
                  metadata=lambda i: sample_metadata(gold))
    want = _encode(jax_host, {}, W, H, fmt, [frame],
                   metadata=lambda i: _metadata_from(gold))
    assert got == want == [gold]


def test_encode_honours_the_pitch():
    """A frame in rows of a wider pitch encodes as its packed rows do."""
    frame = np.frombuffer(tframes.v210_frame(W, H, 1), np.uint8).reshape(
        H, -1)
    wide = np.zeros((H, frame.shape[1] + 128), np.uint8)
    wide[:, :frame.shape[1]] = frame
    enc = api.Encoder("cpu")
    enc.prepare_to_encode(W, H, api.PixelFormat.V210)
    enc.attach_metadata(sample_metadata(_golden("v210_320x240_q4_p1.cfhd")))
    enc.encode_sample(wide.tobytes(), pitch=wide.shape[1])
    assert enc.get_sample_data() == _golden("v210_320x240_q4_p1.cfhd")


@pytest.mark.parametrize("name,fmt,out", DECODE_GOLDENS,
                         ids=[f"{g[0][:6]}-{g[1]}" for g in DECODE_GOLDENS])
def test_decode_matches_jax_and_golden(jax_host, name, fmt, out):
    sample = _golden(name)
    dec = api.Decoder("cpu")
    got = _decode(api, {"device": "cpu"}, [sample], fmt)
    want = _decode(jax_host, {}, [sample], fmt)
    assert got == want == [_golden(out)]
    dec.prepare_to_decode(0, 0, api.PixelFormat[fmt], sample=sample)
    dec.decode_sample(sample)
    assert dec.fallback_frames == 0


#: the Bayer decode goldens: sample, output format, golden output
BAYER_GOLDENS = [
    *(("byr4_320x240_q4_p1", fmt, ext) for fmt, ext in (
        ("RG48", "rg48out"), ("B64A", "b64aout"), ("WP13", "wp13out"),
        ("W13A", "w13aout"), ("YUY2", "yuy2out"), ("UYVY", "2vuyout"),
        ("BYR2", "byr2out"), ("BYR4", "byr4out"))),
    ("byr4_colm_320x240_q4", "RG48", "rg48out"),
    ("byr4_wbal_320x240_q4", "RG48", "rg48out"),
    ("byr4_wbal_320x240_q4", "YUY2", "yuy2out"),
    ("byr4_wbal2_320x240_q4", "RG48", "rg48out"),
    ("byr4_satexp_320x240_q4", "RG48", "rg48out"),
]


@pytest.mark.parametrize("name,fmt,ext", BAYER_GOLDENS,
                         ids=[f"{g[0][5:-3]}-{g[1]}" for g in BAYER_GOLDENS])
def test_bayer_decode_matches_jax_and_golden(jax_host, name, fmt, ext):
    """Every Bayer output, and the develop matrices of the COLM, WBAL and
    SATU/EXPS goldens, byte-equal to the JAX API and the golden, on the
    device route with no frame falling back."""
    sample = _golden(name + ".cfhd")
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(0, 0, api.PixelFormat[fmt], sample=sample)
    got = dec.decode_sample(sample).tobytes()
    assert dec.fallback_frames == 0
    assert got == _decode(jax_host, {}, [sample], fmt)[0] == _golden(
        f"{name}.{ext}")


RG48_GOLDENS = sorted(f[:-len(".rg48out")] for f in os.listdir(SAMPLES)
                      if f.startswith("byr4_") and f.endswith(".rg48out"))


@pytest.mark.parametrize("name", RG48_GOLDENS)
def test_every_bayer_rg48_golden_decodes_or_raises(name, monkeypatch,
                                                   tmp_path):
    """Each `byr4_*` golden with an RG48 output decodes byte-equal to it,
    the develop stages its metadata turns on (vignette, BLSH, the LOOK
    cube, gamma/contrast) included; the `.cflook` look's file is under
    HOME, where the reference finds it."""
    luts = tmp_path / ".cineform" / "LUTs"
    luts.mkdir(parents=True)
    (luts / "DEADBEEF.cflook").write_bytes(_golden("DEADBEEF.cflook"))
    monkeypatch.setenv("HOME", str(tmp_path))
    sample = _golden(name + ".cfhd")
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(0, 0, api.PixelFormat.RG48, sample=sample)
    assert dec.decode_sample(sample).tobytes() == _golden(
        name + ".rg48out")


def test_decode_falls_back_per_frame_and_counts_it():
    """A sample whose coarsest luma band overflows the device decoder
    decodes on the host-entropy route, equal to the JAX API, and counts in
    `fallback_frames`."""
    from tests.test_torch_pool import overflow_sample

    bad = overflow_sample()
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(0, 0, sample=bad)
    got = dec.decode_sample(bad).tobytes()
    assert dec.fallback_frames == 1
    assert got == _decode(japi, {}, [bad], "YUY2")[0]


@pytest.mark.parametrize("name", ["s_320x240_q4_p1", "s_640x360_q5_p1"])
def test_encode_thumbnail_matches_jax_and_golden(name):
    sample = _golden(f"{name}.cfhd")
    got = api.Encoder("cpu").get_encode_thumbnail(sample)
    assert got == japi.Encoder().get_encode_thumbnail(sample)
    assert got[2] == _golden(f"{name}.thumb")


@pytest.mark.parametrize("quality,base", [(5, "fs2_320x240"),
                                          (6, "fs3_320x240")])
def test_filmscan_rate_control_series_matches_jax_and_golden(
        jax_host, quality, base):
    """FILMSCAN2/3: the rate limiter walks from the previous sample's
    compression (8 -> 19, 4 -> 10 on these frames), byte for byte."""
    gold = [_golden(f"{base}.cfhd.f{f}") for f in range(4)]
    frames = [tframes.yuy2_frame(W, H, f + 1) for f in range(4)]
    got = _encode(api, {"device": "cpu"}, W, H, "YUY2", frames, quality,
                  metadata=lambda i: sample_metadata(gold[0]))
    want = _encode(jax_host, {}, W, H, "YUY2", frames, quality,
                   metadata=lambda i: _metadata_from(gold[0]))
    assert got == want == gold


# ---------------------------------------------------------------------------
# The 2-frame GOP stream
# ---------------------------------------------------------------------------

GOP = int(api.EncodingFlags.YUV_2FRAME_GOP)
STREAM = [f"gopstream_320x240_q4.s{i}" for i in range(6)]


def test_gop_stream_encode_matches_jax_and_golden(jax_host):
    """Sequence header, GROUP, FRAME header, GROUP, ... over 6 frames."""
    gold = [_golden(n) for n in STREAM]
    frames = [tframes.yuy2_frame(W, H, 1 + i) for i in range(6)]
    got = _encode(api, {"device": "cpu"}, W, H, "YUY2", frames, flags=GOP,
                  metadata=lambda i: sample_metadata(gold[i | 1]))
    want = _encode(jax_host, {}, W, H, "YUY2", frames, flags=GOP,
                   metadata=lambda i: _metadata_from(gold[i | 1]))
    assert got == want == gold


def test_gop_stream_decode_matches_jax_and_golden(jax_host):
    """The sequence header yields no frame, a GROUP its first frame, a
    FRAME sample the held group's true second frame: the dither window
    advances over the stream."""
    samples = [_golden(n) for n in STREAM]
    names = [None, "f0", "f1true", "f2", "f3true", "f4"]
    want = [None] + [_golden(f"gopstream_320x240_q4.{n}.yuy2")
                     for n in names[1:]]
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(W, H, api.PixelFormat.YUY2, sample=samples[1])
    got = [dec.decode_sample(s) for s in samples]
    assert [None if g is None else g.tobytes() for g in got] == want
    assert dec.fallback_frames == 0
    assert _decode(jax_host, {}, samples, "YUY2", w=W, h=H) == want
    # repeated GROUP samples: frame 1, then frame 1 with the next window
    group = samples[1]
    assert _decode(api, {"device": "cpu"}, [group, group], "UYVY") == \
        _decode(jax_host, {}, [group, group], "UYVY")


def test_frame_sample_without_a_group_raises():
    for mod, kw in ((api, {"device": "cpu"}), (japi, {})):
        dec = mod.Decoder(**kw)
        dec.prepare_to_decode(W, H, mod.PixelFormat.YUY2)
        with pytest.raises(mod.CFHDError) as e:
            dec.decode_sample(_golden(STREAM[2]))
        assert e.value.code == mod.ErrorCode.BADSAMPLE


# ---------------------------------------------------------------------------
# Stereo 3D
# ---------------------------------------------------------------------------

def test_stereo_encoder_and_eye_selection_match_jax(jax_host):
    """Two stereo pairs at 160x120: the samples (the attached metadata on
    every frame, as the JAX StereoEncoder writes it) and each eye's
    decode."""
    w, h = 160, 120
    meta = EncoderMetadata(unique_frame=5, timecode="01:00:00:00")
    jmeta = japi_metadata(meta)
    pairs = [(tframes.yuy2_frame(w, h, p), tframes.yuy2_frame(w, h, p + 6))
             for p in (3, 4)]
    got, want = [], []
    for mod, kw, m, out in ((api, {"device": "cpu"}, meta, got),
                            (jax_host, {}, jmeta, want)):
        enc = mod.StereoEncoder(**kw)
        enc.prepare_to_encode(w, h, mod.PixelFormat.YUY2)
        enc.attach_metadata(m)
        out += [enc.encode_sample(*pair) for pair in pairs]
    assert got == want
    for mask in (1, 2):
        assert _decode(api, {"device": "cpu"}, got, "YUY2", mask, w, h) == \
            _decode(jax_host, {}, got, "YUY2", mask, w, h)


def japi_metadata(meta: EncoderMetadata):
    from cineform_tpu.models.intra_host import EncoderMetadata as JMeta

    return JMeta(**dataclasses.asdict(meta))


# ---------------------------------------------------------------------------
# What the port refuses
# ---------------------------------------------------------------------------

def test_bgra_refused_at_an_odd_chroma_lowpass_width():
    """At 144 wide the chroma lowpass is 9 wide, where the JAX package's
    device and host BGRA decoders differ: the API hands out no bytes."""
    sample = _encode(api, {"device": "cpu"}, 144, 48, "YUY2",
                     [tframes.yuy2_frame(144, 48, 1)])[0]
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(0, 0, api.PixelFormat.BGRA, sample=sample)
    with pytest.raises(api.CFHDError) as e:
        dec.decode_sample(sample)
    assert e.value.code == api.ErrorCode.BADFORMAT
    assert _decode(api, {"device": "cpu"}, [sample], "YUY2") == \
        _decode(japi, {}, [sample], "YUY2")


@dataclasses.dataclass
class _ExtraMetadata(EncoderMetadata):
    """Metadata with extra tuples after the standard block."""

    extra: bytes = b""

    def block(self) -> bytes:
        return super().block() + self.extra


def _tuple(tag: str, typ: bytes, payload: bytes) -> bytes:
    return (tag.encode() + len(payload).to_bytes(3, "little") + typ
            + payload + b"\0" * (-len(payload) % 4))


def _lens_sample():
    meta = _ExtraMetadata(extra=_tuple("LSPH", b"L", (1).to_bytes(4,
                                                                  "little")))
    enc = api.Encoder("cpu")
    enc.prepare_to_encode(64, 48, api.PixelFormat.YUY2)
    enc.attach_metadata(meta)
    enc.encode_sample(tframes.yuy2_frame(64, 48, 1))
    return enc.get_sample_data()


#: the geometry routes, which the port's API refused until they were
#: ported: (sample, output, width, height), 0 x 0 the sample's size
GEOMETRY = {
    "scaled-size": (lambda: _golden("s_320x240_q4_p1.cfhd"), "YUY2", 160,
                    120),
    "gop-scaled-size": (lambda: _golden("gop_320x240_q4_p1.cfhd.f1"), "YUY2",
                        160, 120),
    "lens-warp": (_lens_sample, "YUY2", 0, 0),
    "gop-to-yu64": (lambda: _golden("gop_320x240_q4_p1.cfhd.f1"), "YU64", 0,
                    0),
    "gop-to-v210": (lambda: _golden("gop_320x240_q4_p1.cfhd.f1"), "V210", 0,
                    0),
    "gop-to-bgra": (lambda: _golden("gop_320x240_q4_p1.cfhd.f1"), "BGRA", 0,
                    0),
    "gop-deep-output": (lambda: _golden("gop_320x240_q4_p1.cfhd.f1"),
                        "RG48", 0, 0),
}


@pytest.mark.parametrize("route", list(GEOMETRY))
def test_geometry_routes_match_jax(route, jax_host):
    """A decode to another size, a lens warp and a group to the deep and
    RGB outputs decode as the JAX API decodes them."""
    make, fmt, w, h = GEOMETRY[route]
    sample = make()
    got = _decode(api, {"device": "cpu"}, [sample], fmt, w=w, h=h)
    assert got == _decode(jax_host, {}, [sample], fmt, w=w, h=h)
    assert isinstance(got[0], bytes)


def test_the_lens_sample_decodes_unwarped_to_other_outputs():
    """Only the outputs the reference warps refuse the lens sample: UYVY
    decodes as the JAX API decodes it."""
    sample = _lens_sample()
    assert _decode(api, {"device": "cpu"}, [sample], "UYVY") == \
        _decode(japi, {}, [sample], "UYVY")


def test_kernel_errors_reach_the_caller():
    """On a device with no kernel the wrappers raise, and the API passes
    the error on (the decoder as CFHDError) instead of decoding elsewhere."""
    enc = api.Encoder("meta")
    enc.prepare_to_encode(64, 48, api.PixelFormat.YUY2)
    with pytest.raises(ValueError, match="no kernel"):
        enc.encode_sample(tframes.yuy2_frame(64, 48, 1))
    dec = api.Decoder("meta")
    sample = _golden("s_64x48_q4_p1.cfhd")
    dec.prepare_to_decode(0, 0, sample=sample)
    with pytest.raises(api.CFHDError, match="no kernel"):
        dec.decode_sample(sample)


def test_frames_of_both_frame_makers_agree():
    """The port's test frames are the JAX package's (the inputs above)."""
    assert tframes.yuy2_frame(W, H, 1) == jframes.yuy2_frame(W, H, 1)

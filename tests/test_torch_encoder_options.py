"""The port's encoder options on the CPU: custom quantization, the LYUV/CV67
input transform of the override database, the V210 uncompressed
passthrough and the interlaced two-frame GOP.

The same inputs go through the port and the JAX package, and every
comparison is exact: `limit_convert_yuy2`, `quantize_mid` and
`frame_wavelet_forward` against their NumPy originals
(`cineform_tpu.utils.override_db`, `cineform_tpu.ref.gop`); the port's
`api.Encoder` against the JAX `api.Encoder` on its host route, sample for
sample (the override database in a temporary `CINEFORM_OVERRIDE_PATH`, as
`tests/test_overrides.py` sets it up); `GopCodec(progressive=False)`
against `gop_host.encode_group(progressive=False)` at `tests/test_gop.py`'s
four interlaced sizes and against the reference's interlaced group golden.
"""

import os

import numpy as np
import pytest
import torch

from cineform_tpu import api as japi
from cineform_tpu.models import gop_host as jgop_host
from cineform_tpu.ref import gop as jgop
from cineform_tpu.ref import intra as jref
from cineform_tpu.utils import override_db as joverride
from cineform_tpu_torch import api, pool
from cineform_tpu_torch import testframes as tframes
from cineform_tpu_torch.models.gop import GopCodec
from cineform_tpu_torch.models.intra import IntraCodec, sample_metadata
from cineform_tpu_torch.models.intra_host import EncoderMetadata
from cineform_tpu_torch.ops import intra_transform as ops
from cineform_tpu_torch.spec.production import (IntraParams,
                                                custom_quant_tables)
from cineform_tpu_torch.spec import tags

torch.set_num_threads(1)

CPU = torch.device("cpu")
SAMPLES = os.path.join(os.path.dirname(__file__), "golden", "samples")
META = EncoderMetadata()                # fixed metadata on both sides
#: caller tables for set_custom_quantization: coarse, the finest, one
#: with a distinct chroma table, and a coarser one
CUSTOM = {"coarse": ([4] + [12] * 16,),
          "ones": ([1] * 17, [2] * 17),
          "chroma": ([4, 6, 6, 8, 6, 6, 8, 5, 8, 8, 12, 16, 16, 24, 16, 16,
                      24], [4] + [20] * 16),
          "very-coarse": ([4] + [40] * 16,)}
#: test_gop's interlaced cases: (width, height, quality, pattern)
ILACE = [(320, 240, 4, 7), (320, 240, 1, 3), (192, 120, 6, 11),
         (64, 48, 4, 1)]


def _golden(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


def _encode(mod, fmt, w, h, frames, quality=4, flags=0, metadata=META,
            custom=None):
    """The frames through one `mod.Encoder` -> the samples."""
    enc = mod.Encoder(**({"device": "cpu"} if mod is api else {}))
    enc.prepare_to_encode(w, h, mod.PixelFormat[fmt],
                          encoding_flags=mod.EncodingFlags(flags),
                          quality=quality)
    if custom is not None:
        enc.set_custom_quantization(*custom)
    enc.attach_metadata(metadata)
    out = []
    for f in frames:
        enc.encode_sample(f)
        out.append(enc.get_sample_data())
    return out


@pytest.fixture
def overrides(monkeypatch, tmp_path):
    """The override database in a temporary directory, and the JAX API on
    its host route: -> a function that writes override.colr's tuples."""
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    monkeypatch.setenv("CINEFORM_OVERRIDE_PATH", str(tmp_path))
    monkeypatch.setenv("CINEFORM_LUT_PATH", str(tmp_path))

    def write(pairs):
        (tmp_path / "override.colr").write_bytes(b"".join(
            tag + (4).to_bytes(3, "little") + b"H" + v.to_bytes(4, "little")
            for tag, v in pairs))
    return write


# --- the LYUV/CV67 input transform ----------------------------------------

@pytest.mark.parametrize("w,h", [(320, 240), (104, 24)])
@pytest.mark.parametrize("limit,conv", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_limit_convert_yuy2_matches_jax(limit, conv, w, h):
    frame = np.random.default_rng(w + 2 * limit + conv).integers(
        0, 256, (h, 2 * w), dtype=np.uint8)
    got = ops.limit_convert_yuy2(torch.from_numpy(frame)[None], limit, conv)
    want = joverride.limit_convert_yuy2(frame, limit, conv)
    for g, x in zip(got, want, strict=True):
        np.testing.assert_array_equal(g[0].numpy(), x)


@pytest.mark.parametrize("pairs", [[(b"LYUV", 1)], [(b"CV67", 1)],
                                   [(b"LYUV", 1), (b"CV67", 1)]],
                         ids=["LYUV", "CV67", "LYUV+CV67"])
def test_override_encodes_match_jax(pairs, overrides):
    """override.colr's LYUV and CV67, at test_overrides' 256x128 quality
    4 over two frames, with custom tables set (which that route ignores,
    as the JAX API does): every sample equals the JAX API's, and differs
    from the plain encode."""
    frames = [tframes.yuy2_frame(256, 128, p) for p in (1, 2)]
    plain = _encode(api, "YUY2", 256, 128, frames)
    overrides(pairs)
    got = _encode(api, "YUY2", 256, 128, frames, custom=CUSTOM["coarse"])
    assert got == _encode(japi, "YUY2", 256, 128, frames,
                          custom=CUSTOM["coarse"])
    assert all(a != b for a, b in zip(got, plain))


def test_attached_lyuv_tuple_encodes_as_jax(overrides):
    """An LYUV tuple in the attached metadata drives the encode as the JAX
    API's does."""
    class Meta(EncoderMetadata):
        def block(self) -> bytes:
            return super().block() + b"LYUV" + (4).to_bytes(
                3, "little") + b"H" + (1).to_bytes(4, "little")

    frames = [tframes.yuy2_frame(128, 48, 3)]
    assert _encode(api, "YUY2", 128, 48, frames, metadata=Meta()) == \
        _encode(japi, "YUY2", 128, 48, frames, metadata=Meta())


# --- custom quantization -----------------------------------------------------

@pytest.mark.parametrize("quality", [4, 5])
@pytest.mark.parametrize("name", list(CUSTOM))
def test_custom_quantization_matches_jax(name, quality, overrides):
    """set_custom_quantization on the YUY2 route, alone (FILMSCAN1) and
    with FILMSCAN2's rate control over three frames: every sample equals
    the JAX API's."""
    frames = [tframes.yuy2_frame(320, 240, p) for p in (1, 2, 3)]
    got = _encode(api, "YUY2", 320, 240, frames, quality, custom=CUSTOM[name])
    assert got == _encode(japi, "YUY2", 320, 240, frames, quality,
                          custom=CUSTOM[name])
    if name == "very-coarse":
        plain = _encode(api, "YUY2", 320, 240, frames, quality)
        assert all(len(a) < 0.8 * len(b) for a, b in zip(got, plain))


@pytest.mark.parametrize("fmt,flags", [("UYVY", 0), ("RG48", 0),
                                       ("R210", 0), ("YUY2", 2)])
def test_custom_quantization_ignored_off_the_yuy2_route(fmt, flags,
                                                        overrides):
    """Other formats and the 2-frame GOP ignore the tables, as the JAX
    API does."""
    rb = IntraCodec(64, 48, 4, device=CPU, input_format=fmt).row_bytes
    frames = [tframes.raw_fill(48 * rb, p) for p in (1, 2)]
    got = _encode(api, fmt, 64, 48, frames, flags=flags,
                  custom=CUSTOM["coarse"])
    assert got == _encode(api, fmt, 64, 48, frames, flags=flags)
    assert got == _encode(japi, fmt, 64, 48, frames, flags=flags,
                          custom=CUSTOM["coarse"])


@pytest.mark.parametrize("name", list(CUSTOM))
def test_codec_tables_take_the_custom_quantizers(name):
    """A codec's device tables and band headers take the custom tables."""
    tables = tuple(map(tuple, custom_quant_tables(
        CUSTOM[name][0], CUSTOM[name][-1], tags.PRECISION_10BIT)))
    codec = IntraCodec(64, 48, 4, device=CPU, custom_quant=tables)
    params = IntraParams(width=64, height=48, quality=4, custom_quant=tables)
    assert codec.tables().band_quant == tuple(
        tuple(map(tuple, params.band_quant(ch))) for ch in range(3))


# --- the V210 uncompressed passthrough ---------------------------------------

def test_v210_passthrough_series_matches_jax(overrides):
    """A 12-frame 96x48 V210 series at QUARTER_UNCOMPRESSED | FILMSCAN1
    (0x0404) with fixed metadata: the per-frame decisions and every
    sample, raw and compressed fallback, equal the JAX API's, and both
    kinds occur."""
    w, h = 96, 48
    frames = [tframes.v210_frame(w, h, f + 1) for f in range(12)]
    got = _encode(api, "V210", w, h, frames, 0x0404)
    want = _encode(japi, "V210", w, h, frames, 0x0404)
    raw = [len(s) > 10000 for s in got]
    assert any(raw) and not all(raw)
    assert got == want


def test_v210_passthrough_first_frame_form_matches_jax(overrides):
    """A first-frame uncompressed sample (the header without the
    precision tag, prescale 0) at 320x240, 0x1004, equals the JAX API's."""
    frames = [tframes.v210_frame(320, 240, 1)]
    got = _encode(api, "V210", 320, 240, frames, 0x1004)
    assert len(got[0]) > 200000
    assert got == _encode(japi, "V210", 320, 240, frames, 0x1004)


# --- the interlaced two-frame GOP --------------------------------------------

@pytest.mark.parametrize("channel", [0, 1, 2])
@pytest.mark.parametrize("w,h", [(320, 240), (64, 48)])
def test_frame_wavelet_forward_matches_jax(channel, w, h):
    """The HORZTEMP frame wavelet of each channel of a YUY2 frame, with
    the interlaced quantizers, equals `ref.gop.frame_wavelet_forward`."""
    plane = jref.unpack_yuy2(tframes.yuy2_frame(w, h, 7), w, h)[channel]
    quant = jgop.fieldplus_band_quant(4, 10, channel, progressive=False)[0]
    ll, bands = ops.frame_wavelet_forward(torch.from_numpy(plane)[None],
                                          quant)
    jll, jbands = jgop.frame_wavelet_forward(plane, quant)
    np.testing.assert_array_equal(ll[0].numpy(), jll)
    for g, x in zip(bands, jbands, strict=True):
        np.testing.assert_array_equal(g[0].numpy(), x)


@pytest.mark.parametrize("q", [1, 2, 7, 40])
def test_quantize_mid_matches_jax(q):
    v = torch.from_numpy(np.random.default_rng(q).integers(
        -32768, 32768, (6, 40)).astype(np.int32))
    np.testing.assert_array_equal(ops.quantize_mid(v, q).numpy(),
                                  jgop.quantize_mid(v.numpy(), q))


@pytest.mark.parametrize("w,h,q,pat", ILACE)
def test_interlaced_groups_match_jax(w, h, q, pat):
    """`GopCodec(progressive=False).encode_batch` of two pairs equals
    `gop_host.encode_group(progressive=False)` of each."""
    pairs = [(tframes.yuy2_frame(w, h, p), tframes.yuy2_frame(w, h, p + 1))
             for p in (pat, pat + 2)]
    f0, f1 = (np.stack([np.frombuffer(p[i], np.uint8).reshape(h, 2 * w)
                        for p in pairs]) for i in (0, 1))
    got = GopCodec(w, h, q, device=CPU, progressive=False).encode_batch(
        f0, f1, metadata=META, frame_numbers=[1, 3])
    assert got == [jgop_host.encode_group(a, b, w, h, q, 1 + 2 * i, META,
                                          progressive=False)
                   for i, (a, b) in enumerate(pairs)]


def test_interlaced_api_stream_matches_golden_and_jax(overrides):
    """`YUV_2FRAME_GOP | YUV_INTERLACED` through the port's api.Encoder:
    the group of patterns 1 and 2 is the reference's golden, and a
    4-frame stream equals the JAX API's sample for sample."""
    gold = _golden("ilace_320x240_q4_p1.cfhd.f1")
    meta = sample_metadata(gold)
    frames = [tframes.yuy2_frame(320, 240, p) for p in (1, 2, 3, 4)]
    got = _encode(api, "YUY2", 320, 240, frames, flags=3, metadata=meta)
    assert got[1] == gold
    assert got == _encode(japi, "YUY2", 320, 240, frames, flags=3,
                          metadata=meta)


def test_pool_refuses_interlaced_groups_as_jax():
    """The JAX pool refuses the interlaced GOP, though its sync Encoder
    takes it; the port's pool does the same."""
    for mod, kw in ((pool, {"device": "cpu"}), (None, {})):
        if mod is None:
            from cineform_tpu import pool as jpool
            p = jpool.EncoderPool(1, 2)
            flags = japi.EncodingFlags(3)
            err = japi.CFHDError
            fmt = japi.PixelFormat.YUY2
        else:
            p = mod.EncoderPool(1, 2, **kw)
            flags, err, fmt = api.EncodingFlags(3), api.CFHDError, \
                api.PixelFormat.YUY2
        with pytest.raises(err) as e:
            p.prepare_to_encode(64, 48, fmt, encoding_flags=flags)
        assert int(e.value.code) == int(api.ErrorCode.BADFORMAT)

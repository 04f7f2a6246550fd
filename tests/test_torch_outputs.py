"""The decoder's deep and 8-bit outputs of the port (`ops.yuv_output`,
`IntraCodec.inverse_output`) on the CPU, against the JAX package's host
decoders and the reference goldens.

The same samples, encoded from seeded frames, go through the JAX
`intra_host.decode_sample_to` (4:2:2 sources) or `decode_sample_rgb` (RGB
sources) and through both decode routes of the port's `IntraCodec`
(`decode_batch`, host entropy; `decode_batch_device`, the device entropy
decoder's plain versions).  Every comparison is byte for byte (tolerance
0: all of it is integer arithmetic), but for the 8-bit outputs of an RGB
source against the reference's goldens, which the JAX package itself
holds within +/-1 (the reference dithers there with rand() vectors whose
order is not recoverable).
"""

import functools
import os

import numpy as np
import pytest
import torch

from cineform_tpu import api as japi
from cineform_tpu.models import intra_host as jhost
from cineform_tpu.ref import intra as jref
from cineform_tpu_torch import api
from cineform_tpu_torch import testframes as tframes
from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.ops import yuv_output

torch.set_num_threads(1)

CPU = torch.device("cpu")
SAMPLES = os.path.join(os.path.dirname(__file__), "golden", "samples")
#: 64x48; 144x96, whose chroma lowpass is 9 wide (the odd-width offset);
#: 176x48, whose v210 rows end in a partial 6-pixel group
SIZES = [(64, 48), (144, 96), (176, 48)]
#: the new outputs of a 4:2:2 source, by the JAX package's fourcc names
OUTPUTS_422 = [*yuv_output.OUTPUTS_422, "BGRa", "yuyv"]
RGB_OUTPUTS = ["WP13", "W13A", "BGRA", "BGRa", "RG24"]


def _golden(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def _samples(fmt: str, w: int, h: int) -> tuple[bytes, ...]:
    """Two samples of `fmt` at w x h, encoded by the port from seeded
    frames: test pattern 1 and pattern 2 with seeded noise of +/-8."""
    rng = np.random.default_rng(w * h + len(fmt))
    maker = {"YUY2": tframes.yuy2_frame, "RG48": tframes.rg48_frame,
             "B64A": tframes.b64a_frame}[fmt]
    frames = []
    for pattern in (1, 2):
        f = np.frombuffer(maker(w, h, pattern), np.uint8).astype(np.int32)
        f = f + rng.integers(-8, 9, f.shape)
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    return tuple(codec.encode_batch(
        np.stack(frames).reshape(2, h, codec.row_bytes)))


def _both_routes(codec, samples, output):
    """Each frame's bytes from `decode_batch` and from
    `decode_batch_device`, which must take no frame to its fallback."""
    host = codec.decode_batch(samples, output=output)
    dev, fallback = codec.decode_batch_device(samples, output=output)
    assert fallback == ()
    return [f.tobytes() for f in host], [f.tobytes() for f in dev]


@pytest.mark.parametrize("output", OUTPUTS_422)
@pytest.mark.parametrize("w,h", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_422_output_matches_jax_host_decoder(w, h, output):
    samples = _samples("YUY2", w, h)
    codec = IntraCodec(w, h, 4, device=CPU)
    if output == "v210" and w % 6 == 4:
        # the JAX model's partial tail group reads a chroma column past the
        # row there (ROADMAP Queue 3): both refuse
        with pytest.raises(IndexError):
            jhost.decode_sample_to(samples[0], output)
        with pytest.raises(ValueError, match="past the chroma row"):
            codec.decode_batch(samples, output=output)
        with pytest.raises(ValueError, match="past the chroma row"):
            codec.decode_batch_device(samples, output=output)
        return
    want = [jhost.decode_sample_to(s, output) for s in samples]
    host, dev = _both_routes(codec, samples, output)
    assert host == want
    assert dev == want


@pytest.mark.parametrize("output", RGB_OUTPUTS)
@pytest.mark.parametrize("fmt", ["RG48", "B64A"])
def test_rgb_output_matches_jax_host_decoder(fmt, output):
    w, h = 64, 48
    samples = _samples(fmt, w, h)
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    want = [jhost.decode_sample_rgb(s, output)[0] for s in samples]
    host, dev = _both_routes(codec, samples, output)
    assert host == want
    assert dev == want


#: the output goldens of the reference binary: sample, output format,
#: golden output
OUTPUT_GOLDENS = [
    *(("s_320x240_q4_p1", fmt, ext) for fmt, ext in (
        ("YU64", "yu64out"), ("V210", "v210out"), ("R408", "r408out"),
        ("V408", "v408out"), ("RG24", "rg24out"), ("WP13", "wp13out"),
        ("W13A", "w13aout"), ("YUYV", "yuyvout"), ("CT_SHORT", "av16out"),
        ("CT_USHORT_10_6", "a106out"), ("CT_SHORT_2_14", "a214out"),
        ("CT_10BIT_2_8", "av28out"), ("BGRa", "bgra_sdout"))),
    *(("s_128x96_q4_p1", fmt, ext) for fmt, ext in (
        ("RG48", "rg48out"), ("B64A", "b64aout"), ("R210", "r210out"),
        ("DPX0", "dpx0out"), ("RG30", "rg30out"))),
    ("s_144x96_q4_p1", "V210", "v210out"),
    ("s_144x96_q4_p1", "YU64", "yu64out"),
    ("rg48_320x240_q4_p1", "WP13", "wp13out"),
    ("rg48_320x240_q4_p1", "W13A", "w13aout"),
    ("rg48_320x240_q4_p1", "RG24", "rg24out"),
    ("rg48_320x240_q4_p1", "BGRa", "bgra_sdout"),
    ("yu64_320x240_q4_p1", "RG48", "rg48out"),
]
#: the 8-bit outputs of an RGB source, which round to nearest where the
#: reference dithers
NEAR = {("rg48_320x240_q4_p1", "RG24"), ("rg48_320x240_q4_p1", "BGRa")}


def _api_decode(mod, device_kw, sample, fmt):
    dec = mod.Decoder(**device_kw)
    dec.prepare_to_decode(0, 0, mod.PixelFormat[fmt], sample=sample)
    return dec, dec.decode_sample(sample).tobytes()


@pytest.mark.parametrize("name,fmt,ext", OUTPUT_GOLDENS,
                         ids=[f"{g[0]}-{g[2]}" for g in OUTPUT_GOLDENS])
def test_output_golden_through_the_api(name, fmt, ext, monkeypatch):
    """Every output golden through the port's `api.Decoder` on its device
    route, with no frame falling back, equal to the JAX API's host route
    and to the golden (the two rounded 8-bit outputs of the RGB source
    within the JAX package's own bound of +/-1, on under a fifth of the
    bytes)."""
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    sample = _golden(name + ".cfhd")
    dec, got = _api_decode(api, {"device": "cpu"}, sample, fmt)
    assert dec.fallback_frames == 0
    assert got == _api_decode(japi, {}, sample, fmt)[1]
    gold = _golden(f"{name}.{ext}")
    if (name, fmt) in NEAR:
        d = np.abs(np.frombuffer(got, np.uint8).astype(int)
                   - np.frombuffer(gold, np.uint8).astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.2
    else:
        assert got == gold


def _edge_planes(seed: int, shape) -> torch.Tensor:
    """Seeded uint16 planes as int32, with 0, 65535 and the values at the
    int16 wrap edges of the conversion's shifts spread through them."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 65536, shape)
    edges = np.array([0, 65535, 32767, 32768, 16383, 16384, 49151, 49152,
                      4095, 4096, 8191, 8192, 1, 65534])
    x.flat[rng.choice(x.size, 4 * edges.size, replace=False)] = \
        np.tile(edges, 4)
    return torch.from_numpy(x.astype(np.int32))


@pytest.mark.parametrize("colorspace", [2, 1])
def test_yuv16_to_rgb16_matches_the_oracle(colorspace):
    """`yuv16_to_rgb16` (CG 709 and CG 601) and `chroma_422_to_444` equal
    the JAX package's NumPy oracle on seeded 16-bit planes."""
    y, u, v = (_edge_planes(colorspace * 10 + i, (24, 64)) for i in range(3))
    got = yuv_output.yuv16_to_rgb16(y, u, v, colorspace)
    want = jref.yuv16_to_rgb16(y.numpy(), u.numpy(), v.numpy(), colorspace)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wnt)
    c = u[:, :32]
    np.testing.assert_array_equal(
        yuv_output.chroma_422_to_444(c).numpy(),
        jref.chroma_422_to_444(c.numpy(), 64, interpolate=False))

"""The port's 10-bit 4:2:2 (UYVY, YU64, V210) and Bayer (BYR4, BYR5)
inputs, its BGRA and BYR4 outputs and its dequantization, on the CPU.

The unpacks, `dequantize`, `strip_to_bgra` and the codec's inverses are
held against the JAX package's functions on seeded numpy inputs;
`IntraCodec` against the reference SDK's golden samples on both encode and
both decode routes, against the JAX `IntraCodec.encode_batch` and host
encoder, and its device decode against the JAX host decoders.  The JAX codec's device
encode and decode are in tests/test_torch_formats_device.py.  Every
comparison is exact (tolerance 0): the codec is integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cineform_tpu import api
from cineform_tpu.models import intra_host as jhost
from cineform_tpu.models.intra import IntraCodec as JaxIntraCodec
from cineform_tpu.ops import bgra_jax
from cineform_tpu.ops import intra_transform as jops
from cineform_tpu.ref import intra as jref
from cineform_tpu_torch import testframes
from cineform_tpu_torch.models.intra import IntraCodec, sample_metadata
from cineform_tpu_torch.ops import bgra
from cineform_tpu_torch.ops import intra_transform as tops
from cineform_tpu_torch.ref.intra import byr4_log90_curve
from cineform_tpu_torch.utils.timing import Timing
from tests.test_formats import _golden

torch.set_num_threads(1)

CPU = torch.device("cpu")
NEW_FORMATS = ("UYVY", "YU64", "V210", "BYR4", "BYR5")

#: input format, its 320x240 quality-4 encode golden and the frame that
#: golden encodes
ENCODE_GOLDENS = [
    ("UYVY", "uyvy_320x240_q4_p1.cfhd",
     lambda w, h: testframes.uyvy_frame(w, h, 1)),
    ("V210", "v210_320x240_q4_p1.cfhd",
     lambda w, h: testframes.v210_frame(w, h, 1)),
    ("YU64", "yu64_320x240_q4_p1.cfhd",
     lambda w, h: testframes.yu64_frame(w, h, 1)),
    ("BYR4", "byr4_320x240_q4_p1.cfhd",
     lambda w, h: testframes.byr4_frame(w, h, 1)),
    ("BYR5", "raw_BYR5.cfhd",
     lambda w, h: testframes.raw_fill(w * h * 3 // 2, 1)),
]


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _frames(codec, raws) -> np.ndarray:
    return np.stack([np.frombuffer(r, np.uint8).reshape(
        codec.height, codec.row_bytes) for r in raws])


def _random_frames(fmt: str, w: int, h: int, seed: int, batch: int = 2):
    """Seeded frames of `fmt`: random bytes, v210 with the top two bits of
    every word clear (as a v210 writer leaves them)."""
    rng = np.random.default_rng(seed)
    row_bytes = IntraCodec(w, h, 4, device=CPU, input_format=fmt).row_bytes
    if fmt == "V210":
        words = rng.integers(0, 1 << 30, (batch, h, row_bytes // 4))
        return words.astype("<u4").view(np.uint8)
    return rng.integers(0, 256, (batch, h, row_bytes)).astype(np.uint8)


# ---------------------------------------------------------------------------
# Plain functions against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,width", [("unpack_uyvy", 96),
                                        ("unpack_uyvy", 144),
                                        ("unpack_yu64", 96),
                                        ("unpack_yu64", 144),
                                        ("unpack_v210", 96),
                                        ("unpack_v210", 144)])
def test_yuv_unpacks_match_jax(name, width):
    fmt = name.split("_")[1].upper()
    frames = _random_frames(fmt, width, 8, width + len(name))
    args = (width,) if fmt == "V210" else ()
    got = getattr(tops, name)(torch.from_numpy(frames), *args)
    want = getattr(jops, name)(jnp.asarray(frames), *args)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)


@pytest.mark.parametrize("width", [320, 104, 1928])
def test_v210_unpack_tail_matches_the_oracle(width):
    """At widths that are not a multiple of 48 the reference's scalar tail
    lags Cr by one column in each 6-pixel group: the port's unpack equals
    the NumPy oracle `ref.intra.unpack_v210`, which reproduces it (the JAX
    device unpack takes only multiples of 48)."""
    h = 4
    frames = _random_frames("V210", width, h, width)
    got = tops.unpack_v210(torch.from_numpy(frames), width)
    for i in range(frames.shape[0]):
        want = jref.unpack_v210(frames[i].tobytes(), width, h)
        for g, w in zip(got, want, strict=True):
            _eq(g[i], w)


def test_v210_rows_of_the_wrong_pitch_raise():
    """A v210 row holds whole 48-pixel blocks of 128 bytes; rows of
    another size raise, in the unpack and in the codec."""
    frames = torch.zeros((1, 4, 5 * 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="v210 row 1920 pixels wide"):
        tops.unpack_v210(frames, 1920)
    codec = IntraCodec(1920, 4, 4, device=CPU, input_format="V210")
    assert codec.row_bytes == 5120
    with pytest.raises(ValueError, match="V210"):
        codec.encode_batch(np.zeros((1, 4, 2 * 1920), np.uint8))


@pytest.mark.parametrize("bayer_format", [0, 1, 2, 3])
@pytest.mark.parametrize("width", [96, 144])
@pytest.mark.parametrize("fmt", ["BYR4", "BYR5"])
def test_bayer_unpacks_match_jax(fmt, width, bayer_format):
    """Random mosaics in each of the four Bayer orders: BYR4 (16-bit LE,
    through the LOG-90 curve) and BYR5 (packed 12-bit, as quarter-res rows
    of 3W bytes)."""
    h = 8
    frames = _random_frames(fmt, width, h, width + bayer_format)
    if fmt == "BYR4":
        lut = byr4_log90_curve().astype(np.int32)
        got = tops.unpack_byr4(torch.from_numpy(frames), torch.from_numpy(lut),
                               bayer_format)
        want = jops.unpack_byr4(jnp.asarray(frames), jnp.asarray(lut),
                                bayer_format)
    else:
        frames = frames.reshape(2, h // 2, 3 * width)
        got = tops.unpack_byr5(torch.from_numpy(frames), bayer_format)
        want = jops.unpack_byr5(jnp.asarray(frames), bayer_format)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == (2, h // 2, width // 2) and g.dtype == torch.int32
        _eq(g, w)


@pytest.mark.parametrize("q", [1, 2, 7, 24, 255, 1000])
def test_dequantize_matches_jax(q):
    """Every code in -1100..1100 (past the +-1023 clamp), with quantizers
    up to where the product wraps at 16 bits."""
    codes = np.arange(-1100, 1101, dtype=np.int32)
    _eq(tops.dequantize(torch.from_numpy(codes), q),
        jops.dequantize(jnp.asarray(codes), q))
    mags = np.arange(0, 1101, dtype=np.int32)
    _eq(tops.requantize_magnitude(torch.from_numpy(mags)),
        jops.requantize_magnitude(jnp.asarray(mags)))


@pytest.mark.parametrize("n", [20, 40, 72, 160])
@pytest.mark.parametrize("spread", [3000, 32768])
def test_strip_to_bgra_matches_jax(n, spread):
    """Random final-level strips, Y (2, 6, n) and the chroma (2, 6, n/2),
    at widths where the SSE region ends before, at and well inside the
    row, over a moderate range and the whole int16 range (which saturates
    every lane)."""
    rng = np.random.default_rng(n + spread)

    def rand(w):
        return rng.integers(-spread, spread, (2, 6, w)).astype(np.int32)

    strips = [rand(n), rand(n), rand(n // 2), rand(n // 2), rand(n // 2),
              rand(n // 2)]
    got = bgra.strip_to_bgra(*(torch.from_numpy(s) for s in strips))
    assert got.shape == (2, 6, 2 * n, 4) and got.dtype == torch.uint8
    _eq(got, bgra_jax.strip_to_bgra(*(jnp.asarray(s) for s in strips)))


def _random_coeffs(codec, seed, lo=-2000, hi=2000):
    """Per-channel (lowpass, bands) of random integers, numpy and torch."""
    rng = np.random.default_rng(seed)
    p = codec.params
    out = []
    for ch in range(codec.num_channels):
        w = codec.plane_width(ch)
        lowpass = rng.integers(0, 4 * hi, (2, p.height >> 3, w >> 3))
        bands = [tuple(rng.integers(lo, hi, (2, p.height >> (k + 1),
                                             w >> (k + 1)))
                       for _ in range(3)) for k in range(3)]
        out.append((lowpass.astype(np.int32),
                    [tuple(b.astype(np.int32) for b in bs) for bs in bands]))
    as_torch = [(torch.from_numpy(lp), [tuple(torch.from_numpy(b) for b in bs)
                                        for bs in bands])
                for lp, bands in out]
    as_jax = [(jnp.asarray(lp), [tuple(jnp.asarray(b) for b in bs)
                                 for bs in bands]) for lp, bands in out]
    return as_torch, as_jax


@pytest.mark.parametrize("fmt,w,h", [("V210", 96, 48), ("YU64", 144, 48),
                                     ("BYR4", 96, 48)])
def test_dequantize_of_the_codec_matches_jax(fmt, w, h):
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    coeffs, jcoeffs = _random_coeffs(codec, w + h, -1100, 1100)
    got = codec.dequantize(coeffs)
    want = JaxIntraCodec(width=w, height=h, quality=4,
                         input_format=fmt).dequantize(jcoeffs)
    for (gl, gb), (wl, wb) in zip(got, want, strict=True):
        _eq(gl, wl)
        for k in range(3):
            for b in range(3):
                _eq(gb[k][b], wb[k][b])


@pytest.mark.parametrize("w", [96, 144])
def test_inverse_bgra_matches_jax(w):
    """Random coefficients of a 4:2:2 codec; at 144 the chroma lowpass is
    9 wide, which takes the odd-width offset."""
    codec = IntraCodec(w, 48, 4, device=CPU, input_format="UYVY")
    coeffs, jcoeffs = _random_coeffs(codec, w)
    got = codec.inverse_bgra(coeffs)
    assert got.shape == (2, 48, w, 4) and got.dtype == torch.uint8
    _eq(got, JaxIntraCodec(width=w, height=48, quality=4,
                           input_format="UYVY").inverse_bgra(jcoeffs))


def test_inverse_byr4_matches_jax():
    """Random coefficients of a 96x48 Bayer codec (24x12 planes)."""
    codec = IntraCodec(96, 48, 4, device=CPU, input_format="BYR4")
    coeffs, jcoeffs = _random_coeffs(codec, 5)
    got = codec.inverse_byr(coeffs)
    assert got.shape == (2, 48, 96) and got.dtype == torch.int32
    _eq(got, JaxIntraCodec(width=96, height=48, quality=4,
                           input_format="BYR4").inverse_byr4(jcoeffs))


# ---------------------------------------------------------------------------
# IntraCodec against the JAX codec, the goldens and the JAX host decoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", NEW_FORMATS)
def test_encode_matches_jax(fmt):
    """Both encode routes on seeded frames at 96x48 (Bayer: 48x24 planes)
    against the JAX `IntraCodec.encode_batch`."""
    w, h = 96, 48
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    frames = _random_frames(fmt, w, h, len(fmt))
    want = JaxIntraCodec(width=w, height=h, quality=4,
                         input_format=fmt).encode_batch(frames, 3)
    assert codec.encode_batch_device(frames, 3) == want
    assert codec.encode_batch(frames, 3) == want


@pytest.mark.parametrize("fmt", ["UYVY", "YU64", "V210"])
def test_encode_matches_the_jax_host_encoder(fmt):
    """Both encode routes on the seeded 96x48 frame that the JAX package's
    tests encode on its device route and hold to its host encoder
    (`api.Encoder`): the port equals that encoder."""
    w, h = 96, 48
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    rng = np.random.default_rng(11)
    frame = rng.integers(0, 256, size=h * codec.row_bytes, dtype=np.uint8)
    if fmt == "V210":
        frame = rng.integers(0, 1 << 30, size=h * codec.row_bytes // 4,
                             dtype=np.uint32).astype("<u4").view(np.uint8)
    enc = api.Encoder()
    enc.prepare_to_encode(w, h, getattr(api.PixelFormat, fmt))
    enc.encode_sample(frame.tobytes())
    want = enc.get_sample_data()
    frames = frame.reshape(1, h, codec.row_bytes)
    assert codec.encode_batch_device(frames)[0] == want
    assert codec.encode_batch(frames)[0] == want


@pytest.mark.parametrize("fmt,gold,frame", ENCODE_GOLDENS)
def test_encode_matches_golden(fmt, gold, frame):
    """Both encode routes (the device entropy coder with the host's
    overflow re-encode; the host C++ coder) give the reference's bytes."""
    w, h = 320, 240
    want = _golden(gold)
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    frames = _frames(codec, [frame(w, h)])
    meta = sample_metadata(want)
    assert codec.encode_batch_device(frames, 1, meta)[0] == want
    assert codec.encode_batch(frames, 1, meta)[0] == want


@pytest.mark.parametrize("name,fmt,output,ext,shape", [
    ("byr4_320x240_q4_p1", "BYR4", "BYR4", "byr4out", (1, 240, 320)),
    ("s_320x240_q4_p1", "YUY2", "BGRA", "bgraout", (1, 240, 320, 4))])
def test_decode_matches_golden(name, fmt, output, ext, shape):
    """Both decode routes give the reference decoder's BYR4 and BGRA
    bytes, the device route with no frame falling back to the host."""
    sample = _golden(f"{name}.cfhd")
    want = _golden(f"{name}.{ext}")
    codec = IntraCodec(320, 240, 4, device=CPU, input_format=fmt)
    host = codec.decode_batch([sample], output=output)
    assert host.shape == shape
    assert host.dtype == (np.uint16 if output == "BYR4" else np.uint8)
    assert host.tobytes() == want
    dev, fallback = codec.decode_batch_device([sample], output=output)
    assert fallback == () and dev.tobytes() == want


@pytest.mark.parametrize("fmt", ["BYR4", "BYR5"])
def test_bayer_device_decode_matches_jax_host_decoder(fmt):
    """A batch of 2 seeded 128x64 mosaics, encoded by the port, decoded on
    the device route to BYR4, equals the JAX host decoder
    `decode_sample_bayer_to`, which the JAX device decode falls back to."""
    w, h = 128, 64
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    samples = codec.encode_batch_device(_random_frames(fmt, w, h, 9))
    got, fallback = codec.decode_batch_device(samples)
    assert fallback == () and got.shape == (2, h, w)
    for i, s in enumerate(samples):
        assert got[i].tobytes() == jhost.decode_sample_bayer_to(s, "BYR4")


@pytest.mark.parametrize("fmt,w", [("V210", 96), ("UYVY", 192)])
def test_bgra_device_decode_matches_jax_host_decoder(fmt, w):
    """4:2:2 samples of the port decoded on both routes to BGRA equal the
    JAX host decoder `decode_sample_bgra`.  (At odd lowpass widths the JAX
    device decode, which the port follows, differs from it: see
    tests/test_torch_formats_device.py.)"""
    h = 48
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    samples = codec.encode_batch(_random_frames(fmt, w, h, w))
    got, fallback = codec.decode_batch_device(samples, output="BGRA")
    assert fallback == ()
    for i, s in enumerate(samples):
        assert got[i].tobytes() == jhost.decode_sample_bgra(s)
    assert codec.decode_batch(samples, output="BGRA").tobytes() == \
        got.tobytes()


#: the Bayer outputs beside BYR4, as `IntraCodec` and the JAX host decoder
#: `decode_sample_bayer_to` name them
BAYER_OUTPUTS = ("RG48", "b64a", "WP13", "W13A", "BYR2", "YUY2")


def _bayer_samples(w=128, h=64, seed=11):
    codec = IntraCodec(w, h, 4, device=CPU, input_format="BYR4")
    return codec, codec.encode_batch_device(
        _random_frames("BYR4", w, h, seed))


@pytest.mark.parametrize("output", BAYER_OUTPUTS)
def test_bayer_outputs_equal_on_both_routes_and_the_jax_host_decoder(output):
    """Two seeded 128x64 mosaics, encoded by the port, decode to each
    Bayer output equal on both routes, with no frame falling back, and
    equal to the JAX host decoder (the raw chain: no metadata)."""
    codec, samples = _bayer_samples()
    got, fallback = codec.decode_batch_device(samples, output=output)
    assert fallback == ()
    assert codec.decode_batch(samples, output=output).tobytes() == \
        got.tobytes()
    for i, s in enumerate(samples):
        assert got[i].tobytes() == jhost.decode_sample_bayer_to(s, output)


def _develop_want(sample, matrix, output):
    """The host model of a develop matrix's output: the 16-bit chain's
    develop stored << 3 (RG48; WP13 >> 3 of it), or the bilinear chain's
    develop at whitepoint 13 (YUY2)."""
    from cineform_tpu.ref import demosaic as jdm

    planes = jhost.decode_sample_bayer_row16u(sample)
    if output == "YUY2":
        rgb = jdm.demosaic_bilinear_rgb(*planes)
        out13 = jdm.apply_active_metadata_matrix(
            np.clip(rgb, 0, 65535).astype(np.uint16), matrix)
        return jdm.convert_rgb16_to_yuyv(
            out13, parity=jdm.bayer_yuyv_parity(rgb.shape[0]), whitepoint=13)
    rgb = np.clip(jdm.apply_active_metadata_matrix(
        jdm.demosaic_raw_rg48(*planes), matrix) << 3, 0, 65535)
    return (rgb if output == "RG48" else rgb >> 3).astype("<u2").tobytes()


@pytest.mark.parametrize("output", ["RG48", "WP13", "YUY2"])
def test_bayer_batch_with_two_develop_matrices(output):
    """A batch whose two frames carry different develop matrices equals
    each frame decoded alone with its own, on both routes, and the host
    model of the matrix's chain."""
    from cineform_tpu.ref import demosaic as jdm

    codec, samples = _bayer_samples()
    mats = np.stack([jdm.compose_develop_matrix(None, 1.0, 1.0,
                                                (1.6, 1.0, 0.8)),
                     jdm.compose_develop_matrix(
                         np.array([[0.9, 0.08, 0.02, 0.0],
                                   [0.05, 0.9, 0.05, 0.01],
                                   [0.02, 0.08, 0.9, 0.0]]), 1.3, 1.1)])
    got, fallback = codec.decode_batch_device(samples, output=output,
                                              develop=mats)
    assert fallback == ()
    assert codec.decode_batch(samples, output=output,
                              develop=mats).tobytes() == got.tobytes()
    for i, s in enumerate(samples):
        alone, _ = codec.decode_batch_device([s], output=output,
                                             develop=mats[i:i + 1])
        assert alone[0].tobytes() == got[i].tobytes()
        assert got[i].tobytes() == _develop_want(s, mats[i], output)


def test_develop_matrix_only_for_the_bayer_rgb_outputs():
    codec, samples = _bayer_samples()
    with pytest.raises(ValueError, match="develop matrix"):
        codec.decode_batch(samples, output="BYR4", develop=np.stack(
            [np.eye(3, 4)] * 2))


def test_transform_round_trip_equals_the_codec_round_trip():
    """`inverse(dequantize(forward(frames)))`, bench.py's transform round
    trip, equals `decode_batch` of the `encode_batch` samples, on the 4:2:2
    10-bit frames at 320x240."""
    w, h = 320, 240
    codec = IntraCodec(w, h, 4, device=CPU, input_format="V210")
    frames = _frames(codec, [testframes.v210_frame(w, h, p) for p in (1, 2)])
    got = codec.inverse(codec.dequantize(codec.forward(
        torch.from_numpy(frames))))
    _eq(got, codec.decode_batch(codec.encode_batch(frames)))


def test_outputs_of_the_new_formats_and_their_checks():
    """4:2:2 sources decode to YUY2 by default and to BGRA; Bayer sources
    to BYR4 by default and to RG48, b64a, WP13, W13A, BYR2 and YUY2, not
    BGRA; a format outside the codec's list raises."""
    def codec(fmt):
        return IntraCodec(96, 48, 4, device=CPU, input_format=fmt)

    for fmt in ("YUY2", "UYVY", "YU64", "V210"):
        assert codec(fmt).decode_output(None) == "YUY2"
        assert codec(fmt).decode_output("BGRA") == "BGRA"
    for fmt in ("BYR4", "BYR5"):
        assert codec(fmt).decode_output(None) == "BYR4"
        for output in BAYER_OUTPUTS:
            assert codec(fmt).decode_output(output) == output
        with pytest.raises(ValueError, match="decodes to BYR4"):
            codec(fmt).decode_output("BGRA")
    with pytest.raises(ValueError, match="BYR4"):
        codec("RG48").decode_output("BYR4")
    assert codec("BYR5").row_bytes == 144
    assert (codec("BYR4").params.width, codec("BYR4").params.height) == \
        (48, 24)


def test_timing_stage_on_cpu_tensors():
    """`Timing.stage` times a stage whose tensors are on the CPU (nothing
    to wait for), counts, reports, and refuses to wait for what it cannot."""
    t = Timing()
    x = torch.arange(10)
    with t.stage("a", sync=x):
        x = x * 2
    with t.stage("a") as r:
        r["sync"] = {"y": [x, (x + 1,)]}
    t.count("frames", 3)
    assert t.stages["a"].calls == 2 and t.stages["a"].total_s >= 0
    report = t.report().splitlines()
    assert report[0] == "stage,calls,total_ms,mean_ms,min_ms,max_ms"
    assert report[1].startswith("a,2,") and report[2] == "counter:frames,3"
    with pytest.raises(TypeError, match="cannot wait"):
        with t.stage("b", sync=np.zeros(3)):
            pass

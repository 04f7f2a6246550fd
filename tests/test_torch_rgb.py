"""The port's RGB 4:4:4 (RG48) and RGBA 4:4:4:4 (B64A, RG64) intra codec
on the CPU: the unpacks, the 16-bit inverse helpers and the forward DWT's
plain group version against the JAX package's functions; `IntraCodec`
against the reference SDK's golden samples on both encode and both decode
routes, and its device decode against the JAX host decoder
`intra_host.decode_sample_rgb`.

On the CPU the kernel wrappers run their plain versions; the card's
`dwt_forward_planes` is held against `plain_planes` in
tests/test_torch_kernels.py.  Inputs are made with numpy from a seed or
are the goldens; every comparison is exact (tolerance 0): the codec is
integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cineform_tpu.models import intra_host as jhost
from cineform_tpu.models.intra import IntraCodec as JaxIntraCodec
from cineform_tpu.ops import intra_transform as jops
from cineform_tpu_torch import testframes
from cineform_tpu_torch.models.intra import IntraCodec, sample_metadata
from cineform_tpu_torch.ops import dwt_forward as dwt
from cineform_tpu_torch.ops import intra_transform as tops
from tests.test_formats import _golden, _raw_fill

torch.set_num_threads(1)

CPU = torch.device("cpu")

#: input format, its 320x240 quality-4 encode golden and the frame that
#: golden encodes (pattern 1 of the test frames, the raw fill for RG64)
ENCODE_GOLDENS = [
    ("RG48", "rg48_320x240_q4_p1.cfhd",
     lambda w, h: testframes.rg48_frame(w, h, 1)),
    ("B64A", "b64a_320x240_q4_p1.cfhd",
     lambda w, h: testframes.b64a_frame(w, h, 1)),
    ("RG64", "raw_RG64.cfhd", lambda w, h: _raw_fill(w * h * 8, 1)),
]

#: a 320x240 quality-4 sample of each source, the input format whose
#: codec decodes it, and the reference decoder's RG48 and b64a outputs
DECODE_GOLDENS = [
    ("rgb444_320x240_q4", "RG48", "RG48", "rg48out"),
    ("rgb444_320x240_q4", "RG48", "b64a", "b64aout"),
    ("rgba4444_320x240_q4", "B64A", "b64a", "b64aout"),
    ("rgba4444_320x240_q4", "B64A", "RG48", "rg48out"),
]


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _frames(codec, raws) -> np.ndarray:
    return np.stack([np.frombuffer(r, np.uint8).reshape(
        codec.height, codec.row_bytes) for r in raws])


# ---------------------------------------------------------------------------
# Plain functions against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,nbytes", [("unpack_rg48", 6),
                                         ("unpack_b64a", 8),
                                         ("unpack_rg64", 8)])
def test_unpacks_match_jax(name, nbytes):
    """Random bytes, which reach every alpha companding branch (0, 4095 and
    between) and every bit of the 16-bit samples."""
    rng = np.random.default_rng(nbytes + len(name))
    frames = rng.integers(0, 256, (2, 8, nbytes * 24)).astype(np.uint8)
    frames[0, 0, :16] = 0                                   # alpha 0
    frames[0, 1, :16] = 255                                 # alpha 4095
    got = getattr(tops, name)(torch.from_numpy(frames))
    want = getattr(jops, name)(jnp.asarray(frames))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)


@pytest.mark.parametrize("half", [16, 24, 40, 120, 10])
@pytest.mark.parametrize("precision", [10, 12])
def test_h26_inverse_to_row16u_matches_jax(half, precision):
    """Random int16-range strips at widths whose scalar tail starts at
    half - half % 8 - 9 (16, 24, 40, 120) and below 16 (10)."""
    rng = np.random.default_rng(half * precision)
    low, high = (rng.integers(-32768, 32768, (2, 6, half)).astype(np.int32)
                 for _ in range(2))
    got = tops.h26_inverse_to_row16u(torch.from_numpy(low),
                                     torch.from_numpy(high), precision)
    _eq(got, jax.jit(jops.h26_inverse_to_row16u, static_argnums=2)(
        jnp.asarray(low), jnp.asarray(high), precision))


@pytest.mark.parametrize("prescale", [(0, 2, 0), (0, 2, 2)])
@pytest.mark.parametrize("w", [32, 48, 80, 240])
def test_inverse_channel_strips_matches_jax(prescale, w):
    """A 3-level pyramid of random int16-range coefficients (widths whose
    final half is 16, 24, 40 and 120), descaled as at 10 and 12 bits."""
    rng = np.random.default_rng(w + sum(prescale))
    h = 24

    def rand(shape):
        return rng.integers(-32768, 32768, shape).astype(np.int32)

    lowpass = rand((2, h >> 3, w >> 3))
    bands = [tuple(rand((2, h >> (k + 1), w >> (k + 1))) for _ in range(3))
             for k in range(3)]
    got = tops.inverse_channel_strips(
        torch.from_numpy(lowpass),
        [tuple(torch.from_numpy(b) for b in bs) for bs in bands], prescale)
    want = jax.jit(jops.inverse_channel_strips, static_argnums=2)(
        jnp.asarray(lowpass), [tuple(jnp.asarray(b) for b in bs)
                               for bs in bands], prescale)
    for g, ww in zip(got, want, strict=True):
        _eq(g, ww)


@pytest.mark.parametrize("planes", [3, 4])
@pytest.mark.parametrize("prescale", [0, 2])
def test_plain_planes_matches_jax(planes, prescale):
    """`plain_planes` of a group of G planes equals the JAX `dwt2d_forward`
    of each, laid out with zero pad columns (width 76: level width 38,
    pitch 40)."""
    rng = np.random.default_rng(planes + prescale)
    x = rng.integers(0, 4096, (2, planes, 20, 76)).astype(np.int32)
    quants = [(24, 24, 36), (6, 6, 3), (1, 1, 1), (255, 2, 12)][:planes]
    lows, highs = dwt.plain_planes(torch.from_numpy(x), prescale, quants)
    assert lows.shape == (2, planes, 10, 38)
    assert highs.shape == (2, planes, 3, 10, 40)
    assert not highs[..., 38:].any()
    for g in range(planes):
        ll, bands = jax.jit(jops.dwt2d_forward, static_argnums=(1, 2))(
            jnp.asarray(x[:, g]), prescale, quants[g])
        _eq(lows[:, g], ll)
        for b in range(3):
            _eq(highs[:, g, b, :, :38], bands[b])


@pytest.mark.parametrize("fmt", ["RG48", "B64A", "RG64"])
def test_forward_matches_jax(fmt):
    """`IntraCodec.forward` (the unpack, the 12-bit quantizers and
    prescales, three `dwt_forward_planes` levels) against the JAX
    `IntraCodec.forward`, on random frames."""
    w, h = 64, 48
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    frames = np.random.default_rng(len(fmt)).integers(
        0, 256, (2, h, codec.row_bytes)).astype(np.uint8)
    got = codec.forward(torch.from_numpy(frames))
    want = JaxIntraCodec(width=w, height=h, quality=4,
                         input_format=fmt).forward(jnp.asarray(frames))
    assert len(got) == len(want) == codec.num_channels
    for (gl, gb), (wl, wb) in zip(got, want):
        _eq(gl, wl)
        for k in range(3):
            for b in range(3):
                _eq(gb[k][b], wb[k][b])


# ---------------------------------------------------------------------------
# IntraCodec against the goldens and the JAX host decoder
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("name,fmt,output,ext", DECODE_GOLDENS)
def test_decode_matches_golden(name, fmt, output, ext):
    """Both decode routes give the reference decoder's RG48 and b64a bytes,
    the device route with no frame falling back to the host."""
    sample = _golden(f"{name}.cfhd")
    want = _golden(f"{name}.{ext}")
    codec = IntraCodec(320, 240, 4, device=CPU, input_format=fmt)
    host = codec.decode_batch([sample], output=output)
    nch = 3 if output == "RG48" else 4
    assert host.dtype == np.uint16 and host.shape == (1, 240, 320 * nch)
    assert host.tobytes() == want
    dev, fallback = codec.decode_batch_device([sample], output=output)
    assert fallback == () and dev.tobytes() == want


@pytest.mark.parametrize("fmt", ["RG48", "B64A"])
def test_device_decode_matches_jax_host_decoder(fmt):
    """A batch of 2 at 128x64 (test frames 1 and 2), encoded by the port,
    decoded on the device route to each output, equals the JAX package's
    host decoder, which the JAX device decode falls back to."""
    w, h = 128, 64
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    make = {"RG48": testframes.rg48_frame, "B64A": testframes.b64a_frame}[fmt]
    samples = codec.encode_batch_device(
        _frames(codec, [make(w, h, p) for p in (1, 2)]))
    for output in ("RG48", "b64a"):
        got, fallback = codec.decode_batch_device(samples, output=output)
        assert fallback == ()
        for i, s in enumerate(samples):
            assert got[i].tobytes() == jhost.decode_sample_rgb(s, output)[0]


def test_default_outputs_and_their_checks():
    """RG48 sources decode to RG48 and RGBA ones to b64a by default; an
    output the source does not have raises."""
    def codec(fmt):
        return IntraCodec(64, 48, 4, device=CPU, input_format=fmt)

    assert [codec(f).decode_output(None)
            for f in ("YUY2", "RG48", "B64A", "RG64")] == \
        ["YUY2", "RG48", "b64a", "b64a"]
    with pytest.raises(ValueError, match="decodes to"):
        codec("YUY2").decode_output("BYR4")
    with pytest.raises(ValueError, match="decodes to"):
        codec("RG48").decode_output("YUY2")


def test_codec_runs_on_the_card_by_default():
    assert IntraCodec(64, 48, 4).device == torch.device("cuda")
    assert IntraCodec(64, 48, 4, "cpu", "RG64").device == CPU


def test_rgb_frames_of_the_wrong_shape_raise():
    codec = IntraCodec(64, 48, 4, device=CPU, input_format="B64A")
    with pytest.raises(ValueError, match="B64A"):
        codec.encode_batch_device(np.zeros((1, 48, 64 * 6), np.uint8))

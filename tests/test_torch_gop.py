"""The port's two-frame GOP codec (`cineform_tpu_torch.models.gop`) and
stereo device route (`models.stereo`) on the CPU, against the JAX package.

The same frames, made from the repository's test patterns or from a numpy
seed, go through the JAX function and its counterpart in the port; every
comparison is exact.  The GOP forward is held against the JAX
`GopCodec.forward` (XLA on the CPU), the GROUP samples against the
reference encoder's goldens, and both decode routes against the host
oracle `gop_host.decode_group` and the reference decoder's goldens.
"""

import os

import jax
import numpy as np
import pytest
import torch

from cineform_tpu.bitstream import parse_sample as jparse_sample
from cineform_tpu.models import gop_host as jgop_host
from cineform_tpu.models import stereo as jstereo
from cineform_tpu.models.gop import GopCodec as JaxGopCodec
from cineform_tpu.ops import intra_transform as jops
from cineform_tpu.ref import gop as jref_gop
from cineform_tpu.ref import intra as jref
from cineform_tpu.utils.testframes import yuy2_frame
from cineform_tpu_torch.bitstream import fastwalk
from cineform_tpu_torch.models import stereo
from cineform_tpu_torch.models.gop import GopCodec
from cineform_tpu_torch.models.intra import IntraCodec, sample_metadata
from cineform_tpu_torch.ops import intra_transform as ops
from cineform_tpu_torch.ref import gop as tref_gop
from cineform_tpu_torch.spec import tags

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

CPU = torch.device("cpu")
SAMPLES = os.path.join(os.path.dirname(__file__), "golden", "samples")
#: the GOP goldens: name, the yuy2_frame patterns of frames 0 and 1
GOLDENS = [("gop_320x240_q4_p1", 1, 2), ("gop2_320x240_q4_p100", 100, 100)]


def _golden(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


def _pairs(w, h, patterns):
    """(B, H, 2W) uint8 frames 0 and 1 of the groups of `patterns`, each a
    (frame 0, frame 1) pair of yuy2_frame patterns."""
    def one(p):
        return np.frombuffer(yuy2_frame(w, h, p), np.uint8).reshape(h, 2 * w)
    return (np.stack([one(p0) for p0, _ in patterns]),
            np.stack([one(p1) for _, p1 in patterns]))


def _seeded(seed, *shape, lo=-1200, hi=4096):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int32)


def _groups(w, h, patterns, **kw):
    return [jgop_host.encode_group(yuy2_frame(w, h, p0), yuy2_frame(w, h, p1),
                                   w, h, 4, **kw) for p0, p1 in patterns]


def _host(codec, samples, frame=0, dither=0, output="YUY2"):
    """The host route's frames of `samples`: `host_coefficients`, then
    `output_frame` of each part, in the samples' order."""
    out = [None] * len(samples)
    for idx, coeffs in codec.host_coefficients(samples, output):
        for i, f in zip(idx, codec.output_frame(coeffs, output, frame,
                                                dither), strict=True):
            out[i] = f
    return np.stack(out)


def _assert_decodes(codec, samples, rc, base, want_fallback):
    """Both routes of `codec` on `samples` equal `decode_group`: frame f
    with dither window base + f, frame 1 the true second frame or, with
    `rc` (the reference decoder's GROUP decode), frame 0's reconstruction;
    the device route's fallback is `want_fallback`."""
    want = [jgop_host.decode_group(sample, reference_compatible=rc,
                                   dither_base=base) for sample in samples]
    for f in (0, 1):
        frame = 0 if rc else f
        host = _host(codec, samples, frame, base + f)
        dev, fallback, _ = codec.decode(samples, "YUY2", frame, base + f)
        assert fallback == want_fallback
        for i in range(len(samples)):
            assert host[i].tobytes() == want[i][f], ("host", i, f)
            assert dev[i].tobytes() == want[i][f], ("device", i, f)


# ---------------------------------------------------------------------------
# The transform pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [16, 8, 12, 24])
@pytest.mark.parametrize("prescale", [0, 2])
def test_forward_with_row0_prev_matches_jax(w, prescale):
    """`h26_forward` and `dwt2d_forward` with the narrow-row quirk's row-0
    carry equal the JAX functions; at widths <= 16 that are a multiple of 8
    the carry reaches row 0's first highpass value, elsewhere nothing."""
    x = _seeded(w + prescale, 2, 12, w)
    prev = _seeded(w + 7, 2, 2)
    got = ops.h26_forward(torch.from_numpy(x), prescale,
                          torch.from_numpy(prev))
    want = jops.h26_forward(x, prescale, prev)
    for g, v in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(v))
    got = ops.dwt2d_forward(torch.from_numpy(x), prescale, (6, 6, 3),
                            torch.from_numpy(prev))
    want = jops.dwt2d_forward(x, prescale, (6, 6, 3), prev)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, v in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(v))
    with_carry = ops.h26_forward(torch.from_numpy(x), prescale,
                                 torch.from_numpy(prev))[1]
    without = ops.h26_forward(torch.from_numpy(x), prescale)[1]
    assert torch.equal(with_carry[..., 1:, :], without[..., 1:, :])
    assert torch.equal(with_carry, without) == (w > 16 or w % 8 != 0)


@pytest.mark.parametrize("descale", [1, 2])
def test_dwt2d_inverse_bottom_shift_matches_jax(descale):
    ll, lh, hl, hh = (_seeded(s, 2, 15, 20, lo=-2000, hi=2000)
                      for s in range(4))
    for shift in (False, True):
        got = ops.dwt2d_inverse(*map(torch.from_numpy, (ll, lh, hl, hh)),
                                descale=descale, bottom_shift=shift)
        want = jops.dwt2d_inverse(ll, lh, hl, hh, descale=descale,
                                  bottom_shift=shift)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("group,width", [(16, 112), (8, 72), (16, 96)])
def test_output_scalar_tail_matches_the_oracle(group, width):
    """The 8-bit output with the reference's scalar tail equals the NumPy
    oracle's, the lane wrap of the SSE columns included (sums below -2048,
    saturating highs)."""
    half = width // 2
    low = _seeded(group, 8, half, lo=-6000, hi=9000)
    high = _seeded(group + 1, 8, half, lo=-9000, hi=9000)
    rows = jref.decode_dither_rows(8, 1)
    tail = group if width % (2 * group) == group else 0
    got = ops.h26_inverse_to_output(
        torch.from_numpy(low), torch.from_numpy(high), 2,
        ops.expand_dither_rows(torch.from_numpy(rows), width, group),
        scalar_tail=tail)
    want = jref.h26_inverse_to_output(
        low, high, 2, jref.decode_dither_plane(rows, width, group),
        scalar_tail=tail)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("channel", [0, 1, 2])
def test_frame_wavelet_inverse_matches_the_oracle(channel):
    ll = _seeded(channel, 12, 16, lo=0, hi=2000)
    lh, hl, hh = (_seeded(channel + s, 12, 16, lo=-300, hi=300)
                  for s in (1, 2, 3))
    draws = tref_gop.interlaced_dither_rows(24, 1)
    got = ops.frame_wavelet_inverse(
        *map(torch.from_numpy, (ll, lh, hl, hh)), torch.from_numpy(draws),
        channel)
    want = jref_gop.frame_wavelet_inverse(ll, lh, hl, hh, to8bit=True,
                                          dither=draws, channel=channel)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# GopCodec: the forward, the encode and both decode routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,h", [(320, 240), (64, 48), (96, 48)])
def test_forward_matches_jax(w, h):
    """The port's forward (5 DWT launches on a card, their plain versions
    here) equals the JAX `GopCodec.forward` on two groups; at 64x48
    chroma's temporal high is 16 wide and takes the row-0 carry."""
    f0, f1 = _pairs(w, h, [(1, 2), (3, 0)])
    want = JaxGopCodec(w, h, 4).forward(f0, f1)
    got = GopCodec(w, h, 4, device=CPU).forward(torch.from_numpy(f0),
                                                torch.from_numpy(f1))
    for (glp, gb), (wlp, wb) in zip(got, want, strict=True):
        np.testing.assert_array_equal(glp.numpy(), np.asarray(wlp))
        assert sorted(gb) == sorted(wb) == [0, 1, 3, 4, 5]
        for k in wb:
            for g, v in zip(gb[k], wb[k], strict=True):
                np.testing.assert_array_equal(g.numpy(), np.asarray(v))


@pytest.mark.parametrize("name,p0,p1", GOLDENS)
def test_encode_batch_matches_golden(name, p0, p1):
    gold = _golden(name + ".cfhd.f1")
    f0, f1 = _pairs(320, 240, [(p0, p1)])
    got = GopCodec(320, 240, 4, device=CPU).encode_batch(
        f0, f1, 1, sample_metadata(gold))
    assert got == [gold]


@pytest.mark.parametrize("name", [g[0] for g in GOLDENS])
def test_decode_routes_match_golden(name):
    """Both routes reproduce the reference decoder's two frames, and the
    device route decodes the group on the device: the JAX function sends
    it to the host for its raw 16-bit subband 7."""
    gold = _golden(name + ".cfhd.f1")
    codec = GopCodec(320, 240, 4, device=CPU)
    want = [_golden(f"{name}.f{f}.yuy2") for f in (0, 1)]
    host = [_host(codec, [gold], 0, f)[0].tobytes() for f in (0, 1)]
    dev = [codec.decode([gold], "YUY2", 0, f) for f in (0, 1)]
    assert [fallback for _, fallback, _ in dev] == [(), ()]
    assert host == want
    assert [out[0].tobytes() for out, _, _ in dev] == want
    assert JaxGopCodec(320, 240, 4)._decode_rows_args([gold])[-1] == {0}
    _assert_decodes(codec, [gold], False, 3, ())


@pytest.mark.parametrize("rc", [True, False])
def test_decode_mixed_groups_match_decode_group(rc):
    """Two groups of different frames in one batch, both reference
    modes, two dither windows."""
    samples = _groups(320, 240, [(1, 2), (3, 0)])
    codec = GopCodec(320, 240, 4, device=CPU)
    for base in (0, 5):
        _assert_decodes(codec, samples, rc, base, ())


def test_narrow_and_odd_width_groups_encode_and_decode():
    """At 64x48 (the row-0 carry) and 144x48 (chroma lowpass 9 wide, the
    output's scalar tail on luma and chroma) the port's samples equal the
    host encoder's and both routes equal `decode_group`."""
    for w, h in ((64, 48), (144, 48)):
        f0, f1 = _pairs(w, h, [(1, 2), (5, 6)])
        codec = GopCodec(w, h, 4, device=CPU)
        samples = codec.encode_batch(f0, f1, 7)
        assert samples == [jgop_host.encode_group(
            a.tobytes(), b.tobytes(), w, h, 4, 7 + i)
            for i, (a, b) in enumerate(zip(f0, f1))]
        _assert_decodes(codec, samples, True, 0, ())
        _assert_decodes(codec, samples, False, 1, ())


def _with_peaks() -> bytes:
    """A progressive group whose w0 and w1 HL bands carry peaks tables: an
    interlaced group (codeset 18 with peaks) whose PROTECTION_FLAGS tag,
    optional and of the same size, is swapped for SAMPLE_FLAGS
    progressive, so that the sample's chunk sizes hold."""
    il = _groups(96, 48, [(3, 4)], progressive=False)[0]
    old = (-tags.PROTECTION_FLAGS & 0xFFFF).to_bytes(2, "big") + b"\0\0"
    new = tags.SAMPLE_FLAGS.to_bytes(2, "big") + \
        tags.SAMPLE_FLAGS_PROGRESSIVE.to_bytes(2, "big")
    assert il.count(old) == 1
    return il.replace(old, new)


def test_peaks_and_interlaced_groups_take_the_host_route():
    """A group with a peaks band and an interlaced group: the host route
    equals `decode_group` (the peaks substituted; the HORZTEMP frame
    inverse with its pair dither), and the device route lists them in its
    fallback, between groups it decodes itself."""
    peaks = _with_peaks()
    assert any(b.peaks is not None for c in
               jparse_sample(peaks).channels for b in c.bands)
    assert jparse_sample(peaks).progressive
    ilace = _groups(96, 48, [(7, 8)], progressive=False)[0]
    plain = _groups(96, 48, [(1, 2)])[0]
    codec = GopCodec(96, 48, 4, device=CPU)
    for rc in (True, False):
        _assert_decodes(codec, [plain, peaks, ilace, plain], rc, 1, (1, 2))


def test_interlaced_golden_decodes_byte_exact():
    gold = _golden("ilace_320x240_q4_p1.cfhd.f1")
    codec = GopCodec(320, 240, 4, device=CPU)
    for f in (0, 1):
        assert _host(codec, [gold], 0, f)[0].tobytes() == \
            _golden(f"ilace_320x240_q4_p1.f{f}.yuy2")


def test_decode_rejects_a_sample_of_another_size():
    gold = _golden("gop_320x240_q4_p1.cfhd.f1")
    codec = GopCodec(64, 48, 4, device=CPU)
    with pytest.raises(ValueError):
        codec.host_coefficients([gold])
    with pytest.raises(ValueError):
        codec.decode([gold])


# ---------------------------------------------------------------------------
# Stereo 3D: the device route on the port's IntraCodec
# ---------------------------------------------------------------------------

def test_stereo_device_route_matches_jax():
    """`s3d_320x240_q4_p1`: the 320x240 quality-4 stereo sample of
    yuy2_frame patterns 1 (left) and 2 (right).  The port writes the JAX
    encoder's bytes, and decodes both eyes on the device equal to the JAX
    `decode_sample_3d`; the walker takes a split eye but sends a whole
    dual-channel sample to the parser."""
    w, h = 320, 240
    want = jstereo.encode_sample_3d(yuy2_frame(w, h, 1), yuy2_frame(w, h, 2),
                                    w, h, 4)
    codec = IntraCodec(w, h, 4, device=CPU)
    left, right = _pairs(w, h, [(1, 2)])
    assert stereo.encode_batch_3d(codec, left, right) == [want]
    assert stereo.split_3d(want) == jstereo.split_3d(want)
    assert fastwalk.walk(want) is None
    for eye in (0, 1):
        assert fastwalk.walk(stereo.split_3d(want)[eye]) is not None
        out, fallback = stereo.decode_batch_device_3d([want, want], eye,
                                                      codec)
        assert fallback == ()
        ref = jstereo.decode_sample_3d(want, eye)
        assert out[0].tobytes() == ref and out[1].tobytes() == ref
    with pytest.raises(ValueError):                 # a one-eye sample
        stereo.decode_batch_device_3d(codec.encode_batch(left), 1, codec)

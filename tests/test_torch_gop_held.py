"""A group's FRAME sample served from the coefficients the GROUP sample's
decode left on the device (`api.Decoder`'s held group), on the CPU.

Frame 1 from the held coefficients equals a fresh `GopCodec.decode` of
the group, the JAX package's deep decode (`gop_host.decode_group_to`) and,
for V210 and YU64, the benchmark's plain GOP reference
(`cfbench/reference/gop.py`), byte for byte; the tracer counts one group
decode for the two frames.  The held coefficients are replaced by another
group's, dropped by a new `prepare_to_decode` and `close`, and left
unchanged by the inverse of frame 0.  A host-route group, the YUY2 and
UYVY outputs and a decode to another size hold theirs too.

The pairs are the GOP cell's own content (`content/plasma_pan_pairs.py`)
at small progressive sizes; every comparison is exact."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cfbench import plugins  # noqa: E402
from cineform_tpu.models import gop_host as jgop_host  # noqa: E402
from cineform_tpu_torch import api  # noqa: E402
from cineform_tpu_torch.models import gop_host  # noqa: E402
from cineform_tpu_torch.models.gop import GopCodec  # noqa: E402
from cineform_tpu_torch.utils import timing  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
SEED = 2**31 + 24
SIZES = ((96, 48), (192, 64))
#: the api's deep and RGB outputs here, by the codec's fourcc names
FOURCC = {"V210": "v210", "YU64": "YU64", "RG48": "RG48", "BGRA": "BGRA"}
#: a device-route group decode's band rows (`entropy.band_rows`; none of
#: them by the kernels on the CPU)
GROUP_ROWS = sum(len(planes) * len(GopCodec._LEVEL_ENTRIES[lvl])
                 for lvl, planes in GopCodec._DECODE_CLASSES)
#: the outputs the plain GOP reference decodes
REFERENCE = ("V210", "YU64")
SAMPLES = os.path.join(os.path.dirname(__file__), "golden", "samples")


@pytest.fixture
def tracer():
    """The tracer, on with an empty ring; off and empty afterwards."""
    timing.enable()
    timing.reset()
    try:
        yield timing
    finally:
        timing.disable()
        timing.reset()


def _cfg(w, h, groups=2) -> dict:
    cfg = plugins.read_json(ROOT, "configs", "yuy2_1080_gop")
    return dict(cfg, width=w, height=h, frames=2 * groups)


def _groups(cfg):
    """(pairs (G, 2, H, 2W), GROUP samples, FRAME samples) of the cell's
    content, numbered as `api.Encoder` numbers them."""
    w, h = cfg["width"], cfg["height"]
    pairs = plugins.find(ROOT, "content", cfg["content"]).make(cfg, SEED)
    numbers = [2 * g + 1 for g in range(len(pairs))]
    groups = api.gop_codec(w, h, cfg["quality"], CPU).encode_batch(
        pairs[:, 0], pairs[:, 1], frame_numbers=numbers)
    frames = [gop_host.frame_header_sample(w, h, n) for n in numbers]
    return pairs, groups, frames


def _decoder(w, h, output) -> api.Decoder:
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(w, h, api.PixelFormat[output])
    return dec


def _fresh(group: bytes, w, h, output, frame) -> bytes:
    """Frame `frame` of the group by a fresh device-route decode."""
    codec = api.gop_codec(w, h, api.DECODE_QUALITY, CPU)
    out, fallback, _ = codec.decode([group], FOURCC[output], frame)
    assert fallback == ()
    return out[0].tobytes()


def _totals(snap) -> dict:
    out: dict = {}
    for c in snap.counts:
        out[c.name] = out.get(c.name, 0) + c.n
    return out


@pytest.mark.parametrize("output", tuple(FOURCC))
@pytest.mark.parametrize("w,h", SIZES)
def test_frame_sample_reuses_the_groups_coefficients(tracer, w, h, output):
    """GROUP then FRAME sample through one decoder: frame 1 from the held
    coefficients equals the fresh decode, the JAX deep decode and the
    plain reference; one group decode for the two frames out."""
    cfg = _cfg(w, h, groups=1)
    pairs, (group,), (frame,) = _groups(cfg)
    dec = _decoder(w, h, output)
    got0 = dec.decode_sample(group).tobytes()
    got1 = dec.decode_sample(frame).tobytes()
    assert _totals(tracer.snapshot()) == {
        "gop.group_decodes": 1, "gop.fallback_groups": 0,
        "gop.frames_out": 2, "gop.held_frames": 1,
        "entropy.band_rows": GROUP_ROWS, "entropy.band_rows_kernel": 0}
    for k, got in enumerate((got0, got1)):
        assert got == _fresh(group, w, h, output, k), k
        assert got == jgop_host.decode_group_to(group, FOURCC[output], k), k
        if output in REFERENCE:
            ref = plugins.find(ROOT, "reference/formats", "YUY2_GOP")
            assert got == ref.decode_output(cfg, pairs[0], output,
                                            frame=k).tobytes(), k
    assert dec.fallback_frames == 0


@pytest.mark.parametrize("output", ("V210", "RG48"))
def test_another_group_replaces_the_held_one(tracer, output):
    """GROUP A, GROUP B, FRAME: the FRAME sample gives frame 1 of B."""
    w, h = SIZES[0]
    _, groups, frames = _groups(_cfg(w, h))
    dec = _decoder(w, h, output)
    dec.decode_sample(groups[0])
    dec.decode_sample(groups[1])
    got = dec.decode_sample(frames[1]).tobytes()
    totals = _totals(tracer.snapshot())
    assert (totals["gop.group_decodes"], totals["gop.held_frames"]) == (2, 1)
    assert got == _fresh(groups[1], w, h, output, 1)
    assert got != _fresh(groups[0], w, h, output, 1)


@pytest.mark.parametrize("output", ("V210", "BGRA"))
def test_two_frame_samples_give_frame_1_twice(tracer, output):
    """GROUP A, FRAME, FRAME: frame 1 of A twice, byte-equal, from one
    group decode."""
    w, h = SIZES[0]
    _, groups, frames = _groups(_cfg(w, h))
    dec = _decoder(w, h, output)
    dec.decode_sample(groups[0])
    first = dec.decode_sample(frames[0]).tobytes()
    second = dec.decode_sample(frames[0]).tobytes()
    totals = _totals(tracer.snapshot())
    assert (totals["gop.group_decodes"], totals["gop.held_frames"]) == (1, 2)
    assert first == second == _fresh(groups[0], w, h, output, 1)


@pytest.mark.parametrize("output", ("V210", "YU64"))
def test_repeated_group_calls_give_frame_0(tracer, output):
    """GROUP A, GROUP A, FRAME: frame 0 from each GROUP call, then frame
    1 from the coefficients of the second."""
    w, h = SIZES[0]
    _, groups, frames = _groups(_cfg(w, h))
    dec = _decoder(w, h, output)
    outs = [dec.decode_sample(s).tobytes()
            for s in (groups[0], groups[0], frames[0])]
    totals = _totals(tracer.snapshot())
    assert (totals["gop.group_decodes"], totals["gop.held_frames"]) == (2, 1)
    assert outs[0] == outs[1] == _fresh(groups[0], w, h, output, 0)
    assert outs[2] == _fresh(groups[0], w, h, output, 1)


def test_host_route_group_holds_nothing(tracer):
    """The interlaced group, whose bands carry peaks, goes to the host
    route: the decoder holds that route's coefficients, and its FRAME
    sample makes frame 1 from them, to the bytes of that route; both
    frames count as fallback frames."""
    with open(os.path.join(SAMPLES, "ilace_320x240_q4_p1.cfhd.f1"),
              "rb") as f:
        group = f.read()
    dec = _decoder(320, 240, "YU64")
    dec.decode_sample(group)
    got = dec.decode_sample(gop_host.frame_header_sample(320, 240, 1))
    assert _totals(tracer.snapshot()) == {
        "gop.group_decodes": 1, "gop.fallback_groups": 1,
        "gop.frames_out": 2, "gop.held_frames": 1}
    assert dec.fallback_frames == 2
    codec = api.gop_codec(320, 240, api.DECODE_QUALITY, CPU)
    want, fallback, _ = codec.decode([group], "YU64", 1)
    assert fallback == (0,)
    assert got.tobytes() == want[0].tobytes()


@pytest.mark.parametrize("first,then,close", (("V210", "YU64", False),
                                              ("YU64", "RG48", False),
                                              ("RG48", "BGRA", False),
                                              ("V210", "V210", True)))
def test_prepare_between_group_and_frame(tracer, first, then, close):
    """GROUP to one output, (`close`,) `prepare_to_decode` to another, then
    FRAME: the fresh decode's frame 1 in the new output."""
    w, h = SIZES[1]
    _, groups, frames = _groups(_cfg(w, h))
    dec = _decoder(w, h, first)
    dec.decode_sample(groups[0])
    if close:
        dec.close()
    dec.prepare_to_decode(w, h, api.PixelFormat[then])
    got = dec.decode_sample(frames[0]).tobytes()
    assert "gop.held_frames" not in _totals(tracer.snapshot())
    assert got == _fresh(groups[0], w, h, then, 1)


def test_frame_sample_on_a_fresh_decoder_raises():
    """A FRAME sample with no decoded group: BADSAMPLE."""
    dec = _decoder(*SIZES[0], "V210")
    with pytest.raises(api.CFHDError) as err:
        dec.decode_sample(gop_host.frame_header_sample(*SIZES[0], 1))
    assert err.value.code == api.ErrorCode.BADSAMPLE


@pytest.fixture
def jax_host(monkeypatch):
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")


@pytest.mark.parametrize("output,size", (("YUY2", SIZES[0]),
                                         ("UYVY", SIZES[0]),
                                         ("YUY2", (80, 40))))
def test_yuy2_route_decodes_its_group_again(tracer, jax_host, output, size):
    """The YUY2 and UYVY outputs, each frame with its dither window, and a
    decode to another size: each FRAME sample's frame comes from its
    group's held coefficients, one group decode for two frames, and the
    bytes equal the JAX API's."""
    from cineform_tpu import api as japi

    w, h = SIZES[0]
    _, groups, frames = _groups(_cfg(w, h))
    samples = [groups[0], frames[0], groups[1], frames[1]]
    got = []
    for mod, kw in ((api, {"device": "cpu"}), (japi, {})):
        dec = mod.Decoder(**kw)
        dec.prepare_to_decode(*size, mod.PixelFormat[output])
        got.append([dec.decode_sample(s).tobytes() for s in samples])
        if mod is api:
            assert _totals(tracer.snapshot()) == {
                "gop.group_decodes": 2, "gop.fallback_groups": 0,
                "gop.frames_out": 4, "gop.held_frames": 2,
                "entropy.band_rows": 2 * GROUP_ROWS,
                "entropy.band_rows_kernel": 0}
    assert got[0] == got[1]


@pytest.mark.parametrize("output", tuple(FOURCC.values()))
def test_inverse_leaves_the_coefficients_unchanged(output):
    """`decode`'s coefficients after its frame-0 inverse equal a copy
    taken before it, and give frame 1 as a fresh decode."""
    w, h = SIZES[1]
    _, groups, _ = _groups(_cfg(w, h))
    codec = api.gop_codec(w, h, api.DECODE_QUALITY, CPU)
    out, fallback, coeffs = codec.decode(groups[:1], output)
    assert fallback == () and coeffs is not None
    before = [(lp.clone(), {k: [b.clone() for b in bs]
                            for k, bs in bands.items()})
              for lp, bands in coeffs.channels]
    codec.output_frame(coeffs, output, 0)
    for (lp, bands), (lp0, bands0) in zip(coeffs.channels, before,
                                          strict=True):
        assert torch.equal(lp, lp0)
        for k, bs in bands.items():
            assert all(torch.equal(b, b0)
                       for b, b0 in zip(bs, bands0[k], strict=True))
    frame1 = codec.output_frame(coeffs, output, 1)
    want, _, _ = codec.decode(groups[:1], output, 1)
    assert np.array_equal(frame1, want)
    assert out.tobytes() == codec.decode(groups[:1], output,
                                         0)[0].tobytes()

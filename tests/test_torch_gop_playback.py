"""A 2-frame-GOP clip played through the port's `api.Decoder` on the CPU,
against the benchmark's plain GOP reference (`cfbench/reference/gop.py`,
loaded by path from the repo's `cfbench/`): GROUP then FRAME sample to
V210, YU64 and YUY2, both frames of each group byte-equal to the reference's
decode of the pair; the reference held against the JAX `GopCodec` on the
same pairs; the GOP cell's playback loop (`drivers/api_gop_decoder.py`)
and its check on a two-group stream.

The pairs are the cell's own content (`content/plasma_pan_pairs.py`) at
small progressive sizes; every comparison is exact."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cfbench import check, plugins  # noqa: E402
from cfbench.drive import Record  # noqa: E402
from cineform_tpu_torch import api  # noqa: E402

torch.set_num_threads(1)

CELL = {"name": "yuy2_1080_gop.playback_v210", "config": "yuy2_1080_gop",
        "traffic": "playback_v210", "chips": 1}
SEED = 2**31 + 23
SIZES = ((96, 48), (192, 64))
QUALITIES = (4, 2)


def _cfg(w, h, quality=4, groups=2) -> dict:
    cfg = plugins.read_json(ROOT, "configs", "yuy2_1080_gop")
    return dict(cfg, width=w, height=h, quality=quality, frames=2 * groups)


def _pairs(cfg, seed=SEED) -> np.ndarray:
    return plugins.find(ROOT, "content", cfg["content"]).make(cfg, seed)


def _reference():
    return plugins.find(ROOT, "reference/formats", "YUY2_GOP")


def _stream(cfg, pairs) -> list[bytes]:
    """The pairs through `api.Encoder` under `YUV_2FRAME_GOP`, in frame
    order, then one frame more: the sequence header, then each group's
    GROUP sample and its FRAME sample."""
    enc = api.Encoder("cpu")
    enc.prepare_to_encode(cfg["width"], cfg["height"], api.PixelFormat.YUY2,
                          encoding_flags=api.EncodingFlags.YUV_2FRAME_GOP,
                          quality=api.EncodingQuality(cfg["quality"]))
    out = []
    for frame in [*pairs.reshape(-1, *pairs.shape[2:]), pairs[0, 0]]:
        enc.encode_sample(frame)
        out.append(enc.get_sample_data())
    return out[1:]


@pytest.mark.parametrize("output", ("V210", "YU64", "YUY2"))
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("w,h", SIZES)
def test_playback_equals_the_reference(w, h, quality, output):
    """GROUP then FRAME sample of each of two groups through one decoder:
    frame 0, then the group's true second frame, each byte-equal to the
    reference's decode of its pair (YUY2 with the dither of the decoder's
    k-th emitted frame); no group leaves the device route."""
    cfg = _cfg(w, h, quality)
    pairs = _pairs(cfg)
    samples = _stream(cfg, pairs)
    assert [s[:4] for s in samples] == [b"\x00\x01\x00\x02",
                                        b"\x00\x01\x00\x01"] * 2
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(w, h, api.PixelFormat[output])
    ref = _reference()
    for k, sample in enumerate(samples):
        got = dec.decode_sample(sample)
        want = ref.decode_output(cfg, pairs[k // 2], output, frame=k % 2,
                                 window=k)
        assert got.shape == want.shape
        assert np.array_equal(got, want), (k, int((got != want).sum()))
    assert dec.fallback_frames == 0


@pytest.mark.parametrize("output,fourcc", (("V210", "v210"),
                                           ("YU64", "YU64")))
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("w,h", SIZES)
def test_reference_equals_the_jax_gop_codec(w, h, quality, output, fourcc):
    """The reference's forward equals the JAX `GopCodec.forward` on the
    same pairs, band for band, and its decode of each frame equals the
    JAX package's deep decode (`gop_host.decode_group_to`) of the JAX
    codec's GROUP sample."""
    from cfbench.reference import gop as rgop
    from cineform_tpu.models import gop_host as jgop_host
    from cineform_tpu.models.gop import GopCodec as JaxGopCodec

    cfg = _cfg(w, h, quality)
    pairs = _pairs(cfg)
    jax_codec = JaxGopCodec(w, h, quality)
    coeffs = jax_codec.forward(pairs[:, 0], pairs[:, 1])
    ref = _reference()
    for g, pair in enumerate(pairs):
        planes = [ref.planes(cfg, f) for f in pair]
        for ch, (jlp, jbands) in enumerate(coeffs):
            lowpass, bands = rgop.forward(planes[0][ch], planes[1][ch],
                                          rgop.band_quant(quality, ch))
            np.testing.assert_array_equal(lowpass, np.asarray(jlp[g]))
            assert sorted(bands) == sorted(jbands)
            for k, bs in bands.items():
                for b, jb in zip(bs, jbands[k], strict=True):
                    np.testing.assert_array_equal(b, np.asarray(jb[g]))
    samples = jax_codec.encode_batch(pairs[:, 0], pairs[:, 1],
                                     frame_numbers=[1, 3])
    for g, sample in enumerate(samples):
        for frame in (0, 1):
            want = jgop_host.decode_group_to(sample, fourcc, frame)
            got = ref.decode_output(cfg, pairs[g], output, frame=frame)
            assert got.tobytes() == want, (g, frame)


@pytest.mark.parametrize("height,window", ((48, 0), (48, 5), (64, 3)))
def test_reference_dither_equals_the_glibc_model(height, window):
    """The GOP reference's YUY2 dither on plain ints equals the intra
    reference's, from `glibc_random.glibc_rand_sequence`."""
    from cfbench.reference import gop as rgop
    from cfbench.reference import transform

    assert np.array_equal(rgop.dither_rows(height, window),
                          transform.decode_dither_rows(height, window))


def _parts(cfg) -> plugins.Parts:
    mix = plugins.read_json(ROOT, "traffic", CELL["traffic"])
    return plugins.Parts(cfg, mix, plugins.find(ROOT, "content",
                                                cfg["content"]),
                         plugins.find(ROOT, "drivers", mix["entry"]),
                         _reference())


def test_playback_expected_passes_the_port_and_fails_the_control():
    """A two-group stream from the playback's own set-up, played GROUP
    then FRAME through `api.Decoder` as its clients play it: the check of
    its outputs against the playback's `expected` reads 0 on both
    numbers, and the control's answers (the reference's lowpass in
    float16) differ."""
    cfg = _cfg(96, 48)
    parts = _parts(cfg)
    pairs = parts.frames(SEED)
    logged = []
    inputs = parts.driver.prepare(cfg, parts.mix, pairs, torch.device("cpu"),
                                  logged.append)
    assert len(inputs) == 2 and all(len(f) == 24 for _, f in inputs)
    assert "peak table [] (0)" in logged[0] and "host [] (0)" in logged[0]
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(96, 48, api.PixelFormat[parts.mix["output"]])
    records = [Record(0, k, k // 2, 0.1 * k, 0.1 * k + 0.05, True,
                      dec.decode_sample(inputs[k // 2][k % 2]))
               for k in range(4)]
    numbers, checked = check.compare(parts, pairs, records, 0.0, 1.0, SEED,
                                     slots=2)
    assert numbers == {"failed_calls": 0, "differing_bytes": 0}
    assert {r.k % 2 for r in checked} == {0, 1}
    lossy = [Record(r.client, r.k, r.item, r.start, r.end, True,
                    parts.answer(pairs, r, lossy=True)) for r in records]
    numbers, _ = check.compare(parts, pairs, lossy, 0.0, 1.0, SEED, slots=2)
    assert numbers["differing_bytes"] > 0


def test_load_plays_groups_in_order_and_keeps_both_frames():
    """Request k plays group k // 2 (cycling from the stream's offset),
    frame k % 2; the kept requests alternate frames from block to
    block."""
    cfg = _cfg(96, 48, groups=3)
    parts = _parts(cfg)
    load = parts.driver.Load(cfg, parts.mix, np.zeros((3, 2, 1, 1)),
                             None, torch.device("cpu"), SEED)
    assert load.slots == 2
    assert [load.item(0, k) for k in range(8)] == [0, 0, 1, 1, 2, 2, 0, 0]
    every = parts.mix["keep_every"]
    kept = [k for k in range(64 * every) if load.kept(0, k)]
    assert len(kept) == 64
    assert [k % 2 for k in kept] == [b % 2 for b in range(64)]
    assert [k // every for k in kept] == list(range(64))


def test_content_pans_and_repeats_by_seed():
    """Frame 1 of each group is frame 0 moved 4 rows, up to their noise;
    a seed repeats its frames and another seed changes only the noise."""
    cfg = _cfg(96, 48, groups=4)
    a = _pairs(cfg)
    assert a.shape == (4, 2, 48, 192) and a.dtype == np.uint8
    assert np.array_equal(a, _pairs(cfg))
    clean = _pairs(dict(cfg, noise_bits=0))
    assert np.array_equal(clean, _pairs(dict(cfg, noise_bits=0), SEED + 1))
    assert not np.array_equal(a, _pairs(cfg, SEED + 1))
    assert np.all((a.astype(int) - clean) % 256 < 8)
    for g in range(4):
        assert np.array_equal(clean[g, 1], np.roll(clean[g, 0], 4, axis=0))
        assert np.array_equal(clean[g, 0], np.roll(clean[0, 0], g * 12,
                                                   axis=0))

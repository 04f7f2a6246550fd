"""The port's YUY2 intra codec (cineform_tpu_torch.models.intra) on the CPU:
the whole slice against the reference SDK's golden samples, the host
oracle (cineform_tpu.models.intra_host) and the JAX package's decode.

The JAX device encode (`forward_packed`, `encode_batch_device`) is never
called here: its CPU compiles take minutes.  Every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cineform_tpu.entropy import device as jdev
from cineform_tpu.models import intra_host
from cineform_tpu.models.intra import IntraCodec as JaxIntraCodec
from cineform_tpu.models.intra import _dither_rows as jax_dither_rows
from cineform_tpu.spec.production import IntraParams
from cineform_tpu.utils.testframes import yuy2_frame
from cineform_tpu_torch.models.intra import IntraCodec, sample_metadata
from cineform_tpu_torch.state import codec_tables
from tests.test_intra_host import _golden, _metadata_from

torch.set_num_threads(1)

CPU = torch.device("cpu")

#: goldens small enough for the CPU; 64x48 and 112x48 reach the width <= 16
#: row-filter quirk at the deep levels, 112x48 an odd chroma lowpass width
GOLDENS = [
    ("s_320x240_q4_p1", 320, 240, 4, 1),
    ("s_64x48_q4_p1", 64, 48, 4, 1),
    ("s_112x48_q4_p1", 112, 48, 4, 1),
]


def _frames(w, h, patterns) -> np.ndarray:
    return np.stack([np.frombuffer(yuy2_frame(w, h, p), np.uint8)
                     .reshape(h, 2 * w) for p in patterns])


@pytest.mark.parametrize("name,w,h,q,p", GOLDENS)
def test_encode_batch_device_matches_golden(name, w, h, q, p):
    gold = _golden(name, "cfhd")
    codec = IntraCodec(w, h, q, device=CPU)
    got = codec.encode_batch_device(_frames(w, h, [p]), 1,
                                    _metadata_from(gold))
    assert got[0] == gold


@pytest.mark.parametrize("name", [g[0] for g in GOLDENS]
                         + ["s_1920x1080_q6_p1"])
def test_sample_metadata_matches_the_golden_reader(name):
    gold = _golden(name, "cfhd")
    got, want = sample_metadata(gold), _metadata_from(gold)
    assert got.block() == want.block()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name,w,h,q,p", GOLDENS)
def test_encode_batch_host_entropy_matches_golden(name, w, h, q, p):
    gold = _golden(name, "cfhd")
    codec = IntraCodec(w, h, q, device=CPU)
    assert codec.encode_batch(_frames(w, h, [p]), 1,
                              _metadata_from(gold))[0] == gold


def test_batch_encode_matches_host():
    """A batch advances UFRM and timecode per frame, as the host encoder
    does per sample."""
    w, h, q = 160, 120, 4
    patterns = (0, 1, 2)
    samples = IntraCodec(w, h, q, device=CPU).encode_batch_device(
        _frames(w, h, patterns))
    for i, p in enumerate(patterns):
        want = intra_host.encode_sample(
            yuy2_frame(w, h, p), w, h, q, frame_number=1 + i,
            metadata=intra_host.EncoderMetadata().advanced(i))
        assert samples[i] == want


def test_forced_overflow_falls_back_byte_exact():
    """cap_bits=2 overflows the device bands of noise; the host re-encode
    keeps the sample equal to the host encoder's."""
    w, h = 320, 240
    noisy = np.random.default_rng(0).integers(0, 256, (1, h, 2 * w),
                                              dtype=np.uint8)
    codec = IntraCodec(w, h, 4, device=CPU)
    packed = codec.forward_packed(torch.from_numpy(noisy), cap_bits=2)
    assert any(bool(o.any()) for _, levels in packed
               for _, _, o, _ in levels)
    got = codec.encode_batch_device(noisy, 7, cap_bits=2)
    want = intra_host.encode_sample(
        noisy[0].tobytes(), w, h, 4, frame_number=7,
        metadata=intra_host.EncoderMetadata().advanced(6))
    assert got[0] == want


@pytest.mark.parametrize("name,w,h,q,p", GOLDENS)
def test_decode_batch_matches_golden(name, w, h, q, p):
    out = IntraCodec(w, h, q, device=CPU).decode_batch([_golden(name, "cfhd")])
    assert out.dtype == np.uint8 and out.shape == (1, h, 2 * w)
    assert out.tobytes() == _golden(name, "yuy2")


def test_decode_batch_matches_jax():
    w, h, q = 320, 240, 4
    samples = [intra_host.encode_sample(yuy2_frame(w, h, p), w, h, q)
               for p in (1, 2)]
    want = JaxIntraCodec(width=w, height=h, quality=q).decode_batch(samples)
    got = IntraCodec(w, h, q, device=CPU).decode_batch(samples)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frame_index", [0, 1, 3])
def test_decode_multiframe_dither_matches_host(frame_index):
    w, h = 64, 48
    samples = [intra_host.encode_sample(yuy2_frame(w, h, p), w, h, 4)
               for p in (1, 2)]
    got = IntraCodec(w, h, 4, device=CPU).decode_batch(samples, frame_index)
    for i, s in enumerate(samples):
        want, _ = intra_host.decode_sample(s, frame_index=frame_index)
        assert got[i].tobytes() == want


def test_roundtrip_psnr():
    w, h = 320, 240
    frames = _frames(w, h, [1])
    codec = IntraCodec(w, h, 4, device=CPU)
    out = codec.decode_batch(codec.encode_batch_device(frames))
    mse = np.mean((out.astype(np.float64) - frames) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) > 40.0


@pytest.mark.parametrize("w,h,q,frame_index", [(320, 240, 4, 0),
                                               (1920, 1080, 6, 2)])
def test_codec_tables_match_jax(w, h, q, frame_index):
    t = codec_tables(w, h, q, frame_index, device=CPU)
    p = IntraParams(width=w, height=h, quality=q)
    assert t.prescale == tuple(p.prescale)
    assert t.band_quant == tuple(tuple(tuple(b) for b in p.band_quant(ch))
                                 for ch in range(3))
    assert dataclasses.asdict(t.encode) == \
        dataclasses.asdict(jdev.encode_tables(17))
    assert t.mag_bits.tolist() == list(jdev.encode_tables(17).mag_bits)
    assert t.mag_sizes.tolist() == list(jdev.encode_tables(17).mag_sizes)
    assert t.dither_rows.device == CPU
    np.testing.assert_array_equal(t.dither_rows.numpy(),
                                  jax_dither_rows(h, frame_index))


def test_other_input_formats_are_not_ported():
    """The codec takes every input format of the JAX API (the JAX
    `IntraCodec`'s nine device formats and the thirteen its API encodes on
    the host); a format that no encoder takes (b48r, which the reference
    refuses as an input) raises."""
    from cineform_tpu import api as japi

    for fmt in japi.Encoder.INPUT_FORMATS:
        assert IntraCodec(96, 48, 4, device=CPU, input_format=fmt.name)
    with pytest.raises(ValueError, match="encodes YUY2, UYVY"):
        IntraCodec(320, 240, 4, device=CPU, input_format="b48r")


def test_frames_of_the_wrong_shape_raise():
    with pytest.raises(ValueError, match="YUY2"):
        IntraCodec(320, 240, 4, device=CPU).encode_batch_device(
            np.zeros((1, 240, 320), np.uint8))

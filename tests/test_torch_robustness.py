"""Decode robustness of the port: corrupt and truncated samples fail
cleanly, as the JAX API's do.

`tests/test_robustness.py`'s four tests on `cineform_tpu_torch.api` (on
the CPU), each outcome also held against the JAX API's host route (the
byte-exact oracle, `CINEFORM_API_DEVICE=0`): the same frame's bytes, or a
CFHDError from both.  The reference survives corrupt input through its
ERROR_TOLERANT guards (`Codec/decoder.c:19650-19674`) and a decode fuzzer
(`TestCFHD.cpp:572`).
"""

import numpy as np
import pytest

from cineform_tpu import api as japi
from cineform_tpu.models import intra_host as jhost
from cineform_tpu.models import stereo as jstereo
from cineform_tpu_torch import api
from cineform_tpu_torch import diff_fuzz
from cineform_tpu_torch.models import intra_host, stereo
from cineform_tpu_torch.testframes import yuy2_frame

W, H = 160, 120


@pytest.fixture(autouse=True)
def _jax_host_route(monkeypatch):
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")


def _jax_decode(sample, mask=None):
    """The JAX API's outcome: the frame's bytes, or None for a CFHDError."""
    dec = japi.Decoder()
    try:
        dec.prepare_to_decode(0, 0, sample=sample)
        if mask is not None:
            dec.set_channels_active(mask)
        out = dec.decode_sample(sample)
    except japi.CFHDError:
        return None
    return None if out is None else np.ascontiguousarray(out).tobytes()


def _port_decode(sample, mask=None):
    dec = api.Decoder("cpu")
    try:
        dec.prepare_to_decode(0, 0, sample=sample)
        if mask is not None:
            dec.set_channels_active(mask)
        out = dec.decode_sample(sample)
    except api.CFHDError as exc:
        # a rejection names its cause: none, or the JAX host decoder's own
        # (a bad sample, a parse error); never a lookup or device error
        assert not isinstance(exc.__cause__,
                              (KeyError, IndexError, RuntimeError))
        return None
    return None if out is None else np.ascontiguousarray(out).tobytes()


def _sample():
    return jhost.encode_sample(yuy2_frame(W, H, 1), W, H, 4)


def test_truncated_samples():
    """Truncated samples are REJECTED with CFHDError by the port and the
    JAX API alike (the reference errors on end-of-stream mid-walk; the
    truncated-band and band-count rules, `intra_host.wavelet_band_plan`)."""
    sample = _sample()
    for frac in (0.1, 0.3, 0.6, 0.9, 0.99):
        cut = sample[:int(len(sample) * frac)]
        with pytest.raises(api.CFHDError):
            dec = api.Decoder("cpu")
            dec.prepare_to_decode(0, 0, sample=cut)
            dec.decode_sample(cut)
        assert _jax_decode(cut) is None


def test_bitflip_fuzz():
    """Every bit-flipped sample decodes to the JAX API's frame, byte for
    byte, or both raise CFHDError; no other exception."""
    rng = np.random.default_rng(0)
    sample = bytearray(_sample())
    survived = rejected = 0
    for trial in range(40):
        mutated = bytearray(sample)
        for _ in range(rng.integers(1, 8)):
            pos = int(rng.integers(0, len(mutated)))
            mutated[pos] ^= 1 << int(rng.integers(0, 8))
        got = _port_decode(bytes(mutated))
        assert got == _jax_decode(bytes(mutated)), trial
        if got is None:
            rejected += 1
        else:
            assert len(got) == H * 2 * W
            survived += 1
    # many corruptions land in entropy payloads and still decode something
    assert survived >= 1
    assert survived + rejected == 40


def test_garbage_input():
    rng = np.random.default_rng(1)
    dec = api.Decoder("cpu")
    with pytest.raises(api.CFHDError):
        dec.prepare_to_decode(0, 0, sample=rng.bytes(4096))
        dec.decode_sample(rng.bytes(4096))
    rng = np.random.default_rng(1)
    with pytest.raises(japi.CFHDError):
        jdec = japi.Decoder()
        jdec.prepare_to_decode(0, 0, sample=rng.bytes(4096))
        jdec.decode_sample(rng.bytes(4096))


def test_stereo_encoder_roundtrip():
    """The port's StereoEncoder: the VCHN tuple, two eyes, each decoded on
    the device route to the JAX package's eye decode; an eye whose band
    trailer is broken is rejected for that eye, as the JAX API does, and
    the other eye still decodes."""
    from cineform_tpu import metadata as md

    st = api.StereoEncoder("cpu")
    st.prepare_to_encode(W, H, api.PixelFormat.YUY2)
    sample = st.encode_sample(yuy2_frame(W, H, 1), yuy2_frame(W, H, 2))
    jst = japi.StereoEncoder()
    jst.prepare_to_encode(W, H, japi.PixelFormat.YUY2)
    assert jst.encode_sample(yuy2_frame(W, H, 1),
                             yuy2_frame(W, H, 2)) == sample
    item = md.find_metadata(sample, "VCHN")
    assert item is not None and item.payload[:4] == (2).to_bytes(4, "little")
    eyes = stereo.split_3d(sample)
    assert len(eyes) == 2
    codec = api.intra_codec(W, H, api.DECODE_QUALITY, "YUY2", "cpu")
    for eye in (0, 1):
        out, fallback = stereo.decode_batch_device_3d([sample], eye, codec)
        assert fallback == ()
        assert out[0].tobytes() == jstereo.decode_sample_3d(sample, eye)
        assert _port_decode(sample, eye + 1) == _jax_decode(sample, eye + 1)
    # break the right eye's last band trailer
    start = sample.rfind(eyes[1])
    band = diff_fuzz.payload_ranges(eyes[1])[-1]
    pos = start + band[1] - 3
    corrupt = bytearray(sample)
    corrupt[pos] ^= 0x01
    corrupt = bytes(corrupt)
    assert stereo.split_3d(corrupt)[0] == eyes[0]
    with pytest.raises(intra_host.BadSampleError, match="band trailer"):
        for c in intra_host.intra_channels(
                api.parse_sample(stereo.split_3d(corrupt)[1])):
            intra_host.wavelet_band_plan(c)
    assert _port_decode(corrupt, 2) is None
    assert _jax_decode(corrupt, 2) is None
    assert _port_decode(corrupt, 1) == _jax_decode(corrupt, 1) is not None


def _seed7(*cases):
    """Cases of the 160x120 corpus of seed 7 (`tools/diff_fuzz.py`'s
    draws): 7 a broken band trailer, 51 a missing band slot, 162 a payload
    bit flip that breaks subband 8's trailer, 0 a payload flip that
    decodes."""
    corpus = diff_fuzz.corpus(_sample(), max(cases) + 1, 7)
    return [corpus[c][2] for c in cases]


def test_decoder_pool_gives_each_job_the_api_outcome():
    """A batch of 8 with corrupt samples among pristine ones: each job gets
    what the sync API gives its sample (the frame, or CFHDError BADSAMPLE),
    the rest of the batch decodes, and only the frame the API's rules send
    to the host route counts as a fallback frame."""
    from cineform_tpu_torch import pool

    pristine = _sample()
    c7, c51, c162, c0 = _seed7(7, 51, 162, 0)
    batch = [pristine, c7, pristine, c51, c162, pristine, c0, pristine]
    p = pool.DecoderPool(1, 16, device="cpu")
    p.prepare_to_decode(W, H)
    p.start()
    for i, s in enumerate(batch):
        p.decode_async_sample(i, s)
    for i, s in enumerate(batch):
        want = _port_decode(s)
        assert want == _jax_decode(s)
        if want is None:
            with pytest.raises(api.CFHDError) as e:
                p.wait_for_frame(timeout=120)
            assert e.value.code == api.ErrorCode.BADSAMPLE
        else:
            assert p.wait_for_frame(timeout=120).data.tobytes() == want
    p.stop()
    assert p.batches == [8] and p.fallback_frames == 1


def test_the_jax_pool_reads_no_band_rule():
    """The JAX pool's batched path (`cineform_tpu/pool.py:485-500`): its
    header walk sends a sample with a broken band trailer to the device
    program, which reads no trailer (the JAX API rejects the sample), and
    its host route indexes the bands, so that a sample lacking a band slot
    (which the JAX API decodes) raises KeyError, failing its batch."""
    from cineform_tpu.models.intra import IntraCodec as JaxIntraCodec

    c7, c51 = _seed7(7, 51)
    codec = JaxIntraCodec(W, H, 4)
    assert codec._decode_rows_args([c7])[-1] == set()
    assert _jax_decode(c7) is None
    assert codec._decode_rows_args([c51])[-1] == {0}
    with pytest.raises(KeyError):
        codec.decode_batch([c51])
    assert _jax_decode(c51) is not None

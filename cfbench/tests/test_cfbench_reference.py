"""The plain reference agrees with the port's CPU path at a small size:
the samples byte for byte (the port's device-route encoder and its host
coder), the decoded frames byte for byte (YUY2 with the first dither;
Bayer to RG48 through the raw DemosaicRAW chain).  And the control, the
reference with its lowpass coefficients in float16, fails both."""

import numpy as np
import pytest

from cfbench import check, plugins
from conftest import ROOT


def make_frames(cfg, seed):
    return plugins.find(ROOT, "content", cfg["content"]).make(cfg, seed)


def reference(cfg):
    return plugins.find(ROOT, "reference/formats", cfg["format"])

CASES = [dict(width=96, height=64, frames=3, noise_bits=3, quality=4,
              content="plasma_noise_yuy2", format="YUY2", out="YUY2"),
         dict(width=128, height=64, frames=3, noise_bits=11, quality=4,
              content="plasma_noise_byr4", format="BYR4", out="RG48")]


def _port(cfg):
    from cineform_tpu_torch.models.intra import IntraCodec

    return IntraCodec(cfg["width"], cfg["height"], cfg["quality"],
                      device="cpu", input_format=cfg["format"])


@pytest.mark.parametrize("cfg", CASES, ids=lambda c: c["format"])
def test_reference_equals_the_port_on_the_cpu(cfg):
    frames = make_frames(cfg, 2**31 + 3)
    ref = reference(cfg)
    codec = _port(cfg)
    numbers = [9, 10, 11]
    samples = codec.encode_batch_device(frames, frame_numbers=numbers)
    host = codec.encode_batch(frames, frame_numbers=numbers)
    want = [ref.encode_sample(cfg, f, n) for f, n in zip(frames, numbers)]
    assert samples == want
    assert host == want
    out, fallback = codec.decode_batch_device(samples, output=cfg["out"])
    assert fallback == ()
    out = np.ascontiguousarray(out).view(np.uint8).reshape(
        len(frames), cfg["height"], -1)
    for got, frame in zip(out, frames):
        assert check.differing(got, ref.decode_output(cfg, frame,
                                                           cfg["out"])) == 0


@pytest.mark.parametrize("cfg", CASES, ids=lambda c: c["format"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_comparison(cfg, seed):
    """The control reads above the limit 0 on every seed, both ways."""
    frame = make_frames(cfg, seed)[0]
    ref = reference(cfg)
    enc = check.differing(ref.encode_sample(cfg, frame, 1, lossy=True),
                          ref.encode_sample(cfg, frame, 1))
    dec = check.differing(ref.decode_output(cfg, frame, cfg["out"], True),
                          ref.decode_output(cfg, frame, cfg["out"]))
    assert enc > check.LIMITS["differing_bytes"]
    assert dec > check.LIMITS["differing_bytes"]


def test_decoded_values_clamp_and_wrap():
    from cfbench.reference import vlc

    codes = np.array([0, 1, -1, 5, 2000, -2000])
    got = vlc.decoded_values(codes, 3)
    assert got[0] == 0 and got[1] == 3 and got[2] == -3
    # beyond the book's 11-bit domain: clamped, then companded
    assert got[4] == -got[5] and got[4] == vlc.decoded_values(
        np.array([1023]), 3)[0]
    big = vlc.decoded_values(np.array([1023]), 200)[0]
    assert -32768 <= big <= 32767

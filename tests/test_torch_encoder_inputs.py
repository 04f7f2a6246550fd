"""The port's encoder inputs beyond YUY2, 4:2:2 10-bit, RG48, RGBA and
Bayer, on the CPU: the packed 10-bit RGB formats (r210, DPX0, RG30, AB10,
AR10), the 8-bit RGB formats (BGRA, BGRa, RG24) and the Avid CT family
(avu8, av28, a214, a106, av16).

The same inputs go through the port and the JAX package: each plain
unpack of `cineform_tpu_torch.ops.intra_transform` against the NumPy
function of the same name in `cineform_tpu.ref.intra`, at 320x240 and at
a width that is not a multiple of 16; `IntraCodec.encode_batch_device`
and `encode_batch`, and the port's `api.Encoder`, against the JAX
`api.Encoder` (its host route) and the reference's `raw_*` goldens.  Every
comparison is exact but RG24's against its golden, which the JAX
package's own test holds to 0.999 of the bytes
(`tests/test_formats.py::test_rg24_encode_near_exact`).
"""

import os

import numpy as np
import pytest
import torch

from cineform_tpu import api as japi
from cineform_tpu.ref import intra as jref
from cineform_tpu_torch import api
from cineform_tpu_torch import testframes as tframes
from cineform_tpu_torch.models.intra import IntraCodec, sample_metadata
from cineform_tpu_torch.ops import intra_transform as ops

torch.set_num_threads(1)

CPU = torch.device("cpu")
SAMPLES = os.path.join(os.path.dirname(__file__), "golden", "samples")
W, H = 320, 240
#: (pixel format, golden, bytes a pixel): the goldens are the reference
#: encoder's 320x240 quality-4 samples of `testframes.raw_fill` pattern 1
INPUTS = [("R210", "raw_r210", 4), ("DPX0", "raw_DPX0", 4),
          ("RG30", "raw_RG30", 4), ("AB10", "raw_AB10", 4),
          ("AR10", "raw_AR10", 4), ("BGRA", "raw_BGRA", 4),
          ("BGRa", "raw_BGRa", 4), ("RG24", "raw_RG24", 3),
          ("CT_UCHAR", "raw_avu8", 2), ("CT_10BIT_2_8", "raw_av28", 2.5),
          ("CT_SHORT_2_14", "raw_a214", 4),
          ("CT_USHORT_10_6", "raw_a106", 4), ("CT_SHORT", "raw_av16", 4)]
#: the one golden the reference's 8-bit-import two-pass band coder keeps
#: from byte equality (see the module docstring)
NEAR = {"RG24"}
#: the unpacks: name -> (the port's on (B, H, row bytes) frames, the JAX
#: package's on (bytes, width, height), bytes a pixel)
UNPACKS = {
    **{f"rgb10-{c}": (lambda f, c=c: ops.unpack_rgb10(f, c),
                      lambda b, w, h, c=c: jref.unpack_rgb10(b, w, h, c), 4)
       for c in ("r210", "DPX0", "RG30", "AB10", "AR10")},
    "bgra": (ops.unpack_bgra, jref.unpack_bgra, 4),
    # BGRa: the JAX encoder flips the rows and reads them as BGRA
    "bgra-top-down": (
        lambda f: ops.unpack_bgra(f, top_down=True),
        lambda b, w, h: jref.unpack_bgra(np.frombuffer(b, np.uint8).reshape(
            h, 4 * w)[::-1].tobytes(), w, h), 4),
    "rg24": (ops.unpack_rg24, jref.unpack_rg24, 3),
    "avu8": (ops.unpack_avu8, jref.unpack_avu8, 2),
    "av16": (ops.unpack_av16, jref.unpack_av16, 4),
    "a214": (ops.unpack_a214, jref.unpack_a214, 4),
    "av28": (ops.unpack_av28, jref.unpack_av28, 2.5),
}


def _golden(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


def _frames(bpp, n: int, w: int = W, h: int = H) -> np.ndarray:
    """n frames of the raw fill, patterns 1 .. n, as (n, H, row bytes)."""
    nbytes = int(w * h * bpp)
    return np.stack([np.frombuffer(tframes.raw_fill(nbytes, p), np.uint8)
                     for p in range(1, n + 1)]).reshape(n, h, -1)


def _jax_api(fmt, frames, meta) -> list[bytes]:
    """The frames through one JAX `api.Encoder` at quality 4."""
    enc = japi.Encoder()
    enc.prepare_to_encode(W, H, japi.PixelFormat[fmt],
                          quality=japi.EncodingQuality.FILMSCAN1)
    enc.attach_metadata(meta)
    out = []
    for f in frames:
        enc.encode_sample(f.tobytes())
        out.append(enc.get_sample_data())
    return out


def _assert_golden(fmt, got: bytes, gold: bytes) -> None:
    if fmt not in NEAR:
        assert got == gold
        return
    same = sum(a == b for a, b in zip(got, gold))
    assert same / min(len(got), len(gold)) > 0.999


@pytest.mark.parametrize("w,h", [(320, 240), (104, 24)])
@pytest.mark.parametrize("name", list(UNPACKS))
def test_unpack_matches_jax(name, w, h):
    """Each new unpack on seeded bytes equals the JAX package's NumPy
    unpack plane for plane."""
    port, jax_fn, bpp = UNPACKS[name]
    raw = np.random.default_rng(w + len(name)).integers(
        0, 256, int(w * h * bpp), dtype=np.uint8)
    frames = torch.from_numpy(raw.reshape(1, h, -1))
    got = port(frames)
    want = jax_fn(raw.tobytes(), w, h)
    assert len(got) == len(want) == 3
    for g, x in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g[0].numpy(), x)


@pytest.mark.parametrize("fmt,gold,bpp", INPUTS)
def test_codec_encodes_match_jax_and_golden(fmt, gold, bpp):
    """`encode_batch_device` and `encode_batch` of two frames equal the
    JAX API's samples of the same frames and frame numbers; frame 0 is the
    golden."""
    gold = _golden(gold + ".cfhd")
    meta = sample_metadata(gold)
    frames = _frames(bpp, 2)
    codec = IntraCodec(W, H, 4, device=CPU, input_format=fmt)
    assert codec.row_bytes == frames.shape[-1]
    device = codec.encode_batch_device(frames, 1, meta)
    host = codec.encode_batch(frames, 1, meta)
    assert device == host == _jax_api(fmt, frames, meta)
    _assert_golden(fmt, device[0], gold)


@pytest.mark.parametrize("fmt,gold,bpp", INPUTS)
def test_api_encoder_matches_jax_and_golden(fmt, gold, bpp):
    """The port's `api.Encoder` on the CPU: the golden's frame encodes to
    the golden, and equals the JAX API's sample."""
    gold = _golden(gold + ".cfhd")
    meta = sample_metadata(gold)
    frame = _frames(bpp, 1)[0]
    enc = api.Encoder("cpu")
    enc.prepare_to_encode(W, H, api.PixelFormat[fmt],
                          quality=api.EncodingQuality.FILMSCAN1)
    enc.attach_metadata(meta)
    enc.encode_sample(frame.tobytes())
    got = enc.get_sample_data()
    assert got == _jax_api(fmt, frame[None], meta)[0]
    _assert_golden(fmt, got, gold)


@pytest.mark.parametrize("fmt", ["R210", "BGRA", "RG24", "CT_UCHAR",
                                 "CT_10BIT_2_8"])
def test_codec_encodes_a_ragged_width_as_jax(fmt):
    """At 112x48 (a width that is not a multiple of 16 pixels' bytes in
    every band) the codec's samples equal the JAX API's."""
    w, h = 112, 48
    bpp = dict((f, b) for f, _, b in INPUTS)[fmt]
    frames = _frames(bpp, 2, w, h)
    meta = sample_metadata(_golden("raw_r210.cfhd"))
    got = IntraCodec(w, h, 4, device=CPU,
                     input_format=fmt).encode_batch_device(frames, 1, meta)
    enc = japi.Encoder()
    enc.prepare_to_encode(w, h, japi.PixelFormat[fmt])
    enc.attach_metadata(meta)
    for f, sample in zip(frames, got):
        enc.encode_sample(f.tobytes())
        assert sample == enc.get_sample_data()


def test_input_formats_and_families_follow_jax():
    """The port's encoder takes the JAX API's input formats, in its order,
    and pairs each with the encoded formats the JAX API pairs it with."""
    assert [f.name for f in api.Encoder.INPUT_FORMATS] == \
        [f.name for f in japi.Encoder.INPUT_FORMATS]
    for pf in api.Encoder.INPUT_FORMATS:
        for ef in api.EncodedFormat:
            ok = []
            for mod in (api, japi):
                enc = mod.Encoder(**({"device": "cpu"} if mod is api
                                     else {}))
                try:
                    enc.prepare_to_encode(64, 48, mod.PixelFormat[pf.name],
                                          mod.EncodedFormat(int(ef)))
                    ok.append(True)
                except mod.CFHDError:
                    ok.append(False)
            assert ok[0] == ok[1], (pf.name, ef.name)

"""The port's scaler (`cineform_tpu_torch.ops.scaler`) on the CPU, against
the JAX package's (`cineform_tpu.ref.scaler`, `cineform_tpu.ops.scaler`)
and the reference scaler's goldens.

The same inputs, the 320x240 and 128x96 decode goldens' YU64 and b64a
buffers or frames from numpy seeds, go through both.  The fixed-point
scaler is held byte for byte (tolerance 0); the float resamplers within
rtol 1e-5 and atol 1e-4 on float32 images in [0, 1]: both sum float32
products, the JAX ones through XLA's dot and fusion and the port's through
PyTorch's, and the two libraries need not add in the same order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cineform_tpu.ops import scaler as jops
from cineform_tpu.ref import scaler as jref
from cineform_tpu_torch.ops import scaler

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
#: the decode-to-size outputs of the API (`Decoder._decode_to_size`'s map)
SIZED = ("YUY2", "2vuy", "YU64", "v210", "RG48", "BGRA", "b64a", "r210",
         "DPX0", "RG30")
SIZES = ((200, 150), (211, 157), (480, 360), (81, 63))
RTOL, ATOL = 1e-5, 1e-4


def _golden(name, sub="scaler"):
    with open(os.path.join(HERE, "golden", sub, name), "rb") as f:
        return f.read()


def _yu64_320() -> bytes:
    return _golden("s_320x240_q4_p1.yu64out", "samples")


def _yu64_tensor(raw: bytes, w: int, h: int) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(raw, "<u2").astype(np.int32)
                            .reshape(1, h, 2 * w))


def _argb16le_128() -> np.ndarray:
    raw = np.frombuffer(_golden("s_128x96_q4_p1.b64aout", "samples"), ">u2")
    return raw.astype(np.int32).reshape(96, 128, 4)


def _port_bytes(fn, *args):
    """The port's result as bytes, or the exception's kind: the JAX model
    raises where its packing cannot lay out a width, and so must the
    port."""
    try:
        return fn(*args)[0].numpy().tobytes()
    except (RuntimeError, ValueError):
        return "raises"


def _jax_bytes(fn, *args):
    try:
        return fn(*args)
    except (RuntimeError, ValueError):
        return "raises"


@pytest.mark.parametrize("fourcc", SIZED)
@pytest.mark.parametrize("ow,oh", SIZES)
def test_scale_yu64_to_matches_jax(ow, oh, fourcc):
    """Every output of a decode to another size, downscaled, upscaled and
    at odd sizes, from the 320x240 golden's YU64."""
    raw = _yu64_320()
    want = _jax_bytes(jref.scale_yu64_to, raw, 320, 240, ow, oh, fourcc)
    got = _port_bytes(scaler.scale_yu64_to, _yu64_tensor(raw, 320, 240),
                      320, 240, ow, oh, fourcc)
    assert got == want


@pytest.mark.parametrize("fourcc", ("AB10", "AR10", "b64a", "RG48"))
@pytest.mark.parametrize("is709", (False, True))
def test_scale_yu64_to_other_words_and_709_match_jax(fourcc, is709):
    """The 10-bit words the API does not ask for, and the 709 matrix, on a
    96x64 YU64 frame from a numpy seed scaled to 57x41."""
    yu64 = np.random.default_rng(7).integers(0, 65536, (64, 192), np.uint16)
    want = jref.scale_yu64_to(yu64.astype("<u2").tobytes(), 96, 64, 57, 41,
                              fourcc, is709)
    got = scaler.scale_yu64_to(torch.from_numpy(yu64.astype(np.int32))[None],
                               96, 64, 57, 41, fourcc, is709)
    assert got[0].numpy().tobytes() == want


@pytest.mark.parametrize("ow,oh", [(200, 150), (480, 360), (211, 157),
                                   (200, 240)])
def test_scale_yu64_to_bgra64_golden(ow, oh):
    """ScaleToBGRA64 byte-equal to the reference scaler's goldens."""
    got = scaler.scale_yu64_to_bgra64(_yu64_tensor(_yu64_320(), 320, 240),
                                      320, 240, ow, oh)
    assert got[0].numpy().tobytes() == _golden(f"scale_yu64_{ow}x{oh}.bgra64")


def test_scale_yu64_batch_is_framewise():
    """A batch scales each frame as it scales alone."""
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.integers(0, 65536, (3, 48, 128),
                                           np.uint16).astype(np.int32))
    batch = scaler.scale_yu64_to(frames, 64, 48, 40, 30, "RG48")
    for i in range(3):
        one = scaler.scale_yu64_to(frames[i:i + 1], 64, 48, 40, 30, "RG48")
        assert torch.equal(batch[i], one[0])


@pytest.mark.parametrize("ow,oh", [(80, 60), (200, 150), (81, 63),
                                   (128, 96), (64, 96)])
def test_scale_b64a_to_b64a(ow, oh):
    argb = _argb16le_128()
    want = jref.scale_b64a_to_b64a(argb.astype("<u2").tobytes(), 128, 96,
                                   ow, oh)
    got = scaler.scale_b64a_to_b64a(torch.from_numpy(argb)[None], 128, 96,
                                    ow, oh)[0].numpy().tobytes()
    assert got == want
    if os.path.exists(os.path.join(HERE, "golden", "scaler",
                                   f"scale_b64a_{ow}x{oh}.b64a")):
        assert got == _golden(f"scale_b64a_{ow}x{oh}.b64a")


@pytest.mark.parametrize("ow,oh", [(80, 60), (81, 63), (128, 96),
                                   (200, 150), (64, 96)])
def test_scale_b64a_to_bgra(ow, oh):
    """Including the reference's out_w * 3 column stride quirk, whose taps
    past the buffer are skipped."""
    argb = _argb16le_128()
    want = jref.scale_b64a_to_bgra(argb.astype("<u2").tobytes(), 128, 96,
                                   ow, oh)
    got = scaler.scale_b64a_to_bgra(torch.from_numpy(argb)[None], 128, 96,
                                    ow, oh)[0].numpy().tobytes()
    assert got == want
    if os.path.exists(os.path.join(HERE, "golden", "scaler",
                                   f"scale_bgra_{ow}x{oh}.bgra")):
        assert got == _golden(f"scale_bgra_{ow}x{oh}.bgra")


def test_the_mix_stays_int32():
    """The tap tables' builder keeps the mixes int32 (65535 times a line's
    absolute mix sum fits), at the phase's 1080p sizes and an extreme
    downscale."""
    for n_in, n_out in ((1920, 1280), (1920, 3840), (1080, 720),
                        (1920, 200), (320, 7)):
        _, mix = scaler.tap_table(n_in, n_out, 3, torch.device("cpu"))
        assert mix.dtype == torch.int32


# ---------------------------------------------------------------------------
# The float resamplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_in,n_out", [(240, 180), (64, 96), (100, 37)])
def test_resample_matrix_is_the_jax_one(n_in, n_out):
    assert np.array_equal(scaler.resample_matrix(n_in, n_out),
                          jops.resample_matrix(n_in, n_out))


def _image(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, np.float32)


@pytest.mark.parametrize("shape,out", [
    ((2, 48, 64, 3), (36, 40)), ((48, 64), (96, 128)),
    ((1, 64, 96, 4), (31, 47))])
def test_scale_image_matches_jax(shape, out):
    img = _image(shape)
    want = np.asarray(jops.scale_image(jnp.asarray(img), *out))
    got = scaler.scale_image(torch.from_numpy(img), *out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,out", [
    ((2, 48, 64, 3), (36, 40)), ((48, 64), (96, 128)),
    ((1, 64, 96, 4), (31, 47))])
def test_scale_bilinear_matches_jax(shape, out):
    img = _image(shape, 1)
    want = np.asarray(jops.scale_bilinear(jnp.asarray(img), *out))
    got = scaler.scale_bilinear(torch.from_numpy(img), *out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_scale_image_restores_tf32_setting():
    """scale_image turns TF32 off for its products and restores the
    caller's setting."""
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with scaler._full_float32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved

"""The port's Bayer RAW chain (`cineform_tpu_torch.ops.demosaic`) on the
CPU, against the JAX package's device program (`ops/demosaic_jax.
demosaic_develop`) and its byte-exact host model (`ref/demosaic`).

The planes are the Row16u planes of Bayer goldens (`intra_host.
decode_sample_bayer_row16u`) and seeded random planes at small shapes,
quarter-res heights and widths odd and even.  Every comparison is exact
(tolerance 0).  At plane widths that are not a multiple of 8 the port
follows the host model's scalar tail, which the JAX program lacks (ROADMAP
Queue 3), so the JAX comparisons take widths that are.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cineform_tpu.models import intra_host as jhost
from cineform_tpu.ops import demosaic_jax as dj
from cineform_tpu.ref import demosaic as jdm
from cineform_tpu_torch import api
from cineform_tpu_torch.ops import demosaic as td
from cineform_tpu_torch.ref import demosaic as tdm

torch.set_num_threads(1)

SAMPLES = os.path.join(os.path.dirname(__file__), "golden", "samples")
#: the goldens of tests/test_demosaic_jax.py, and one 96x64 golden
GOLDENS = ["byr4_320x240_q4_p1", "byr4_colm_320x240_q4", "byr4_vgn_96x64_q4"]
#: seeded quarter-res plane shapes (h, w): widths that are multiples of 8
#: (the JAX program's) and others
JAX_SHAPES = [(5, 8), (6, 16), (3, 24), (8, 8)]
TAIL_SHAPES = [(7, 12), (4, 9), (5, 13)]
COLM = [[0.9, 0.08, 0.02, 0.0], [0.05, 0.9, 0.05, 0.01],
        [0.02, 0.08, 0.9, 0.0]]


def _golden_planes(name):
    with open(os.path.join(SAMPLES, name + ".cfhd"), "rb") as f:
        return jhost.decode_sample_bayer_row16u(f.read())


def _seeded_planes(h, w, seed=0):
    rng = np.random.default_rng(1000 * h + w + seed)
    return [rng.integers(0, 65536, (h, w)).astype(np.uint16)
            for _ in range(4)]


def _t(planes):
    return [torch.from_numpy(p.astype(np.int32))[None] for p in planes]


def _random_matrix(seed=3):
    rng = np.random.default_rng(seed)
    return np.eye(3, 4) + rng.uniform(-0.2, 0.2, (3, 4)) * [1, 1, 1, 0.05]


def _tables():
    return (torch.from_numpy(tdm.curve2linear_lut().astype(np.int32)),
            torch.from_numpy(tdm.linear2curve_lut().astype(np.int32)))


def _port_develop(planes, matrix):
    c2l, l2c = _tables()
    lcm = td.develop_matrix_lcm(np.asarray(matrix)[None], "cpu")
    out13 = td.develop_1d(td.demosaic_raw(*_t(planes)), lcm, c2l, l2c)
    return (out13[0] << 3).clamp(0, 65535).numpy()


PLANES = ([("golden", n) for n in GOLDENS]
          + [("seeded", s) for s in JAX_SHAPES])


def _planes(kind, arg):
    return _golden_planes(arg) if kind == "golden" else _seeded_planes(*arg)


@pytest.mark.parametrize("kind,arg", PLANES, ids=[str(a) for _, a in PLANES])
@pytest.mark.parametrize("which", ["identity", "colm", "random"])
def test_develop_of_demosaic_equals_jax_demosaic_develop(kind, arg, which):
    """`develop_1d(demosaic_raw(x)) << 3` is the JAX program's output, bit
    for bit, for the identity, the COLM golden's and a random matrix."""
    planes = _planes(kind, arg)
    matrix = {"identity": None, "colm": COLM,
              "random": _random_matrix()}[which]
    want = np.asarray(dj.demosaic_develop(
        *[jnp.asarray(p) for p in planes], *dj.develop_tables(matrix)))
    got = _port_develop(planes, np.eye(3, 4) if matrix is None else matrix)
    assert got.dtype == np.int32 and (got == want).all()


@pytest.mark.parametrize("kind,arg",
                         PLANES + [("seeded", s) for s in TAIL_SHAPES],
                         ids=[str(a) for _, a in PLANES]
                         + [str(s) for s in TAIL_SHAPES])
def test_demosaic_raw_equals_host_model(kind, arg):
    """`demosaic_raw` is `ref/demosaic.demosaic_raw_rg48`, the scalar tail
    of widths that are not a multiple of 8 included."""
    planes = _planes(kind, arg)
    want = jdm.demosaic_raw_rg48(*planes)
    got = td.demosaic_raw(*_t(planes))
    assert got.shape == (1, *want.shape) and (got[0].numpy() == want).all()


def test_demosaic_raw_is_batched():
    """Two frames in one call equal each frame alone."""
    a, b = _seeded_planes(6, 16, 1), _seeded_planes(6, 16, 2)
    both = td.demosaic_raw(*[torch.cat(p) for p in zip(_t(a), _t(b))])
    assert (both[0] == td.demosaic_raw(*_t(a))[0]).all()
    assert (both[1] == td.demosaic_raw(*_t(b))[0]).all()


def test_develop_product_in_int64_at_the_extreme_matrix():
    """White balance 10 and exposure 11 put `lcm` at 901,120; a saturated
    frame's terms pass 2^31.  The port's int64 product equals the host
    model; the JAX program's int32 einsum wraps there (ROADMAP Queue 3)."""
    matrix = jdm.compose_develop_matrix(None, 1.0, 11.0, (10.0, 10.0, 10.0))
    assert np.trunc(matrix * 8192).max() == 901120
    rng = np.random.default_rng(7)
    planes = [np.full((6, 16), 65535, np.uint16),
              rng.integers(0, 65536, (6, 16)).astype(np.uint16),
              rng.integers(0, 65536, (6, 16)).astype(np.uint16),
              np.full((6, 16), 32768, np.uint16)]
    rgb = jdm.demosaic_raw_rg48(*planes)
    want = np.clip(jdm.apply_active_metadata_matrix(rgb, matrix) << 3,
                   0, 65535)
    assert (_port_develop(planes, matrix) == want).all()
    jax_out = np.asarray(dj.demosaic_develop(
        *[jnp.asarray(p) for p in planes], *dj.develop_tables(matrix)))
    assert (jax_out != want).any()


@pytest.mark.parametrize("kind,arg",
                         PLANES + [("seeded", (7, 12)), ("seeded", (4, 9))],
                         ids=[str(a) for _, a in PLANES] + ["(7, 12)",
                                                            "(4, 9)"])
def test_bilinear_demosaic_equals_host_model(kind, arg):
    planes = _planes(kind, arg)
    want = jdm.demosaic_bilinear_rgb(*planes)
    got = td.demosaic_bilinear_rgb(*_t(planes))
    assert (got[0].numpy() == want).all()


@pytest.mark.parametrize("kind,arg", PLANES, ids=[str(a) for _, a in PLANES])
@pytest.mark.parametrize("whitepoint", [16, 13])
@pytest.mark.parametrize("uyvy", [False, True])
def test_yuyv_conversion_equals_host_model(kind, arg, whitepoint, uyvy):
    """The bilinear demosaic to YUY2 or UYVY bytes, at whitepoint 16 and,
    through the COLM matrix's develop, at whitepoint 13, with the Bayer
    row parity.  The port's UYVY is its YUY2's byte pairs swapped, as the
    API stores it."""
    planes = _planes(kind, arg)
    rgb = jdm.demosaic_bilinear_rgb(*planes)
    parity = jdm.bayer_yuyv_parity(rgb.shape[0])
    if whitepoint == 13:
        rgb = jdm.apply_active_metadata_matrix(
            np.clip(rgb, 0, 65535).astype(np.uint16), COLM)
    want = jdm.convert_rgb16_to_yuyv(rgb, parity=parity,
                                     whitepoint=whitepoint, uyvy=uyvy)
    got = td.convert_rgb16_to_yuyv(
        torch.from_numpy(rgb.astype(np.int32))[None],
        torch.from_numpy(tdm.bayer_yuyv_parity(rgb.shape[0])),
        whitepoint=whitepoint)
    assert got.dtype == torch.uint8
    got = got[0].numpy()
    assert (api._to_uyvy(got) if uyvy else got).tobytes() == want


def test_yuyv_conversion_refuses_ragged_widths():
    with pytest.raises(ValueError):
        td.convert_rgb16_to_yuyv(torch.zeros((1, 2, 12, 3), dtype=torch.int32),
                                 torch.zeros(2, dtype=torch.int64))

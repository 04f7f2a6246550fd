"""The port's Bayer develop stages (`cineform_tpu_torch.ops.demosaic`: the
LOOK RawCube applies, the gamma tweaks, the vignette and the BLSH passes,
`DevelopPlan`) and the API's develop routes, on the CPU, against the JAX
package's host model (`cineform_tpu.ref.demosaic`), its API on the host
route (`CINEFORM_API_DEVICE=0`) and the reference goldens.

The stage inputs are seeded `np.random.default_rng` WP13 frames; every
comparison is exact (tolerance 0).  The `.cflook` golden's LUT is found as
the reference finds it, under `$HOME/.cineform/LUTs`: each test that needs
it points HOME at a temporary directory holding
`tests/golden/samples/DEADBEEF.cflook` there.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from cineform_tpu import api as japi
from cineform_tpu.ref import demosaic as jdm
from cineform_tpu_torch import api
from cineform_tpu_torch.ops import demosaic as dmops
from cineform_tpu_torch.ref import demosaic as tdm

torch.set_num_threads(1)

CPU = torch.device("cpu")
SAMPLES = os.path.join(os.path.dirname(__file__), "golden", "samples")
#: the Bayer goldens whose metadata turns on a develop stage beyond the
#: matrix: vignette, BLSH sharpening, the LOOK cube, gamma/contrast
DEVELOP_GOLDENS = ["byr4_blsh05_96x64_q4", "byr4_blshm05_96x64_q4",
                   "byr4_blshm10_96x64_q4", "byr4_colm_blsh_96x64_q4",
                   "byr4_colm_look_96x64_q4", "byr4_ctrs_96x64_q4",
                   "byr4_ctrs_gamt_96x64_q4", "byr4_ctrs_look_96x64_q4",
                   "byr4_full_develop_96x64_q4", "byr4_gamt_320x240_q4",
                   "byr4_gamt_look_96x64_q4", "byr4_look_cflook_96x64_q4",
                   "byr4_look_protune_96x64_q4", "byr4_vgn_96x64_q4",
                   "byr4_vgn_blsh_96x64_q4"]
#: BLSH values: both signs, and the blur cases -1 .. -5 (case = -1 +
#: int(s * 4)) with values between them
SHARPNESS = [0.1, 0.25, 0.5, 0.77, 1.0, -0.1, -0.25, -0.4, -0.5, -0.6,
             -0.75, -0.9, -1.0]
#: frame sizes (H, W): 3*W % 8 == 0; rows enough for the 9-tap blur's
#: interior beside its demoted edge rows, and a frame of edge rows only
SIZES = [(64, 96), (20, 32), (8, 16)]
SIZE_IDS = ["96x64", "32x20", "16x8"]


def _golden(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


def _wp13(h, w, seed, lo=-3000, hi=9000):
    return np.random.default_rng(seed).integers(lo, hi, size=(h, w, 3))


def _t(a, dtype=torch.int64):
    return torch.from_numpy(np.asarray(a)).to(dtype)[None]


@pytest.fixture
def look_home(monkeypatch, tmp_path):
    """HOME with the `.cflook` golden in its LUTs directory."""
    luts = tmp_path / ".cineform" / "LUTs"
    luts.mkdir(parents=True)
    shutil.copy(os.path.join(SAMPLES, "DEADBEEF.cflook"),
                luts / "DEADBEEF.cflook")
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    return tmp_path


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("s", SHARPNESS)
def test_blsh_horizontal_matches_jax(s, size):
    h, w = size
    x = _wp13(h, w, 1)
    got = dmops.fast_sharpening_blur_h_wp13(_t(x), s)[0].numpy()
    np.testing.assert_array_equal(got, jdm.fast_sharpening_blur_h_wp13(x, s))


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("s", SHARPNESS)
def test_blsh_vertical_matches_jax(s, size):
    """The float32 taps in the reference's order, rounded half to even;
    wide values reach the 2^24 rounding boundary of the float32 sums."""
    h, w = size
    x = _wp13(h, w, 2, -32768, 32768)
    got = dmops.fast_sharpening_blur_v_wp13(_t(x), s)[0].numpy()
    np.testing.assert_array_equal(got, jdm.fast_sharpening_blur_v_wp13(x, s))


def test_blsh_vertical_refuses_widths_the_model_refuses():
    x = _wp13(16, 36, 3)
    with pytest.raises(AssertionError):
        jdm.fast_sharpening_blur_v_wp13(x, 0.5)
    with pytest.raises(ValueError):
        dmops.fast_sharpening_blur_v_wp13(_t(x), 0.5)


#: (start, end, gain): the decoder's start and end (the tags' minus one)
VIGNETTES = [(-0.7, 0.0, 0.5), (-0.7, 0.0, 0.0), (-0.5, 0.2, 0.5),
             (-0.5, -0.2, 0.0), (-0.8, 0.0, 0.3), (-0.2, 0.3, 0.75)]


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("vgn", VIGNETTES, ids=[f"{v[0]}_{v[1]}_{v[2]}"
                                                for v in VIGNETTES])
def test_vignette_matches_jax(vgn, size):
    h, w = size
    x = _wp13(h, w, 4)
    af, ring = dmops.vignette_tables(w, h, *vgn, CPU)
    got = dmops.fast_vignette_wp13(_t(x), af, ring)[0].numpy()
    np.testing.assert_array_equal(got, jdm.fast_vignette_wp13(x, *vgn))


def test_vignette_rings_are_not_empty():
    """Each vignette case touches pixels, and gain 0 zeroes some."""
    for vgn in VIGNETTES:
        af, ring = tdm.vignette_geometry(96, 64, *vgn)
        assert ring.any(), vgn
        if vgn[2] == 0.0:
            assert (ring & (af == 0)).any(), vgn


def _rgb16(h, w, seed):
    return np.random.default_rng(seed).integers(0, 65536, size=(h, w, 3))


def _cubes():
    lut, size = tdm.protune_look_lut()
    rng = np.random.default_rng(5)
    noise = rng.integers(-20000, 30000, size=(65 ** 3, 3)).astype(np.int16)
    return {"protune": tdm.build_raw_cube(lut, size),
            "protune-developed": tdm.build_raw_cube_developed(
                np.array([[1.1, -0.05, -0.05, 0.01], [0.0, 0.95, 0.05, 0.0],
                          [-0.1, 0.0, 1.1, 0.0]]), (0.9, 1.0, 1.2), 1.1,
                lut, size),
            "seeded": noise}


CUBES = _cubes()


@pytest.mark.parametrize("name", list(CUBES))
def test_cube_applies_match_jax(name):
    """The 1D lerp and the trilinear apply of each cube, whether or not it
    is separable (the seeded cube is not)."""
    cube = CUBES[name]
    x = _rgb16(48, 80, 6)
    c = torch.from_numpy(cube.astype(np.int32))
    got1 = dmops.apply_raw_cube_rgb16_1d(_t(x, torch.int32), c)[0].numpy()
    np.testing.assert_array_equal(got1, jdm.apply_raw_cube_rgb16_1d(x, cube))
    got3 = dmops.apply_raw_cube_rgb16_trilinear(_t(x, torch.int32),
                                                c)[0].numpy()
    np.testing.assert_array_equal(
        got3, jdm.apply_raw_cube_rgb16_trilinear(x, cube))
    assert tdm.cube_is_separable(cube) == jdm.cube_is_separable(cube)
    assert tdm.cube_is_separable(cube) == (name == "protune")


@pytest.mark.parametrize("gamma,contrast", [((0.8, 1.0, 1.7), 1.0),
                                            ((1.0, 1.0, 1.0), 1.4),
                                            ((1.2, 0.6, 2.2), 0.7)])
def test_gamma_tweaks_match_jax(gamma, contrast):
    x = _rgb16(48, 80, 7)
    tables = np.stack([tdm.gamma_contrast_lut(g, contrast) for g in gamma])
    got = dmops.apply_gamma_tweaks(_t(x, torch.int32),
                                   torch.from_numpy(tables.astype(np.int32)))
    np.testing.assert_array_equal(got[0].numpy(),
                                  jdm.apply_gamma_tweaks(x, gamma, contrast))


@pytest.mark.parametrize("cube", ["protune", "seeded"])
def test_plan_runs_the_jax_order(cube):
    """A plan with a cube, the vignette and BLSH runs cube, vignette, BLSH
    H, BLSH V, << 3 and the clip, as the JAX host decoder does."""
    c = CUBES[cube]
    plan = dmops.DevelopPlan(cube=c, separable=tdm.cube_is_separable(c),
                             vignette=(-0.7, 0.0, 0.5), sharpen=-0.6)
    x = _rgb16(32, 64, 8)
    c2l = torch.from_numpy(tdm.curve2linear_lut().astype(np.int32))
    l2c = torch.from_numpy(tdm.linear2curve_lut().astype(np.int32))
    got = dmops.develop_rgb16(_t(x, torch.int32), plan, c2l, l2c)[0]
    apply = jdm.apply_raw_cube_rgb16_1d if plan.separable \
        else jdm.apply_raw_cube_rgb16_trilinear
    want = jdm.fast_vignette_wp13(apply(x, c), -0.7, 0.0, 0.5)
    want = jdm.fast_sharpening_blur_v_wp13(
        jdm.fast_sharpening_blur_h_wp13(want, -0.6), -0.6)
    np.testing.assert_array_equal(got.numpy(),
                                  np.clip(want << 3, 0, 65535))


# ---------------------------------------------------------------------------
# The API's develop routes
# ---------------------------------------------------------------------------

def _decode(mod, kw, sample, fmt):
    dec = mod.Decoder(**kw)
    dec.prepare_to_decode(0, 0, mod.PixelFormat[fmt], sample=sample)
    out = dec.decode_sample(sample).tobytes()
    return out, dec


@pytest.mark.parametrize("name", DEVELOP_GOLDENS)
def test_develop_goldens_match_jax_and_golden(look_home, name):
    """Each golden whose metadata turns on a develop stage decodes through
    the port's `api.Decoder` on the CPU byte-equal to its `.rg48out` and
    to the JAX API, with no frame falling back."""
    sample = _golden(name + ".cfhd")
    got, dec = _decode(api, {"device": "cpu"}, sample, "RG48")
    assert dec.fallback_frames == 0
    assert got == _golden(name + ".rg48out")
    assert got == _decode(japi, {}, sample, "RG48")[0]


def test_the_look_goldens_take_both_cube_applies(look_home):
    """The Protune look's cube is separable (the 1D apply), the `.cflook`
    file's is not (the trilinear)."""
    plans = {n: api.bayer_develop(_golden(f"byr4_look_{n}_96x64_q4.cfhd"),
                                  None, "RG48") for n in ("protune", "cflook")}
    assert plans["protune"].cube is not None and plans["protune"].separable
    assert plans["cflook"].cube is not None and not plans["cflook"].separable


@pytest.mark.parametrize("fmt", ["B64A", "WP13", "W13A"])
def test_full_develop_to_other_outputs_matches_jax(look_home, fmt):
    sample = _golden("byr4_full_develop_96x64_q4.cfhd")
    got, dec = _decode(api, {"device": "cpu"}, sample, fmt)
    assert dec.fallback_frames == 0
    assert got == _decode(japi, {}, sample, fmt)[0]


def test_an_unresolved_look_falls_through_to_the_matrix_chain(
        monkeypatch, tmp_path):
    """With no `.cflook` under HOME the JAX decoder falls through to the
    matrix chain; the port gives the same bytes (not the golden's)."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    sample = _golden("byr4_look_cflook_96x64_q4.cfhd")
    assert api.bayer_develop(sample, None, "RG48") is None or \
        api.bayer_develop(sample, None, "RG48").cube is None
    got, _ = _decode(api, {"device": "cpu"}, sample, "RG48")
    # the port's reader creates no LUTs directory (the JAX database does)
    assert not (tmp_path / ".cineform").exists()
    assert got == _decode(japi, {}, sample, "RG48")[0]
    assert got != _golden("byr4_look_cflook_96x64_q4.rg48out")


def test_plans_are_cached_by_their_settings(look_home):
    """Two samples with one setting share a plan (its device tables are
    uploaded once); the YUY2 output's plan holds the matrix alone."""
    sample = _golden("byr4_full_develop_96x64_q4.cfhd")
    a = api.bayer_develop(sample, None, "RG48")
    assert api.bayer_develop(sample, None, "b64a") is a
    y = api.bayer_develop(_golden("byr4_colm_blsh_96x64_q4.cfhd"), None,
                          "YUY2")
    assert y.matrix is not None and y.sharpen == 0.0 and y.cube is None


def test_a_cached_look_plan_reads_no_lut(look_home, monkeypatch):
    """The `.cflook` plan is keyed by the file (path, modification time,
    size): a second frame of the look neither reads nor hashes the LUT,
    and a rewritten file builds a new plan."""
    from cineform_tpu_torch.utils import lutpath

    reads = []
    read = lutpath.read_cflook
    monkeypatch.setattr(lutpath, "read_cflook",
                        lambda path: reads.append(path) or read(path))
    api._PLANS.clear()
    sample = _golden("byr4_look_cflook_96x64_q4.cfhd")
    a = api.bayer_develop(sample, None, "RG48")
    assert api.bayer_develop(sample, None, "RG48") is a
    assert len(reads) == 1 and a.cube is not None
    path = look_home / ".cineform" / "LUTs" / "DEADBEEF.cflook"
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    b = api.bayer_develop(sample, None, "RG48")
    assert b is not a and len(reads) == 2
    assert b.cube.tobytes() == a.cube.tobytes()

"""The port's lens-correction warp (`cineform_tpu_torch.ops.warp`,
`models.lens` and the API's warp routes) on the CPU, against the JAX
package's (`cineform_tpu.ref.geomesh`, `models.lens`, `ops.warp`, `api`)
and the reference's warp goldens.

The same inputs, frames and meshes from numpy seeds, the golden cases of
`tests/test_warp_geomesh.py` and the lens samples of
`tests/test_warp_decode.py` (encoded by the JAX API with the lens tags in
the sample), go through both.  The integer warp is held byte for byte
(tolerance 0); the float resampler `warp_bilinear` within rtol 1e-5 and
atol 1e-4 on float32 images in [0, 1] (XLA may fuse its blend into FMAs
where PyTorch rounds each product), and the numpy mesh builders exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cineform_tpu import api as japi
from cineform_tpu import metadata as md
from cineform_tpu.models import lens as jlens
from cineform_tpu.ops import warp as jwarp
from cineform_tpu.ref import geomesh as jgm
from cineform_tpu.utils.testframes import rg48_frame, yuy2_frame
from cineform_tpu_torch import api
from cineform_tpu_torch.models import lens
from cineform_tpu_torch.ops import warp
from cineform_tpu_torch.ref import geomesh as gm
from tests.test_warp_decode import CASES as LENS_CASES
from tests.test_warp_geomesh import APPLY, BPP, CASES, _test_image

torch.set_num_threads(1)

CPU = torch.device("cpu")
GOLD = os.path.join(os.path.dirname(__file__), "golden", "warp")
FORMATS = ("yuy2", "bgra", "b64a", "rg48", "wp13", "w13a")
RTOL, ATOL = 1e-5, 1e-4


def _fmt(mod, fmt):
    return {"yuy2": mod.FORMAT_YUY2, "bgra": mod.FORMAT_32BGRA,
            "b64a": mod.FORMAT_64ARGB, "rg48": mod.FORMAT_RG48,
            "wp13": mod.FORMAT_WP13, "w13a": mod.FORMAT_W13A}[fmt]


def _mesh(mod, name, fmt, fill, w, h):
    """The golden case `name` built by `mod`'s GeoMesh, its cache filled
    over the whole frame from a fresh rand stream."""
    _, mw, mh, steps = CASES[name]
    g = mod.GeoMesh(mw, mh)
    g.init(w, h, w * BPP[fmt], _fmt(mod, fmt), w, h, w * BPP[fmt],
           _fmt(mod, fmt), fill)
    for t, args in steps:
        if t == "set_custom_lens":
            g.set_custom_lens(*args)
        else:
            getattr(g, "transform_" + t)(*args)
    g.cache_init_bilinear_range(0, h, mod.GlibcRand())
    return g


def _frames(raw: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8)[None]


# ---------------------------------------------------------------------------
# The integer apply and the blur
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fill", (0, 1))
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", ("defish_pos", "scale_out", "sphere_stack",
                                  "repoint_equi"))
def test_apply_bilinear_matches_jax(name, fmt, fill):
    """`apply_bilinear` of every format, with and without the fill blends,
    equals `GeoMesh.apply_bilinear` on 96x64 frames from a seed (160x80
    for the equirect case); with fill, `blur_vertical` equals
    `lens.blur_vertical`."""
    w, h = (160, 80) if name == "repoint_equi" else (96, 64)
    want_mesh = _mesh(jgm, name, fmt, fill, w, h)
    ours = _mesh(gm, name, fmt, fill, w, h)
    assert np.array_equal(ours.cache, want_mesh.cache)
    img = _test_image(w, h, fmt)
    want = want_mesh.apply_bilinear(img)
    dm = warp.upload(ours, CPU)
    got = warp.apply_bilinear(dm, _frames(img))
    assert got[0].numpy().tobytes() == want.tobytes()
    if fill:
        jlens.blur_vertical(want_mesh, want)
        got = warp.blur_vertical(dm, got)
        assert got[0].numpy().tobytes() == want.tobytes()


def test_the_fill_recurrences_run_where_the_fill_is():
    """The zoomed-out mesh blends a band across whole rows: YUY2 solves its
    chains in doubling rounds, the packed formats sweep the blended
    columns, and the blur walks the rows that hold a fill pixel."""
    yuy2 = warp.upload(_mesh(gm, "scale_out", "yuy2", 1, 96, 64), CPU)
    rg48 = warp.upload(_mesh(gm, "scale_out", "rg48", 1, 96, 64), CPU)
    none = warp.upload(_mesh(gm, "scale_out", "rg48", 0, 96, 64), CPU)
    assert yuy2.recurrence_steps["blend_rounds"] > 0
    assert yuy2.recurrence_steps["blend_columns"] == 0
    assert rg48.recurrence_steps["blend_columns"] == 95
    assert rg48.recurrence_steps["blur_rows"] > 0
    assert none.recurrence_steps == {"blend_columns": 0, "blend_rounds": 0,
                                     "blur_rows": 0}


def test_apply_bilinear_batch_is_framewise():
    dm = warp.upload(_mesh(gm, "scale_out", "w13a", 1, 96, 64), CPU)
    frames = torch.stack([_frames(_test_image(96, 64, "w13a"))[0],
                          _frames(_test_image(96, 64, "w13a"))[0].flip(0)])
    batch = warp.blur_vertical(dm, warp.apply_bilinear(dm, frames))
    for i in range(2):
        one = warp.blur_vertical(dm, warp.apply_bilinear(dm, frames[i:i + 1]))
        assert torch.equal(batch[i], one[0])


@pytest.mark.parametrize("name,fmt,fill", APPLY)
def test_apply_goldens(name, fmt, fill):
    """The reference's `apply_*` goldens, driven from the copied cache."""
    w, h = (320, 240) if fmt == "yuy2" else (128, 96)
    dm = warp.upload(_mesh(gm, name, fmt, fill, w, h), CPU)
    got = warp.apply_bilinear(dm, _frames(_test_image(w, h, fmt)))
    with open(os.path.join(GOLD, f"apply_{name}_{fmt}_{w}x{h}_f{fill}.bin"),
              "rb") as f:
        assert got[0].numpy().tobytes() == f.read()


def test_apply_fill_goldens():
    """The two fill goldens, generated back to back in one process: the
    rand stream continues from the first cache into the second."""
    rand = gm.GlibcRand()
    for fmt, (w, h) in (("yuy2", (320, 240)), ("bgra", (128, 96))):
        _, mw, mh, steps = CASES["scale_out"]
        g = gm.GeoMesh(mw, mh)
        g.init(w, h, w * BPP[fmt], _fmt(gm, fmt), w, h, w * BPP[fmt],
               _fmt(gm, fmt), 1)
        g.transform_scale(*steps[0][1])
        g.cache_init_bilinear_range(0, h, rand)
        got = warp.apply_bilinear(warp.upload(g, CPU),
                                  _frames(_test_image(w, h, fmt)))
        with open(os.path.join(GOLD, f"apply_scale_out_{fmt}_{w}x{h}_f1.bin"),
                  "rb") as f:
            assert got[0].numpy().tobytes() == f.read()


def test_apply_refuses_a_frame_of_another_size():
    dm = warp.upload(_mesh(gm, "defish_pos", "rg48", 0, 96, 64), CPU)
    with pytest.raises(ValueError, match="bytes"):
        warp.apply_bilinear(dm, torch.zeros((1, 100), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# models.lens: warp_output and warp_decode
# ---------------------------------------------------------------------------

PARAMS = {
    "sphere": dict(lens_sphere=1, zoom=1.2, offset_x=-0.1, offset_y=-0.05,
                   offset_r=0.1),
    "planar_fill": dict(lens_fill=1, zoom=0.8, offset_r=0.2),
    "sphere_fill": dict(lens_sphere=1, lens_fill=1, zoom=0.9,
                        offset_r=-0.1, fish_fov=20.0),
}


def _params(mod, name):
    return mod.LensParams(**PARAMS[name])


@pytest.mark.parametrize("fourcc", ("YUY2", "BGRA", "W13A", "WP13", "RG48",
                                    "b64a"))
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_warp_output_matches_jax(name, fourcc):
    w, h = 96, 64
    bpp = {"YUY2": 2, "BGRA": 4, "W13A": 8, "WP13": 6, "RG48": 6,
           "b64a": 8}[fourcc]
    frame = np.random.default_rng(5).integers(0, 256, (h, w * bpp),
                                              np.uint8).tobytes()
    want = jlens.warp_output(_params(jlens, name), frame, w, h, fourcc)
    cache = {}
    got = lens.warp_output(_params(lens, name), _frames(frame), w, h, fourcc,
                           cache)
    assert got[0].numpy().tobytes() == want.tobytes()
    assert len(cache) == 1
    again = lens.warp_output(_params(lens, name), _frames(frame), w, h,
                             fourcc, cache)
    assert torch.equal(again, got)


@pytest.mark.parametrize("fourcc", ("YUY2", "WP13"))
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_warp_decode_matches_jax(name, fourcc):
    """The WP13 detour: the sample's WP13 decode warped, then converted to
    YUY2; the WP13 decode is the JAX host decoder's, the port's decode of
    the same bytes being held in tests/test_torch_outputs.py."""
    from cineform_tpu.models import intra_host

    sample = _lens_sample({})
    want = jlens.warp_decode(_params(jlens, name), sample, 96, 64, fourcc)
    wp13 = intra_host.decode_sample_to(sample, "WP13")
    got = lens.warp_decode(_params(lens, name), _frames(wp13).reshape(
        1, 64, -1), 96, 64, fourcc)
    assert got[0].numpy().tobytes() == want


def test_build_mesh_is_the_jax_one():
    for name in PARAMS:
        for (w, h) in ((96, 64), (160, 80), (128, 96)):
            a = jlens.build_mesh(_params(jlens, name), w, h, 2 * w, "YUY2")
            b = lens.build_mesh(_params(lens, name), w, h, 2 * w, "YUY2")
            assert a.meshx.tobytes() == b.meshx.tobytes()
            assert np.array_equal(a.cache, b.cache)


# ---------------------------------------------------------------------------
# The API's warp routes against the JAX API
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _jax_host(monkeypatch):
    """The JAX API on its host route."""
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")


def _lens_sample(tags, w=96, h=64, fmt="YUY2", flags=0, frames=1):
    """Frames encoded by the JAX API with the lens tags in the sample, as
    tests/test_warp_decode.py encodes them."""
    enc = japi.Encoder()
    encoded = {"YUY2": japi.EncodedFormat.YUV_422,
               "RG48": japi.EncodedFormat.RGB_444}[fmt]
    enc.prepare_to_encode(w, h, japi.PixelFormat[fmt], encoded,
                          japi.EncodingFlags(flags), japi.EncodingQuality(4))
    m = md.Metadata()
    for tag, value in tags.items():
        if isinstance(value, int):
            m.add(tag, value, md.TYPE_HIDDEN)
        else:
            m.add(tag, float(value))
    enc.attach_metadata(m)
    make = {"YUY2": yuy2_frame, "RG48": rg48_frame}[fmt]
    out = []
    for i in range(frames):
        enc.encode_sample(make(w, h, 3 + i))
        out.append(enc.get_sample_data())
    return out if frames > 1 else out[0]


def _decode(mod, kw, samples, fmt, w=0, h=0):
    """Each sample through one `mod.Decoder` -> its bytes, None, or the
    error code."""
    dec = mod.Decoder(**kw)
    dec.prepare_to_decode(w, h, mod.PixelFormat[fmt], sample=samples[0])
    out = []
    for s in samples:
        try:
            o = dec.decode_sample(s)
            out.append(None if o is None else o.tobytes())
        except mod.CFHDError as e:
            out.append(e.code.name)
    return out


def _same(samples, fmt, w=0, h=0):
    want = _decode(japi, {}, samples, fmt, w, h)
    got = _decode(api, {"device": "cpu"}, samples, fmt, w, h)
    assert got == want
    return got


@pytest.mark.parametrize("name", sorted(LENS_CASES))
def test_api_lens_cases_match_jax(name):
    """The six lens cases of tests/test_warp_decode.py at 320x240, decoded
    to YUY2 (the WP13 detour)."""
    out = _same([_lens_sample(LENS_CASES[name], 320, 240)], "YUY2")
    assert isinstance(out[0], bytes)


@pytest.mark.parametrize("fmt", ("YUY2", "UYVY", "BGRA", "RG48", "B64A",
                                 "WP13", "W13A", "YU64"))
def test_api_lens_outputs_match_jax(fmt):
    """sphere_stack to every output: the warped ones through the detour or
    the direct output's warp, UYVY and YU64 unwarped."""
    _same([_lens_sample(LENS_CASES["sphere_stack"])], fmt)


@pytest.mark.parametrize("fmt", ("YUY2", "RG48"))
def test_api_lens_fill_matches_jax(fmt):
    """LFIL=1: the fill draws, the blends and the vertical blur."""
    tags = {**LENS_CASES["sphere_stack"], "LFIL": 1, "ZOOM": 0.9}
    _same([_lens_sample(tags)], fmt)


@pytest.mark.parametrize("fmt,size", [("RG48", (64, 48)), ("YUY2", (64, 48)),
                                      ("BGRA", (128, 80))])
def test_api_lens_at_another_size_matches_jax(fmt, size):
    """A scaled decode warps the scaled output; the WP13 detour of YUY2
    takes only the sample's size: BADSAMPLE, as in JAX."""
    _same([_lens_sample(LENS_CASES["sphere_stack"])], fmt, *size)


@pytest.mark.parametrize("fmt", ("YUY2", "RG48", "WP13"))
def test_api_lens_group_matches_jax(fmt):
    """A lens GOP stream: the deep outputs warp, YUY2's detour fails on the
    group (BADSAMPLE), WP13 is no group output (BADFORMAT)."""
    samples = _lens_sample(LENS_CASES["planar_rotate"], flags=2, frames=4)
    _same(samples, fmt)


@pytest.mark.parametrize("fmt", ("WP13", "RG48", "YUY2"))
def test_api_lens_rgb_source_matches_jax(fmt):
    _same([_lens_sample(LENS_CASES["planar_rotate"], fmt="RG48")], fmt)


# ---------------------------------------------------------------------------
# The float resampler and its mesh builders
# ---------------------------------------------------------------------------

MESHES = {
    "identity": lambda m: m.mesh_identity(48, 64),
    "rotate": lambda m: m.mesh_rotate(48, 64, 17.0),
    "defish": lambda m: m.mesh_defish(48, 64, 110.0, 0.8),
    "repoint": lambda m: m.mesh_repoint_equirect(32, 64, 20.0, -10.0),
    "scale": lambda m: m.mesh_scale(m.mesh_identity(48, 64), 1.2, 0.9),
    "pan": lambda m: m.mesh_pan(m.mesh_identity(48, 64), 3.5, -2.0),
    "flip_h": lambda m: m.mesh_flip(m.mesh_identity(48, 64), True),
    "flip_v": lambda m: m.mesh_flip(m.mesh_identity(48, 64), False),
    "fisheye": lambda m: m.mesh_fisheye(48, 64, 70.0),
    "ortho": lambda m: m.mesh_orthographic(48, 64, 60.0),
    "stereo": lambda m: m.mesh_stereographic(48, 64, 80.0),
    "gopro_rect": lambda m: m.mesh_gopro_to_rectilinear(48, 64, 0.9),
    "hstretch": lambda m: m.mesh_horizontal_stretch_poly(
        m.mesh_identity(48, 64), 0.2, 0.1, 0.05),
    **{f"preset_{p}_{f}": (lambda m, p=p, f=f: m.mesh_gopro_preset(
        48, 64, p, f)) for p, f in jwarp.GOPRO_PRESETS},
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_builders_are_the_jax_ones(name):
    assert MESHES[name](warp).tobytes() == MESHES[name](jwarp).tobytes()


@pytest.mark.parametrize("wrap_x", (False, True))
@pytest.mark.parametrize("name", ("rotate", "defish", "repoint",
                                  "preset_hero4_superview"))
def test_warp_bilinear_matches_jax(name, wrap_x):
    mesh = MESHES[name](warp)
    h, w = mesh.shape[:2]
    img = np.random.default_rng(9).random((2, h, w, 3), np.float32)
    want = np.asarray(jwarp.warp_bilinear(jnp.asarray(img), jnp.asarray(mesh),
                                          wrap_x=wrap_x))
    got = warp.warp_bilinear(torch.from_numpy(img), torch.from_numpy(mesh),
                             wrap_x=wrap_x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

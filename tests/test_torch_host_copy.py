"""The port's own copy of the host path (`cineform_tpu_torch.spec`,
`bitstream`, `entropy.native`, `native`, `models.intra_host`,
`models.gop_host`, `models.thumbnail`, `models.lens`, `metadata`,
`models.active_metadata`'s develop parameters, `ref.intra`, `ref.gop`,
`ref.demosaic`, `ref.scaler`, `ref.geomesh`, `utils.glibc_random`,
`utils.override_db`, `utils.keyframes`, `testframes`, and the API's
constants), on the CPU.

The port imports nothing of the JAX package: no source names it, and the
slice runs where it cannot be imported.  Each copy equals its original on
the goldens and on seeded inputs, and a band that overflows its device
capacity is re-encoded from the device's coefficients into the bytes the
JAX package writes.  Every comparison is exact.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cineform_tpu import api as japi
from cineform_tpu import metadata as jmetadata
from cineform_tpu.bitstream import fastwalk as jfastwalk
from cineform_tpu.bitstream import parse_sample as jparse_sample
from cineform_tpu.entropy import native as jnative
from cineform_tpu.models import gop_host as jgop_host
from cineform_tpu.models import active_metadata as jam
from cineform_tpu.models import intra_host as jhost
from cineform_tpu.models import lens as jlens
from cineform_tpu.models import thumbnail as jthumbnail
from cineform_tpu.models.intra import IntraCodec as JaxIntraCodec
from cineform_tpu.ref import demosaic as jdemosaic
from cineform_tpu.ref import geomesh as jgeomesh
from cineform_tpu.ref import gop as jgop
from cineform_tpu.ref import intra as jref
from cineform_tpu.ref import scaler as jscaler
from cineform_tpu.spec import codebooks as jcb
from cineform_tpu.spec import production as jprod
from cineform_tpu.spec import tags as jtags
from cineform_tpu.utils import glibc_random as jglibc
from cineform_tpu.utils import keyframes as jkeyframes
from cineform_tpu.utils import lutpath as jlutpath
from cineform_tpu.utils import override_db as joverride
from cineform_tpu.spec import quant as jquant
from cineform_tpu.spec import wavelet as jwavelet
from cineform_tpu.utils import testframes as jframes
from cineform_tpu_torch import api as tapi
from cineform_tpu_torch import metadata as tmetadata
from cineform_tpu_torch import native as tnative_build
from cineform_tpu_torch import testframes as tframes
from cineform_tpu_torch.bitstream import fastwalk as tfastwalk
from cineform_tpu_torch.bitstream import parse_sample as tparse_sample
from cineform_tpu_torch.entropy import native as tnative
from cineform_tpu_torch.models import active_metadata as tam
from cineform_tpu_torch.models import gop_host as tgop_host
from cineform_tpu_torch.models import intra_host as thost
from cineform_tpu_torch.models import lens as tlens
from cineform_tpu_torch.models import thumbnail as tthumbnail
from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.ref import demosaic as tdemosaic
from cineform_tpu_torch.ref import geomesh as tgeomesh
from cineform_tpu_torch.ref import gop as tgop
from cineform_tpu_torch.ref import intra as tref
from cineform_tpu_torch.ref import scaler as tscaler
from cineform_tpu_torch.spec import codebooks as tcb
from cineform_tpu_torch.spec import production as tprod
from cineform_tpu_torch.spec import tags as ttags
from cineform_tpu_torch.utils import glibc_random as tglibc
from cineform_tpu_torch.utils import keyframes as tkeyframes
from cineform_tpu_torch.utils import lutpath as tlutpath
from cineform_tpu_torch.utils import override_db as toverride
from cineform_tpu_torch.spec import quant as tquant
from cineform_tpu_torch.spec import wavelet as twavelet
from tests.test_formats import _raw_fill
from tests.test_warp_geomesh import CASES as WARP_CASES

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "cineform_tpu_torch")
SAMPLES = os.path.join(REPO, "tests", "golden", "samples")
CPU = torch.device("cpu")
#: every golden sample: the parser and the walker are whole copies
GOLDENS = sorted(f[:-5] for f in os.listdir(SAMPLES) if f.endswith(".cfhd"))


def _read(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


def _port_sources():
    for root, _, files in os.walk(PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _plain(x):
    """A dataclass tree with numpy arrays made comparable with ==."""
    if dataclasses.is_dataclass(x):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    return x


# ---------------------------------------------------------------------------
# The port imports nothing of the JAX package
# ---------------------------------------------------------------------------

#: modules of the port that a later slice added, which the guards must see
NEW_MODULES = ("models/gop.py", "models/gop_host.py", "models/stereo.py",
               "ref/gop.py", "api.py", "pool.py", "models/thumbnail.py",
               "models/lens.py", "utils/override_db.py", "metadata.py",
               "models/active_metadata.py", "ops/demosaic.py",
               "ops/develop.py", "ops/scaler.py", "ops/warp.py",
               "ref/scaler.py", "ref/geomesh.py", "utils/lutpath.py",
               "ops/dwt.py", "ops/quant.py", "ops/pyramid.py",
               "spec/quant.py", "spec/wavelet.py", "parallel/__init__.py",
               "parallel/mesh.py", "parallel/dryrun.py",
               "utils/keyframes.py")


def test_port_sources_import_nothing_of_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports `cineform_tpu`
    or `jax`, at top level or inside a function; the GOP, stereo, API and
    pool modules, and the Bayer develop's, are among those checked."""
    sources = [os.path.relpath(p, PKG) for p in _port_sources()]
    assert set(NEW_MODULES) <= set(sources)
    found = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
                assert node.level == 0, (path, node.lineno)
            else:
                continue
            found += [(os.path.relpath(path, REPO), node.lineno, n)
                      for n in names
                      if n.split(".")[0] in ("cineform_tpu", "jax", "jaxlib")]
    assert found == []


_BLOCKED_RUN = r"""
import importlib, importlib.abc, os, pkgutil, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("cineform_tpu", "jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, Blocked())
import numpy as np, torch
import cineform_tpu_torch
for m in pkgutil.walk_packages(cineform_tpu_torch.__path__,
                               "cineform_tpu_torch."):
    importlib.import_module(m.name)
from cineform_tpu_torch.models.intra import IntraCodec, sample_metadata
from cineform_tpu_torch.testframes import yuy2_frame

samples = os.path.join("tests", "golden", "samples")
gold = open(os.path.join(samples, "s_64x48_q4_p1.cfhd"), "rb").read()
want = open(os.path.join(samples, "s_64x48_q4_p1.yuy2"), "rb").read()
c = IntraCodec(64, 48, 4, device=torch.device("cpu"))
f = np.frombuffer(yuy2_frame(64, 48, 1), np.uint8).reshape(1, 48, 128)
assert c.encode_batch_device(f, 1, sample_metadata(gold))[0] == gold
assert c.decode_batch([gold]).tobytes() == want
out, fallback = c.decode_batch_device([gold])
assert fallback == () and out.tobytes() == want
from cineform_tpu_torch.models.gop import GopCodec
group = open(os.path.join(samples, "gop_320x240_q4_p1.cfhd.f1"), "rb").read()
f0, fallback, _ = GopCodec(320, 240, 4, device="cpu").decode([group])
assert fallback == () and f0.tobytes() == open(os.path.join(
    samples, "gop_320x240_q4_p1.f0.yuy2"), "rb").read()
for name in ("gop", "gop_host", "stereo", "lens", "thumbnail",
             "active_metadata"):
    assert "cineform_tpu_torch.models." + name in sys.modules
from cineform_tpu_torch import api, pool
enc = api.Encoder("cpu")
enc.prepare_to_encode(64, 48, api.PixelFormat.YUY2)
enc.attach_metadata(sample_metadata(gold))
enc.encode_sample(yuy2_frame(64, 48, 1))
assert enc.get_sample_data() == gold
dec = api.Decoder("cpu")
dec.prepare_to_decode(0, 0, sample=gold)
assert dec.decode_sample(gold).tobytes() == want
p = pool.EncoderPool(1, 2, device="cpu")
p.prepare_to_encode(64, 48, api.PixelFormat.YUY2, use_device=False)
p.attach_metadata(sample_metadata(gold))
p.start()
p.encode_async_sample(1, yuy2_frame(64, 48, 1))
assert p.wait_for_sample(timeout=120).data == gold
p.stop()
p = pool.DecoderPool(device="cpu")
p.prepare_to_decode(64, 48)
p.start()
p.decode_async_sample(1, gold)
assert p.wait_for_frame(timeout=120).data.tobytes() == want
p.stop()
byr = open(os.path.join(samples, "byr4_wbal_320x240_q4.cfhd"), "rb").read()
dec = api.Decoder("cpu")
dec.prepare_to_decode(0, 0, api.PixelFormat.RG48, sample=byr)
assert dec.decode_sample(byr).tobytes() == open(os.path.join(
    samples, "byr4_wbal_320x240_q4.rg48out"), "rb").read()
dec = api.Decoder("cpu")
dec.prepare_to_decode(40, 30, api.PixelFormat.RG48)
assert dec.decode_sample(gold).shape == (30, 240)
dec = api.Decoder("cpu")
dec.prepare_to_decode(0, 0, api.PixelFormat.RG48, sample=group)
assert dec.decode_sample(group).tobytes() == open(os.path.join(
    samples, "gop_320x240_q4_p1.rg48out"), "rb").read()
for name in ("scaler", "warp", "dwt", "quant", "pyramid"):
    assert "cineform_tpu_torch.ops." + name in sys.modules
look = open(os.path.join(samples, "byr4_look_protune_96x64_q4.cfhd"),
            "rb").read()
dec = api.Decoder("cpu")
dec.prepare_to_decode(0, 0, api.PixelFormat.RG48, sample=look)
assert dec.decode_sample(look).tobytes() == open(os.path.join(
    samples, "byr4_look_protune_96x64_q4.rg48out"), "rb").read()
assert not [m for m in sys.modules
            if m.split(".")[0] in ("cineform_tpu", "jax", "jaxlib")]
print("ok")
"""


def test_port_runs_where_the_jax_package_cannot_be_imported():
    """In a fresh interpreter where importing `cineform_tpu` or `jax`
    raises, every port module imports, the 64x48 golden encodes and
    decodes byte for byte on both decode routes and through the API and
    the decoder pool, a GOP golden decodes on the device route, and a
    Bayer golden with a white balance, and one with the Protune LOOK,
    decode to RG48; the encoder pool's worker route encodes the golden
    too."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_native_libraries_build_outside_the_sources():
    for name in ("entropy", "samplewalk"):
        path = tnative_build.library_path(name)
        assert os.path.dirname(path) == tnative_build.BUILD_DIR
        assert os.path.exists(path)
    assert not [f for f in os.listdir(os.path.join(PKG, "native"))
                if f.endswith(".so")]


# ---------------------------------------------------------------------------
# Each copy against its original
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codeset", [9, 17, 18])
def test_codebooks_match(codeset):
    assert _plain(tcb.get_codeset(codeset)) == _plain(jcb.get_codeset(codeset))
    for t, j in ((tcb.build_valuebook, jcb.build_valuebook),
                 (tcb.build_runbook, jcb.build_runbook)):
        for a, b in zip(t(codeset), j(codeset), strict=True):
            np.testing.assert_array_equal(a, b)
    flags = tcb.CS_FLAGS[codeset]
    assert [tcb.expand_code(c, flags) for c in range(-300, 300)] == \
        [jcb.expand_code(c, flags) for c in range(-300, 300)]


def test_tags_match():
    names = [n for n in dir(jtags) if n.isupper()]
    assert [getattr(ttags, n) for n in names] == \
        [getattr(jtags, n) for n in names]


@pytest.mark.parametrize("quality", range(1, 7))
def test_production_params_match(quality):
    t = tprod.IntraParams(width=1920, height=1080, quality=quality)
    j = jprod.IntraParams(width=1920, height=1080, quality=quality)
    assert (t.precision, t.num_spatial, t.num_wavelets, t.prescale) == \
        (j.precision, j.num_spatial, j.num_wavelets, j.prescale)
    assert [t.band_quant(ch) for ch in range(3)] == \
        [j.band_quant(ch) for ch in range(3)]
    assert tprod.pack_prescale_table(t.prescale) == \
        jprod.pack_prescale_table(j.prescale)


@pytest.mark.parametrize("quality", range(1, 7))
@pytest.mark.parametrize("fmt", ["RG48", "B64A", "RG64"])
def test_rgb_production_params_match(fmt, quality):
    """The 12-bit params of the RGB formats (RG48 and RG64 with the luma
    tables for chroma, B64A without), as each package's `IntraCodec`
    makes them."""
    t = IntraCodec(1920, 1080, quality, device=CPU, input_format=fmt).params
    j = JaxIntraCodec(width=1920, height=1080, quality=quality,
                      input_format=fmt).params
    assert (t.precision, t.chroma_full_res, t.rgb_quality, t.prescale) == \
        (j.precision, j.chroma_full_res, j.rgb_quality, j.prescale)
    assert [t.band_quant(ch) for ch in range(4)] == \
        [j.band_quant(ch) for ch in range(4)]
    assert tprod.pack_prescale_table(t.prescale) == \
        jprod.pack_prescale_table(j.prescale)


@pytest.mark.parametrize("quality", range(1, 7))
@pytest.mark.parametrize("fmt", ["UYVY", "YU64", "V210", "BYR4", "BYR5"])
def test_new_format_params_and_tables_match(fmt, quality):
    """The params of the 10-bit 4:2:2 and Bayer formats as each package's
    `IntraCodec` makes them (Bayer: 12 bits, rgb_quality 3, the planes a
    quarter of the mosaic), and the codec tables built from them."""
    codec = IntraCodec(1920, 1080, quality, device=CPU, input_format=fmt)
    t = codec.params
    j = JaxIntraCodec(width=1920, height=1080, quality=quality,
                      input_format=fmt).params
    fields = ("width", "height", "quality", "precision", "chroma_full_res",
              "rgb_quality", "prescale")
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    assert [t.band_quant(ch) for ch in range(4)] == \
        [j.band_quant(ch) for ch in range(4)]
    tables = codec.tables()
    assert tables.prescale == tuple(j.prescale)
    assert tables.band_quant == tuple(
        tuple(tuple(q) for q in j.band_quant(ch))
        for ch in range(codec.num_channels))
    assert tuple(tables.dither_rows.shape) == (j.height, 16)


def test_new_format_host_tables_match():
    """The BYR4 encode curve and decode restore tables (float32 steps,
    bit for bit) and the absolute lowpass offsets."""
    np.testing.assert_array_equal(tref.byr4_log90_curve(),
                                  jref.byr4_log90_curve())
    got, want = tdemosaic.log2lin_lut(), jdemosaic.log2lin_lut()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for deep_yuv in (False, True):
        for frames in (1, 2):
            assert [thost.lowpass_offset_absolute(w, deep_yuv, frames)
                    for w in range(1, 40)] == \
                [jhost.lowpass_offset_absolute(w, deep_yuv, frames)
                 for w in range(1, 40)]


def test_output_host_tables_match():
    """The decoder outputs' host tables: the lowpass offsets of the deep
    outputs, the YUV->RGB multipliers (and the function that makes them),
    the 10-bit RGB word layouts, the R408 dither lanes, and the RG24 dither
    table that `_decode_sample_rg24` draws inline."""
    for deep in (False, True):
        for frames in (1, 2):
            assert [thost.lowpass_channel_offset(w, deep, frames)
                    for w in range(1, 300)] == \
                [jhost.lowpass_channel_offset(w, deep, frames)
                 for w in range(1, 300)]
    assert tref._YUV2RGB_CG709 == jref._YUV2RGB_CG709
    assert tref._YUV2RGB_CG601 == jref._YUV2RGB_CG601
    args = (1.2, 1.5, 0.7, 0.3, 2.2, (1, -2, 3, -4, 5, -6, 7, -8))
    assert tref._yuv2rgb_coeffs(*args) == jref._yuv2rgb_coeffs(*args)
    assert tref.RGB10_INPUT_FORMATS == jref.RGB10_INPUT_FORMATS
    for lanes in ("_R408_DITHER_EVEN", "_R408_DITHER_ODD"):
        got, want = getattr(thost, lanes), getattr(jhost, lanes)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for w, h in ((64, 48), (176, 6)):
        draws = jglibc.glibc_rand_sequence(w * h) & 0x7FFF
        order = [0, 1, h - 2, h - 1] + list(range(2, h - 2))
        want = np.empty((h, w), np.int64)
        for blk, r in enumerate(order):
            want[r] = draws[w * blk:w * (blk + 1)]
        np.testing.assert_array_equal(tref.rg24_dither(w, h), want)


@pytest.mark.parametrize("pattern", [0, 1, 2])
@pytest.mark.parametrize("w,h", [(96, 48), (112, 24)])
def test_new_frame_generators_match(w, h, pattern):
    for name in ("v210_frame", "yu64_frame", "byr4_frame"):
        assert getattr(tframes, name)(w, h, pattern) == \
            getattr(jframes, name)(w, h, pattern), name
    for got, want in zip(tframes.components10(w, h, pattern),
                         jframes.components10(w, h, pattern), strict=True):
        np.testing.assert_array_equal(got, want)
    # the UYVY frame as tests/test_formats.py builds the UYVY golden's
    quad = np.frombuffer(jframes.yuy2_frame(w, h, pattern),
                         np.uint8).reshape(-1, 4)
    assert tframes.uyvy_frame(w, h, pattern) == \
        quad[:, [1, 0, 3, 2]].tobytes()
    assert tframes.raw_fill(w * h * 3 // 2, pattern) == \
        _raw_fill(w * h * 3 // 2, pattern)


@pytest.mark.parametrize("name", GOLDENS)
def test_parser_and_walker_match_on_the_goldens(name):
    sample = _read(f"{name}.cfhd")
    assert _plain(tparse_sample(sample)) == _plain(jparse_sample(sample))
    got, want = tfastwalk.walk(sample), jfastwalk.walk(sample)
    assert _plain(got) == _plain(want)
    if want is None or not want.bands:
        return
    # the payload copy and the lowpass expansion of the walked sample
    offs, lens = zip(*[(o, n) for o, n, *_ in want.bands.values()])
    rows = np.arange(len(offs))
    bufs = [np.zeros((len(offs), max(lens)), np.uint8) for _ in range(2)]
    for lib, buf in zip((tfastwalk, jfastwalk), bufs):
        lib.fill_rows(buf, sample, np.asarray(offs), np.asarray(lens), rows)
    np.testing.assert_array_equal(*bufs)
    h, w = want.lowpass_h[0], want.lowpass_w[0]
    planes = [np.zeros((h, w), np.int32) for _ in range(2)]
    for lib, out in zip((tfastwalk, jfastwalk), planes):
        lib.lowpass_i32(sample, want.lowpass_off[0], h, w, -19, out)
    np.testing.assert_array_equal(*planes)


def _frames(w, h, patterns):
    return np.stack([np.frombuffer(tframes.yuy2_frame(w, h, p), np.uint8)
                     .reshape(h, 2 * w) for p in patterns])


@pytest.mark.parametrize("w,h,quality", [(64, 48, 4), (112, 48, 6),
                                         (144, 96, 1)])
def test_write_sample_and_band_coder_match(w, h, quality):
    """The copy's sample writer, with every band through the copy's C++
    coder, against the original's, on the original's transform."""
    jp = jprod.IntraParams(width=w, height=h, quality=quality)
    tp = tprod.IntraParams(width=w, height=h, quality=quality)
    planes = jref.unpack_yuy2(jframes.yuy2_frame(w, h, 2), w, h, jp.precision)
    chans = [jhost.transform_channel(p, jp, c) for c, p in enumerate(planes)]
    meta = jhost.EncoderMetadata().advanced(3)
    want = jhost.write_sample(chans, jp, 4, meta,
                              input_format=jtags.COLOR_FORMAT_YUYV)
    tchans = [thost.EncodedChannel(lowpass=c.lowpass, bands=c.bands,
                                   quants=c.quants) for c in chans]
    tmeta = thost.EncoderMetadata().advanced(3)
    assert tmeta.block() == meta.block()
    assert thost.write_sample(tchans, tp, 4, tmeta) == want


@pytest.mark.parametrize("fmt", ["RG48", "B64A", "RG64", "UYVY", "YU64",
                                 "V210", "BYR4", "BYR5"])
def test_write_sample_of_rgb_formats_matches(fmt):
    """The copy's sample writer with the RGB formats' keywords (a required
    input-format tag for RG48 and RG64, no colourspace, QUALITY_H 0x2000
    for RGBA, the required 12-bit prescale tag) against the original's, on
    the original's host transform of a test frame."""
    w, h = 64, 48
    codec = IntraCodec(w, h, 4, device=CPU, input_format=fmt)
    jcodec = JaxIntraCodec(width=w, height=h, quality=4, input_format=fmt)
    kwargs = codec._write_sample_kwargs
    assert kwargs == jcodec._write_sample_kwargs
    raw = np.random.default_rng(len(fmt)).integers(
        0, 256, h * codec.row_bytes).astype(np.uint8).tobytes()
    planes = jcodec._unpack_host(raw)
    chans = [jhost.transform_channel(p, jcodec.params, c)
             for c, p in enumerate(planes)]
    meta = jhost.EncoderMetadata().advanced(2)
    want = jhost.write_sample(chans, jcodec.params, 3, meta, **kwargs)
    tchans = [thost.EncodedChannel(lowpass=c.lowpass, bands=c.bands,
                                   quants=c.quants) for c in chans]
    assert thost.write_sample(tchans, codec.params, 3,
                              thost.EncoderMetadata().advanced(2),
                              **kwargs) == want


@pytest.mark.parametrize("codeset,density,quant", [(17, 0.3, 1), (17, 0.9, 7),
                                                   (18, 0.5, 300), (9, 0.2, 2)])
def test_native_band_coder_matches(codeset, density, quant):
    rng = np.random.default_rng(codeset + quant)
    vals = rng.integers(-900, 900, (40, 64)).astype(np.int32)
    vals[rng.random(vals.shape) >= density] = 0
    payload = tnative.encode_band_bytes(vals, codeset)
    assert payload == jnative.encode_band_bytes(vals, codeset)
    padded = payload + b"\0" * (-len(payload) % 4)
    got = tnative.decode_band(padded, vals.size, codeset, quant)
    want = jnative.decode_band(padded, vals.size, codeset, quant)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_host_helpers_match():
    assert [thost.align16_pixels(w) for w in range(1, 200)] == \
        [jhost.align16_pixels(w) for w in range(1, 200)]
    assert [thost.lowpass_channel_offset(w) for w in range(1, 300)] == \
        [jhost.lowpass_channel_offset(w) for w in range(1, 300)]
    np.testing.assert_array_equal(tglibc.glibc_rand_sequence(5000, 7),
                                  jglibc.glibc_rand_sequence(5000, 7))
    for height, frame_index in ((48, 0), (240, 3), (1080, 1)):
        np.testing.assert_array_equal(
            tref.decode_dither_rows(height, frame_index),
            jref.decode_dither_rows(height, frame_index))
    for pattern in (0, 1, 2):
        for name in ("yuy2_frame", "rg48_frame", "b64a_frame"):
            assert getattr(tframes, name)(112, 48, pattern) == \
                getattr(jframes, name)(112, 48, pattern)


# ---------------------------------------------------------------------------
# The overflow re-encode from the device's coefficients
# ---------------------------------------------------------------------------

def test_overflow_reencode_from_device_coefficients_matches_jax():
    """cap_bits=4 overflows some bands of the test pattern and every band
    of the noise frame: the host re-encodes those from the coefficients that
    `forward_packed` computed, and the samples equal the JAX package's
    `IntraCodec.encode_batch` (whose bands all go through the host coder)
    and the host encoder's."""
    w, h = 128, 64
    frames = _frames(w, h, [1])
    frames = np.concatenate([frames, np.random.default_rng(3).integers(
        0, 256, (1, h, 2 * w), dtype=np.uint8)])
    codec = IntraCodec(w, h, 4, device=CPU)
    packed = codec.forward_packed(torch.from_numpy(frames), cap_bits=4)
    ovf = np.stack([o.numpy() for _, levels in packed
                    for _, _, o, _ in levels], axis=1)    # (B, 9, 3)
    assert ovf[0].any() and not ovf[0].all() and ovf[1].all()
    got = codec.write_samples(frames, packed, 5)
    assert got == JaxIntraCodec(width=w, height=h, quality=4).encode_batch(
        frames, 5)
    for i in range(2):
        assert got[i] == jhost.encode_sample(
            frames[i].tobytes(), w, h, 4, frame_number=5 + i,
            metadata=jhost.EncoderMetadata().advanced(4 + i))


# ---------------------------------------------------------------------------
# The two-frame GOP's host copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quality", range(1, 7))
def test_gop_quality_tables_and_band_quant_match(quality):
    """`quality_tables(gop_length=2)` and the FIELDPLUS band quantizers,
    progressive and interlaced, scales and prescale table."""
    for precision in (jtags.PRECISION_10BIT, jtags.PRECISION_12BIT):
        assert tprod.quality_tables(quality, precision, gop_length=2) == \
            jprod.quality_tables(quality, precision, gop_length=2)
    for ch in range(3):
        for progressive in (True, False):
            assert tgop.fieldplus_band_quant(
                quality, ttags.PRECISION_10BIT, ch, progressive) == \
                jgop.fieldplus_band_quant(quality, jtags.PRECISION_10BIT, ch,
                                          progressive)
    assert tgop.fieldplus_band_scales() == jgop.fieldplus_band_scales()
    assert tgop.FIELDPLUS_PRESCALE == jgop.FIELDPLUS_PRESCALE


def test_gop_host_helpers_match():
    """The subband map, the band-end marker, the two-frame lowpass offsets
    and the interlaced output's draws (the windows `decode_group` cuts)."""
    assert tgop_host.SUBBAND_MAP == jgop_host.SUBBAND_MAP
    assert tgop_host.BANDEND_MARKER == jgop_host._bandend_marker()
    for frames in (1, 2):
        assert [thost.lowpass_channel_offset(w, num_frames=frames)
                for w in range(1, 300)] == \
            [jhost.lowpass_channel_offset(w, num_frames=frames)
             for w in range(1, 300)]
    height, base = 48, 3
    pairs = height // 2
    seq = jglibc.glibc_rand_sequence(16 * pairs * (base + 2)) & 1
    for f in (0, 1):
        np.testing.assert_array_equal(
            tgop.interlaced_dither_rows(height, base + f),
            seq[16 * pairs * (base + f):16 * pairs * (base + f + 1)]
            .reshape(pairs, 16))


@pytest.mark.parametrize("w,h,quality", [(96, 48, 4), (144, 48, 6),
                                         (320, 240, 1)])
def test_write_group_matches(w, h, quality):
    """The copy's GROUP writer, with every band through the copy's C++
    coder, against the original's, on the original's FIELDPLUS transform
    of two frames."""
    f0 = jref.unpack_yuy2(jframes.yuy2_frame(w, h, 1), w, h)
    f1 = jref.unpack_yuy2(jframes.yuy2_frame(w, h, 2), w, h)
    chans = []
    for ch in range(3):
        bq = jgop.fieldplus_band_quant(quality, jtags.PRECISION_10BIT, ch)
        lowpass, bands = jgop.forward_channel_gop(f0[ch], f1[ch], bq)
        chans.append((lowpass, bands, bq))
    meta = jhost.EncoderMetadata().advanced(2)
    tmeta = thost.EncoderMetadata().advanced(2)
    assert tgop_host.write_group(chans, w, h, quality, 3, tmeta) == \
        jgop_host.write_group(chans, w, h, quality, 3, meta)


def test_stereo_metadata_and_eye_headers_match():
    """The VCHN tuple of a stereo sample's metadata and an eye's header
    tags, as the original's `write_sample` writes them."""
    jp = jprod.IntraParams(width=64, height=48, quality=4)
    tp = tprod.IntraParams(width=64, height=48, quality=4)
    planes = jref.unpack_yuy2(jframes.yuy2_frame(64, 48, 1), 64, 48)
    chans = [jhost.transform_channel(p, jp, c) for c, p in enumerate(planes)]
    tchans = [thost.EncodedChannel(lowpass=c.lowpass, bands=c.bands,
                                   quants=c.quants) for c in chans]
    meta = jhost.EncoderMetadata(video_channels=2)
    tmeta = thost.EncoderMetadata(video_channels=2)
    for eye in (0, 1):
        assert thost.write_sample(tchans, tp, 1, tmeta, eye=eye) == \
            jhost.write_sample(chans, jp, 1, meta, video_channels=2,
                               channel_number=eye)


# ---------------------------------------------------------------------------
# The API's copies: the constants users pass, and the host pieces the API
# reads
# ---------------------------------------------------------------------------

API_ENUMS = ("ErrorCode", "PixelFormat", "EncodedFormat", "EncodingQuality",
             "DecodedResolution", "EncodingFlags", "DecodingFlags")


@pytest.mark.parametrize("name", API_ENUMS)
def test_api_enums_match(name):
    """Every member of the API's enums, by name and value, as users pass
    them."""
    t, j = getattr(tapi, name), getattr(japi, name)
    assert [(m.name, int(m.value)) for m in t] == \
        [(m.name, int(m.value)) for m in j]
    assert dict(t.__members__.items()).keys() == j.__members__.keys()


def test_api_error_and_sample_info_match():
    assert [f.name for f in dataclasses.fields(tapi.SampleInfo)] == \
        [f.name for f in dataclasses.fields(japi.SampleInfo)]
    for code in japi.ErrorCode:
        for msg in ("", "bad"):
            assert str(tapi.CFHDError(tapi.ErrorCode(code), msg)) == \
                str(japi.CFHDError(code, msg))
    assert tapi.Decoder.OUTPUT_FORMATS == tuple(
        tapi.PixelFormat(int(f)) for f in japi.Decoder.OUTPUT_FORMATS)
    assert tapi.Encoder.INPUT_FORMATS == tuple(
        tapi.PixelFormat(int(f)) for f in japi.Encoder.INPUT_FORMATS)


@pytest.mark.parametrize("name", ["s_320x240_q4_p1", "s_640x360_q5_p1",
                                  "s_112x48_q4_p1", "s_144x96_q4_p1"])
def test_thumbnail_matches(name):
    sample = _read(f"{name}.cfhd")
    assert tthumbnail.extract(sample) == jthumbnail.extract(sample)


def _tuple(tag: bytes, typ: bytes, payload: bytes) -> bytes:
    return (tag + len(payload).to_bytes(3, "little") + typ + payload
            + b"\0" * (-len(payload) % 4))


def _u32(v: int) -> bytes:
    return v.to_bytes(4, "little")


#: metadata blocks: overrides, a proxy copy, short payloads, a zero tag
OVERRIDE_BLOCKS = [
    b"",
    _tuple(b"LYUV", b"H", _u32(1)) + _tuple(b"CV67", b"H", _u32(2)),
    _tuple(b"CLSY", b"L", _u32(2)) + _tuple(b"PRXY", b"L", _u32(1))
    + _tuple(b"LYUV", b"H", _u32(1)),
    _tuple(b"IGND", b"L", _u32(1)) + _tuple(b"ECRV", b"L", b"\1\2"),
    _tuple(b"GUID", b"G", b"\xa5" * 16) + b"\0" * 8
    + _tuple(b"BFMT", b"L", _u32(3)),
    _tuple(b"VDCH", b"L", _u32(2)) + b"\x01\x02\x03",
]


def test_override_db_matches(tmp_path, monkeypatch):
    """The paths, the disk blocks, the tuple walk and the overrides, with
    and without disk blocks."""
    monkeypatch.setenv("CINEFORM_OVERRIDE_PATH", str(tmp_path / "pub"))
    monkeypatch.setenv("CINEFORM_LUT_PATH", str(tmp_path / "luts"))
    monkeypatch.setenv("CINEFORM_DB_PATH", "db")
    assert toverride.default_paths() == joverride.default_paths()
    assert toverride.load_disk_blocks() == joverride.load_disk_blocks() \
        == (b"", b"")
    os.makedirs(tmp_path / "pub")
    os.makedirs(tmp_path / "luts" / "db")
    (tmp_path / "luts" / "db" / "defaults.colr").write_bytes(
        OVERRIDE_BLOCKS[2])
    (tmp_path / "pub" / "override.colr").write_bytes(OVERRIDE_BLOCKS[1])
    assert toverride.load_disk_blocks() == joverride.load_disk_blocks() \
        == (OVERRIDE_BLOCKS[2], OVERRIDE_BLOCKS[1])
    for block in OVERRIDE_BLOCKS:
        assert list(toverride.iter_tuples(block)) == \
            list(joverride.iter_tuples(block))
        assert toverride.parse_overrides(block) == \
            joverride.parse_overrides(block)
    assert toverride.parse_overrides(*OVERRIDE_BLOCKS) == \
        joverride.parse_overrides(*OVERRIDE_BLOCKS)
    assert toverride.OVERRIDE_TAGS == joverride.OVERRIDE_TAGS


@pytest.mark.parametrize("w,h", [(320, 240), (1920, 1080), (64, 48)])
def test_gop_stream_headers_match(w, h):
    """The copies take a YUY2 stream, the format the API's GOP encode
    takes: the JAX writer at that format."""
    assert tgop_host.sequence_header(w, h) == \
        jgop_host.sequence_header(w, h, jtags.COLOR_FORMAT_YUYV)
    for n in (1, 3, 2 ** 20 + 1):
        assert tgop_host.frame_header_sample(w, h, n) == \
            jgop_host.frame_header_sample(w, h, n)


def _f32(v: float) -> bytes:
    return np.float32(v).tobytes()


#: lens and framing tuples: none, each doMesh trigger, clamps, sources
LENS_BLOCKS = [
    b"",
    _tuple(b"LSPH", b"L", _u32(1)),
    _tuple(b"LGPR", b"L", _u32(0)) + _tuple(b"LSPH", b"L", _u32(1)),
    _tuple(b"LGPR", b"L", _u32(2)) + _tuple(b"ZOOM", b"f", _f32(9.0)),
    _tuple(b"LFIL", b"L", _u32(1)) + _tuple(b"OFFX", b"f", _f32(0.7))
    + _tuple(b"OFFF", b"f", _f32(-120.0)),
    _tuple(b"LFIL", b"L", _u32(1)) + _tuple(b"ZOOM", b"f", _f32(0.5)),
    _tuple(b"OFFR", b"f", _f32(0.02)) + _tuple(b"HSCL", b"f", _f32(1.25)),
    _tuple(b"OFFR", b"f", _f32(0.005)),
    _tuple(b"LSPH", b"L", _u32(1)) + _tuple(b"LSRC", b"f", _f32(0.5) * 6)
    + _tuple(b"LDST", b"f", _f32(-0.25) * 6) + _tuple(b"LSTL", b"L",
                                                      _u32(3)),
]


@pytest.mark.parametrize("i", range(len(LENS_BLOCKS)))
def test_lens_decision_matches(i):
    """`parse_lens_metadata` on a sample whose metadata holds the block:
    the same doMesh decision and parameters."""
    @dataclasses.dataclass
    class Extra(jhost.EncoderMetadata):
        def block(self) -> bytes:
            return super().block() + LENS_BLOCKS[i]

    sample = jhost.encode_sample(jframes.yuy2_frame(64, 48, 1), 64, 48, 4,
                                 metadata=Extra())
    want = jlens.parse_lens_metadata(sample)
    got = tlens.parse_lens_metadata(sample)
    assert (got is None) == (want is None) == (i in (0, 7))
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tlens.parse_lens_metadata(
        sample, tparse_sample(sample)) == got


@pytest.mark.parametrize("quality", [4, 5, 6, 0x105, 7])
def test_fs_rate_limiter_update_matches(quality):
    """The per-frame limiter update over limiters, sizes and sample
    lengths (compression ratios from 1.2 to 9 of the 4:4:4 size, so 0.8
    to 6 of the 4:2:2 one), against the JAX function at the copy's fixed
    frame: 3 channels, 10 bits, 4:2:2 chroma."""
    for limiter in (0, 4, 8, 19, 20):
        for w, h in ((320, 240), (1920, 1080)):
            raw = w * h * 3 * 10 // 8
            for ratio in (1.2, 1.6, 2.2, 2.7, 3.2, 3.8, 4.2, 5.0, 5.8, 6.8,
                          7.8, 9.0, 10.5, 12.0):
                args = (limiter, quality, int(raw / ratio), w, h)
                assert tprod.update_fs_rate_limiter(*args) == \
                    jprod.update_fs_rate_limiter(
                        *args, num_channels=3, precision_bits=10,
                        chroma_full_res=False)
    assert tprod.update_fs_rate_limiter(8, quality, 0, 320, 240) == \
        jprod.update_fs_rate_limiter(8, quality, 0, 320, 240)


@pytest.mark.parametrize("quality", [5, 6])
def test_production_params_with_the_rate_limiter_match(quality):
    """The band quantizers at every limiter the rate control reaches, 10
    and 12 bits, and the codec's tables built from them."""
    for limiter in (None, 0, 3, 8, 16, 20):
        for precision, full in ((ttags.PRECISION_10BIT, False),
                                (ttags.PRECISION_12BIT, True)):
            t = tprod.IntraParams(320, 240, quality, precision=precision,
                                  chroma_full_res=full,
                                  fs_rate_limiter=limiter)
            j = jprod.IntraParams(320, 240, quality, precision=precision,
                                  chroma_full_res=full,
                                  fs_rate_limiter=limiter)
            assert [t.band_quant(ch) for ch in range(3)] == \
                [j.band_quant(ch) for ch in range(3)]
        codec = IntraCodec(320, 240, quality, device=CPU,
                           fs_rate_limiter=limiter)
        assert codec.tables().band_quant == tuple(
            tuple(tuple(q) for q in jprod.IntraParams(
                320, 240, quality, fs_rate_limiter=limiter).band_quant(ch))
            for ch in range(3))


# ---------------------------------------------------------------------------
# The Bayer develop's host pieces: metadata, develop parameters, tables
# ---------------------------------------------------------------------------

#: the goldens whose metadata carries develop tuples, and two without
DEVELOP_GOLDENS = sorted(g for g in GOLDENS if g.startswith("byr4_")) + [
    "s_320x240_q4_p1", "gop_320x240_q4_p1"]


def _develop_golden(name):
    return _read(name + (".cfhd.f1" if name.startswith("gop") else ".cfhd"))


@pytest.mark.parametrize("name", DEVELOP_GOLDENS)
def test_metadata_reader_and_develop_params_match(name):
    """`read_metadata` and `develop_params` of the goldens, alone and with
    a database that overrides the PRCS flags, equal the originals."""
    sample = _develop_golden(name)
    got = [dataclasses.astuple(i) for i in tmetadata.read_metadata(sample)]
    assert got == [(i.tag, i.typ, i.payload)
                   for i in jmetadata.read_metadata(sample)]
    assert tmetadata.read_metadata(sample, tparse_sample(sample)) == \
        tmetadata.read_metadata(sample)
    for flags in (None, 1, 1 | 2, 1 | 4 | 8 | 32, 0x3F):
        db = None if flags is None else [
            ("PRCS", b"L", flags.to_bytes(4, "little")),
            ("WBAL", b"f", np.float32([1.5, 1.0, 1.0, 0.3]).tobytes()),
            ("SATU", b"f", np.float32([12.0]).tobytes()),
            ("GAMT", b"f", np.float32([0.1, 2.0]).tobytes())]
        want = jam.develop_params(sample, None if db is None else
                                  [jmetadata.MetadataItem(*i) for i in db])
        got = tam.develop_params(sample, None if db is None else
                                 [tmetadata.MetadataItem(*i) for i in db])
        assert _plain(got) == _plain(want)


def test_develop_tables_and_matrix_match():
    """The curve tables, the white balance conditioning, NeedCube's
    matrix composition over saturations, exposures, gains and COLM, the
    row parity and the YUYV coefficients equal the originals; the inverse
    LOG-90 table gives `decode_sample_bayer`'s quarter-res linear RGB."""
    for fn in ("log2lin_lut", "curve2linear_lut", "linear2curve_lut"):
        np.testing.assert_array_equal(getattr(tdemosaic, fn)(),
                                      getattr(jdemosaic, fn)())
    rng = np.random.default_rng(21)
    for _ in range(20):
        wb = rng.uniform(0.1, 12.0, 3)
        np.testing.assert_array_equal(tdemosaic.normalize_white_balance(wb),
                                      jdemosaic.normalize_white_balance(wb))
    for colm in (None, rng.uniform(-1, 2, (3, 4))):
        for sat in (0.0, 0.5, 1.0, 2.5, 11.0):
            for exp in (0.25, 1.0, 11.0):
                for wb in (None, (1.0, 1.0, 1.0), tuple(rng.uniform(0.3, 11,
                                                                    3))):
                    np.testing.assert_array_equal(
                        tdemosaic.compose_develop_matrix(colm, sat, exp, wb),
                        jdemosaic.compose_develop_matrix(colm, sat, exp, wb))
    for h in (2, 64, 240, 2160):
        np.testing.assert_array_equal(tdemosaic.bayer_yuyv_parity(h),
                                      jdemosaic.bayer_yuyv_parity(h))
    assert tdemosaic._RGB2YUV_709 == jdemosaic._RGB2YUV_709
    assert tdemosaic._RGB2YUV_VS709 == jdemosaic._RGB2YUV_VS709
    sample = _read("byr4_320x240_q4_p1.cfhd")
    codec = IntraCodec(320, 240, 4, device=CPU, input_format="BYR4")
    got = codec.inverse_bayer_linear(codec.host_entropy_decode([sample]))
    np.testing.assert_array_equal(got[0].numpy(),
                                  jhost.decode_sample_bayer(sample)[0])


# ---------------------------------------------------------------------------
# The geometry stage's host pieces: the Lanczos taps and the GeoMesh
# ---------------------------------------------------------------------------

#: (input, output) lengths of the scaler goldens' axes and of the 1080p
#: geometry phase's scales
SCALES = [(320, 200), (240, 150), (320, 480), (240, 360), (320, 211),
          (240, 157), (128, 80), (96, 60), (128, 81), (96, 63), (128, 200),
          (96, 150), (160, 200), (1920, 1280), (1920, 3840), (1080, 720),
          (1080, 2160), (2000, 333), (7, 5)]


@pytest.mark.parametrize("n_in,n_out", SCALES)
def test_lanczos_tap_tables_match(n_in, n_out):
    """The device scaler's padded tap table of every output line equals
    the JAX package's `lanczos_coeff` taps, the padding index 0 with mix
    0; the copy's own `lanczos_coeff` and factor wrappers equal theirs."""
    index, mix = tscaler.tap_table(n_in, n_out, 3, CPU)
    for line in range(n_out):
        want = jscaler.lanczos_coeff(n_in, n_out, line)
        n = len(want)
        assert [(int(a), int(b)) for a, b in zip(index[line, :n],
                                                 mix[line, :n])] == want
        assert not mix[line, n:].any() and not index[line, n:].any()
    for line in range(0, n_out, max(1, n_out // 5)):
        assert tscaler.lanczos_coeff(n_in, n_out, line) == \
            jscaler.lanczos_coeff(n_in, n_out, line)
        assert tscaler.column_scale_factors(line, n_in, n_out) == \
            jscaler.column_scale_factors(line, n_in, n_out)
        assert tscaler.column_scale_factors(line, n_in, n_out, 1) == \
            jscaler.column_scale_factors(line, n_in, n_out, 1)


def test_scaler_factor_wrappers_match():
    assert tscaler.row_scale_factors(160, 211) == \
        jscaler.row_scale_factors(160, 211)
    for args in ((1920, 1080, 960, 540), (1920, 1080, 961, 540),
                 (1920, 1080, 100, 100), (320, 240, 480, 360)):
        assert tscaler.decoded_scale(*args) == jscaler.decoded_scale(*args)


def _geomesh(mod, name, fill=0, fmt="YUY2"):
    (w, h), mw, mh, steps = WARP_CASES[name]
    f = getattr(mod, "FORMAT_" + fmt)
    bpp = mod._FMTINFO[f][0]
    g = mod.GeoMesh(mw, mh)
    g.init(w, h, w * bpp, f, w, h, w * bpp, f, fill)
    for t, args in steps:
        if t == "set_custom_lens":
            g.set_custom_lens(*args)
        else:
            getattr(g, "transform_" + t)(*args)
    return g, w, h


@pytest.mark.parametrize("name", sorted(WARP_CASES))
def test_geomesh_matches_and_meets_the_mesh_goldens(name):
    """Every transform stack of the warp goldens: the copy's mesh nodes
    equal the JAX model's and the reference's `mesh_*.f32` goldens, bit
    for bit; its `interp_bilinear` on every destination pixel and both
    cache inits (without and with backgroundfill, RG48 and YUY2) equal
    the JAX model's."""
    ours, w, h = _geomesh(tgeomesh, name)
    want, _, _ = _geomesh(jgeomesh, name)
    with open(os.path.join(REPO, "tests", "golden", "warp",
                           f"mesh_{name}_{w}x{h}.f32"), "rb") as f:
        raw = f.read()
    n = ours.meshwidth * ours.meshheight
    assert ours.meshx.tobytes() == raw[:4 * n] == want.meshx.tobytes()
    assert ours.meshy.tobytes() == raw[4 * n:] == want.meshy.tobytes()
    rows, cols = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
    for a, b in zip(ours.interp_bilinear(rows, cols),
                    want.interp_bilinear(rows, cols)):
        assert a.tobytes() == b.tobytes()
    assert np.array_equal(ours.cache_init_bilinear().cache,
                          want.cache_init_bilinear().cache)
    for fill in (0, 1):
        for fmt in ("RG48", "YUY2"):
            ours, _, _ = _geomesh(tgeomesh, name, fill, fmt)
            want, _, _ = _geomesh(jgeomesh, name, fill, fmt)
            ours.cache_init_bilinear_range(0, h, tgeomesh.GlibcRand())
            want.cache_init_bilinear_range(0, h, jgeomesh.GlibcRand())
            assert np.array_equal(ours.cache, want.cache)


def test_glibc_rand_stream_matches():
    ours, want = tgeomesh.GlibcRand(5, prefetch=8), jgeomesh.GlibcRand(
        5, prefetch=8)
    assert [ours.next() for _ in range(40)] == [want.next() for _ in range(40)]


@pytest.mark.parametrize("i", range(len(LENS_BLOCKS)))
@pytest.mark.parametrize("w,h", [(96, 64), (160, 80), (128, 96)])
def test_lens_build_mesh_matches(i, w, h):
    """`build_mesh` of each lens block's parameters, at a 16:9-ish, a 2:1
    (equirect) and a 4:3 size: the same mesh and cache."""
    @dataclasses.dataclass
    class Extra(jhost.EncoderMetadata):
        def block(self) -> bytes:
            return super().block() + LENS_BLOCKS[i]

    sample = jhost.encode_sample(jframes.yuy2_frame(64, 48, 1), 64, 48, 4,
                                 metadata=Extra())
    want = jlens.parse_lens_metadata(sample)
    if want is None:
        return
    got = tlens.parse_lens_metadata(sample)
    a = jlens.build_mesh(want, w, h, 6 * w, "RG48")
    b = tlens.build_mesh(got, w, h, 6 * w, "RG48")
    assert a.meshx.tobytes() == b.meshx.tobytes()
    assert a.meshy.tobytes() == b.meshy.tobytes()
    assert np.array_equal(a.cache, b.cache)



# ---------------------------------------------------------------------------
# The encoder options' host copies
# ---------------------------------------------------------------------------

#: caller tables: coarse, the finest, and a distinct chroma table
CUSTOM_TABLES = [([4] + [12] * 16, [4] + [12] * 16),
                 ([1] * 17, [2] * 17),
                 (list(range(1, 18)), list(range(40, 6, -2)))]


@pytest.mark.parametrize("gop_length", [1, 2])
@pytest.mark.parametrize("precision", [8, 10, 12])
def test_custom_quant_tables_match(precision, gop_length):
    """`custom_quant_tables` over the precisions, GOP lengths, RGB
    qualities and chroma resolutions, and the intra band quantizers that
    `IntraParams(custom_quant=)` derives from them."""
    for y, c in CUSTOM_TABLES:
        for rgb_quality in range(5):
            for full in (False, True):
                got = tprod.custom_quant_tables(y, c, precision, gop_length,
                                                full, rgb_quality)
                assert got == jprod.custom_quant_tables(
                    y, c, precision, gop_length, full, rgb_quality)
                t = tprod.IntraParams(width=64, height=48, quality=4,
                                      precision=precision,
                                      custom_quant=tuple(map(tuple, got)))
                j = jprod.IntraParams(width=64, height=48, quality=4,
                                      precision=precision, custom_quant=got)
                assert [t.band_quant(ch) for ch in range(3)] == \
                    [j.band_quant(ch) for ch in range(3)]


def test_rgb10_input_formats_match():
    assert tref.RGB10_INPUT_FORMATS == jref.RGB10_INPUT_FORMATS


@pytest.mark.parametrize("later_form", [None, False, True])
@pytest.mark.parametrize("frame_number", [1, 4])
def test_write_sample_uncompressed_matches(frame_number, later_form):
    """The passthrough's raw sample, in both header forms (and the form
    the frame number picks), against the original's."""
    w, h = 96, 48
    raw = tframes.v210_frame(w, h, frame_number)
    meta = jhost.EncoderMetadata().advanced(frame_number - 1)
    tmeta = thost.EncoderMetadata().advanced(frame_number - 1)
    assert thost.write_sample_uncompressed(
        raw, w, h, 0x0404, frame_number, tmeta, 10,
        later_form=later_form) == jhost.write_sample_uncompressed(
            raw, w, h, 0x0404, frame_number, meta, 10, later_form=later_form)


@pytest.mark.parametrize("quality_word", [0x0004, 0x0404, 0x0805, 0x1004])
def test_uncompressed_decision_matches(quality_word):
    """The per-frame decision over a 40-frame window, with the window's
    state, against the original's."""
    last_t, last_j, picks = [0] * 16, [0] * 16, []
    for f in range(40):
        head = int.from_bytes(tframes.v210_frame(48, 8, f)[:4], "little")
        block = thost.EncoderMetadata().advanced(f).block() if f % 3 else b""
        got = thost.uncompressed_decision(head, block, quality_word, last_t)
        assert got == jhost.uncompressed_decision(head, block, quality_word,
                                                  last_j)
        assert last_t == last_j
        picks.append(got)
    assert any(picks) == bool(quality_word & 0x1F00)


def test_quality_relabel_matches():
    """The fallback frame's QUALITY_L relabel: the port's `relabel_quality`
    of a q5 sample equals the original's `encode_sample_planes` with
    quality_tag 6."""
    w, h = 96, 48
    planes = jref.unpack_v210(tframes.v210_frame(w, h, 2), w, h)
    meta = jhost.EncoderMetadata()
    want = jhost.encode_sample_planes(planes, w, h, 5, 10, 1, meta,
                                      quality_tag=6)
    params = jprod.IntraParams(width=w, height=h, quality=5)
    chans = [jhost.transform_channel(p, params, c)
             for c, p in enumerate(planes)]
    tchans = [thost.EncodedChannel(lowpass=c.lowpass, bands=c.bands,
                                   quants=c.quants) for c in chans]
    sample = thost.write_sample(
        tchans, tprod.IntraParams(width=w, height=h, quality=5), 1,
        thost.EncoderMetadata(), input_format=10)
    assert sample != want
    assert thost.relabel_quality(sample, 5, 6) == want
    assert thost.relabel_quality(sample, 5, 5) == sample


@pytest.mark.parametrize("w,h,quality,peaks", [(96, 48, 4, False),
                                               (320, 240, 1, False),
                                               (192, 120, 6, True)])
def test_interlaced_write_group_matches(w, h, quality, peaks):
    """The copy's GROUP writer for an interlaced group (no SAMPLE_FLAGS,
    the frame wavelets' HL bands with codeset 18 and, where a value passes
    250, a peaks table) against the original's, on the original's
    interlaced transform of two frames."""
    f0 = jref.unpack_yuy2(jframes.yuy2_frame(w, h, 5), w, h)
    f1 = jref.unpack_yuy2(jframes.yuy2_frame(w, h, 6), w, h)
    chans = []
    for ch in range(3):
        bq = jgop.fieldplus_band_quant(quality, jtags.PRECISION_10BIT, ch,
                                       progressive=False)
        lowpass, bands = jgop.forward_channel_gop(f0[ch], f1[ch], bq,
                                                  progressive=False)
        if peaks:
            hl = bands[0][1].copy()
            hl[::5, ::7] = np.where(hl[::5, ::7] >= 0, 300, -400)
            bands[0] = (bands[0][0], hl, bands[0][2])
        chans.append((lowpass, bands, bq))
    meta = jhost.EncoderMetadata().advanced(2)
    tmeta = thost.EncoderMetadata().advanced(2)
    got = tgop_host.write_group(chans, w, h, quality, 3, tmeta,
                                progressive=False)
    assert got == jgop_host.write_group(chans, w, h, quality, 3, meta,
                                        progressive=False)
    if peaks:
        assert any(b.peaks is not None
                   for c in tparse_sample(got).channels for b in c.bands)


# ---------------------------------------------------------------------------
# The develop stages' host pieces: tables, weights, looks and cubes
# ---------------------------------------------------------------------------

#: BLSH values of both signs across every case of both passes
BLSH = [0.0, 0.05, 0.2, 0.37, 0.5, 0.61, 0.8, 0.99, 1.0, 1.5, -0.05, -0.1,
        -0.25, -0.3, -0.5, -0.6, -0.75, -0.9, -1.0]


@pytest.mark.parametrize("gamma,contrast", [(1.0, 1.0), (0.8, 1.0),
                                            (2.2, 1.0), (1.0, 1.4),
                                            (1.3, 0.6), (0.45, 2.0)])
def test_gamma_tables_match(gamma, contrast):
    np.testing.assert_array_equal(
        tdemosaic.gamma_contrast_lut(gamma, contrast),
        jdemosaic.gamma_contrast_lut(gamma, contrast))
    np.testing.assert_array_equal(
        tdemosaic._gammatweak_table(gamma, contrast),
        jdemosaic._gammatweak_table(gamma, contrast))
    v = np.linspace(-1.2, 4.2, 997).astype(np.float32)
    np.testing.assert_array_equal(tdemosaic._calc_contrast(v, contrast),
                                  jdemosaic._calc_contrast(v, contrast))


def test_sharpening_weights_and_coefficients_match():
    for s in BLSH:
        fs, w = tdemosaic._sharpen_wp13_weights(s)
        jfs, jw = jdemosaic._sharpen_wp13_weights(s)
        assert fs == jfs, s
        np.testing.assert_array_equal(w, jw)
        assert tdemosaic._sharpen_h_coeffs(s) == \
            jdemosaic._sharpen_h_coeffs(s), s


def _cflook():
    return jlutpath.read_cflook(os.path.join(SAMPLES, "DEADBEEF.cflook"))


def test_looks_and_curves_match():
    assert tdemosaic.PROTUNE_LOOK_CRC == jdemosaic.PROTUNE_LOOK_CRC
    np.testing.assert_array_equal(tdemosaic._PROTUNE_CURVE,
                                  jdemosaic._PROTUNE_CURVE)
    got, want = tdemosaic.protune_look_lut(), jdemosaic.protune_look_lut()
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(tdemosaic._curve2lin_table(),
                                  jdemosaic._curve2lin_table())
    np.testing.assert_array_equal(tdemosaic._lin2curve_table(),
                                  jdemosaic._lin2curve_table())
    table = jdemosaic._gammatweak_table(1.7)
    v = np.linspace(-1.0, 4.0, 1001).astype(np.float32)
    np.testing.assert_array_equal(tdemosaic._lerp512(table, v),
                                  jdemosaic._lerp512(table, v))


#: (matrix, rgb gamma, contrast) of the developed cubes
CUBE_DEVELOPS = [
    (None, (1.0, 1.0, 1.0), 1.0),
    (None, (0.8, 1.0, 1.3), 1.0),
    (None, (1.0, 1.0, 1.0), 1.5),
    (np.array([[1.2, -0.1, -0.1, 0.0], [-0.05, 1.1, -0.05, 0.01],
               [-0.4, -0.9, 2.3, 0.0]]), (1.0, 1.0, 1.0), 1.0),
    (np.array([[1.2, -0.1, -0.1, 0.0], [-0.05, 1.1, -0.05, 0.01],
               [-0.4, -0.9, 2.3, 0.0]]), (1.1, 0.9, 1.0), 0.8),
]


@pytest.mark.parametrize("look", ["none", "protune", "cflook"])
@pytest.mark.parametrize("i", range(len(CUBE_DEVELOPS)))
def test_raw_cubes_match(look, i):
    """BuildCube's branches (the LUT alone, and the develop folded with or
    without a LUT) and the separability test equal the originals."""
    if look == "protune":
        lut, size = jdemosaic.protune_look_lut()
    elif look == "cflook":
        c = _cflook()
        lut, size = c.lut.reshape(-1, 3), c.size
    else:
        lut, size = None, 0
    m, gamma, contrast = CUBE_DEVELOPS[i]
    got = tdemosaic.build_raw_cube_developed(m, gamma, contrast, lut, size)
    want = jdemosaic.build_raw_cube_developed(m, gamma, contrast, lut, size)
    np.testing.assert_array_equal(got, want)
    assert tdemosaic.cube_is_separable(got) == \
        jdemosaic.cube_is_separable(want)
    if lut is not None and i == 0:
        plain = tdemosaic.build_raw_cube(lut, size)
        np.testing.assert_array_equal(plain,
                                      jdemosaic.build_raw_cube(lut, size))
        assert tdemosaic.cube_is_separable(plain) == (look == "protune")


def test_vignette_geometry_reads_the_model():
    """`vignette_geometry` is the port's own: the model's pixels it scales
    are its ring, by its factors (a frame of ones scaled by 0 marks the
    ring; the model's output on a ramp matches the factors)."""
    h, w = 64, 96
    for start, end, gain in ((-0.7, 0.0, 0.5), (-0.5, -0.2, 0.0)):
        af, ring = tdemosaic.vignette_geometry(w, h, start, end, gain)
        big = np.full((h, w, 3), 4000)
        out = jdemosaic.fast_vignette_wp13(big, start, end, gain)
        f32 = np.float32
        mag = np.sqrt(f32(4000) * f32(4000) * af, dtype=f32).astype(np.int64)
        np.testing.assert_array_equal(out[..., 0],
                                      np.where(ring, mag, 4000))


def test_lutpath_reader_matches(tmp_path, monkeypatch):
    path = os.path.join(SAMPLES, "DEADBEEF.cflook")
    got, want = tlutpath.read_cflook(path), jlutpath.read_cflook(path)
    np.testing.assert_array_equal(got.lut, want.lut)
    assert (got.name, got.input_curve, got.output_curve, got.size) == \
        (want.name, want.input_curve, want.output_curve, want.size)
    # big-endian files read the same
    big = tmp_path / "big.cflook"
    jlutpath.write_cflook(str(big), want)
    raw = bytearray(big.read_bytes())
    for k in range(6):
        raw[4 * k:4 * k + 4] = raw[4 * k:4 * k + 4][::-1]
    hdr = 24 + 40
    raw[hdr:] = np.frombuffer(bytes(raw[hdr:]), "<f4").astype(">f4").tobytes()
    big.write_bytes(bytes(raw))
    np.testing.assert_array_equal(tlutpath.read_cflook(str(big)).lut,
                                  jlutpath.read_cflook(str(big)).lut)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tlutpath.default_lut_dir() == jlutpath.default_lut_dir()
    (tmp_path / ".cineform").mkdir()
    (tmp_path / ".cineform" / "dbsettings").write_text(
        '# prefs\nLUTPath "/srv/looks/cineform/base"\n')
    assert tlutpath.default_lut_dir() == jlutpath.default_lut_dir() == \
        "/srv/looks/cineform/base/LUTs"
    db = tlutpath.LookDatabase(str(tmp_path))
    assert db.path_for(0xDEADBEEF) == jlutpath.LookDatabase(
        str(tmp_path)).path_for(0xDEADBEEF)
    assert db.load(0x12345678) is None


@pytest.mark.parametrize("crc", [0x3F6F5788, 0xDEADBEEF, 0x12345678])
def test_resolve_look_matches(crc, tmp_path, monkeypatch):
    luts = tmp_path / ".cineform" / "LUTs"
    luts.mkdir(parents=True)
    (luts / "DEADBEEF.cflook").write_bytes(_read("DEADBEEF.cflook"))
    monkeypatch.setenv("HOME", str(tmp_path))
    got, want = tam.resolve_look(crc), jam.resolve_look(crc)
    assert got[1] == want[1]
    if want[0] is None:
        assert got[0] is None
    else:
        np.testing.assert_array_equal(got[0], want[0])


def test_demo_quant_and_wavelet_specs_match():
    for q in range(1, 300):
        assert tquant.quant_multiplier(q) == jquant.quant_multiplier(q)
        assert tquant.quant_midpoint(q) == jquant.quant_midpoint(q)
    for depth in range(7, 17):
        assert tquant.demo_quant_tables(depth) == \
            jquant.demo_quant_tables(depth)
    assert twavelet.ROUNDING == jwavelet.ROUNDING


@pytest.mark.parametrize("values", [[1.0, 2.5, 0.5], [(1.0, 1.0, 1.0),
                                                    (2.0, 1.0, 0.5),
                                                    (0.4, 3.0, 1.0)]])
def test_keyframes_track_matches(values):
    """The linear `Track` (unsorted keys, scalar and vector values) equals
    the original's at, between and beyond its keyframes."""
    frames = [10, 0, 24]
    got = tkeyframes.Track(list(frames), list(values))
    want = jkeyframes.Track(list(frames), list(values))
    for f in (-3, 0, 2.5, 5, 10, 17, 24, 40):
        np.testing.assert_array_equal(got.sample(f), want.sample(f))


# ---------------------------------------------------------------------------
# The decoder's error tolerance and the corrupt-sample corpus
# ---------------------------------------------------------------------------

def _outcome(fn, *args):
    """(None, fn's result), or (its exception's type name, message)."""
    try:
        return None, fn(*args)
    except Exception as exc:  # noqa: BLE001 - the outcome compared
        return type(exc).__name__, str(exc)


def _jax_fuzz_tool():
    """`tools/diff_fuzz.py`, loaded from its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_diff_fuzz", os.path.join(REPO, "tools", "diff_fuzz.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _corrupt_corpus(name, cases, seed):
    """`cases` mutations of a golden (the 160x120 corpus sample for None)
    drawn as the JAX tool draws them, and the port's `diff_fuzz`."""
    from cineform_tpu_torch import diff_fuzz

    if name is None:
        sample = jhost.encode_sample(jframes.yuy2_frame(160, 120, 1),
                                     160, 120, 4)
    else:
        sample = _read(name)
    jfuzz = _jax_fuzz_tool()
    rng = np.random.default_rng(seed)
    return [jfuzz.mutate(rng, sample) for _ in range(cases)], diff_fuzz


@pytest.mark.parametrize("name,cases,seed", [
    (None, 120, 5), ("rg48_320x240_q4_p1.cfhd", 40, 6),
    ("byr4_320x240_q4_p1.cfhd", 40, 7), ("b64a_320x240_q4_p1.cfhd", 30, 8)])
def test_intra_channels_and_collect_wavelet_bands_match(name, cases, seed):
    """On corrupt samples `intra_channels` and `collect_wavelet_bands` give
    the original's channels, arrays or BadSampleError message;
    `wavelet_band_plan` raises where the original does and places the
    bands it decodes."""
    samples, _ = _corrupt_corpus(name, cases, seed)
    rejected = 0
    for sample in samples:
        try:
            s_j, s_t = jparse_sample(sample), tparse_sample(sample)
        except Exception:  # noqa: BLE001 - a parse error: no channel
            continue
        raised, chans_j = _outcome(jhost.intra_channels, s_j)
        if raised:
            assert _outcome(thost.intra_channels, s_t) == (raised, chans_j)
            rejected += 1
            continue
        chans_t = thost.intra_channels(s_t)
        assert [c.channel for c in chans_t] == [c.channel for c in chans_j]
        for cj, ct in zip(chans_j, chans_t):
            want = _outcome(jhost.collect_wavelet_bands, cj)
            got = _outcome(thost.collect_wavelet_bands, ct)
            raised, plan = _outcome(thost.wavelet_band_plan, ct)
            if want[0] == "BadSampleError":
                assert got == want == (raised, plan)
                rejected += 1
                continue
            assert _plain(got) == _plain(want)
            assert {b.data_offset for b, _, _ in plan[1]} <= {
                b.data_offset for b in ct.bands}
    assert rejected > 0


def test_diff_fuzz_helpers_match():
    """`mutate`, `payload_ranges` and `classify_mutation` of the port's
    `diff_fuzz` draw the same bytes and classes from a seed as those of
    `tools/diff_fuzz.py`, and `corpus` the same cases as its `run`."""
    jfuzz = _jax_fuzz_tool()
    for name in (None, "rg48_320x240_q4_p1.cfhd"):
        samples, tfuzz = _corrupt_corpus(name, 1, 0)
        sample = (_read(name) if name else jhost.encode_sample(
            jframes.yuy2_frame(160, 120, 1), 160, 120, 4))
        ranges = jfuzz.payload_ranges(sample)
        assert tfuzz.payload_ranges(sample) == ranges
        rng_j, rng_t = (np.random.default_rng(11) for _ in range(2))
        for _ in range(60):
            m = jfuzz.mutate(rng_j, sample)
            assert tfuzz.mutate(rng_t, sample) == m
            assert tfuzz.classify_mutation(sample, m, ranges) == \
                jfuzz.classify_mutation(sample, m, ranges)
        rng_j = np.random.default_rng(0)
        want = []
        for case in range(8):
            m = jfuzz.mutate(rng_j, sample)
            want.append((case, jfuzz.classify_mutation(sample, m, ranges), m))
        assert tfuzz.corpus(sample, 8, 0) == want

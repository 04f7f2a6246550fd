"""The port's own copy of the host path (`cineform_tpu_torch.spec`,
`bitstream`, `entropy.native`, `native`, `models.intra_host`, `ref.intra`,
`utils.glibc_random`, `testframes`), on the CPU.

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

from cineform_tpu.bitstream import fastwalk as jfastwalk
from cineform_tpu.bitstream import parse_sample as jparse_sample
from cineform_tpu.entropy import native as jnative
from cineform_tpu.models import intra_host as jhost
from cineform_tpu.models.intra import IntraCodec as JaxIntraCodec
from cineform_tpu.ref import intra as jref
from cineform_tpu.spec import codebooks as jcb
from cineform_tpu.spec import production as jprod
from cineform_tpu.spec import tags as jtags
from cineform_tpu.utils import glibc_random as jglibc
from cineform_tpu.utils import testframes as jframes
from cineform_tpu_torch import native as tnative_build
from cineform_tpu_torch import testframes as tframes
from cineform_tpu_torch.bitstream import fastwalk as tfastwalk
from cineform_tpu_torch.bitstream import parse_sample as tparse_sample
from cineform_tpu_torch.entropy import native as tnative
from cineform_tpu_torch.models import intra_host as thost
from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.ref import intra as tref
from cineform_tpu_torch.spec import codebooks as tcb
from cineform_tpu_torch.spec import production as tprod
from cineform_tpu_torch.spec import tags as ttags
from cineform_tpu_torch.utils import glibc_random as tglibc

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

def test_port_sources_import_nothing_of_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports `cineform_tpu`
    or `jax`, at top level or inside a function."""
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
assert not [m for m in sys.modules
            if m.split(".")[0] in ("cineform_tpu", "jax", "jaxlib")]
print("ok")
"""


def test_port_runs_where_the_jax_package_cannot_be_imported():
    """In a fresh interpreter where importing `cineform_tpu` or `jax`
    raises, every port module imports, and the 64x48 golden encodes and
    decodes byte for byte on both decode routes."""
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


@pytest.mark.parametrize("fmt", ["RG48", "B64A", "RG64"])
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

"""The port's CUDA kernels and their wrappers.

On the CPU: each wrapper runs its plain PyTorch version for CPU tensors,
counts no launch there, and raises (never falls back) on a wrong dtype or
a device it has no kernel for; the package imports no JAX.

On a card (marker `gpu`, skipped where there is none): each kernel equals
its plain version bit for bit, and the codec on the card reproduces the
golden samples.  Run them where the card is, without the JAX conftest:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cineform_tpu_torch.entropy import device as tdev
from cineform_tpu_torch.entropy import device_decode as tdd
from cineform_tpu_torch.ops import intra_transform
from cineform_tpu_torch.ops.chunk_pack import chunk_pack
from cineform_tpu_torch.ops import dwt_forward as dwt
from cineform_tpu_torch.ops.dwt_forward import (dwt_forward_groups,
                                                dwt_forward_level,
                                                dwt_forward_planes,
                                                dwt_forward_yuy2)
from cineform_tpu_torch.ops.merge_network import (merge_network,
                                                  merge_network_highfirst,
                                                  merge_network_tgt)
from cineform_tpu_torch.testframes import plasma_noise_frames

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = (dwt_forward_yuy2, dwt_forward_groups, dwt_forward_planes,
            dwt_forward_level, chunk_pack, merge_network, merge_network_tgt,
            merge_network_highfirst)
DWTS = ("dwt", "yuy2", "groups", "planes")
#: (LH, HL, HH) quantizers of Y, V, U at each level (quality 4's, then
#: others that reach q <= 1 and large q)
LEVEL_QUANTS = ([(24, 24, 36), (12, 12, 6), (12, 12, 6)],
                [(6, 6, 3), (1, 1, 1), (24, 24, 12)],
                [(36, 24, 2), (3, 3, 3), (255, 2, 1)])
#: (LH, HL, HH) quantizers of four planes (G, R, B, A): RG48's at quality
#: 4, level 1, then others
PLANE_QUANTS = [(12, 12, 32), (12, 12, 64), (1, 1, 1), (255, 2, 7)]
MERGES = ("merge", "merge_tgt", "merge_highfirst")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(seed, shape, lo=-1200, hi=1200) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        lo, hi, shape).astype(np.int32))


def _codes(seed, shape, density):
    """(bits, sizes) of a sparse band, as the encoder makes them."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-200, 200, shape).astype(np.int32)
    vals[rng.random(shape) >= density] = 0
    return tdev.band_codes(torch.from_numpy(vals), tdev.encode_tables(17))


def _concat_inputs(seed, rows, chunks, density):
    bits, sizes = _codes(seed, (rows, chunks * 256), density)
    bufs, lens, _ = tdev.tree_pack(bits.reshape(rows, chunks, 256),
                                   sizes.reshape(rows, chunks, 256),
                                   cap_bits_per_elem=12)
    val, rem, _ = tdev._concat_slots(bufs, lens)
    return val, rem


def _merge(which, val, rem, tgt=None):
    """(wrapper output, plain version's output) of one merge form."""
    if which == "merge":
        return merge_network(val, rem), tdev._settle_network(
            val.cpu(), rem.cpu())
    if which == "merge_tgt":
        return merge_network_tgt(val, rem, tgt), tdev._settle_network_tgt(
            val.cpu(), rem.cpu(), tgt.cpu())
    return merge_network_highfirst(val, rem), \
        tdev._settle_network_highfirst(val.cpu(), rem.cpu())


def _spread_inputs(seed, rows, chunks, nout):
    """The decoder's spread rows, mirrored, as `spread_rows` hands them to
    the high-bit-first network: slot targets strictly increasing per row."""
    rng = np.random.default_rng(seed)
    s = chunks * 12
    nval = rng.integers(0, s // 2, rows)
    val = np.zeros((rows, s), np.int32)
    tgt = np.zeros((rows, s), np.int32)
    for r in range(rows):
        val[r, :nval[r]] = rng.integers(1, 65536, nval[r])
        tgt[r, :nval[r]] = np.sort(rng.choice(nout, nval[r], replace=False))
    return tdd.spread_inputs(torch.from_numpy(tgt), torch.from_numpy(val),
                             nout)


def _guarded_rows(seed, rows, n, form, bad=()):
    """Rows for the guarded merge forms, with random values, that pass the
    form's guard (`concat`: rem steps of 0 or 1 from 0; `tgt`: the same,
    with zeros on the +1 steps; `highfirst`: rem nonincreasing, below
    2^L), except the rows in `bad`, each broken at one slot in one of three
    ways.  Returns int32 tensors (val, rem, tgt) or (val, rem)."""
    rng = np.random.default_rng(seed)
    val = rng.integers(-(1 << 31), 1 << 31, (rows, n))
    if form == "concat":
        steps = rng.random((rows, n)) < rng.random((rows, 1))
        rem = np.cumsum(steps, axis=1)
        for r in bad:
            i = rng.integers(n)
            if r % 3 == 0:
                rem[r, i:] += 2                 # a step of 2 or 3
            elif r % 3 == 1:                    # a fall of 1
                rem[r, i:] -= rem[r, i] - (rem[r, i - 1] if i else 0) + 1
            else:
                rem[r, -1] += 3                 # a last step of 3 or 4
        arrays = (val, rem)
    elif form == "tgt":
        steps = rng.random((rows, n)) < rng.random((rows, 1))
        rem = np.cumsum(steps, axis=1)
        tgt = rng.integers(0, 1 << 20, (rows, n))
        val[steps], tgt[steps] = 0, 0
        for r in bad:
            i = rng.integers(n)
            if r % 3 == 0:
                rem[r, i:] += 2                 # a step of 2 or 3
            elif r % 3 == 1:
                rem[r, i:] += 1                 # a filled slot on a +1 step
                val[r, i] = 1
            else:
                tgt[r, i] = -1 - rng.integers(5)   # a negative target
                if steps[r, i]:
                    val[r, i] = 1
        arrays = (val, rem, tgt)
    else:
        levels = max(1, (n - 1).bit_length())
        rem = -np.sort(-rng.integers(0, min(1 << levels, n + 9), (rows, n)),
                       axis=1)
        for r in bad:
            if r % 3 == 0:
                i = rng.integers(1, n)
                rem[r, i] = rem[r, i - 1] + 1   # an increase
            elif r % 3 == 1:
                rem[r, -1] = -1                 # a negative displacement
            else:
                rem[r] += (1 << levels) - rem[r, 0]   # one beyond 2^L
        arrays = (val, rem)
    return tuple(torch.from_numpy(a.astype(np.int32)) for a in arrays)


# ---------------------------------------------------------------------------
# CPU: the wrappers' contract
# ---------------------------------------------------------------------------

def test_wrappers_run_the_plain_versions_on_cpu():
    counts = [w.launches for w in WRAPPERS]
    x = _rand(0, (2, 12, 32))
    ll, highs = dwt_forward_level(x, 2, (6, 6, 3))
    wll, whighs = intra_transform.dwt2d_forward(x, 2, (6, 6, 3))
    assert torch.equal(ll, wll)
    assert all(torch.equal(a, b) for a, b in zip(highs, whighs))

    frames = _frames(3, 2, 24, 48)
    got = dwt_forward_yuy2(frames, 10, 0, LEVEL_QUANTS[0])
    want = dwt.plain_groups(intra_transform.unpack_yuy2(frames, 10), 0,
                            LEVEL_QUANTS[0])
    assert _equal(got, want)
    lows = want[0]
    got = dwt_forward_groups(lows, 2, LEVEL_QUANTS[1])
    want = dwt.plain_groups((lows[0][:, 0], lows[1][:, 0], lows[1][:, 1]),
                            2, LEVEL_QUANTS[1])
    assert _equal(got, want)
    x = _rand(4, (2, 4, 12, 20), 0, 4096)
    assert _equal(dwt_forward_planes(x, 2, PLANE_QUANTS),
                  dwt.plain_planes(x, 2, PLANE_QUANTS))

    bits, sizes = _codes(1, (2, 256), 0.9)
    got = chunk_pack(bits, sizes)
    want = tdev.tree_pack(bits, sizes, cap_bits_per_elem=12)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    val, rem = _concat_inputs(2, 2, 6, 0.3)
    for which in MERGES:
        got, want = _merge(which, val, rem, rem * 3)
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    assert [w.launches for w in WRAPPERS] == counts


def _frames(seed, b, h, w) -> torch.Tensor:
    """(b, h, 2w) uint8 YUY2 frames of seeded noise."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (b, h, 2 * w)).astype(np.uint8))


def _equal(got, want) -> bool:
    """Nested tuples of tensors, equal in shape, dtype and value (on the
    CPU)."""
    if isinstance(want, torch.Tensor):
        return got.dtype == want.dtype and torch.equal(got.cpu(), want)
    return len(got) == len(want) and all(
        _equal(g, w) for g, w in zip(got, want))


def _lows(b, h, w, dtype=torch.int32, device=None):
    """Zero group lowpass buffers of a (b, h, w) luma plane."""
    return (torch.zeros((b, 1, h, w), dtype=dtype, device=device),
            torch.zeros((b, 2, h, w // 2), dtype=dtype, device=device))


@pytest.mark.parametrize("which", [*DWTS, "pack", *MERGES])
def test_wrappers_raise_on_wrong_dtype(which):
    with pytest.raises(TypeError):
        if which == "dwt":
            dwt_forward_level(torch.zeros((8, 8), dtype=torch.int64))
        elif which == "yuy2":
            dwt_forward_yuy2(torch.zeros((1, 8, 32), dtype=torch.int32), 10,
                             0, LEVEL_QUANTS[0])
        elif which == "groups":
            dwt_forward_groups(_lows(1, 8, 16, torch.int64), 0,
                               LEVEL_QUANTS[0])
        elif which == "planes":
            dwt_forward_planes(torch.zeros((1, 3, 8, 16), dtype=torch.int64),
                               0, PLANE_QUANTS[:3])
        elif which == "pack":
            chunk_pack(torch.zeros((1, 256), dtype=torch.int64),
                       torch.zeros((1, 256), dtype=torch.int32))
        else:
            z = torch.zeros(64, dtype=torch.int32)
            _merge(which, torch.zeros(64, dtype=torch.float32), z, z)


@pytest.mark.parametrize("which", [*DWTS, "pack", *MERGES])
def test_wrappers_do_not_fall_back_off_the_cpu(which):
    """A tensor on a device without a kernel raises instead of taking the
    plain version."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        if which == "dwt":
            dwt_forward_level(torch.zeros((8, 8), dtype=torch.int32,
                                          device=meta))
        elif which == "yuy2":
            dwt_forward_yuy2(torch.zeros((1, 8, 32), dtype=torch.uint8,
                                         device=meta), 10, 0,
                             LEVEL_QUANTS[0])
        elif which == "groups":
            dwt_forward_groups(_lows(1, 8, 16, device=meta), 0,
                               LEVEL_QUANTS[0])
        elif which == "planes":
            dwt_forward_planes(torch.zeros((1, 4, 8, 16), dtype=torch.int32,
                                           device=meta), 0, PLANE_QUANTS)
        elif which == "pack":
            z = torch.zeros((1, 256), dtype=torch.int32, device=meta)
            chunk_pack(z, z)
        else:
            z = torch.zeros(64, dtype=torch.int32, device=meta)
            _merge(which, z, z, z)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        dwt_forward_level(torch.zeros((7, 8), dtype=torch.int32))
    q = LEVEL_QUANTS[0]
    for shape in ((1, 8, 36), (1, 7, 32), (1, 4, 32), (1, 8, 16), (8, 32)):
        with pytest.raises(ValueError):             # W % 4, H odd, small
            dwt_forward_yuy2(torch.zeros(shape, dtype=torch.uint8), 10, 0, q)
    with pytest.raises(ValueError):                 # a triple missing
        dwt_forward_yuy2(torch.zeros((1, 8, 32), dtype=torch.uint8), 10, 0,
                         q[:2])
    y, c = _lows(1, 8, 16)
    for lows in ((y, c[:, :1]), (y, c[..., :4]), _lows(1, 8, 10),
                 _lows(1, 7, 16), (y,)):
        with pytest.raises(ValueError):
            dwt_forward_groups(lows, 0, q)
    for shape, planes in (((1, 5, 8, 16), 5), ((1, 3, 7, 16), 3),
                          ((1, 3, 8, 9), 3), ((1, 3, 4, 16), 3),
                          ((3, 8, 16), 3), ((1, 3, 8, 16), 2)):
        with pytest.raises(ValueError):             # G, H odd, W odd, small
            dwt_forward_planes(torch.zeros(shape, dtype=torch.int32), 0,
                               PLANE_QUANTS[:planes] + [(1, 1, 1)] * (
                                   planes - len(PLANE_QUANTS)))
    with pytest.raises(ValueError):
        chunk_pack(torch.zeros((1, 128), dtype=torch.int32),
                   torch.zeros((1, 128), dtype=torch.int32))
    z64, z32 = (torch.zeros(n, dtype=torch.int32) for n in (64, 32))
    with pytest.raises(ValueError):
        merge_network(z64, z32)
    with pytest.raises(ValueError):
        merge_network_tgt(z64, z64, z32)
    with pytest.raises(ValueError):
        merge_network_highfirst(z32, z64)


def _carries(seed, b, which):
    """Row-0 carries of the Y and V, U groups: `which` of them seeded
    pixels, the other None."""
    return tuple(_rand(seed + g, (b, g, 2), 0, 4096) if which in (n, "both")
                 else None for g, n in ((1, "y"), (2, "c")))


def test_dwt_forward_groups_row0_carry_on_cpu():
    """On the CPU `dwt_forward_groups` hands its row-0 carries to the plain
    version; at a chroma width of 16 the carry changes rows 0 and 1 of
    chroma's LH and HH (the vertical filter's first rows read input row
    0's highpass), and nothing of luma, 32 wide.  A carry of the wrong shape
    or dtype raises."""
    x = _rand(5, (2, 12, 32), 0, 4096)
    lows = (x[:, None], torch.stack((x[..., :16], x[..., 16:]), dim=1))
    carry = _carries(9, 2, "both")
    got = dwt_forward_groups(lows, 0, LEVEL_QUANTS[0], carry)
    want = dwt.plain_groups((lows[0][:, 0], lows[1][:, 0], lows[1][:, 1]), 0,
                            LEVEL_QUANTS[0], carry)
    assert _equal(got, want)
    plain = dwt_forward_groups(lows, 0, LEVEL_QUANTS[0])
    assert _equal(plain[0], got[0]) and torch.equal(plain[1][0], got[1][0])
    diff = (plain[1][1] != got[1][1]).nonzero()
    assert len(diff) and set(diff[:, 2].tolist()) <= {0, 2} \
        and 0 in set(diff[:, 3].tolist()) <= {0, 1}
    for bad in ((carry[0][:1], None), (None, carry[0]),
                (carry[0].long(), None), (carry[0],)):
        with pytest.raises(ValueError):
            dwt_forward_groups(lows, 0, LEVEL_QUANTS[0], bad)


def test_package_imports_no_jax():
    """In a fresh interpreter where importing jax fails, every module of
    the port imports and the slice runs."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "import cineform_tpu_torch, cineform_tpu_torch.state\n"
        "import cineform_tpu_torch.ops.dwt_forward\n"
        "import cineform_tpu_torch.ops.chunk_pack\n"
        "import cineform_tpu_torch.ops.merge_network\n"
        "import cineform_tpu_torch.entropy.device_decode\n"
        "from cineform_tpu_torch.models.intra import IntraCodec\n"
        "from cineform_tpu_torch.testframes import yuy2_frame\n"
        "c = IntraCodec(64, 48, 4, device=torch.device('cpu'))\n"
        "f = np.frombuffer(yuy2_frame(64, 48, 1), np.uint8)"
        ".reshape(1, 48, 128)\n"
        "s = c.encode_batch_device(f)\n"
        "out = c.decode_batch(s)\n"
        "assert out.shape == (1, 48, 128)\n"
        "dev, fallback = c.decode_batch_device(s)\n"
        "assert fallback == () and (dev == out).all()\n"
        "assert not any(m == 'jax' or m.startswith('jax.')"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_package_sources_import_no_jax():
    pkg = os.path.join(REPO, "cineform_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    for line in f:
                        s = line.strip()
                        assert not s.startswith(("import jax", "from jax")), \
                            (name, line)


# ---------------------------------------------------------------------------
# Card: each kernel against its plain version
# ---------------------------------------------------------------------------

DWT_CASES = [
    # (batch, h, w, prescale, quant): a 1080p-like odd band height (135),
    # widths <= 16 (the narrow-row quirk, with and without w % 8 == 0),
    # the minimum plane and a ragged column tile
    (2, 270, 480, 0, (24, 24, 12)),
    (1, 64, 128, 2, (6, 6, 3)),
    (3, 12, 16, 0, (24, 24, 36)),
    (3, 12, 14, 2, (6, 6, 3)),
    (2, 6, 6, 0, (1, 1, 1)),
    (1, 30, 300, 2, (12, 12, 6)),
]


#: (batch, H, W of the luma plane, prescale, carried groups) of the row-0
#: carry: chroma 16 wide (the quirk reads the carry), luma 16 and chroma 8
#: (both), chroma 12 and luma 24 (W % 8 != 0 or W > 16: ignored), and the
#: GOP's w4 and w3 shapes at 64x48 (prescale 2, and the carry)
CARRY_CASES = [
    (2, 12, 32, 0, "both"),
    (3, 24, 16, 2, "both"),
    (1, 12, 16, 0, "y"),
    (2, 12, 32, 2, "c"),
    (2, 8, 24, 0, "both"),
    (2, 24, 32, 2, None),
    (2, 24, 32, 0, "both"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,prescale,which", CARRY_CASES)
def test_dwt_forward_groups_carry_kernel_matches_plain(cuda, b, h, w,
                                                       prescale, which):
    y = _rand(w * h + prescale, (b, 1, h, w), -2000, 4096)
    c = _rand(w * h + 1, (b, 2, h, w // 2), -2000, 4096)
    carry = _carries(h, b, which)
    before = dwt_forward_groups.launches
    got = dwt_forward_groups((y.to(cuda), c.to(cuda)), prescale,
                             LEVEL_QUANTS[1],
                             tuple(t if t is None else t.to(cuda)
                                   for t in carry))
    torch.cuda.synchronize()
    assert dwt_forward_groups.launches == before + 1
    assert _equal(got, dwt.plain_groups((y[:, 0], c[:, 0], c[:, 1]),
                                        prescale, LEVEL_QUANTS[1], carry))


@pytest.mark.gpu
@pytest.mark.parametrize("w,h", [(64, 48), (96, 48), (320, 240)])
def test_gop_forward_on_the_card_matches_plain(cuda, w, h):
    """`GopCodec.forward` on the card, 2 `dwt_forward_yuy2` and 3
    `dwt_forward_groups` launches, equals its plain version on the CPU."""
    from cineform_tpu_torch.models.gop import GopCodec

    f0, f1 = (_frames(w * h + k, 2, h, w) for k in (0, 1))
    launches = (dwt_forward_yuy2.launches, dwt_forward_groups.launches)
    got = GopCodec(w, h, 4, device=cuda).forward(f0.to(cuda), f1.to(cuda))
    torch.cuda.synchronize()
    assert (dwt_forward_yuy2.launches, dwt_forward_groups.launches) == (
        launches[0] + 2, launches[1] + 3)
    want = GopCodec(w, h, 4, device=torch.device("cpu")).forward(f0, f1)
    for (glp, gb), (wlp, wb) in zip(got, want, strict=True):
        assert _equal(glp, wlp)
        assert all(_equal(gb[k], wb[k]) for k in wb)


@pytest.mark.gpu
def test_gop_codec_on_the_card_matches_goldens(cuda):
    """The GOP goldens encode byte for byte on the card, and decode on both
    routes, the device route with 6 launches of each decoder merge form
    and no fallback."""
    from cineform_tpu_torch.models.gop import GopCodec
    from cineform_tpu_torch.models.intra import sample_metadata
    from cineform_tpu_torch.testframes import yuy2_frame

    def golden(name):
        with open(os.path.join(REPO, "tests", "golden", "samples", name),
                  "rb") as f:
            return f.read()

    codec = GopCodec(320, 240, 4, device=cuda)
    for name, p0, p1 in (("gop_320x240_q4_p1", 1, 2),
                         ("gop2_320x240_q4_p100", 100, 100)):
        gold = golden(name + ".cfhd.f1")
        f0, f1 = (np.frombuffer(yuy2_frame(320, 240, p), np.uint8).reshape(
            1, 240, 640) for p in (p0, p1))
        assert codec.encode_batch(f0, f1, 1, sample_metadata(gold)) == [gold]
        want = [golden(f"{name}.f{f}.yuy2") for f in (0, 1)]
        assert [f.tobytes() for f in codec.decode_batch([gold])] == want
        launches = [merge_network_tgt.launches,
                    merge_network_highfirst.launches]
        *dev, fallback = codec.decode_batch_device([gold])
        assert fallback == () and [f.tobytes() for f in dev] == want
        assert [merge_network_tgt.launches,
                merge_network_highfirst.launches] == [n + 6 for n in launches]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,prescale,quant", DWT_CASES)
def test_dwt_forward_kernel_matches_plain(cuda, b, h, w, prescale, quant):
    x = _rand(h * w + prescale, (b, h, w), -1200, 4096)
    before = dwt_forward_level.launches
    ll, highs = dwt_forward_level(x.to(cuda), prescale, quant)
    torch.cuda.synchronize()
    assert dwt_forward_level.launches == before + 1
    wll, whighs = intra_transform.dwt2d_forward(x, prescale, quant)
    assert torch.equal(ll.cpu(), wll)
    for got, want in zip(highs, whighs):
        assert torch.equal(got.cpu(), want)


#: (batch, H, W, levels) of YUY2 frames for the fused levels, covering the
#: cases of DWT_CASES: a batch-2 1080p frame (band height 135 at level 3),
#: narrow planes (the quirk, with W % 8 == 0 at level 1 chroma of W = 32
#: and level 2 luma, without it at W = 12, 112 and 48), the minimum plane
#: (6x6 chroma at level 3 of 48x24), ragged column tiles and band pitches
#: (W = 600, 112), and rows that are not a multiple of 16 bytes (YUY2 at
#: W = 100, int32 at level 2 chroma of W = 104)
FRAME_CASES = [
    (2, 1080, 1920, 3),
    (1, 48, 64, 3),
    (1, 48, 112, 3),
    (3, 24, 48, 3),
    (2, 24, 32, 2),
    (1, 60, 600, 2),
    (2, 30, 100, 1),
    (1, 24, 104, 2),
    (2, 270, 480, 1),
    (1, 12, 12, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("prescale", [0, 2])
@pytest.mark.parametrize("b,h,w,levels", FRAME_CASES)
def test_dwt_forward_fused_kernels_match_plain(cuda, b, h, w, levels,
                                               prescale):
    """Level 1 from the YUY2 bytes and the three-channel levels after it,
    each against its plain version on the same input."""
    frames = _frames(h * w + prescale, b, h, w)
    launches = (dwt_forward_yuy2.launches, dwt_forward_groups.launches)
    got = dwt_forward_yuy2(frames.to(cuda), 10, prescale, LEVEL_QUANTS[0])
    torch.cuda.synchronize()
    want = dwt.plain_groups(intra_transform.unpack_yuy2(frames, 10),
                            prescale, LEVEL_QUANTS[0])
    assert _equal(got, want)
    for k in range(1, levels):
        lows = want[0]
        got = dwt_forward_groups(tuple(t.to(cuda) for t in lows),
                                 2 - prescale, LEVEL_QUANTS[k])
        torch.cuda.synchronize()
        want = dwt.plain_groups((lows[0][:, 0], lows[1][:, 0],
                                 lows[1][:, 1]), 2 - prescale,
                                LEVEL_QUANTS[k])
        assert _equal(got, want)
    assert (dwt_forward_yuy2.launches, dwt_forward_groups.launches) == (
        launches[0] + 1, launches[1] + levels - 1)


@pytest.mark.gpu
def test_forward_packed_on_the_card_takes_three_dwt_launches(cuda,
                                                            monkeypatch):
    """On the card `forward_packed` launches the DWT 3 times, reads the
    YUY2 bytes (no unpack) and hands the entropy coder the kernels' band
    buffers (no stack or pad), and equals the plain path."""
    from cineform_tpu_torch.models.intra import IntraCodec
    from cineform_tpu_torch.testframes import yuy2_frame

    w, h = 320, 240
    frames = torch.from_numpy(np.stack([
        np.frombuffer(yuy2_frame(w, h, p), np.uint8).reshape(h, 2 * w)
        for p in (1, 2)]))
    want = IntraCodec(w, h, 4, device=torch.device("cpu")).forward_packed(
        frames)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain stage ran on the card's path")

    monkeypatch.setattr(intra_transform, "unpack_yuy2", refuse)
    monkeypatch.setattr(dwt, "plain_groups", refuse)
    monkeypatch.setattr(dwt, "group_layout", refuse)
    wrappers = (dwt_forward_yuy2, dwt_forward_groups, dwt_forward_level)
    before = [f.launches for f in wrappers]
    got = IntraCodec(w, h, 4, device=cuda).forward_packed(frames.to(cuda))
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [before[0] + 1, before[1] + 2,
                                              before[2]]
    assert _equal(got, want)


#: (batch, H, W) of 10-bit 4:2:2 planes for `dwt_forward_groups` at level
#: 1, as UYVY, YU64 and V210 give it: a batch-2 1080p frame (luma 1920,
#: chroma 960 wide), ragged column tiles and band pitches (W = 300, chroma
#: 150), narrow planes (chroma 10 wide) and a small batch-3 frame
GROUP_LEVEL1_CASES = [
    (2, 1080, 1920),
    (2, 48, 96),
    (1, 30, 300),
    (3, 12, 20),
]


@pytest.mark.gpu
@pytest.mark.parametrize("prescale", [0, 2])
@pytest.mark.parametrize("b,h,w", GROUP_LEVEL1_CASES)
def test_dwt_forward_groups_at_level_1_matches_plain(cuda, b, h, w,
                                                     prescale):
    """One launch for Y and for V, U at a level-1 size, equal to
    `plain_groups` on the same 10-bit planes."""
    y = _rand(b * h * w + prescale, (b, 1, h, w), 0, 1024)
    c = _rand(b * h * w + prescale + 1, (b, 2, h, w // 2), 0, 1024)
    before = dwt_forward_groups.launches
    got = dwt_forward_groups((y.to(cuda), c.to(cuda)), prescale,
                             LEVEL_QUANTS[0])
    torch.cuda.synchronize()
    assert dwt_forward_groups.launches == before + 1
    assert _equal(got, dwt.plain_groups((y[:, 0], c[:, 0], c[:, 1]),
                                        prescale, LEVEL_QUANTS[0]))


#: (batch, planes, H, W) of int32 plane groups: the RG48 and RGBA 1080p
#: levels at batch 2 (level 3: 135 output rows), the four 1920x1080 Bayer
#: planes of a 4K mosaic at level 1, narrow planes (the
#: narrow-row quirk with W % 8 == 0 at 16, without it at 14), the minimum
#: plane, ragged column tiles and band pitches (W = 300, 76), rows that are
#: not a multiple of 16 bytes (W = 38) and groups of one and two planes
PLANE_CASES = [
    (2, 3, 1080, 1920),
    (2, 4, 1080, 1920),
    (2, 4, 540, 960),
    (2, 4, 270, 480),
    (3, 3, 12, 16),
    (3, 4, 12, 14),
    (2, 3, 6, 6),
    (1, 4, 30, 300),
    (2, 3, 20, 76),
    (1, 2, 24, 38),
    (2, 1, 64, 128),
]


@pytest.mark.gpu
@pytest.mark.parametrize("prescale", [0, 2])
@pytest.mark.parametrize("b,g,h,w", PLANE_CASES)
def test_dwt_forward_planes_kernel_matches_plain(cuda, b, g, h, w, prescale):
    """One launch for the group, equal to `plain_planes` on the same
    12-bit planes, pad columns included."""
    x = _rand(b * g * h * w + prescale, (b, g, h, w), 0, 4096)
    before = dwt_forward_planes.launches
    got = dwt_forward_planes(x.to(cuda), prescale, PLANE_QUANTS[:g])
    torch.cuda.synchronize()
    assert dwt_forward_planes.launches == before + 1
    assert _equal(got, dwt.plain_planes(x, prescale, PLANE_QUANTS[:g]))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["RG48", "B64A", "RG64"])
def test_rgb_forward_packed_on_the_card_takes_three_planes_launches(cuda,
                                                                   fmt):
    """On the card a 4:4:4 `forward_packed` launches `dwt_forward_planes`
    3 times and neither YUY2 entry point, and equals the plain path."""
    from cineform_tpu_torch.models.intra import IntraCodec

    w, h = 320, 240
    codec = IntraCodec(w, h, 4, device=torch.device("cpu"), input_format=fmt)
    frames = torch.from_numpy(np.random.default_rng(len(fmt)).integers(
        0, 256, (2, h, codec.row_bytes)).astype(np.uint8))
    want = codec.forward_packed(frames)
    wrappers = (dwt_forward_planes, dwt_forward_yuy2, dwt_forward_groups,
                dwt_forward_level)
    before = [f.launches for f in wrappers]
    got = IntraCodec(w, h, 4, device=cuda, input_format=fmt).forward_packed(
        frames.to(cuda))
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [before[0] + 3, *before[1:]]
    assert _equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,w", [("UYVY", 192), ("YU64", 192),
                                   ("V210", 192), ("V210", 320),
                                   ("BYR4", 192), ("BYR5", 192)])
def test_new_formats_forward_packed_on_the_card(cuda, fmt, w):
    """On the card the 10-bit 4:2:2 formats' `forward_packed` launches
    `dwt_forward_groups` 3 times (level 1 from the plain unpack's group
    buffers; at V210's width 320 the unpack cuts the luma from whole
    6-pixel groups) and Bayer's `dwt_forward_planes` 3 times, and each
    equals the plain path."""
    from cineform_tpu_torch.models.intra import IntraCodec

    h = 96
    codec = IntraCodec(w, h, 4, device=torch.device("cpu"), input_format=fmt)
    frames = np.random.default_rng(len(fmt)).integers(
        0, 256, (2, h, codec.row_bytes)).astype(np.uint8)
    if fmt == "V210":
        frames &= np.tile(np.array([255, 255, 255, 63], np.uint8),
                          codec.row_bytes // 4)
    frames = torch.from_numpy(frames)
    want = codec.forward_packed(frames)
    wrappers = (dwt_forward_groups, dwt_forward_planes, dwt_forward_yuy2,
                dwt_forward_level)
    before = [f.launches for f in wrappers]
    got = IntraCodec(w, h, 4, device=cuda, input_format=fmt).forward_packed(
        frames.to(cuda))
    torch.cuda.synchronize()
    dwt_launches = (3, 0) if fmt in ("UYVY", "YU64", "V210") else (0, 3)
    assert [f.launches for f in wrappers] == [
        before[0] + dwt_launches[0], before[1] + dwt_launches[1], *before[2:]]
    assert _equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,gold,src", [
    ("RG48", "rg48_320x240_q4_p1", "rgb444_320x240_q4"),
    ("B64A", "b64a_320x240_q4_p1", "rgba4444_320x240_q4")])
def test_rgb_codec_on_the_card_matches_golden(cuda, fmt, gold, src):
    """The 320x240 RG48 and B64A goldens encoded on the card, and the RGB
    and RGBA decode goldens decoded on both routes to both outputs."""
    from cineform_tpu_torch import testframes
    from cineform_tpu_torch.models.intra import IntraCodec, sample_metadata

    def golden(name):
        with open(os.path.join(REPO, "tests", "golden", "samples", name),
                  "rb") as f:
            return f.read()

    codec = IntraCodec(320, 240, 4, device=cuda, input_format=fmt)
    make = {"RG48": testframes.rg48_frame, "B64A": testframes.b64a_frame}
    frames = np.frombuffer(make[fmt](320, 240, 1), np.uint8).reshape(
        1, 240, codec.row_bytes)
    want = golden(f"{gold}.cfhd")
    assert codec.encode_batch_device(frames, 1, sample_metadata(want))[0] \
        == want
    sample = golden(f"{src}.cfhd")
    for output, ext in (("RG48", "rg48out"), ("b64a", "b64aout")):
        want = golden(f"{src}.{ext}")
        assert codec.decode_batch([sample], output=output).tobytes() == want
        out, fallback = codec.decode_batch_device([sample], output=output)
        assert fallback == () and out.tobytes() == want


@pytest.mark.gpu
@pytest.mark.parametrize("seed,density,cap", [(0, 0.2, 12), (1, 0.9, 12),
                                              (2, 0.0, 12), (3, 0.9, 8),
                                              (4, 0.5, 27)])
def test_chunk_pack_kernel_matches_plain(cuda, seed, density, cap):
    bits, sizes = _codes(seed, (3, 7 * 256), density)
    bits, sizes = bits.reshape(3, 7, 256), sizes.reshape(3, 7, 256)
    got = chunk_pack(bits.to(cuda), sizes.to(cuda), cap_bits_per_elem=cap)
    torch.cuda.synchronize()
    want = tdev.tree_pack(bits, sizes, cap_bits_per_elem=cap)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if density == 0.9:
        assert want[2].any()


def _boundary_codes(seed, chunks):
    """(bits, sizes) of chunks whose codes end exactly on a word boundary
    (at 64, 512 and 3072 bits, the last a full chunk of 12-bit codes) and
    of empty chunks, with random bits above each size."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(-(1 << 31), 1 << 31, (chunks, 256)).astype(np.int32)
    sizes = np.zeros((chunks, 256), np.int32)
    for c in range(chunks):
        kind = c % 4
        if kind == 0:
            sizes[c, rng.choice(256, 4, replace=False)] = 16
        elif kind == 1:
            sizes[c, :64] = 8
        elif kind == 2:
            sizes[c] = 12
    return torch.from_numpy(bits), torch.from_numpy(sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("case,cap", [("mixed", 12), ("mixed", 8),
                                      ("boundary", 12), ("boundary", 27)])
def test_chunk_pack_kernel_prefix_and_tree_chunks(cuda, case, cap):
    """One call mixing chunks that fit (packed by the prefix sum) with
    overflowed ones (packed by the tree), or chunks that end on a word
    boundary: every chunk equals the tree, and the device counts exactly
    the chunks that do not fit."""
    if case == "mixed":
        bits, sizes = _codes(5, (4, 9 * 256), 0.3)
        noisy = _codes(6, (4, 9 * 256), 0.95)
        keep = torch.rand((4, 9, 1), generator=torch.Generator().manual_seed(
            cap)) < 0.5
        bits = torch.where(keep, bits.reshape(4, 9, 256),
                           noisy[0].reshape(4, 9, 256))
        sizes = torch.where(keep, sizes.reshape(4, 9, 256),
                            noisy[1].reshape(4, 9, 256))
    else:
        bits, sizes = _boundary_codes(cap, 37)
    fits = tdev._pack_fits(sizes, cap_bits_per_elem=cap)
    dev = torch.device("cuda", torch.cuda.current_device())
    before = chunk_pack.tree_chunks.get(dev)
    before = 0 if before is None else int(before.item())
    got = chunk_pack(bits.contiguous().to(cuda), sizes.contiguous().to(cuda),
                     cap_bits_per_elem=cap)
    torch.cuda.synchronize()
    want = tdev.tree_pack(bits, sizes, cap_bits_per_elem=cap)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)
    assert int(chunk_pack.tree_chunks[dev].item()) == before + int(
        (~fits).sum())
    if case == "mixed":
        assert want[2].any() and fits.any()


def _tree_chunks(dev) -> int:
    t = chunk_pack.tree_chunks.get(dev)
    return 0 if t is None else int(t.item())


@pytest.mark.gpu
@pytest.mark.parametrize("seed,density", [(0, 0.2), (1, 0.9), (2, 1.0)])
def test_chunk_pack_kernel_at_the_encoders_schedule(cuda, seed, density):
    """At the encoder's schedule, every chunk at its worst case, even
    chunks of the longest codes fit: the kernel packs every chunk by the
    prefix sum, equal to the tree and to `_pack_direct`, and flags none."""
    vals = _rand(seed, (3, 9 * 256))
    vals[torch.from_numpy(np.random.default_rng(seed).random(
        vals.shape)) >= density] = 0
    t = tdev.encode_tables(17)
    bits, sizes = (x.reshape(3, 9, 256) for x in tdev.band_codes(vals, t))
    sched = tdev.chunk_schedule(t)
    dev = torch.device("cuda", torch.cuda.current_device())
    before = _tree_chunks(dev)
    got = chunk_pack(bits.to(cuda), sizes.to(cuda), *sched)
    torch.cuda.synchronize()
    for want in (tdev.tree_pack(bits, sizes, *sched),
                 tdev._pack_direct(bits, sizes, *sched)):
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g.cpu(), w)
    assert _tree_chunks(dev) == before and not got[2].any()
    if density == 1.0:       # a 12-bit chunk capacity would truncate
        assert tdev.tree_pack(bits, sizes, cap_bits_per_elem=12)[2].any()


@pytest.mark.gpu
def test_plasma_noise_encode_on_the_card_overflows_nothing(cuda):
    """One batch-8 1080p encode of the benchmark's content: no band
    overflows, no chunk takes the tree, no merge_network row fails its
    guard, and the samples equal the host coder's."""
    from cineform_tpu_torch.models.intra import IntraCodec

    frames = plasma_noise_frames(1920, 1080,
                                 [i * 1080 // 8 for i in range(8)], 21)
    codec = IntraCodec(1920, 1080, 4, device=cuda)
    dev = torch.device("cuda", torch.cuda.current_device())
    tree, flagged = _tree_chunks(dev), _flagged(merge_network, dev)
    packed = codec.forward_packed(codec._upload(frames))
    torch.cuda.synchronize()
    assert _tree_chunks(dev) == tree
    assert _flagged(merge_network, dev) == flagged
    assert not any(bool(o.any()) for _, levels in packed
                   for _, _, o, _ in levels)
    assert codec.write_samples(frames, packed) == codec.encode_batch(frames)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,rows,chunks,density", [(0, 3, 40, 0.5),
                                                      (1, 2, 9, 0.02),
                                                      (2, 4, 64, 0.9)])
def test_merge_network_kernel_matches_plain(cuda, seed, rows, chunks,
                                            density):
    """The encoder's concat rows (at density 0.9 overflowed chunks make
    the displacements fall): the rows that fail the guard, and only they,
    go through the network."""
    val, rem = _concat_inputs(seed, rows, chunks, density)
    dev = torch.device("cuda", torch.cuda.current_device())
    flagged = _flagged(merge_network, dev)
    got_v, got_r = merge_network(val.to(cuda), rem.to(cuda))
    torch.cuda.synchronize()
    want_v, want_r = tdev._settle_network(val, rem)
    assert torch.equal(got_v.cpu(), want_v)
    assert torch.equal(got_r.cpu(), want_r)
    assert _flagged(merge_network, dev) == flagged + int(
        (~tdev._concat_guard(rem)).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("seed,rows,chunks,density", [(0, 3, 40, 0.5),
                                                      (1, 2, 9, 0.02),
                                                      (2, 4, 64, 0.9)])
def test_merge_network_tgt_kernel_matches_plain(cuda, seed, rows, chunks,
                                                density):
    """The tgt form on the encoder's concat slots (with overflowed chunks
    at density 0.9, so displacements fall) and a third array in no
    order."""
    val, rem = _concat_inputs(seed, rows, chunks, density)
    tgt = _rand(seed, tuple(val.shape), 0, 1 << 20)
    got, want = _merge("merge_tgt", val.to(cuda), rem.to(cuda), tgt.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,rows,n", [(0, 3, 5000), (1, 2, 2048),
                                         (2, 5, 3071), (3, 1, 1),
                                         (4, 2, 70000)])
def test_merge_network_highfirst_kernel_matches_plain(cuda, seed, rows, n):
    """Rows not a multiple of the 2048-slot tile, and displacements in no
    order (overlapping moves and collisions)."""
    val = _rand(seed, (rows, n), -(1 << 31), 1 << 31)
    rem = _rand(seed + 100, (rows, n), 0, n + 9)
    got, want = _merge("merge_highfirst", val.to(cuda), rem.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,rows,chunks,nout", [(0, 3, 100, 3000),
                                                   (1, 2, 700, 20000)])
def test_merge_network_highfirst_kernel_on_spread_rows(cuda, seed, rows,
                                                       chunks, nout):
    val, rem = _spread_inputs(seed, rows, chunks, nout)
    got, want = _merge("merge_highfirst", val.to(cuda), rem.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)
    assert not want[1].any()                          # settled


def _flagged(wrapper, dev) -> int:
    t = wrapper.flagged.get(dev)
    return 0 if t is None else int(t.item())


GUARDED = {"concat": (merge_network, "merge"),
           "tgt": (merge_network_tgt, "merge_tgt"),
           "highfirst": (merge_network_highfirst, "merge_highfirst")}


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(GUARDED))
@pytest.mark.parametrize("seed,rows,n,bad", [
    (0, 4, 5000, ()),                 # every row placed
    (1, 3, 70001, (0, 1, 2)),         # every row through the network
    (2, 6, 3071, (1, 3, 5)),          # both branches in one call
    (3, 5, 2049, (0, 2)),
    (4, 2, 1, ())])
def test_guarded_merge_kernels_match_plain(cuda, form, seed, rows, n, bad):
    """Each merge form on rows that pass its guard, rows that do not, and
    both in one call: each equals its plain network, and the device counts
    exactly the rows that failed."""
    arrays = _guarded_rows(seed, rows, n, form, bad)
    on_card = [a.to(cuda) for a in arrays]
    wrapper, which = GUARDED[form]
    dev = on_card[0].device
    flagged = _flagged(wrapper, dev)
    branches = dict(wrapper.branch_launches)
    got, want = _merge(which, *on_card)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)
    assert _flagged(wrapper, dev) == flagged + len(bad)
    assert wrapper.branch_launches == {b: c + 1 for b, c in branches.items()}


def _hostile_rows(seed, rows, n, form):
    """Rows for the decoder's merge forms outside any codec's range, as a
    corrupt payload could hand them over if a guard upstream failed: per
    row, displacements drawn from the whole int32 range, small negative
    ones, ones past n, or in no order below n + 9; random values, and for
    `tgt` random targets of either sign.  Returns int32 tensors (val, rem,
    tgt) or (val, rem)."""
    rng = np.random.default_rng(seed)
    val = rng.integers(-(1 << 31), 1 << 31, (rows, n))
    kinds = [(-(1 << 31), 1 << 31), (-n - 9, 0), (n, 2 * n + 9),
             (-9, n + 9)]
    rem = np.stack([rng.integers(*kinds[r % 4], n) for r in range(rows)])
    if form == "tgt":
        tgt = rng.integers(-(1 << 31), 1 << 31, (rows, n))
        return tuple(torch.from_numpy(a.astype(np.int32))
                     for a in (val, rem, tgt))
    return tuple(torch.from_numpy(a.astype(np.int32)) for a in (val, rem))


HOSTILE_CASES = [(0, 4, 5000), (1, 8, 2049), (2, 2, 70001), (3, 4, 1)]


@pytest.mark.parametrize("seed,rows,n", HOSTILE_CASES)
def test_hostile_rows_fail_every_guard(seed, rows, n):
    """The hostile rows of the decoder's merge forms lie outside their
    guards (each row fails the form's guard where it has more than one
    slot), and the plain networks settle them without raising."""
    val, rem, tgt = _hostile_rows(seed, rows, n, "tgt")
    assert (rem < 0).any() and (rem >= n).any()
    if n > 1:
        assert not tdev._concat_guard(rem).any()
    for out in (tdev._settle_network_tgt(val, rem, tgt),
                tdev._settle_network_highfirst(
                    *_hostile_rows(seed, rows, n, "highfirst"))):
        assert all(o.shape == (rows, n) for o in out)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["tgt", "highfirst"])
@pytest.mark.parametrize("seed,rows,n", HOSTILE_CASES)
def test_decoder_merge_kernels_on_hostile_rows(cuda, form, seed, rows, n):
    """The decoder's two merge forms on hostile rows (`_hostile_rows`):
    each equals its plain network bit for bit, and the context runs the
    same launch again after them."""
    arrays = _hostile_rows(seed, rows, n, form)
    wrapper, which = GUARDED[form]
    got, want = _merge(which, *(a.to(cuda) for a in arrays))
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)
    # the context still runs a launch after them
    again, want = _merge(which, *(a.to(cuda) for a in arrays))
    torch.cuda.synchronize()
    assert torch.equal(again[0].cpu(), want[0])


@pytest.mark.gpu
def test_device_decode_on_the_card_matches_golden(cuda):
    from cineform_tpu_torch.models.intra import IntraCodec
    from test_intra_host import _golden

    launches = [merge_network_tgt.launches, merge_network_highfirst.launches]
    flagged = [_flagged(w, torch.device("cuda", 0))
               for w in (merge_network_tgt, merge_network_highfirst)]
    out, fallback = IntraCodec(320, 240, 4, device=cuda).decode_batch_device(
        [_golden("s_320x240_q4_p1", "cfhd")])
    assert fallback == ()
    assert out.tobytes() == _golden("s_320x240_q4_p1", "yuy2")
    assert merge_network_tgt.launches == launches[0] + 6
    assert merge_network_highfirst.launches == launches[1] + 6
    # every decoder row took the placement
    assert flagged == [_flagged(w, torch.device("cuda", 0))
                       for w in (merge_network_tgt, merge_network_highfirst)]


@pytest.mark.gpu
def test_wrappers_reject_non_contiguous_cuda_tensors(cuda):
    x = torch.zeros((16, 16), dtype=torch.int32, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        dwt_forward_level(x)


@pytest.mark.gpu
def test_dwt_forward_yuy2_rejects_misaligned_frames(cuda):
    buf = torch.zeros(1 + 8 * 32, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="4-byte"):
        dwt_forward_yuy2(buf[1:].view(1, 8, 32), 10, 0, LEVEL_QUANTS[0])


@pytest.mark.gpu
def test_codec_on_the_card_matches_golden(cuda):
    from cineform_tpu_torch.models.intra import IntraCodec
    from cineform_tpu_torch.testframes import yuy2_frame
    # this directory is on sys.path under pytest; a `tests` package
    # installed elsewhere may shadow the repository's
    from test_intra_host import _golden, _metadata_from

    gold = _golden("s_320x240_q4_p1", "cfhd")
    codec = IntraCodec(320, 240, 4, device=cuda)
    frames = np.frombuffer(yuy2_frame(320, 240, 1), np.uint8).reshape(
        1, 240, 640)
    assert codec.encode_batch_device(frames, 1, _metadata_from(gold))[0] \
        == gold
    assert codec.decode_batch([gold]).tobytes() == \
        _golden("s_320x240_q4_p1", "yuy2")


@pytest.mark.gpu
def test_pools_on_the_card_equal_the_pools_on_the_cpu(cuda):
    """An EncoderPool and a DecoderPool on the card, 320x240, batches of 3
    frames (submitted, then harvested): the samples and frames equal the
    same pools' with `device="cpu"`."""
    from cineform_tpu_torch import api, pool
    from cineform_tpu_torch.testframes import yuy2_frame

    frames = [yuy2_frame(320, 240, p) for p in range(6)]

    def run(device):
        enc = api.CFHD_CreateEncoderPool(1, 3, device=device)
        enc.prepare_to_encode(320, 240, api.PixelFormat.YUY2)
        enc.start()
        samples = []
        for i, f in enumerate(frames):
            enc.encode_async_sample(i + 1, f)
            if i % 3 == 2:
                samples += [enc.wait_for_sample(timeout=600)
                            .get_encoded_sample() for _ in range(3)]
        enc.stop()
        decoded = {}
        for output in (api.PixelFormat.YUY2, api.PixelFormat.BGRA):
            dec = pool.DecoderPool(2, 3, device=device)
            dec.prepare_to_decode(320, 240, output)
            dec.start()
            for i, s in enumerate(samples):
                dec.decode_async_sample(i + 1, s)
            decoded[output] = [dec.wait_for_frame(timeout=600).data.tobytes()
                               for _ in samples]
            dec.stop()
            assert dec.fallback_frames == 0
        return samples, decoded

    assert run(cuda) == run("cpu")


@pytest.mark.gpu
def test_bayer_rgb_outputs_on_the_card_equal_the_cpu(cuda):
    """The Bayer outputs on the card, both decode routes, equal the same
    decodes with `device="cpu"`: the 320x240 WBAL golden (the raw chain
    and its develop matrix) and a seeded batch of two 256x128 mosaics."""
    from cineform_tpu_torch.models.intra import IntraCodec
    from cineform_tpu_torch.ops.demosaic import DevelopPlan
    from cineform_tpu_torch.ref.demosaic import compose_develop_matrix

    with open(os.path.join(REPO, "tests", "golden", "samples",
                           "byr4_wbal_320x240_q4.cfhd"), "rb") as f:
        golden = f.read()
    rng = np.random.default_rng(256)
    frames = rng.integers(0, 256, (2, 128, 512)).astype(np.uint8)
    wbal = compose_develop_matrix(None, 1.0, 1.0, (1.7, 1.0, 0.6))
    for w, h, samples in ((320, 240, [golden]), (256, 128, None)):
        on = {d: IntraCodec(w, h, 4, device=d, input_format="BYR4")
              for d in (cuda, "cpu")}
        if samples is None:
            samples = on["cpu"].encode_batch(frames)
        mats = [DevelopPlan(matrix=wbal)] * len(samples)
        for output in ("RG48", "b64a", "WP13", "W13A", "BYR2", "YUY2"):
            for develop in (None, mats if output != "BYR2" else None):
                want = on["cpu"].decode_batch(samples, output=output,
                                              develop=develop)
                assert on[cuda].decode_batch(
                    samples, output=output, develop=develop).tobytes() == \
                    want.tobytes()
                out, fallback = on[cuda].decode_batch_device(
                    samples, output=output, develop=develop)
                assert fallback == () and out.tobytes() == want.tobytes()


@pytest.mark.gpu
def test_outputs_and_scaled_decodes_on_the_card_equal_the_cpu(cuda):
    """Every decode output of a 4:2:2 and of an RGB source (the packers of
    `ops.yuv_output` on the card), and the half, quarter and thumbnail
    decodes, on both routes, equal the same decodes with `device="cpu"`:
    the 144x96 golden (an odd chroma lowpass width), the 320x240 one (a
    partial v210 group) and the RG48 one."""
    from cineform_tpu_torch.models.intra import _DECODE_OUTPUTS, IntraCodec

    for name, fmt, w, h in (("s_144x96_q4_p1", "YUY2", 144, 96),
                            ("s_320x240_q4_p1", "YUY2", 320, 240),
                            ("rg48_320x240_q4_p1", "RG48", 320, 240)):
        with open(os.path.join(REPO, "tests", "golden", "samples",
                               name + ".cfhd"), "rb") as f:
            samples = [f.read()]
        on = {d: IntraCodec(w, h, 4, device=d, input_format=fmt)
              for d in (cuda, "cpu")}
        cases = [(output, 1) for output in _DECODE_OUTPUTS[on["cpu"].encoded]]
        if fmt == "YUY2":
            cases += [("YUY2", res) for res in (2, 3, 4)]
        for output, res in cases:
            want = on["cpu"].decode_batch(samples, output=output,
                                          resolution=res)
            assert on[cuda].decode_batch(
                samples, output=output, resolution=res).tobytes() == \
                want.tobytes(), (name, output, res)
            out, fallback = on[cuda].decode_batch_device(
                samples, output=output, resolution=res)
            assert fallback == () and out.tobytes() == want.tobytes(), \
                (name, output, res)


@pytest.mark.gpu
def test_geometry_on_the_card_equals_the_cpu(cuda):
    """The geometry stage on the card equals it with `device="cpu"`:
    api.Decoder's decode to another size (an intra sample, a group), a
    group's deep outputs, and the warp (the fill blends and blur) of a
    mesh with backgroundfill in every format."""
    from cineform_tpu_torch import api
    from cineform_tpu_torch.ops import warp
    from cineform_tpu_torch.ref import geomesh

    gold = os.path.join(REPO, "tests", "golden", "samples")
    for name, fmt, size in (("s_320x240_q4_p1.cfhd", "RG48", (211, 157)),
                            ("s_320x240_q4_p1.cfhd", "YUY2", (480, 360)),
                            ("gop_320x240_q4_p1.cfhd.f1", "B64A", (200, 150)),
                            ("gop_320x240_q4_p1.cfhd.f1", "V210", (0, 0)),
                            ("gop_320x240_q4_p1.cfhd.f1", "BGRA", (0, 0))):
        with open(os.path.join(gold, name), "rb") as f:
            sample = f.read()
        got = []
        for d in (cuda, "cpu"):
            dec = api.Decoder(d)
            dec.prepare_to_decode(*size, api.PixelFormat[fmt], sample=sample)
            got.append(dec.decode_sample(sample).tobytes())
            assert dec.fallback_frames == 0
        assert got[0] == got[1], (name, fmt, size)
    rng = np.random.default_rng(2)
    for fmt, bpp in (("YUY2", 2), ("32BGRA", 4), ("RG48", 6), ("W13A", 8)):
        f = getattr(geomesh, "FORMAT_" + fmt)
        mesh = geomesh.GeoMesh(39, 29)
        mesh.init(96, 64, 96 * bpp, f, 96, 64, 96 * bpp, f, 1)
        mesh.transform_scale(0.7, 0.7)
        mesh.transform_rotate(9.0)
        mesh.cache_init_bilinear_range(0, 64, geomesh.GlibcRand())
        frames = torch.from_numpy(rng.integers(0, 256, (2, 64 * 96 * bpp),
                                               np.uint8))
        out = [warp.blur_vertical(m, warp.apply_bilinear(m, frames.to(d)))
               .cpu() for m, d in ((warp.upload(mesh, cuda), cuda),
                                   (warp.upload(mesh, "cpu"), "cpu"))]
        assert torch.equal(out[0], out[1]), fmt


#: the encoder's new level-1 inputs: (input format, LYUV/CV67 transform)
#: and the DWT entry point that takes every level of it
NEW_INPUTS = [*((fmt, None, "planes") for fmt in (
    "R210", "DPX0", "RG30", "AB10", "AR10", "BGRA", "BGRa", "RG24")),
    *((fmt, None, "groups") for fmt in (
        "CT_UCHAR", "CT_10BIT_2_8", "CT_SHORT_2_14", "CT_USHORT_10_6",
        "CT_SHORT")),
    ("YUY2", (1, 0), "groups"), ("YUY2", (0, 1), "groups"),
    ("YUY2", (1, 1), "groups")]


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,convert,dwt_name", NEW_INPUTS)
def test_new_inputs_forward_packed_on_the_card(cuda, fmt, convert,
                                               dwt_name):
    """On the card the packed 10-bit and 8-bit RGB inputs launch
    `dwt_forward_planes` 3 times an encode, the Avid CT family and a YUY2
    frame through the LYUV/CV67 transform `dwt_forward_groups` 3 times
    (level 1 from the plain unpack), no other DWT entry point, and each
    equals the plain path; so do the samples of `encode_batch_device`."""
    from cineform_tpu_torch.models.intra import IntraCodec

    w, h = 192, 96
    codec = IntraCodec(w, h, 4, device=torch.device("cpu"), input_format=fmt,
                       convert=convert)
    frames = np.random.default_rng(len(fmt)).integers(
        0, 256, (2, h, codec.row_bytes)).astype(np.uint8)
    want = codec.forward_packed(torch.from_numpy(frames))
    wrappers = {"planes": dwt_forward_planes, "groups": dwt_forward_groups,
                "yuy2": dwt_forward_yuy2, "level": dwt_forward_level}
    before = {n: f.launches for n, f in wrappers.items()}
    card = IntraCodec(w, h, 4, device=cuda, input_format=fmt,
                      convert=convert)
    got = card.forward_packed(torch.from_numpy(frames).to(cuda))
    torch.cuda.synchronize()
    assert {n: f.launches - before[n] for n, f in wrappers.items()} == {
        n: 3 if n == dwt_name else 0 for n in wrappers}
    assert _equal(got, want)
    assert card.encode_batch_device(frames) == \
        codec.encode_batch_device(frames)


def _custom_quants(table):
    """Per level, the (LH, HL, HH) quantizers of Y, V, U that a caller's
    17-entry table gives through `custom_quant_tables`."""
    from cineform_tpu_torch.spec.production import (IntraParams,
                                                    custom_quant_tables)

    tables = tuple(map(tuple, custom_quant_tables(table, table, 10)))
    p = IntraParams(width=64, height=48, quality=4, custom_quant=tables)
    return [[p.band_quant(ch)[k] for ch in range(3)] for k in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("table", [[1] * 17, [0xFFFF] * 17],
                         ids=["q1", "largest"])
@pytest.mark.parametrize("b,h,w", [(2, 96, 192), (1, 1080, 1920)])
def test_custom_quantizers_kernels_match_plain(cuda, b, h, w, table):
    """`dwt_forward_yuy2` and `dwt_forward_groups` at a caller's custom
    quantizers, all 1 and the largest a 16-bit table entry gives after the
    x4 scaling and the band scales, equal their plain versions."""
    quants = _custom_quants(table)
    frames = torch.from_numpy(np.random.default_rng(w).integers(
        0, 256, (b, h, 2 * w)).astype(np.uint8))
    got = dwt_forward_yuy2(frames.to(cuda), 10, 0, quants[0])
    assert _equal(got, dwt.plain_groups(intra_transform.unpack_yuy2(frames),
                                        0, quants[0]))
    lows = tuple(t.cpu() for t in got[0])
    for k in (1, 2):
        prescale = (0, 2, 0)[k]
        got = dwt_forward_groups(tuple(t.to(cuda) for t in lows), prescale,
                                 quants[k])
        want = dwt.plain_groups((lows[0][:, 0], lows[1][:, 0],
                                 lows[1][:, 1]), prescale, quants[k])
        assert _equal(got, want)
        lows = tuple(t.cpu() for t in got[0])


@pytest.mark.gpu
def test_encoder_options_on_the_card_equal_the_cpu(cuda, monkeypatch,
                                                   tmp_path):
    """api.Encoder on the card equals it with `device="cpu"` on every
    encoder route of this slice: custom quantization, LYUV and CV67 from
    the override database, a V210 passthrough series with both kinds of
    frame, and the interlaced GOP, whose pattern-1/2 group is the
    reference's golden."""
    from cineform_tpu_torch import api
    from cineform_tpu_torch import testframes as tf
    from cineform_tpu_torch.models.intra import sample_metadata

    monkeypatch.setenv("CINEFORM_OVERRIDE_PATH", str(tmp_path))
    monkeypatch.setenv("CINEFORM_LUT_PATH", str(tmp_path))

    def both(fmt, w, h, frames, quality=4, flags=0, custom=None, meta=None):
        out = []
        for d in (cuda, "cpu"):
            enc = api.Encoder(d)
            enc.prepare_to_encode(w, h, api.PixelFormat[fmt],
                                  encoding_flags=api.EncodingFlags(flags),
                                  quality=quality)
            if custom:
                enc.set_custom_quantization(custom)
            enc.attach_metadata(meta)
            samples = []
            for f in frames:
                enc.encode_sample(f)
                samples.append(enc.get_sample_data())
            out.append(samples)
        assert out[0] == out[1], fmt
        return out[0]

    yuy2 = [tf.yuy2_frame(320, 240, p) for p in (1, 2, 3, 4)]
    both("YUY2", 320, 240, yuy2, 5, custom=[4] + [40] * 16)
    for tags_ in ((b"LYUV",), (b"CV67",), (b"LYUV", b"CV67")):
        (tmp_path / "override.colr").write_bytes(b"".join(
            t + (4).to_bytes(3, "little") + b"H" + (1).to_bytes(4, "little")
            for t in tags_))
        both("YUY2", 320, 240, yuy2[:2])
    (tmp_path / "override.colr").unlink()
    v210 = both("V210", 96, 48, [tf.v210_frame(96, 48, f + 1)
                                 for f in range(12)], 0x0404)
    assert len({len(s) > 10000 for s in v210}) == 2
    gold_path = os.path.join(REPO, "tests", "golden", "samples",
                             "ilace_320x240_q4_p1.cfhd.f1")
    with open(gold_path, "rb") as f:
        gold = f.read()
    assert both("YUY2", 320, 240, yuy2, flags=3,
                meta=sample_metadata(gold))[1] == gold

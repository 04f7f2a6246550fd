"""The port's three CUDA kernels and their wrappers.

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
from cineform_tpu_torch.ops import intra_transform
from cineform_tpu_torch.ops.chunk_pack import chunk_pack
from cineform_tpu_torch.ops.dwt_forward import dwt_forward_level
from cineform_tpu_torch.ops.merge_network import merge_network

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = (dwt_forward_level, chunk_pack, merge_network)


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

    bits, sizes = _codes(1, (2, 256), 0.9)
    got = chunk_pack(bits, sizes)
    want = tdev.tree_pack(bits, sizes, cap_bits_per_elem=12)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    val, rem = _concat_inputs(2, 2, 6, 0.3)
    got = merge_network(val, rem)
    want = tdev._settle_network(val, rem)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [w.launches for w in WRAPPERS] == counts


@pytest.mark.parametrize("which", ["dwt", "pack", "merge"])
def test_wrappers_raise_on_wrong_dtype(which):
    with pytest.raises(TypeError):
        if which == "dwt":
            dwt_forward_level(torch.zeros((8, 8), dtype=torch.int64))
        elif which == "pack":
            chunk_pack(torch.zeros((1, 256), dtype=torch.int64),
                       torch.zeros((1, 256), dtype=torch.int32))
        else:
            merge_network(torch.zeros(64, dtype=torch.float32),
                          torch.zeros(64, dtype=torch.int32))


@pytest.mark.parametrize("which", ["dwt", "pack", "merge"])
def test_wrappers_do_not_fall_back_off_the_cpu(which):
    """A tensor on a device without a kernel raises instead of taking the
    plain version."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        if which == "dwt":
            dwt_forward_level(torch.zeros((8, 8), dtype=torch.int32,
                                          device=meta))
        elif which == "pack":
            z = torch.zeros((1, 256), dtype=torch.int32, device=meta)
            chunk_pack(z, z)
        else:
            z = torch.zeros(64, dtype=torch.int32, device=meta)
            merge_network(z, z)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        dwt_forward_level(torch.zeros((7, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        chunk_pack(torch.zeros((1, 128), dtype=torch.int32),
                   torch.zeros((1, 128), dtype=torch.int32))
    with pytest.raises(ValueError):
        merge_network(torch.zeros(64, dtype=torch.int32),
                      torch.zeros(32, dtype=torch.int32))


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
        "from cineform_tpu_torch.models.intra import IntraCodec\n"
        "from cineform_tpu_torch.testframes import yuy2_frame\n"
        "c = IntraCodec(64, 48, 4, device=torch.device('cpu'))\n"
        "f = np.frombuffer(yuy2_frame(64, 48, 1), np.uint8)"
        ".reshape(1, 48, 128)\n"
        "out = c.decode_batch(c.encode_batch_device(f))\n"
        "assert out.shape == (1, 48, 128)\n"
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


@pytest.mark.gpu
@pytest.mark.parametrize("seed,rows,chunks,density", [(0, 3, 40, 0.5),
                                                      (1, 2, 9, 0.02),
                                                      (2, 4, 64, 0.9)])
def test_merge_network_kernel_matches_plain(cuda, seed, rows, chunks,
                                            density):
    val, rem = _concat_inputs(seed, rows, chunks, density)
    got_v, got_r = merge_network(val.to(cuda), rem.to(cuda))
    torch.cuda.synchronize()
    want_v, want_r = tdev._settle_network(val, rem)
    assert torch.equal(got_v.cpu(), want_v)
    assert torch.equal(got_r.cpu(), want_r)


@pytest.mark.gpu
def test_wrappers_reject_non_contiguous_cuda_tensors(cuda):
    x = torch.zeros((16, 16), dtype=torch.int32, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        dwt_forward_level(x)


@pytest.mark.gpu
def test_codec_on_the_card_matches_golden(cuda):
    from cineform_tpu.utils.testframes import yuy2_frame
    from cineform_tpu_torch.models.intra import IntraCodec
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

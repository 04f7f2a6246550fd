"""The port's band entropy encoder (cineform_tpu_torch.entropy.device) vs
the JAX package's, the Pallas kernels in interpret mode, the host coder and
the reference encoder's golden band streams.

JAX is compared only at the tier-1 sizes of tests/test_entropy_device.py
and tests/test_pallas_pack.py (its CPU compiles of larger bands take
minutes); larger bands are held against the host coder, which needs no
JAX.  Every comparison is exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cineform_tpu.entropy import device as jdev
from cineform_tpu.entropy import host as ehost
from cineform_tpu.ops.pallas_merge import merge_network as pallas_merge
from cineform_tpu.ops.pallas_pack import chunk_pack as pallas_pack
from cineform_tpu_torch.entropy import device as tdev
from tests.test_entropy_host import CASES, CB_BY_INDEX, xorshift32_band

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _u32(x) -> np.ndarray:
    """Words of either package as uint32 numpy."""
    return np.asarray(x).astype(np.int64).astype(np.uint32) \
        if np.asarray(x).dtype != np.int32 else np.asarray(x).view(np.uint32)


def _host_bytes(band: np.ndarray, codeset: int) -> bytes:
    bits, sizes = ehost.encode_band(band, codeset)
    return ehost.pack_msb_first(bits, sizes, align=32)


def _port_bytes(band: np.ndarray, codeset: int) -> bytes:
    words, nbits, ovf = tdev.encode_band_arrays(
        _t(band.reshape(-1).astype(np.int32)), codeset, cap_bits_per_elem=27)
    assert not bool(ovf)
    return tdev.finish_band_bytes(words.numpy(), int(nbits), codeset)


def _sparse(seed, shape, density, lo=-200, hi=200):
    rng = np.random.default_rng(seed)
    vals = rng.integers(lo, hi, size=shape, dtype=np.int32)
    vals[rng.random(vals.shape) >= density] = 0
    return vals


@pytest.mark.parametrize("codeset", [9, 17, 18])
def test_encode_tables_match_jax(codeset):
    assert dataclasses.asdict(tdev.encode_tables(codeset)) == \
        dataclasses.asdict(jdev.encode_tables(codeset))


def test_finish_band_bytes_matches_jax():
    rng = np.random.default_rng(1)
    for total in (0, 1, 31, 32, 33, 700, 2047):
        words = rng.integers(0, 2**32, 80, dtype=np.uint64).astype(np.uint32)
        nwords = -(-total // 32)
        words[nwords:] = 0
        if total % 32:
            words[nwords - 1] &= np.uint32(0xFFFFFFFF << (32 - total % 32)
                                           & 0xFFFFFFFF)
        want = jdev.finish_band_bytes(words, total, 17)
        assert tdev.finish_band_bytes(words.view(np.int32), total, 17) == want
        assert tdev.finish_band_bytes(words, total, 17) == want


def test_run_geometry_matches_jax():
    zero = np.random.default_rng(2).random((2, 1024)) < 0.9
    zero[0, 100:700] = True
    for got, want in zip(tdev._run_geometry(_t(zero), 64),
                         jdev._run_geometry(jnp.asarray(zero), 64)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("codeset", [9, 17, 18])
@pytest.mark.parametrize("seed,density", [(0, 0.2), (1, 0.9), (2, 0.0)])
def test_band_codes_matches_jax(codeset, seed, density):
    vals = _sparse(seed, (2, 4 * 256), density, -1500, 1500)
    t = jdev.encode_tables(codeset)
    jbits, jsizes = jax.jit(lambda v: jdev.band_codes(v, t, 256))(
        jnp.asarray(vals))
    bits, sizes = tdev.band_codes(_t(vals), tdev.encode_tables(codeset), 256)
    np.testing.assert_array_equal(_u32(bits.numpy()), _u32(jbits))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))


@pytest.mark.parametrize("seed,density", [(0, 0.2), (1, 0.9), (2, 0.0)])
def test_tree_pack_matches_jax_and_pallas(seed, density):
    """The three seeds and densities of tests/test_pallas_pack.py; density
    0.9 overflows chunks, whose truncated words must agree too."""
    vals = _sparse(seed, (2, 4 * 256), density)
    t = jdev.encode_tables(17)
    jbits, jsizes = jax.jit(lambda v: jdev.band_codes(v, t, 256))(
        jnp.asarray(vals))
    b4 = jnp.asarray(np.asarray(jbits).reshape(2, 4, 256))
    s4 = jnp.asarray(np.asarray(jsizes).reshape(2, 4, 256))
    jw, jl, jo = jax.jit(
        lambda b, s: jdev.tree_pack(b, s, cap_bits_per_elem=12))(b4, s4)
    pw, pl_, po = pallas_pack(b4, s4, interpret=True)
    w, ln, o = tdev.tree_pack(_t(np.asarray(b4).view(np.int32)),
                              _t(np.asarray(s4)), cap_bits_per_elem=12)
    assert w.dtype == torch.int32 and ln.dtype == torch.int32
    for want_w, want_l, want_o in ((jw, jl, jo), (pw, pl_, po)):
        np.testing.assert_array_equal(_u32(w.numpy()), _u32(want_w))
        np.testing.assert_array_equal(ln.numpy(), np.asarray(want_l))
        np.testing.assert_array_equal(o.numpy(), np.asarray(want_o))
    if density == 0.9:
        assert o.any()


@functools.lru_cache(maxsize=None)
def _jax_tree_pack(cap):
    return jax.jit(functools.partial(jdev.tree_pack, cap_bits_per_elem=cap))


@pytest.mark.parametrize("cap", [8, 12, 27])
@pytest.mark.parametrize("density", [0.0, 0.2, 0.5, 0.9])
def test_pack_direct_matches_tree_pack_and_jax(density, cap):
    """The chunk_pack kernel's prefix-sum packing (csrc/chunk_pack.cu)
    equals the tree, the port's and the JAX package's, on every chunk whose
    flag is clear, and on every chunk where no level truncates; lengths and
    flags equal everywhere.  The last chunk of each row ends exactly on a
    word boundary."""
    vals = _sparse(10 + cap, (2, 4 * 256), density)
    bits, sizes = tdev.band_codes(_t(vals), tdev.encode_tables(17))
    bits, sizes = bits.reshape(2, 4, 256), sizes.reshape(2, 4, 256)
    sizes[:, -1] = torch.where(torch.arange(256) < 64, 8, 0)   # 512 bits
    w, ln, o = tdev.tree_pack(bits, sizes, cap_bits_per_elem=cap)
    jw, jl, jo = _jax_tree_pack(cap)(jnp.asarray(bits.numpy()),
                                     jnp.asarray(sizes.numpy()))
    dw, dl, do = tdev._pack_direct(bits, sizes, cap_bits_per_elem=cap)
    fits = tdev._pack_fits(sizes, cap_bits_per_elem=cap)
    assert torch.equal(dl, ln) and torch.equal(do, o)
    np.testing.assert_array_equal(dl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(do.numpy(), np.asarray(jo))
    assert fits[~o].all()
    assert torch.equal(dw[fits], w[fits])
    np.testing.assert_array_equal(_u32(dw[fits].numpy()),
                                  _u32(np.asarray(jw)[fits.numpy()]))
    assert (ln[:, -1] == 512).all() and fits[:, -1].all()


def _monotone_case(rng, shape):
    """tests/test_pallas_merge.py's inputs: displacements nondecreasing
    with {0,1} steps, random words."""
    steps = rng.integers(0, 2, shape)
    rem = np.cumsum(steps, axis=-1).astype(np.int32)
    val = rng.integers(0, 2**32, shape, dtype=np.uint32)
    return val, rem


def _direct_settle(val: np.ndarray, rem: np.ndarray) -> np.ndarray:
    """Every slot ORed into target u - rem[u], targets off the row dropped:
    what the network settles to when the displacements are monotone."""
    out = np.zeros(val.shape, np.uint32)
    n = val.shape[-1]
    for r in range(val.shape[0]):
        tgt = np.arange(n) - rem[r]
        keep = (tgt >= 0) & (tgt < n)
        np.bitwise_or.at(out[r], tgt[keep], val[r][keep])
    return out


@pytest.mark.parametrize("n", [4096, 65536 + 17, 198548])
def test_settle_network_matches_jax_pallas_and_direct(n):
    rng = np.random.default_rng(n)
    val, rem = _monotone_case(rng, (2, n))
    v, r = tdev._settle_network(_t(val.view(np.int32)), _t(rem))
    pv, pr = pallas_merge(jnp.asarray(val), jnp.asarray(rem), lowfirst=True,
                          interpret=True)
    np.testing.assert_array_equal(_u32(v.numpy()), np.asarray(pv))
    np.testing.assert_array_equal(r.numpy(), np.asarray(pr))
    if n == 4096:
        jv, jr = jax.jit(jdev._settle_network)(jnp.asarray(val),
                                               jnp.asarray(rem))
        np.testing.assert_array_equal(_u32(v.numpy()), np.asarray(jv))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    # on monotone displacements the settled network is the direct
    # OR-scatter, and it leaves no displacement behind
    np.testing.assert_array_equal(_u32(v.numpy()), _direct_settle(val, rem))
    assert not r.any()


def test_settle_network_on_concat_inputs_is_direct():
    """The encoder's own network inputs (a band group of chunk payloads,
    no chunk overflowed) settle to the direct OR-scatter with all
    displacements 0."""
    vals = _sparse(3, (3, 40 * 256), 0.5)
    bits, sizes = tdev.band_codes(_t(vals), tdev.encode_tables(17))
    bufs, lens, _ = tdev.tree_pack(bits.reshape(3, 40, 256),
                                   sizes.reshape(3, 40, 256),
                                   cap_bits_per_elem=12)
    val, rem, _ = tdev._concat_slots(bufs, lens)
    v, r = tdev._settle_network(val, rem)
    np.testing.assert_array_equal(
        _u32(v.numpy()), _direct_settle(_u32(val.numpy()), rem.numpy()))
    assert not r.any()


def test_overflowed_chunks_break_monotone_displacements():
    """A chunk whose codes outgrow its words makes the displacements fall,
    so the network is no longer a scatter: the merge_network kernel runs
    the network itself (csrc/merge_network.cu)."""
    vals = _sparse(2, (3, 9 * 256), 0.9)
    bits, sizes = tdev.band_codes(_t(vals), tdev.encode_tables(17))
    bufs, lens, ovf = tdev.tree_pack(bits.reshape(3, 9, 256),
                                     sizes.reshape(3, 9, 256),
                                     cap_bits_per_elem=12)
    assert ovf.any()
    val, rem, _ = tdev._concat_slots(bufs, lens)
    assert (rem[..., 1:] < rem[..., :-1]).any()
    v, r = tdev._settle_network(val, rem)
    pv, pr = pallas_merge(jnp.asarray(_u32(val.numpy())),
                          jnp.asarray(rem.numpy()), lowfirst=True,
                          interpret=True)
    np.testing.assert_array_equal(_u32(v.numpy()), np.asarray(pv))
    np.testing.assert_array_equal(r.numpy(), np.asarray(pr))
    assert not np.array_equal(_u32(v.numpy()),
                              _direct_settle(_u32(val.numpy()), rem.numpy()))


def _concat_case(seed, rows, chunks, density):
    """The encoder's network inputs for a band group, and each chunk's
    overflow flag."""
    vals = _sparse(seed, (rows, chunks * 256), density)
    bits, sizes = tdev.band_codes(_t(vals), tdev.encode_tables(17))
    bufs, lens, ovf = tdev.tree_pack(bits.reshape(rows, chunks, 256),
                                     sizes.reshape(rows, chunks, 256),
                                     cap_bits_per_elem=12)
    val, rem, _ = tdev._concat_slots(bufs, lens)
    return val, rem, ovf


@pytest.mark.parametrize("density", [0.0, 0.02, 0.2])
def test_concat_guard_holds_and_placement_matches_on_clear_rows(density):
    """On the encoder's rows with no overflowed chunk the merge_network
    kernel's guard holds, and its placement equals the network, the port's
    and the Pallas kernel's in interpret mode."""
    val, rem, ovf = _concat_case(3, 3, 40, density)
    assert not ovf.any()
    assert tdev._concat_guard(rem).all()
    pv, pr = tdev._place_concat(val, rem)
    v, r = tdev._settle_network(val, rem)
    assert torch.equal(pv, v) and torch.equal(pr, r)
    kv, kr = pallas_merge(jnp.asarray(_u32(val.numpy())),
                          jnp.asarray(rem.numpy()), lowfirst=True,
                          interpret=True)
    np.testing.assert_array_equal(_u32(pv.numpy()), np.asarray(kv))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(kr))


@pytest.mark.parametrize("seed,density", [(2, 0.9), (4, 0.5), (5, 0.7)])
def test_concat_guard_fails_exactly_where_displacements_fall(seed, density):
    """Seed 2 at density 0.9 is the input of
    test_overflowed_chunks_break_monotone_displacements.  The guard fails
    on the rows whose displacements fall and holds on the others, where
    the placement equals the network though chunks overflowed."""
    val, rem, ovf = _concat_case(seed, 3, 9, density)
    assert ovf.any()
    falls = (rem[..., 1:] < rem[..., :-1]).any(dim=-1)
    guard = tdev._concat_guard(rem)
    assert torch.equal(guard, ~falls)
    v, r = tdev._settle_network(val, rem)
    pv, pr = tdev._place_concat(val, rem)
    for i in range(3):
        assert (torch.equal(pv[i], v[i]) and torch.equal(pr[i], r[i])) \
            == bool(guard[i])


@pytest.mark.parametrize("n", [1, 4096, 65536 + 17])
def test_place_concat_matches_network_on_monotone_rows(n):
    """tests/test_pallas_merge.py's rows (random words, rem[0] in {0, 1})
    pass the guard, and the placement ORs the slots of a target as the
    network does."""
    val, rem = _monotone_case(np.random.default_rng(n + 1), (2, n))
    val, rem = _t(val.view(np.int32)), _t(rem)
    assert tdev._concat_guard(rem).all()
    pv, pr = tdev._place_concat(val, rem)
    v, r = tdev._settle_network(val, rem)
    assert torch.equal(pv, v) and torch.equal(pr, r)


@pytest.mark.parametrize("cap", [2, 8, 27])
def test_encode_band_arrays_matches_jax(cap):
    """One 4096-element band, as tests/test_entropy_device.py's tier-1
    overflow case (cap 2 overflows)."""
    rng = np.random.default_rng(4)
    band = rng.integers(-1023, 1024, size=4096, dtype=np.int32)
    band[band == 0] = 1
    band[rng.random(4096) < 0.6] = 0
    jw, jn, jo = jax.jit(lambda v: jdev.encode_band_arrays(
        v, 17, cap_bits_per_elem=cap))(jnp.asarray(band))
    w, n, o = tdev.encode_band_arrays(_t(band), 17, cap_bits_per_elem=cap)
    assert bool(o) == bool(jo)
    assert bool(o) == (cap != 27)    # ~5.4 bits per coefficient
    assert int(n) == int(jn)
    np.testing.assert_array_equal(_u32(w.numpy()), _u32(jw))


@pytest.mark.parametrize("case_idx", range(len(CASES)))
def test_band_streams_golden(case_idx):
    """Payloads of the reference encoder's golden band streams, equal to
    the golden bytes and to the host coder's."""
    hdr, golden = CASES[case_idx]
    band = xorshift32_band(int(hdr["seed"]), int(hdr["w"]), int(hdr["h"]),
                           int(hdr["density"]), int(hdr["cap"]))
    codeset = CB_BY_INDEX[int(hdr["cb"])]
    mine = _port_bytes(band, codeset)
    assert mine == golden
    assert mine == _host_bytes(band, codeset)


@pytest.mark.parametrize("case", ["sparse", "dense", "allzero", "giant_runs",
                                  "runs_324", "ragged"])
def test_large_band_matches_host(case):
    """Bands of 1080p level-3 size and a ragged length, against the host
    coder (no JAX compile)."""
    rng = np.random.default_rng(len(case))
    n = 135 * 240
    band = np.zeros(n, np.int32)
    if case == "sparse":
        band = _sparse(5, n, 0.1, -300, 300)
    elif case == "dense":
        band = rng.integers(-1023, 1024, n, dtype=np.int32)
    elif case == "giant_runs":
        band[0], band[-1] = 5, -7
    elif case == "runs_324":
        pos = 0
        for run in (0, 1, 11, 12, 13, 19, 20, 21, 31, 32, 33, 59, 60, 61,
                    99, 100, 101, 179, 180, 181, 319, 320, 321, 324, 645,
                    3000, 9999):
            pos += run
            band[pos] = int(rng.integers(1, 100))
            pos += 1
    elif case == "ragged":
        band = _sparse(6, 3001, 0.3, -30000, 30000)
    assert _port_bytes(band, 17) == _host_bytes(band, 17)


def test_encode_band_arrays_batched_rows_are_independent():
    bands = _sparse(7, (2, 3, 2048), 0.2, -50, 50)
    words, nbits, ovf = tdev.encode_band_arrays(_t(bands), 17)
    assert words.shape[:2] == (2, 3) and not ovf.any()
    for i in range(2):
        for j in range(3):
            w1, n1, _ = tdev.encode_band_arrays(_t(bands[i, j]), 17)
            np.testing.assert_array_equal(words[i, j].numpy(), w1.numpy())
            assert int(nbits[i, j]) == int(n1)

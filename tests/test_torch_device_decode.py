"""The port's device entropy decoder (cineform_tpu_torch.entropy.
device_decode) and `IntraCodec.decode_batch_device` on the CPU, against
the JAX package's decoder stage by stage, the Pallas merge kernel in
interpret mode, the host coder and the reference SDK's goldens.

The JAX stages run once on four band rows of at most 512 chunks (module
fixture); every port stage gets the JAX stage's own inputs.  Every
comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cineform_tpu.entropy import device_decode as dd
from cineform_tpu.entropy import host as ehost
from cineform_tpu.models import intra_host
from cineform_tpu.models.intra import IntraCodec as JaxIntraCodec
from cineform_tpu.ops.pallas_merge import merge_network as pallas_merge
from cineform_tpu.ref import intra as xf
from cineform_tpu.spec import tags
from cineform_tpu.spec.production import IntraParams
from cineform_tpu.utils.testframes import yuy2_frame
from cineform_tpu_torch.entropy import device as tdev
from cineform_tpu_torch.entropy import device_decode as tdd
from cineform_tpu_torch.models.intra import IntraCodec
from tests.test_intra_host import _golden
from tests.test_torch_kernels import _guarded_rows

torch.set_num_threads(1)

CPU = torch.device("cpu")
NOUT = 1000
# (density, codeset, quant) per band row: empty, sparse, cs18, dense with
# a quantizer that wraps int16
BANDS = [(0.0, 17, 1), (0.05, 17, 12), (0.3, 18, 4), (0.9, 17, 96)]


def _t(a) -> torch.Tensor:
    """A JAX or numpy integer array as an int32 (or uint8) tensor."""
    a = np.asarray(a)
    if a.dtype != np.uint8:
        a = a.astype(np.int64).astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _payload(vals: np.ndarray, codeset: int) -> bytes:
    bits, sizes = ehost.encode_band(vals, codeset)
    return ehost.pack_msb_first(bits, sizes, align=32)


def _host_ref(payload: bytes, n: int, codeset: int, quant: int):
    want, _ = ehost.decode_band(payload, n, codeset, quant)
    return (want.astype(np.int32) << 16) >> 16   # DeQuantFSM int16 wrap


def _rows(payloads, min_chunks=256):
    """Band payloads -> (payload (R, S*4) uint8, nchunks (R,) int32)."""
    s = min_chunks
    while s < max(len(p) for p in payloads) // 4:
        s *= 2
    pay = np.zeros((len(payloads), s * 4), np.uint8)
    for r, p in enumerate(payloads):
        pay[r, :len(p)] = np.frombuffer(p, np.uint8)
    return pay, np.asarray([len(p) // 4 for p in payloads], np.int32)


@pytest.fixture(scope="module")
def jax_stages():
    """Every JAX decoder stage, run once on the band rows of BANDS."""
    rng = np.random.default_rng(21)
    payloads, host = [], []
    for density, codeset, quant in BANDS:
        vals = np.zeros(NOUT, np.int64)
        nz = rng.random(NOUT) < density
        vals[nz] = rng.integers(-60, 61, nz.sum())
        payloads.append(_payload(vals, codeset))
        host.append(_host_ref(payloads[-1], NOUT, codeset, quant))
    pay, nch = _rows(payloads)
    r, s = pay.shape[0], pay.shape[1] // 4
    assert s <= 512
    quant = np.asarray([q for _, _, q in BANDS], np.int32)
    lin = np.asarray([int(cs == 18) for _, cs, _ in BANDS], np.int32)

    out = {"pay": pay, "nch": nch, "quant": quant, "lin": lin,
           "host": np.stack(host)}
    packed = dd.classify(jnp.asarray(pay))
    out["packed"] = packed
    packed = packed.reshape(r, s, 32)
    out["exits"], out["endm"], out["cnt"] = dd.chunk_transfers(packed)
    # jitted where the eager run takes longer than the compile
    out["entry"], out["base"] = jax.jit(dd.scan_entries_rows)(
        out["exits"], out["endm"], out["cnt"])
    out["act"] = dd.final_walk(packed, out["entry"])
    act = out["act"] * (jnp.arange(s) < jnp.asarray(nch)[:, None])[
        ..., None].astype(jnp.uint32)
    shape = (r, s)
    out["emit_in"] = (packed, act, out["base"], jnp.zeros(shape, jnp.int32),
                      jnp.full(shape, NOUT, jnp.int32),
                      jnp.broadcast_to(jnp.asarray(quant)[:, None], shape),
                      jnp.broadcast_to(jnp.asarray(lin)[:, None], shape))
    out["emit"] = dd.emit_slots(*out["emit_in"])
    out["compact"] = dd.compact_rows(*out["emit"][:3])
    out["spread"] = jax.jit(dd.spread_rows, static_argnames="nout")(
        *out["compact"], nout=NOUT)
    out["scatter"] = dd.spread_rows_scatter(*out["compact"], nout=NOUT)
    out["whole"] = jax.jit(dd.decode_band_rows, static_argnames="nout")(
        jnp.asarray(pay), jnp.asarray(nch), jnp.asarray(quant),
        jnp.asarray(lin), nout=NOUT)
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                else np.asarray(v)) for k, v in out.items()}


def _eq(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


# ---------------------------------------------------------------------------
# Each stage against the JAX stage, on the JAX stage's inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codeset", [17, 18])
def test_interval_tables_match_jax(codeset):
    assert tdd.interval_tables(codeset) == dd.interval_tables(codeset)


def test_interval_tables_reject_incomplete_codes():
    with pytest.raises(ValueError, match="incomplete"):
        tdd.interval_tables(9)


def test_classify_matches_jax(jax_stages):
    _eq(tdd.classify(_t(jax_stages["pay"])), jax_stages["packed"])


def test_chunk_transfers_match_jax(jax_stages):
    packed = _t(jax_stages["packed"]).reshape(len(BANDS), -1, 32)
    for got, want in zip(tdd.chunk_transfers(packed),
                         (jax_stages["exits"], jax_stages["endm"],
                          jax_stages["cnt"]), strict=True):
        _eq(got, want)


def test_scan_entries_rows_matches_jax(jax_stages):
    entry, base = tdd.scan_entries_rows(_t(jax_stages["exits"]),
                                        _t(jax_stages["endm"]),
                                        _t(jax_stages["cnt"]))
    assert entry.dtype == base.dtype == torch.int32
    _eq(entry, jax_stages["entry"])
    _eq(base, jax_stages["base"])
    assert (jax_stages["entry"] == tdd.DONE).any()     # rows past band end


def test_final_walk_matches_jax(jax_stages):
    packed = _t(jax_stages["packed"]).reshape(len(BANDS), -1, 32)
    _eq(tdd.final_walk(packed, _t(jax_stages["entry"])), jax_stages["act"])


def test_emit_slots_matches_jax(jax_stages):
    got = tdd.emit_slots(*(_t(a) for a in jax_stages["emit_in"]))
    for g, w in zip(got, jax_stages["emit"], strict=True):
        _eq(g, w)
    assert jax_stages["emit"][2].max() > 1             # several slots a chunk


def test_compact_rows_matches_jax(jax_stages):
    ctgt, cval, nval, _ = (_t(a) for a in jax_stages["emit"])
    for g, w in zip(tdd.compact_rows(ctgt, cval, nval),
                    jax_stages["compact"], strict=True):
        _eq(g, w)


def test_spread_rows_matches_jax_and_scatter(jax_stages):
    tgt, val = (_t(a) for a in jax_stages["compact"])
    got = tdd.spread_rows(tgt, val, NOUT)
    _eq(got, jax_stages["spread"])
    _eq(got, jax_stages["scatter"])


def test_decode_band_rows_matches_jax_and_host(jax_stages):
    co, ovf = tdd.decode_band_rows(
        _t(jax_stages["pay"]), _t(jax_stages["nch"]),
        _t(jax_stages["quant"]), _t(jax_stages["lin"]), NOUT)
    _eq(co, jax_stages["whole"][0])
    _eq(ovf, jax_stages["whole"][1])
    _eq(co, jax_stages["host"])
    assert not ovf.any()


# ---------------------------------------------------------------------------
# The two new network forms against the JAX networks they replace
# ---------------------------------------------------------------------------

def _spread_inputs(tgt: np.ndarray, val: np.ndarray, nout: int):
    """spread_rows's (varr, darr) rows, built as the JAX function does."""
    r, s = tgt.shape
    arr = s + nout + 8
    d = np.where(val != 0, tgt - np.arange(s), arr)
    rem = np.minimum(np.minimum.accumulate(d[:, ::-1], axis=1)[:, ::-1],
                     nout + 8)
    varr = np.zeros((r, arr), np.int64)
    darr = np.zeros((r, arr), np.int64)
    varr[:, :s], darr[:, :s] = val, rem
    return varr, darr


def _pallas_highfirst(val: np.ndarray, rem: np.ndarray, **kw):
    v, r = pallas_merge(jnp.asarray(val.astype(np.uint32)),
                        jnp.asarray(rem.astype(np.int32)), lowfirst=False,
                        **kw)
    return np.asarray(v).astype(np.int64), np.asarray(r).astype(np.int64)


def _random_slots(seed, rows, n):
    """Values and displacements in no order at all."""
    rng = np.random.default_rng(seed)
    val = rng.integers(0, 2**32, (rows, n), dtype=np.uint64)
    rem = rng.integers(0, n + 5, (rows, n))
    return val, rem


def test_highfirst_plain_matches_pallas_on_mirrored_spread(jax_stages):
    """The spread's rows, mirrored: the high-bit-first plain network equals
    the Pallas kernel (interpret mode, four blocks a row) and the XLA
    network, and mirrored back it is spread_rows and spread_rows_scatter."""
    tgt, val = jax_stages["compact"]
    varr, darr = _spread_inputs(tgt, val, NOUT)
    vm, dm = varr[:, ::-1], darr[:, ::-1]
    got_v, got_r = tdev._settle_network_highfirst(_t(vm), _t(dm))
    for kw in ({"interpret": True, "block_rows": 16}, {"use_pallas": False}):
        want_v, want_r = _pallas_highfirst(vm, dm, **kw)
        _eq(got_v, want_v.astype(np.uint32).view(np.int32))
        _eq(got_r, want_r)
    assert not got_r.any()                             # settled
    spread = got_v.numpy()[:, ::-1][:, :NOUT]
    spread = (spread.astype(np.int32) << 16) >> 16
    np.testing.assert_array_equal(spread, jax_stages["spread"])
    np.testing.assert_array_equal(spread, jax_stages["scatter"])


@pytest.mark.parametrize("rows,n", [(3, 3000), (2, 1024), (1, 1)])
def test_highfirst_plain_matches_pallas_on_any_input(rows, n):
    val, rem = _random_slots(n, rows, n)
    got_v, got_r = tdev._settle_network_highfirst(
        _t(val.astype(np.uint32).view(np.int32)), _t(rem))
    want_v, want_r = _pallas_highfirst(val, rem, interpret=True,
                                       block_rows=8)
    _eq(got_v, want_v.astype(np.uint32).view(np.int32))
    _eq(got_r, want_r)


def _jax_compact_network(val, rem, tgt):
    n = val.shape[-1]
    rem, val, tgt = (jnp.asarray(a) for a in (rem, val, tgt))
    k = 0
    while (1 << k) <= n:
        rem, val, tgt = dd._compact_level((rem, val, tgt), 1 << k, k)
        k += 1
    return tuple(np.asarray(a) for a in (val, rem, tgt))


@pytest.mark.parametrize("case", ["compact_rows", "any_input"])
def test_tgt_plain_matches_compact_network(jax_stages, case):
    if case == "compact_rows":
        ctgt, cval, nval, _ = (np.asarray(a) for a in jax_stages["emit"])
        r, s, nslot = ctgt.shape
        csum = np.cumsum(nval, axis=-1)
        d_c = np.arange(s) * nslot - (csum - nval)
        d_next = np.concatenate([d_c[:, 1:], s * nslot - csum[:, -1:]], 1)
        lane = np.arange(nslot)
        valid = lane < nval[..., None]
        rem = np.where(valid, d_c[..., None],
                       np.minimum(d_c[..., None] + lane - nval[..., None] + 1,
                                  d_next[..., None])).reshape(r, -1)
        val = np.where(valid, cval, 0).reshape(r, -1).astype(np.uint32)
        tgt = np.where(valid, ctgt, 0).reshape(r, -1)
    else:
        val, rem = _random_slots(5, 3, 2500)
        val = val.astype(np.uint32)
        tgt = np.random.default_rng(6).integers(0, 10**6, val.shape)
    want = _jax_compact_network(val, rem.astype(np.int32),
                                tgt.astype(np.int32))
    got = tdev._settle_network_tgt(_t(val.view(np.int32)), _t(rem), _t(tgt))
    for g, w in zip(got, want, strict=True):
        _eq(g, w.astype(np.int64).astype(np.uint32).view(np.int32)
            if w.dtype == np.uint32 else w)


# ---------------------------------------------------------------------------
# The guards of the decoder's merge kernels: where a row passes, the network
# settles to the one-pass placement
# ---------------------------------------------------------------------------

def _guard(form, arrays):
    return (tdev._compact_guard(*arrays) if form == "tgt"
            else tdev._spread_guard(arrays[1]))


def _network_and_placement(form, arrays):
    if form == "tgt":
        return (tdev._settle_network_tgt(*arrays),
                tdev._place_compact(*arrays))
    return (tdev._settle_network_highfirst(*arrays),
            tdev._place_spread(*arrays))


@pytest.mark.parametrize("form", ["tgt", "highfirst"])
@pytest.mark.parametrize("seed,rows,n", [(0, 4, 1), (1, 3, 2), (2, 5, 777),
                                         (3, 2, 2048), (4, 3, 5001)])
def test_network_equals_placement_where_the_guard_holds(form, seed, rows, n):
    """Random values (not decoder rows) under the guard's condition: the
    plain network's settled arrays are the placement's, rem all zero."""
    arrays = _guarded_rows(seed, rows, n, form)
    assert _guard(form, arrays).all()
    net, placed = _network_and_placement(form, arrays)
    for a, b in zip(net, placed, strict=True):
        _eq(a, b.numpy())
    assert not net[1].any()


@pytest.mark.parametrize("form", ["tgt", "highfirst"])
def test_guards_flag_violating_rows(form):
    bad = (0, 1, 2, 4, 5, 7)
    arrays = _guarded_rows(7, 9, 400, form, bad)
    _eq(_guard(form, arrays), np.array([r not in bad for r in range(9)]))
    # the network does not place those rows: that is why they are flagged
    net, placed = _network_and_placement(form, arrays)
    assert any(not torch.equal(a[r], b[r]) for r in bad
               for a, b in zip(net, placed))


def test_guards_hold_on_decoder_rows(jax_stages):
    """The rows `compact_inputs` and `spread_inputs` build from the decoder's
    slots pass their guards, and both placements equal the networks."""
    ctgt, cval, nval, _ = (_t(a) for a in jax_stages["emit"])
    comp = tdd.compact_inputs(ctgt, cval, nval)
    assert tdev._compact_guard(*comp).all()
    net, placed = _network_and_placement("tgt", comp)
    for a, b in zip(net, placed, strict=True):
        _eq(a, b.numpy())
    spread = tdd.spread_inputs(net[2], net[0], NOUT)
    assert tdev._spread_guard(spread[1]).all()
    net, placed = _network_and_placement("highfirst", spread)
    for a, b in zip(net, placed, strict=True):
        _eq(a, b.numpy())


# ---------------------------------------------------------------------------
# Whole bands against the host coder
# ---------------------------------------------------------------------------

EDGE_CASES = {
    "all_zeros": (np.array([0] * 500), 17, 3),
    "clamp_max": (np.array([1023] + [0] * 99), 17, 3),
    "all_max_negative": (np.array([-1023] * 64), 17, 3),
    "run_beyond_runbook": (np.array([0] * 3500 + [5]), 17, 3),
    "alternating_smallest": (np.array([1, -1] * 200), 17, 3),
    "cs18_quant_wrap": (np.resize(np.array([0, 700, -513, 0, 0, 255, -1]),
                                  900), 18, 200),
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_decode_band_rows_matches_host_decoder(name):
    vals, codeset, quant = EDGE_CASES[name]
    payload = _payload(vals.astype(np.int64), codeset)
    pay, nch = _rows([payload])
    co, ovf = tdd.decode_band_rows(
        torch.from_numpy(pay), torch.from_numpy(nch),
        torch.tensor([quant], dtype=torch.int32),
        torch.tensor([int(codeset == 18)], dtype=torch.int32), len(vals))
    assert not ovf.any()
    np.testing.assert_array_equal(co[0].numpy(),
                                  _host_ref(payload, len(vals), codeset,
                                            quant))


# ---------------------------------------------------------------------------
# IntraCodec.decode_batch_device
# ---------------------------------------------------------------------------

def test_decode_batch_device_matches_jax_device_decode():
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (2, 64, 256), dtype=np.uint8)
    samples = JaxIntraCodec(width=128, height=64, quality=4).encode_batch(
        frames)
    want = JaxIntraCodec(width=128, height=64,
                         quality=4).decode_batch_device(samples)
    got, fallback = IntraCodec(128, 64, 4, device=CPU).decode_batch_device(
        samples)
    assert fallback == ()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frame_index", [0, 2])
def test_decode_batch_device_matches_host_entropy_decode(frame_index):
    w, h = 160, 96
    rng = np.random.default_rng(frame_index)
    frames = np.stack([np.frombuffer(yuy2_frame(w, h, 1), np.uint8)
                       .reshape(h, 2 * w),
                       rng.integers(0, 256, (h, 2 * w), dtype=np.uint8)])
    codec = IntraCodec(w, h, 4, device=CPU)
    samples = codec.encode_batch_device(frames)
    got, fallback = codec.decode_batch_device(samples, frame_index)
    assert fallback == ()
    np.testing.assert_array_equal(got, codec.decode_batch(samples,
                                                          frame_index))


@pytest.mark.parametrize("name,w,h", [("s_320x240_q4_p1", 320, 240),
                                      ("s_64x48_q4_p1", 64, 48),
                                      ("s_112x48_q4_p1", 112, 48)])
def test_decode_batch_device_matches_golden(name, w, h):
    out, fallback = IntraCodec(w, h, 4, device=CPU).decode_batch_device(
        [_golden(name, "cfhd")])
    assert fallback == ()
    assert out.dtype == np.uint8 and out.shape == (1, h, 2 * w)
    assert out.tobytes() == _golden(name, "yuy2")


def test_decode_batch_device_falls_back_per_frame():
    """A frame whose coarsest luma band holds more coefficients than the
    band raises the device overflow flag; that frame alone is decoded by
    decode_batch, and the other frame of the batch stays on the device."""
    w, h = 64, 48
    frame = yuy2_frame(w, h, 1)
    params = IntraParams(width=w, height=h, quality=4)
    planes = xf.unpack_yuy2(frame, w, h, params.precision)
    chans = [intra_host.transform_channel(p, params, c)
             for c, p in enumerate(planes)]
    coarse = chans[0].bands[2][0]
    oversize = np.ones((coarse.shape[0] * 4, coarse.shape[1]), np.int32)
    chans[0].payloads = [None, None,
                         (intra_host.encode_band_payload(oversize), None,
                          None)]
    bad = intra_host.write_sample(chans, params, 1,
                                  intra_host.EncoderMetadata(),
                                  input_format=tags.COLOR_FORMAT_YUYV)
    good = intra_host.encode_sample(frame, w, h, 4)
    codec = IntraCodec(w, h, 4, device=CPU)
    out, fallback = codec.decode_batch_device([good, bad])
    assert fallback == (1,)
    np.testing.assert_array_equal(out, codec.decode_batch([good, bad]))
    _, fallback = codec.decode_batch_device([bad, bad])
    assert fallback == (0, 1)

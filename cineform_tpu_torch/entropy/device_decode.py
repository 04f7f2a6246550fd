"""CFHD band entropy decoder on tensors: band payload bytes -> dense
dequantized coefficient rows on the device.

Port of `cineform_tpu.entropy.device_decode` (the data-parallel
re-expression of `DecodeBandFSM16sNoGap`, `Codec/decoder.c:19532`, with the
companding expansion of `ScaleFSM`, `Codec/codebooks.c:1345`, and the
int16-wrapping `DeQuantFSM`, `Codec/entropy_threading.c:191`), equal to it
stage by stage.  The stages of `decode_band_rows`, each row one band:

1. `classify`: per payload bit position, the codeword that starts there
   (length, run count, magnitude, band end, sign), from the interval
   tiling of the complete cs17/cs18 prefix code;
2. `chunk_transfers`: per 32-bit chunk, where a walk entering at each of
   the 27 bit phases leaves it (or ends the band), and how many
   coefficients it emits;
3. `scan_entries_rows`: a scan composing those transfers along the row,
   giving every chunk's true entry phase and first coefficient index;
4. `final_walk`: the true codeword starts;
5. `emit_slots`: per chunk, up to NSLOT (target index, dequantized value)
   slots, front-packed;
6. `compact_rows` (kernel `merge_network_tgt`) and `spread_rows` (kernel
   `merge_network_highfirst` on mirrored rows): the slots of a row
   compacted across chunks, then spread to their target indices.

On the card stages 1-5 are the three kernels of `csrc/band_decode.cu`
(`ops.band_decode.band_kernels`: the transfers with the classification,
the row scan, the final walk with the emission), which `band_slots`
launches.  Their plain PyTorch version, `plain_band_slots`, runs on the
CPU and is the tests' reference.  There
phase masks use bits 0-26 and are carried in int32; the 27-bit windows of
stage 1 are built in int64.  Where the JAX code ORs disjoint masks it sums
them, and so does this port, by `scatter_add_` where the JAX code compares
against every target index.  The JAX `lax.associative_scan` becomes a
log-step (Hillis-Steele) scan over transfers held as functions from entry
phase to exit phase (a gather per composition), which the JAX module's
disjoint exit masks encode.

Legacy codeset cs9 (an incomplete prefix code) is decoded on the host, as
in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from cineform_tpu_torch import _build
from cineform_tpu_torch.spec import codebooks as cb
from cineform_tpu_torch.ops import band_decode
from cineform_tpu_torch.ops.merge_network import (merge_network_highfirst,
                                                  merge_network_tgt)
from cineform_tpu_torch.utils import timing

NPHASE = 27      # max codeword incl. sign = 26 bits -> entry phase in [0,27)
DONE = 27        # absorbing "band ended" phase
NSLOT = 12       # nonzero codewords are >=3 bits -> <=11 per 32-bit chunk
M27 = (1 << 27) - 1


# ---------------------------------------------------------------------------
# Static tables
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def interval_tables(codeset: int = 17) -> tuple[tuple[int, ...],
                                                tuple[int, ...]]:
    """(bounds, packed-leaf deltas) over the sorted 26-bit interval tiling.

    packed leaf = len | count << 5 | mag << 14 | isend << 22.  The RLV
    codebook must be complete (cs17/cs18 are; cs9 is not and raises)."""
    cs = cb.get_codeset(codeset)
    rows = [(int(b) << (26 - int(s)), int(s), int(c), int(v), 0)
            for s, b, c, v in cs.rlv.tolist()]
    rows.append((cs.bandend_bits << (26 - cs.bandend_size),
                 cs.bandend_size, 0, 0, 1))
    rows.sort()
    prev = 0                  # completeness: the intervals tile [0, 2^26)
    for lo, s, _, _, _ in rows:
        if lo != prev:
            raise ValueError(f"cs{codeset} prefix code is incomplete")
        prev = lo + (1 << (26 - s))
    if prev != 1 << 26:
        raise ValueError(f"cs{codeset} prefix code is incomplete")
    packed = [s | (c << 5) | (v << 14) | (e << 22) for _, s, c, v, e in rows]
    bounds = tuple(r[0] for r in rows)
    dleaf = tuple(p - q for p, q in zip(packed, [0] + packed[:-1]))
    return bounds, dleaf


@lru_cache(maxsize=None)
def _interval_lut(codeset: int, device: torch.device):
    """(bounds, packed leaves) as int32 tensors on `device`: the packed
    code of window w is leaves[j] for the last j with bounds[j] <= w (the
    JAX module's telescoping sum of threshold deltas)."""
    bounds, dleaf = interval_tables(codeset)
    leaves = torch.cumsum(torch.tensor(dleaf, dtype=torch.int64), 0)
    return (torch.tensor(bounds, dtype=torch.int32, device=device),
            leaves.to(torch.int32).to(device))


# ---------------------------------------------------------------------------
# Stage 1: per-bit-position classification
# ---------------------------------------------------------------------------

def classify(payload: torch.Tensor, codeset: int = 17) -> torch.Tensor:
    """(..., NB) uint8 payload -> (..., NB*8) int32 packed per-bit-position
    code: len | count << 5 | mag << 14 | isend << 22 | sign << 23.
    Lead dims are independent payload rows (windows never cross rows)."""
    bounds, leaves = _interval_lut(codeset, payload.device)
    nb = payload.shape[-1]
    b = F.pad(payload, (0, 8)).to(torch.int64)
    cat40 = ((b[..., 0:nb] << 32) | (b[..., 1:nb + 1] << 24)
             | (b[..., 2:nb + 2] << 16) | (b[..., 3:nb + 3] << 8)
             | b[..., 4:nb + 4])
    # the 27-bit window at bit r of each byte (MSB first)
    shifts = torch.arange(13, 5, -1, dtype=torch.int64, device=b.device)
    win27 = ((cat40[..., None] >> shifts) & M27).reshape(
        *payload.shape[:-1], nb * 8)
    win26 = (win27 >> 1).to(torch.int32)
    idx = torch.searchsorted(bounds, win26, right=True, out_int32=True) - 1
    packed = leaves[idx]
    length = (packed & 31).to(torch.int64)
    sign = ((win27 >> (26 - length)) & 1).to(torch.int32)
    return packed | (sign << 23)


def _unpack(packed: torch.Tensor):
    length = packed & 31
    count = (packed >> 5) & 511
    mag = (packed >> 14) & 255
    isend = (packed >> 22) & 1
    sign = (packed >> 23) & 1
    adv = length + (mag > 0).to(torch.int32)
    return length, count, mag, isend, sign, adv


# ---------------------------------------------------------------------------
# Stage 2: per-chunk transfer functions via the bit-serial wavefront
# ---------------------------------------------------------------------------

def _wavefront(packed2d: torch.Tensor, pend0: torch.Tensor) -> torch.Tensor:
    """Walk all 32 positions of every chunk once; pend0 (..., 32) int32
    seeds the phase masks.  Returns WM (..., 32): the mask of phases
    visiting each position.

    Position i passes its mask to i + adv[i] > i, so column i is final once
    step i is reached, and the masks arriving at one position are disjoint
    (each phase's walk is one chain): the JAX module's OR is a sum here."""
    *_, isend, _, adv = _unpack(packed2d)
    pend = pend0.clone(memory_format=torch.contiguous_format)
    for i in range(31):
        j = i + adv[..., i]
        hit = j < 32
        wl = torch.where(hit & (isend[..., i] == 0), pend[..., i], 0)
        pend.scatter_add_(-1, torch.where(hit, j, 0).long()[..., None],
                          wl[..., None])
    return pend


def chunk_transfers(packed2d: torch.Tensor):
    """(..., 32) packed -> (EXITS (..., 27) int32, ENDM (...,) int32,
    CNT (..., 27) int32): per exit phase the mask of entry phases leaving
    there, the mask of entry phases that reach band end, and per entry
    phase the coefficients it emits."""
    _, count, _, isend, _, adv = _unpack(packed2d)
    iota = torch.arange(32, dtype=torch.int32, device=packed2d.device)
    seed = torch.where(iota < NPHASE, 1 << iota.clamp(max=30), 0)
    wm = _wavefront(packed2d, seed.expand(packed2d.shape))
    wl = torch.where(isend == 1, 0, wm)
    # per-phase exits are unique -> masks disjoint -> OR == SUM
    d = iota + adv - 32
    out = (d >= 0) & (d < NPHASE)
    exits = torch.zeros((*packed2d.shape[:-1], NPHASE + 1), dtype=torch.int32,
                        device=packed2d.device)
    exits.scatter_add_(-1, torch.where(out, d, NPHASE).long(),
                       torch.where(out, wl, 0))
    endm = torch.where(isend == 1, wm, 0).sum(-1, dtype=torch.int32)
    cnt = torch.stack([(((wl >> p) & 1) * count).sum(-1, dtype=torch.int32)
                       for p in range(NPHASE)], dim=-1)
    return exits[..., :NPHASE], endm, cnt


# ---------------------------------------------------------------------------
# Stage 3: the transfer scan
# ---------------------------------------------------------------------------

def _transfer_function(exits: torch.Tensor, endm: torch.Tensor):
    """Exit masks -> the transfer as a function: (..., 28) int64, entry
    phase p -> its exit phase, or DONE; DONE -> DONE.  Every entry phase
    lies in exactly one exit mask or in the band-end mask."""
    p = torch.arange(NPHASE, dtype=torch.int32, device=exits.device)
    f = DONE * ((endm[..., None] >> p) & 1)
    for r in range(NPHASE):
        f = f + r * ((exits[..., r, None] >> p) & 1)
    return F.pad(f.to(torch.int64), (0, 1), value=DONE)


def _combine(a, b):
    """Compose transfers: a then b.  Each is (F (..., 28) int64, C (..., 28)
    int32): F maps an entry phase to the exit phase (DONE absorbing), C
    counts the coefficients emitted from that entry; C[DONE] = 0.  Equals
    the JAX module's mask composition, whose exit masks are disjoint."""
    fa, ca = a
    fb, cbb = b
    return fb.gather(-1, fa), ca + cbb.gather(-1, fa)


def scan_entries_rows(exits, endm, cnt):
    """Per-row transfer scan: each lead row is one whole band starting at
    phase 0, chunk 0.  exits (..., S, 27), endm (..., S), cnt (..., S, 27)
    -> (entry (..., S) int32, coeff base (..., S) int32).

    An inclusive log-step scan of h_0 = identity, h_k = transfer of chunk
    k - 1: prefix k composes chunks 0 .. k-1, and chunk k is entered at
    prefix k's image of phase 0."""
    s = exits.shape[-2]
    dev = exits.device
    fun = _transfer_function(exits, endm)
    ident = torch.arange(NPHASE + 1, dtype=torch.int64, device=dev)
    fun = torch.cat([ident.expand(*fun.shape[:-2], 1, NPHASE + 1),
                     fun[..., :-1, :]], dim=-2)
    cnt = F.pad(cnt, (0, 1))
    cnt = torch.cat([torch.zeros_like(cnt[..., :1, :]), cnt[..., :-1, :]],
                    dim=-2)
    d = 1
    while d < s:
        fc, cc = _combine((fun[..., :-d, :], cnt[..., :-d, :]),
                          (fun[..., d:, :], cnt[..., d:, :]))
        fun = torch.cat([fun[..., :d, :], fc], dim=-2)
        cnt = torch.cat([cnt[..., :d, :], cc], dim=-2)
        d *= 2
    return fun[..., 0].to(torch.int32), cnt[..., 0]


# ---------------------------------------------------------------------------
# Stage 4: final walk from the true entry phases
# ---------------------------------------------------------------------------

def final_walk(packed2d: torch.Tensor, entry: torch.Tensor) -> torch.Tensor:
    """(..., 32) packed + (...,) entry phases -> ACT (..., 32) int32 0/1
    marks of true codeword start positions (band-end positions excluded)."""
    iota = torch.arange(32, dtype=torch.int32, device=packed2d.device)
    pend0 = (iota == entry[..., None]).to(torch.int32)
    wm = _wavefront(packed2d, pend0)
    return torch.where(((packed2d >> 22) & 1) == 1, 0, wm)


# ---------------------------------------------------------------------------
# Stage 5: emission + in-chunk compaction
# ---------------------------------------------------------------------------

def _excl_cumsum32(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative sum along a 32-wide last axis, by a log tree
    as in the JAX module: on the card, `torch.cumsum` along this short
    innermost axis was the decoder's costliest operator."""
    y = F.pad(x, (1, 0))[..., :-1]
    for sh in (1, 2, 4, 8, 16):
        y = y + F.pad(y, (sh, 0))[..., :-sh]
    return y


def emit_slots(packed2d, act, base, region_base, region_end, quant, linear):
    """Per-chunk emissions -> front-packed (..., NSLOT) slot arrays.

    packed2d/act: (..., 32); base/region_base/region_end/quant/linear:
    (...,) per-chunk band attributes (output offsets, int16-wrap dequant
    factor, cs18 flag).  Returns (tgt (..., NSLOT) int32, val (..., NSLOT)
    int32 low 16 bits of the dequantized value, nval (...,) int32, ovf
    (...,) bool)."""
    _, count, mag, _, sign, _ = _unpack(packed2d)
    a = act.to(torch.int32)
    tgt = (region_base[..., None] + base[..., None]
           + _excl_cumsum32(count * a))
    expand = torch.where(linear[..., None] == 1, mag,
                         mag + ((mag * mag * mag * 3) >> 16))
    v = torch.where(sign == 1, -expand, expand)
    dq = ((v * quant[..., None]) << 16) >> 16         # DeQuantFSM int16 wrap
    emitting = (a == 1) & (mag > 0)
    ovf = (emitting & (tgt >= region_end[..., None])).any(dim=-1)
    valid = emitting & (tgt < region_end[..., None])
    vi = valid.to(torch.int32)
    rank = _excl_cumsum32(vi)
    slot = torch.where(valid & (rank < NSLOT), rank, NSLOT).long()
    shape = (*packed2d.shape[:-1], NSLOT + 1)
    ctgt = torch.zeros(shape, dtype=torch.int32, device=packed2d.device)
    ctgt.scatter_add_(-1, slot, torch.where(valid, tgt, 0))
    cval = torch.zeros_like(ctgt)
    cval.scatter_add_(-1, slot, torch.where(valid, dq & 0xFFFF, 0))
    nval = vi.sum(-1, dtype=torch.int32)
    return ctgt[..., :NSLOT], cval[..., :NSLOT], nval, ovf


# ---------------------------------------------------------------------------
# Stage 6: placement
# ---------------------------------------------------------------------------

def compact_inputs(ctgt, cval, nval):
    """(..., S, NSLOT) slot arrays -> the compaction network's (val, rem,
    tgt), each (..., S*NSLOT) int32.  Displacement is constant per chunk
    (NSLOT*k - R_k) and tail lanes are graded +1 toward the next chunk's,
    so steps stay in {0, 1}."""
    *lead, s, _ = ctgt.shape
    dev = ctgt.device
    csum = torch.cumsum(nval, -1, dtype=torch.int32)
    r_k = csum - nval                                   # exclusive prefix
    d_c = torch.arange(s, dtype=torch.int32, device=dev) * NSLOT - r_k
    d_next = torch.cat([d_c[..., 1:], s * NSLOT - csum[..., -1:]], dim=-1)
    lane = torch.arange(NSLOT, dtype=torch.int32, device=dev)
    valid = lane < nval[..., None]
    rem = torch.where(valid, d_c[..., None],
                      torch.minimum(d_c[..., None] + lane - nval[..., None]
                                    + 1, d_next[..., None]))
    n = s * NSLOT
    return (torch.where(valid, cval, 0).reshape(*lead, n),
            rem.reshape(*lead, n),
            torch.where(valid, ctgt, 0).reshape(*lead, n))


def compact_rows(ctgt, cval, nval):
    """Per-row front-packing of valid slots: (..., S, NSLOT) slot arrays
    -> (..., S*NSLOT) compacted (tgt, val), by the low-bit-first
    monotone-displacement network carrying tgt (kernel
    merge_network_tgt)."""
    val, _, tgt = merge_network_tgt(*compact_inputs(ctgt, cval, nval))
    return tgt, val


def spread_inputs(tgt, val, nout: int):
    """Compacted (..., N) slots -> the spread network's rows, mirrored:
    (varr, darr), each (..., N + nout + 8) int32, slot N-1-i of a row at
    index nout + 8 + i.

    Valid slots (val != 0) have strictly increasing targets >= their slot
    index, so their displacements are nonnegative and nondecreasing;
    invalid slots take the suffix minimum, clamped to nout + 8.  The
    mirrored displacements are nonincreasing, and the zero padding takes
    the first real slot's, so that they stay nonincreasing over the whole
    row: the condition under which the kernel places the slots in one pass
    (`entropy.device._spread_guard`).  The padding holds zeros, so where it
    lands changes no output."""
    s = tgt.shape[-1]
    arr = s + nout + 8
    sidx = torch.arange(s, dtype=torch.int32, device=tgt.device)
    d = torch.where(val != 0, tgt - sidx, arr)
    rem_m = torch.clamp(torch.cummin(d.flip(-1), dim=-1).values,
                        max=nout + 8)
    pad = rem_m[..., :1].expand(*rem_m.shape[:-1], arr - s)
    return (F.pad(val.flip(-1), (arr - s, 0)),
            torch.cat([pad, rem_m], dim=-1))


def spread_rows(tgt, val, nout: int):
    """Per-row spread: compacted (..., N) slots -> dense (..., nout) int32
    coefficient rows.

    The JAX module moves every slot right by its displacement, high bit
    first; the high-bit-first network (kernel merge_network_highfirst)
    moves slots left, so it runs on the rows reversed: the mirror of a
    right move is the same level on the mirrored row."""
    out_m, _ = merge_network_highfirst(*spread_inputs(tgt, val, nout))
    out = out_m[..., out_m.shape[-1] - nout:].flip(-1)
    return (out << 16) >> 16                            # reinterpret int16


def plain_band_slots(payload: torch.Tensor, nchunks: torch.Tensor,
                     quant: torch.Tensor, linear: torch.Tensor, nout: int):
    """Stages 1-5 of `decode_band_rows` (same arguments) in plain PyTorch:
    the per-chunk slots (ctgt, cval, nval, ovf) of `emit_slots`, activity
    masked to each row's real chunks.  `band_slots` runs it on the CPU."""
    *lead, nb = payload.shape
    s = nb // 4
    with timing.span("entropy.classify"):
        packed = classify(payload).reshape(*lead, s, 32)
    with timing.span("entropy.chunk_transfers"):
        transfers = chunk_transfers(packed)
    with timing.span("entropy.scan_entries_rows"):
        entry, base = scan_entries_rows(*transfers)
    with timing.span("entropy.final_walk"):
        act = final_walk(packed, entry)
    with timing.span("entropy.emit_slots"):
        cidx = torch.arange(s, dtype=torch.int32, device=payload.device)
        act = act * (cidx < nchunks[..., None]).to(torch.int32)[..., None]
        shape = (*lead, s)
        return emit_slots(
            packed, act, base,
            torch.zeros(shape, dtype=torch.int32, device=payload.device),
            torch.full(shape, nout, dtype=torch.int32, device=payload.device),
            quant[..., None].expand(shape), linear[..., None].expand(shape))


def band_slots(payload: torch.Tensor, nchunks: torch.Tensor,
               quant: torch.Tensor, linear: torch.Tensor, nout: int):
    """Stages 1-5 of `decode_band_rows` (same arguments): the per-chunk
    slots of `plain_band_slots`.  For CUDA tensors it launches the
    kernels of `ops.band_decode`, which count the rows they decoded in
    `entropy.band_rows_kernel`, or raises; for tensors on the CPU it runs
    the plain stages, and counts 0 there."""
    if _build.uses_kernel("band_slots", payload):
        bounds, leaves = _interval_lut(17, payload.device)
        return band_decode.band_kernels(payload, nchunks, quant, linear,
                                        nout, bounds, leaves)
    band_decode.check(payload, nchunks, quant, linear, nout)
    timing.count("entropy.band_rows_kernel", 0)
    return plain_band_slots(payload, nchunks, quant, linear, nout)


def decode_band_rows(payload: torch.Tensor, nchunks: torch.Tensor,
                     quant: torch.Tensor, linear: torch.Tensor, nout: int):
    """Decode R independent band bitstreams of one size class.

    payload: (R, S*4) uint8, each row ONE complete band payload (32-bit
    aligned, band-end terminated), zero-padded to S chunks.  nchunks,
    quant, linear: (R,) int32 chunk count and band attributes.  nout: the
    dense region size (band h * pitch) shared by the class.  Returns
    (coeffs (R, nout) int32, ovf (R,) bool).

    Counts the call's rows in `entropy.band_rows`; `band_slots` counts
    those that the kernels decoded in `entropy.band_rows_kernel`."""
    timing.count("entropy.band_rows", payload.shape[0])
    ctgt, cval, nval, covf = band_slots(payload, nchunks, quant, linear, nout)
    with timing.span("entropy.compact_rows"):
        tgt, val = compact_rows(ctgt, cval, nval)
    with timing.span("entropy.spread_rows"):
        out = spread_rows(tgt, val, nout)
    return out, covf.any(dim=-1)


# ---------------------------------------------------------------------------
# Band row buffers: `decode_band_rows`' input, filled on the host
# ---------------------------------------------------------------------------

#: floor of a class's row capacity in 32-bit chunks; capacities double
#: from here to fit the class's longest band payload
MIN_ROW_CHUNKS = 256


def row_buffers(rows, pin: bool):
    """The host buffers of one class of band rows, each row a band's
    (payload bytes, quantization, linear flag) -> (payload, nchunks,
    quant, linear) as `decode_band_rows` takes them: the payload (R, cap *
    4) uint8 zeros for the caller to fill, cap the least doubling of
    MIN_ROW_CHUNKS that holds the longest payload, and the (R,) int32
    attributes; pinned where `pin`, for an asynchronous upload."""
    cap = MIN_ROW_CHUNKS
    while cap < max(n for n, _, _ in rows) // 4:
        cap *= 2
    payload = torch.zeros((len(rows), cap * 4), dtype=torch.uint8,
                          pin_memory=pin)
    meta = torch.tensor([(n // 4, q, lin) for n, q, lin in rows],
                        dtype=torch.int32).t().contiguous()
    if pin:
        meta = meta.pin_memory()
    return payload, meta[0], meta[1], meta[2]


def upload_rows(rows, device: torch.device):
    """A host walk's groups of row buffers and planes, then its fallback
    set -> the same on `device` (asynchronous copies from pinned memory on
    CUDA); the fallback set passes through."""
    *groups, fallback = rows
    return (*(tuple(t.to(device, non_blocking=True) for t in g)
              for g in groups), fallback)

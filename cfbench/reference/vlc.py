"""The CFHD band entropy encoder in plain NumPy: zero runs as composite
run codes, values through the companded 2048-entry book, the band-end
code, packed MSB first.

A frozen copy of the encode half of the JAX package's `entropy/host.py`,
the pure-Python coder its C++ coder is held to (contract:
`Codec/encoder.c:5386-5692`, EncodeQuantLongRuns).  Also the decoder's
view of a coded value (`decoded_values`): the companded code's expansion
times the band's quantizer in int16, which the reference decodes from the
payload (`ScaleFSM`, `Codec/codebooks.c:1345`; `DeQuantFSM`,
`Codec/decoder.c:20551`).
"""

from __future__ import annotations

import numpy as np

from cfbench.reference import codebooks as cb


def pack_msb_first(bits: np.ndarray, sizes: np.ndarray, align: int = 32) -> bytes:
    """Vectorized MSB-first packing of (bits, sizes) code sequences.

    Each code may be up to 32 bits; codes are concatenated MSB-first.
    """
    sizes = sizes.astype(np.int64)
    bits = bits.astype(np.uint64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offs[-1])
    if total == 0:
        return b""
    pad = (-total) % align
    nbytes = (total + pad) // 8
    out = np.zeros(nbytes + 8, dtype=np.uint8)
    starts = offs[:-1]
    byte0 = starts >> 3
    bitpos = (starts & 7).astype(np.uint64)
    # 64-bit window with the code left-aligned at bit position `bitpos`
    chunk = bits << (np.uint64(64) - sizes.astype(np.uint64) - bitpos)
    # the codes' bits are disjoint, so a byte's sum of its parts is their
    # OR (np.bincount in place of the original's slower np.add.at)
    acc = np.zeros(nbytes + 8, dtype=np.float64)
    for j in range(5):  # a ≤32-bit code at any phase spans ≤5 bytes
        acc += np.bincount(byte0 + j, weights=((chunk >> np.uint64(56 - 8 * j))
                                               & np.uint64(0xFF)).astype(np.float64),
                           minlength=nbytes + 8)
    out[:] = acc.astype(np.uint8)
    return out[:nbytes].tobytes()


def encode_band(values: np.ndarray, codeset: int = 17) -> tuple[np.ndarray, np.ndarray]:
    """Encode a quantized band to (bits, sizes) code arrays (no padding).

    values: int array, scanned row-major (flattened internally).
    Returns code arrays suitable for pack_msb_first; the band-end code is
    included.  Contract: `Codec/encoder.c:5435-5692`.
    """
    cs = cb.get_codeset(codeset)
    vb_size, vb_bits = cb.build_valuebook(codeset)
    rb_size, rb_count, rb_bits = cb.build_runbook(codeset)

    flat = np.asarray(values).ravel().astype(np.int64)
    nz = np.flatnonzero(flat)
    # zero-run lengths before each nonzero value, plus the tail run
    prev = np.concatenate([[-1], nz])
    runs_before = (nz - prev[:-1] - 1) if len(nz) else np.zeros(0, dtype=np.int64)
    tail = len(flat) - (int(nz[-1]) + 1) if len(nz) else len(flat)

    vals = flat[nz]
    # clamp to the valuebook's signed 11-bit domain (`encoder.c:5556-5569`)
    vals = np.clip(vals, -(cb.VALUE_TABLE_LENGTH >> 1) + 1, (cb.VALUE_TABLE_LENGTH >> 1) - 1)
    vindex = vals & (cb.VALUE_TABLE_LENGTH - 1)

    # Vectorized interleave of run and value codes in scan order.  A run of
    # length r emits a greedy chain of composite codes; the full chains for
    # all r < RUNBOOK_LENGTH are precomputed (build_runchains), so encoding
    # is pure gathers.  Runs >= RUNBOOK_LENGTH peel maximal chunks first
    # (rare; python loop rewrites them as extra slots).
    runs = (np.concatenate([runs_before, [tail]]) if len(nz)
            else np.array([tail], dtype=np.int64))
    ch_bits, ch_sizes, ch_offs = cb.build_runchains(codeset)

    prefix_bits: dict[int, tuple[list, list]] = {}
    if (runs >= cb.RUNBOOK_LENGTH).any():
        runs = runs.copy()
        top = cb.RUNBOOK_LENGTH - 1
        for i in np.flatnonzero(runs >= cb.RUNBOOK_LENGTH):
            pb: list[int] = []
            ps: list[int] = []
            r = int(runs[i])
            while r >= cb.RUNBOOK_LENGTH:
                pb.append(int(rb_bits[top]))
                ps.append(int(rb_size[top]))
                r -= int(rb_count[top])
            prefix_bits[i] = (pb, ps)
            runs[i] = r

    n_slots = len(runs)
    ncodes = ch_offs[runs + 1] - ch_offs[runs]           # chain length per slot
    has_val = np.zeros(n_slots, dtype=np.int64)
    has_val[:len(nz)] = 1
    slot_total = ncodes + has_val
    pos = np.concatenate([[0], np.cumsum(slot_total)])
    total = int(pos[-1])

    out_bits = np.empty(total + 1, dtype=np.uint64)
    out_sizes = np.empty(total + 1, dtype=np.int64)

    # scatter run chains: ragged gather from the chain table
    nz_chain = np.flatnonzero(ncodes)
    if len(nz_chain):
        lens = ncodes[nz_chain]
        src0 = ch_offs[runs[nz_chain]]
        dst0 = pos[nz_chain]
        within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
        src = np.repeat(src0, lens) + within
        dst = np.repeat(dst0, lens) + within
        out_bits[dst] = ch_bits[src]
        out_sizes[dst] = ch_sizes[src]

    # scatter value codes after each slot's run chain
    if len(nz):
        vdst = pos[:len(nz)] + ncodes[:len(nz)]
        out_bits[vdst] = vb_bits[vindex].astype(np.uint64)
        out_sizes[vdst] = vb_size[vindex].astype(np.int64)

    out_bits[total] = cs.bandend_bits
    out_sizes[total] = cs.bandend_size

    if prefix_bits:
        # splice the peeled oversized-run prefixes in front of their slots
        parts_b: list[np.ndarray] = []
        parts_s: list[np.ndarray] = []
        last = 0
        for i in sorted(prefix_bits):
            parts_b.append(out_bits[last:pos[i]])
            parts_s.append(out_sizes[last:pos[i]])
            pb, ps = prefix_bits[i]
            parts_b.append(np.array(pb, dtype=np.uint64))
            parts_s.append(np.array(ps, dtype=np.int64))
            last = pos[i]
        parts_b.append(out_bits[last:])
        parts_s.append(out_sizes[last:])
        return np.concatenate(parts_b), np.concatenate(parts_s)

    return out_bits, out_sizes



def encode_band_bytes(values: np.ndarray, codeset: int = 17) -> bytes:
    """A (pitch-padded) quantized band -> its payload bytes, byte-aligned
    (the sample writer pads them to 32 bits)."""
    bits, sizes = encode_band(values, codeset)
    return pack_msb_first(bits, sizes, align=8)


def decoded_values(codes: np.ndarray, quant: int,
                   codeset: int = 17) -> np.ndarray:
    """The coefficients a decoder reads back for quantized `codes` of a
    band with quantizer `quant`: each value clamped to the book's signed
    11-bit domain, companded to its code's magnitude, expanded again and
    multiplied by `quant` with the int16 wrap of `DeQuantFSM`."""
    cs = cb.get_codeset(codeset)
    max_mag = len(cs.mag_size) - 1
    half = cb.VALUE_TABLE_LENGTH >> 1
    mag = np.arange(half)
    if cs.flags & cb.COMPANDING_CUBIC:
        coded = cb.cubic_compand_table()[np.minimum(mag, 1024)]
    elif cs.flags & cb.COMPANDING_NONE:
        coded = mag
    else:
        coded = np.array([cb.old_compand(int(m)) for m in mag])
    coded = np.minimum(coded.astype(np.int64), max_mag)
    expand = np.array([cb.expand_code(int(c), cs.flags) for c in coded],
                      dtype=np.int64)
    c = np.clip(np.asarray(codes, dtype=np.int64), -(half - 1), half - 1)
    v = np.sign(c) * expand[np.abs(c)] * int(quant)
    return ((v + 32768) % 65536 - 32768).astype(np.int32)

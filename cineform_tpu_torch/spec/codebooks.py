"""CFHD entropy-coding codebooks: the three codesets (cs9, cs17, cs18).

A copy of the JAX package's `spec/codebooks.py`, without the run chains
the port does not use.  Static Huffman tables are format constants
extracted from the published CFHD tables (`Common/table{9,17,18}.inc`) into
codebooks_data.npz (a copy of the JAX package's) by tools/gen_codebooks.py.
The *derived* runtime tables — the 2048-entry signed-value VLE book with fused companding+sign, and the 3072-entry
composite zero-run book — are computed here by our own implementation of the
build algorithms (behavioral contract: `Codec/codebooks.c` FillVleTable,
ComputeRunLengthCodeTable/FillRunLengthCodeTable) and validated bit-for-bit
against a dump of the reference oracle (tests/golden/codebooks_dump.txt).

Codeset semantics (`Codec/codebooks.c:48-117`):
  cs9  — legacy codeset, piecewise-linear "old style" companding
  cs17 — default codeset, cubic companding (flags COMPANDING_CUBIC)
  cs18 — same codes as 17, values stored linear (no companding)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

_DATA_PATH = os.path.join(os.path.dirname(__file__), "codebooks_data.npz")

VALUE_TABLE_SIZE = 11  # `Codec/vlc.h:37`
VALUE_TABLE_LENGTH = 1 << VALUE_TABLE_SIZE
RUNBOOK_LENGTH = 3072  # NEW_CODEBOOK_LENGTH, `Codec/codebooks.c:128`
MAX_CODE_SIZE = 31  # BITSTREAM_LONG_SIZE - 1, `Codec/codebooks.c:505`

# flags per codeset (`Codec/codebooks.c:61,87,115`)
COMPANDING_OLD = 0
COMPANDING_CUBIC = 4
COMPANDING_NONE = 2
CS_FLAGS = {9: COMPANDING_OLD, 17: COMPANDING_CUBIC, 18: COMPANDING_NONE}
COMPANDING_MORE = 54  # `Codec/vlc.h:33`


@dataclass(frozen=True)
class Codeset:
    number: int
    flags: int
    mag_size: np.ndarray  # (N,) code sizes for magnitudes 0..N-1
    mag_bits: np.ndarray
    zero_size: np.ndarray  # sparse zero-run codes
    zero_bits: np.ndarray
    zero_count: np.ndarray
    rlv: np.ndarray  # decode table (size, bits, count, value) rows
    bandend_size: int
    bandend_bits: int


@lru_cache(maxsize=None)
def get_codeset(number: int) -> Codeset:
    data = np.load(_DATA_PATH)
    mag = data[f"cs{number}_mag"]
    zero = data[f"cs{number}_zero"]
    rlv = data[f"cs{number}_rlv"]
    be = data[f"cs{number}_bandend"]
    return Codeset(
        number=number,
        flags=CS_FLAGS[number],
        mag_size=mag[:, 0].astype(np.int32),
        mag_bits=mag[:, 1].astype(np.uint32),
        zero_size=zero[:, 0].astype(np.int32),
        zero_bits=zero[:, 1].astype(np.uint32),
        zero_count=zero[:, 2].astype(np.int32),
        rlv=rlv,
        bandend_size=int(be[0]),
        bandend_bits=int(be[1]),
    )


# ---------------------------------------------------------------------------
# Companding (production formulas, distinct from the WaveletDemo model)
# ---------------------------------------------------------------------------

def cubic_compand_table() -> np.ndarray:
    """magnitude (0..1024) -> code, `Codec/codebooks.c:1048-1079`."""
    table = np.zeros(1025, dtype=np.int32)
    for i in range(1, 256):
        mag = i + int(float(i) * i * i * 768.0 / (256 * 256 * 256))
        if mag > 1023:
            mag = 1023
        table[mag] = i
    last = 0
    for m in range(1025):
        if table[m]:
            last = table[m]
        else:
            table[m] = last
    return table


def cubic_expand(code: int) -> int:
    """code -> magnitude, `Codec/codebooks.c:1360-1388` (ScaleFSM cubic)."""
    mag = abs(int(code))
    mag += int(float(mag) * mag * mag * 768.0 / (256 * 256 * 256))
    return -mag if code < 0 else mag


def old_compand(mag: int) -> int:
    """Piecewise-linear compress, `Codec/codebooks.c:1099-1118`."""
    if mag >= 40:
        mag = ((mag - 40 + 2) >> 2) + 40
        if mag >= COMPANDING_MORE:
            mag = ((mag - COMPANDING_MORE + 2) >> 2) + COMPANDING_MORE
    return mag


def old_expand(code: int) -> int:
    """Piecewise-linear expand, `Codec/codebooks.c:1393-1436` (ScaleFSM)."""
    v = abs(int(code))
    if 40 <= v < 264:
        if v >= COMPANDING_MORE:
            v = ((v - COMPANDING_MORE) << 2) + COMPANDING_MORE
        v = ((v - 40) << 2) + 40
    return -v if code < 0 else v


def expand_code(code: int, flags: int) -> int:
    """Decode-side companding expansion dispatch."""
    if flags & COMPANDING_CUBIC:
        return cubic_expand(code)
    if flags & COMPANDING_NONE:
        return int(code)
    return old_expand(code)


# ---------------------------------------------------------------------------
# Derived encode tables
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def build_valuebook(number: int) -> tuple[np.ndarray, np.ndarray]:
    """2048-entry (size, bits) table indexed by value & 2047.

    Contract: `Codec/codebooks.c:1032-1143` (FillVleTable).  Index is an
    11-bit two's-complement value; entry = companded magnitude code followed
    by a sign bit (0 positive / 1 negative) when the value is nonzero.
    """
    cs = get_codeset(number)
    max_mag = len(cs.mag_size) - 1
    cubic = cubic_compand_table() if cs.flags & COMPANDING_CUBIC else None

    sizes = np.zeros(VALUE_TABLE_LENGTH, dtype=np.int32)
    bits = np.zeros(VALUE_TABLE_LENGTH, dtype=np.uint32)
    sign_mask = 1 << (VALUE_TABLE_SIZE - 1)
    mag_mask = sign_mask - 1
    for index in range(VALUE_TABLE_LENGTH):
        value = (index & mag_mask) - sign_mask if (index & sign_mask) else index
        mag = abs(value)
        if cs.flags & COMPANDING_CUBIC:
            mag = int(cubic[min(mag, 1024)])
        elif cs.flags & COMPANDING_NONE:
            pass
        else:
            mag = old_compand(mag)
        mag = min(mag, max_mag)
        codeword = int(cs.mag_bits[mag])
        codesize = int(cs.mag_size[mag])
        if value > 0:
            codeword = codeword << 1
            codesize += 1
        elif value < 0:
            codeword = (codeword << 1) | 1
            codesize += 1
        sizes[index] = codesize
        bits[index] = codeword
    return sizes, bits


@lru_cache(maxsize=None)
def build_runbook(number: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """3072-entry composite zero-run table (size, count, bits).

    Contract: `Codec/codebooks.c:401-582`.  Entry i holds a composite
    codeword covering as much of a run of i zeros as fits in 31 bits
    (greedy: longest sparse run codes first, plus the single-zero magnitude
    code), and `count` = the zeros actually covered.
    """
    cs = get_codeset(number)
    # sparse codes + single-zero code (m0) if absent, sorted by run length desc
    codes = [
        (int(cs.zero_size[i]), int(cs.zero_bits[i]), int(cs.zero_count[i]))
        for i in range(len(cs.zero_size))
    ]
    if not any(c[2] == 1 for c in codes):
        codes.append((int(cs.mag_size[0]), int(cs.mag_bits[0]), 1))
    codes.sort(key=lambda c: -c[2])

    sizes = np.zeros(RUNBOOK_LENGTH, dtype=np.int32)
    counts = np.zeros(RUNBOOK_LENGTH, dtype=np.int32)
    bits = np.zeros(RUNBOOK_LENGTH, dtype=np.uint32)
    for i in range(RUNBOOK_LENGTH):
        remaining = i
        codeword = 0
        codesize = 0
        stop = False
        for size, cbits, count in codes:
            if remaining == 0:
                break
            repetition = remaining // count
            k = 0
            while k < repetition:
                if size > (MAX_CODE_SIZE - codesize):
                    if codesize:
                        # DAN 2/12/02 quirk: stop composing the entry rather
                        # than padding with single zeros (`codebooks.c:544-557`)
                        stop = True
                    break
                codeword = ((codeword << size) | cbits) & 0xFFFFFFFF
                codesize += size
                k += 1
            remaining -= k * count
            if stop:
                break
        sizes[i] = codesize
        counts[i] = i - remaining
        bits[i] = codeword
    return sizes, counts, bits

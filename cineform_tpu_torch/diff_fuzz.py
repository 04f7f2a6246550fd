"""Corrupt-sample corpus for the decoder's error tolerance.

A copy of the corpus half of the JAX package's `tools/diff_fuzz.py`: the
mutation distribution (`mutate`: bit flips, byte splices, truncation,
trailing garbage; the reference fuzzer's move, `Example/TestCFHD.cpp:572`),
the byte ranges of a sample's band payloads (`payload_ranges`) and the
class of a mutation (`classify_mutation`).  The tests and `chip_smoke.py`
decode each case as `tools/diff_fuzz.py` does (prepare from the sample,
full resolution) and compare the outcomes: the frame's bytes, or a
rejection (`CFHDError`).

`corpus(sample, cases, seed)` draws the cases from `numpy`'s
`default_rng(seed)`; the same seed gives the same mutated samples as the
JAX tool's `run`.  `targeted(sample)` changes one tag value for each
accept/reject rule of the decoder (`models.intra_host.intra_channels`,
`wavelet_band_plan`, the frame's size and precision).
"""

from __future__ import annotations

import struct

import numpy as np

from cineform_tpu_torch.bitstream import parse_sample
from cineform_tpu_torch.spec import tags


def mutate(rng: np.random.Generator, sample: bytes) -> bytes:
    """One mutation drawn from the corpus distribution: bit flips
    (common), byte splices, truncation, or growth with trailing noise."""
    buf = bytearray(sample)
    kind = rng.integers(0, 10)
    if kind < 6:  # 1-16 random bit flips (the reference fuzzer's move)
        for _ in range(int(rng.integers(1, 17))):
            pos = int(rng.integers(0, len(buf)))
            buf[pos] ^= 1 << int(rng.integers(0, 8))
    elif kind < 8:  # splice a random run of random bytes
        n = int(rng.integers(1, 64))
        pos = int(rng.integers(0, max(1, len(buf) - n)))
        buf[pos:pos + n] = rng.bytes(n)
    elif kind == 8:  # truncate
        buf = buf[:int(rng.integers(16, len(buf)))]
    else:  # append trailing garbage (decoders must ignore it)
        buf += rng.bytes(int(rng.integers(1, 256)))
    return bytes(buf)


def payload_ranges(sample: bytes):
    """Byte ranges of the band entropy payloads in a pristine sample."""
    s = parse_sample(sample)
    out = []
    for c in s.channels:
        for b in c.bands:
            out.append((b.data_offset, b.data_offset + len(b.data)))
    return out


def classify_mutation(sample: bytes, mutated: bytes, ranges) -> str:
    """'payload'   -- every changed byte is inside a band entropy payload
                      (and the length is unchanged): the reference's
                      ERROR_TOLERANT FSM semantics apply and outputs must
                      be byte-identical or both reject;
       'structure' -- only the length changed (truncation / appended
                      bytes): same strict contract;
       'header'    -- a tag VALUE was altered: the reference's tolerant
                      path reallocates wavelets and may emit pixels from
                      uninitialized allocations (verified: its corrupt
                      output differs from its pristine output by up to
                      255 across half the frame and depends on allocator
                      history), so only a bounded accept/reject
                      divergence rate can be enforced."""
    n = min(len(sample), len(mutated))
    a = np.frombuffer(sample[:n], np.uint8)
    b = np.frombuffer(mutated[:n], np.uint8)
    diff = np.nonzero(a != b)[0]
    if diff.size == 0:
        return "structure" if len(mutated) != len(sample) else "payload"
    if all(any(lo <= int(p) < hi for lo, hi in ranges) for p in diff):
        return "payload" if len(mutated) == len(sample) else "header"
    return "header"


def corpus(sample: bytes, cases: int, seed: int):
    """[(case, class, mutated sample)] of `cases` mutations of `sample`
    drawn from `default_rng(seed)`, as the JAX tool's `run` draws them."""
    ranges = payload_ranges(sample)
    rng = np.random.default_rng(seed)
    out = []
    for case in range(cases):
        m = mutate(rng, sample)
        out.append((case, classify_mutation(sample, m, ranges), m))
    return out


def tag_values(sample: bytes) -> list[tuple[int, int]]:
    """[(tag, byte offset of its 16-bit value)] of the plain tags of a
    sample's tag stream, walked as `parse_sample` walks it (the chunks'
    contents skipped)."""
    out = []
    pos = 0
    while pos + 4 <= len(sample):
        tag, value = struct.unpack(">hH", sample[pos:pos + 4])
        at = abs(tag)
        pos += 4
        if at >= tags.CUSTOM_CHUNK24BIT:
            pos += (((at & 0xFF) << 16) | value) * 4
        elif at >= tags.CHUNK:
            pos += value * 4
        elif at >= tags.CHUNK24BIT:
            if at & 0xFF00 not in (tags.SAMPLE_SIZE, tags.LEVEL_SIZE):
                pos += (((at & 0xFF) << 16) | value) * 4
        else:
            out.append((at, pos - 2))
            if at == tags.INDEX:
                pos += 4 * value
            elif at == tags.FRAME_TRAILER:
                break
    return out


def targeted(sample: bytes) -> list[tuple[str, bytes]]:
    """[(rule, mutated sample)]: one tag value of an intra sample changed
    for each rule by which the JAX host decoder rejects a sample or reads
    its bands otherwise than a well-formed one (missing, dropped,
    duplicated, overwriting the lowpass), and for its precision and frame
    size."""
    where: dict[int, list[int]] = {}
    for tag, off in tag_values(sample):
        where.setdefault(tag, []).append(off)
    value = {off: struct.unpack(">H", sample[off:off + 2])[0]
             for offs in where.values() for off in offs}
    # the band tags in stream order: band i's are the i-th of each
    bands = list(zip(*(where[t] for t in (
        tags.BAND_NUMBER, tags.BAND_WIDTH, tags.BAND_SUBBAND,
        tags.BAND_ENCODING, tags.BAND_QUANTIZATION))))
    by_subband = {value[sb]: (num, w, sb, enc, q)
                  for num, w, sb, enc, q in reversed(bands)}

    def changed(*edits):
        buf = bytearray(sample)
        for off, v in edits:
            struct.pack_into(">H", buf, off, v & 0xFFFF)
        return bytes(buf)

    # the last band's trailer, (BAND_TRAILER, 0), made (BAND_TRAILER + 1, 0)
    trailer = payload_ranges(sample)[-1][1] - 4
    num1, _, sb1, enc1, q1 = by_subband[1]
    num2, _, sb2, _, _ = by_subband[2]
    w7 = by_subband[7][1]
    marker = where[tags.MARKER][-1]
    return [
        ("band trailer", changed((trailer, tags.BAND_TRAILER + 1))),
        ("band dims", changed((w7, value[w7] + 2))),
        ("band of another level", changed((sb1, 4))),
        ("out-of-map subband", changed((sb2, 12))),
        ("subband out of range", changed((sb2, 17))),
        ("band slot 0", changed((num1, 0))),
        ("duplicate band slot", changed((num2, 1))),
        ("band number out of range", changed((num2, 4))),
        ("band encoding", changed((enc1, 1))),
        ("band quantization", changed((q1, 0x8001))),
        ("precision", changed((where[tags.PRECISION][0], 8))),
        ("frame width", changed((where[tags.FRAME_WIDTH][0],
                                 value[where[tags.FRAME_WIDTH][0]] + 1))),
        ("levels", changed((where[tags.NUM_LEVELS][0], 2))),
        ("lowpass quantization", changed((where[tags.QUANTIZATION][0], 0))),
        ("channel number", changed((where[tags.CHANNEL][0], 2))),
        ("frame end marker", changed((marker, value[marker] ^ 0x0200))),
    ]

"""CFHD band entropy encoder on tensors: byte-exact bitstreams on the device.

Port of `cineform_tpu.entropy.device` (the re-expression of
`EncodeQuantLongRuns`, `Codec/encoder.c:5386-5692`, `PutZeroRun`,
`Codec/vlc.c:366`, and `PutBits`, `Codec/bitstream.c:996`), bit-exact
against it.  The stages are the same:

1. run geometry (`_run_geometry`): for every coefficient, its zero run's
   length and its distance from the run start, by chunked log-doubling;
2. per-coefficient codes (`band_codes`): each coefficient becomes at most
   one (codeword, size) pair;
3. packing: within 256-element chunks by a log tree (`tree_pack`, kernel
   `ops.chunk_pack`), then across chunks by funnel shifts and a
   monotone-displacement compaction (`_concat_chunks`, kernel
   `ops.merge_network`).

Words are int32 tensors holding uint32 bit patterns and are shifted as
int64 (see `cineform_tpu_torch._int`).  A band denser than its capacity
raises its overflow flag, and the caller re-encodes it on the host.  The
band-end codeword and the 32-bit zero padding are appended on the host by
`finish_band_bytes`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from cineform_tpu_torch.spec import codebooks as cb
from cineform_tpu_torch._int import MASK32, bits32, u32


@dataclass(frozen=True)
class EncodeTables:
    """Per-codeset constants (the JAX package's `EncodeTables`)."""

    codeset: int
    flags: int
    # sparse zero-run codes, descending count, single-zero code last
    run_counts: tuple[int, ...]
    run_bits: tuple[int, ...]
    run_sizes: tuple[int, ...]
    # magnitude codebook (index = companded magnitude)
    mag_bits: tuple[int, ...]
    mag_sizes: tuple[int, ...]
    bandend_bits: int
    bandend_size: int

    @property
    def max_mag(self) -> int:
        return len(self.mag_bits) - 1


@lru_cache(maxsize=None)
def encode_tables(codeset: int = 17) -> EncodeTables:
    cs = cb.get_codeset(codeset)
    codes = [(int(cs.zero_count[i]), int(cs.zero_bits[i]), int(cs.zero_size[i]))
             for i in range(len(cs.zero_size))]
    if not any(c[0] == 1 for c in codes):
        codes.append((1, int(cs.mag_bits[0]), int(cs.mag_size[0])))
    codes.sort(key=lambda c: -c[0])
    return EncodeTables(
        codeset=codeset,
        flags=cs.flags,
        run_counts=tuple(c[0] for c in codes),
        run_bits=tuple(c[1] for c in codes),
        run_sizes=tuple(c[2] for c in codes),
        mag_bits=tuple(int(b) for b in cs.mag_bits),
        mag_sizes=tuple(int(s) for s in cs.mag_size),
        bandend_bits=int(cs.bandend_bits),
        bandend_size=int(cs.bandend_size),
    )


@lru_cache(maxsize=None)
def magnitude_lut(t: EncodeTables, device: torch.device):
    """The magnitude codebook as (bits, sizes) int32 tensors on `device`."""
    return (torch.tensor(t.mag_bits, dtype=torch.int32, device=device),
            torch.tensor(t.mag_sizes, dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# Stage 1: run geometry via chunked log-doubling scans
# ---------------------------------------------------------------------------

def _shift_last(x: torch.Tensor, offset: int) -> torch.Tensor:
    """Shift along the last axis with zero fill (offset > 0 pulls from the
    right, i.e. x'[i] = x[i + offset])."""
    n = x.shape[-1]
    if abs(offset) >= n:
        return torch.zeros_like(x)
    if offset == 0:
        return x
    if offset > 0:
        return F.pad(x[..., offset:], (0, offset))
    return F.pad(x[..., :offset], (-offset, 0))


def _suffix_zero_run(zero: torch.Tensor) -> torch.Tensor:
    """z[i] = number of consecutive zero flags starting at i (within the
    last axis), by log-doubling in int16."""
    n = zero.shape[-1]
    assert n <= 32767
    z = zero.to(torch.int16)
    k = 1
    while k < n:
        z = torch.where(z == k, k + _shift_last(z, k), z)
        k <<= 1
    return z


def _prefix_zero_run(zero: torch.Tensor) -> torch.Tensor:
    """p[i] = number of consecutive zero flags ending at i (inclusive)."""
    n = zero.shape[-1]
    assert n <= 32767
    p = zero.to(torch.int16)
    k = 1
    while k < n:
        p = torch.where(p == k, k + _shift_last(p, -k), p)
        k <<= 1
    return p


def _run_geometry(zero: torch.Tensor, chunk: int = 256):
    """(…, N) zero mask -> (run_length r, distance-from-run-start d) for
    every element, with runs measured across the whole last axis.

    Log-doubling inside chunks of `chunk`, then a carry scan over the
    chunk axis, then recombination."""
    *lead, n = zero.shape
    if n % chunk:
        raise ValueError(f"band length {n} not a multiple of {chunk}")
    t = n // chunk
    zc = zero.reshape(*lead, t, chunk)
    suf = _suffix_zero_run(zc)
    pre = _prefix_zero_run(zc)

    # S[c] = global suffix-zero count at the start of chunk c; P[c] = global
    # prefix-zero count at the end of chunk c (saturating scans, threshold
    # k*chunk, over the chunk axis)
    s_g = suf[..., 0].to(torch.int32)
    k = 1
    while k < t:
        s_g = torch.where(s_g == k * chunk, k * chunk + _shift_last(s_g, k), s_g)
        k <<= 1
    p_g = pre[..., -1].to(torch.int32)
    k = 1
    while k < t:
        p_g = torch.where(p_g == k * chunk, k * chunk + _shift_last(p_g, -k), p_g)
        k <<= 1

    iota = torch.arange(chunk, dtype=torch.int32, device=zero.device)
    p_carry = _shift_last(p_g, -1)[..., :, None]
    pre_g = pre + torch.where(pre == iota + 1, p_carry, 0)
    s_carry = _shift_last(s_g, 1)[..., :, None]
    suf_g = suf + torch.where(suf == chunk - iota, s_carry, 0)

    d = pre_g - 1                      # distance from run start (zeros only)
    r = d + suf_g                      # total run length (zeros only)
    return r.reshape(*lead, n), d.reshape(*lead, n)


# ---------------------------------------------------------------------------
# Stage 2: per-coefficient codes
# ---------------------------------------------------------------------------

def _compand_magnitude(mag: torch.Tensor, t: EncodeTables) -> torch.Tensor:
    """|value| (<=1023) -> companded magnitude code index.

    cs17: bisection of the cubic curve (max c with c + (c^3*3>>16) <= mag,
    `Codec/codebooks.c:1048-1079`).  cs9: piecewise linear
    (`codebooks.c:1099-1118`).  cs18: linear."""
    if t.flags & cb.COMPANDING_CUBIC:
        c = torch.zeros_like(mag)
        for bit in (128, 64, 32, 16, 8, 4, 2, 1):
            cand = c | bit
            mag_c = cand + ((cand * cand * cand * 3) >> 16)
            c = torch.where(mag_c <= mag, cand, c)
        return c.clamp(max=t.max_mag)
    if t.flags & cb.COMPANDING_NONE:
        return mag.clamp(max=t.max_mag)
    m = torch.where(mag >= 40, ((mag - 40 + 2) >> 2) + 40, mag)
    m = torch.where(m >= cb.COMPANDING_MORE,
                    ((m - cb.COMPANDING_MORE + 2) >> 2) + cb.COMPANDING_MORE, m)
    return m.clamp(max=t.max_mag)


def _floor_div(x: torch.Tensor, c: int) -> torch.Tensor:
    return torch.div(x, c, rounding_mode="floor")


def band_codes(values: torch.Tensor, t: EncodeTables, chunk: int = 256):
    """(…, N) quantized coefficients -> per-element (bits, sizes), int32.

    Concatenating the nonzero-size codes MSB-first (plus the band-end
    code) reproduces EncodeQuantLongRuns byte for byte.  Zero coefficients
    carry the greedy decomposition of their run over the sparse run codes,
    decided locally from (r, d); nonzero coefficients carry the companded
    magnitude code and a sign bit."""
    v = values.to(torch.int32)
    zero = v == 0
    r, d = _run_geometry(zero, chunk)

    zbits = torch.zeros_like(v)
    zsize = torch.zeros_like(v)
    rem = r
    a = torch.zeros_like(r)
    for cnt, bits_s, size_s in zip(t.run_counts, t.run_bits, t.run_sizes):
        span = _floor_div(rem, cnt) * cnt if cnt > 1 else rem
        da = d - a
        hit = (da >= 0) & (da < span)
        if cnt > 1:
            hit &= (da - _floor_div(da, cnt) * cnt) == 0
        zbits = torch.where(hit, bits_s, zbits)
        zsize = torch.where(hit, size_s, zsize)
        rem = rem - span
        a = a + span

    vc = v.clamp(-(cb.VALUE_TABLE_LENGTH >> 1) + 1,
                 (cb.VALUE_TABLE_LENGTH >> 1) - 1)
    mag = _compand_magnitude(vc.abs(), t)
    lut_bits, lut_sizes = magnitude_lut(t, v.device)
    nbits = (lut_bits[mag] << 1) | (vc < 0).to(torch.int32)
    nsize = lut_sizes[mag] + 1

    bits = torch.where(zero, zbits, nbits)
    sizes = torch.where(zero, zsize, nsize)
    return bits, sizes


# ---------------------------------------------------------------------------
# Stage 3: log-tree bit packing (plain version of the chunk_pack kernel)
# ---------------------------------------------------------------------------

def _word_cap(nbits: int) -> int:
    return -(-nbits // 32)


def pack_schedule(max_code_bits: int, cap_bits_per_elem: int, n: int = 256):
    """Per-level (words, capacity bits, capacity checked) of the packing
    tree over n elements: full worst-case capacity for the first four
    levels, the budget `cap_bits_per_elem` above, never shrinking."""
    out = []
    w_cur = 1
    for k in range(1, n.bit_length()):
        full = max_code_bits << k
        cap_bits = full if k <= 4 else min(
            full, max(cap_bits_per_elem << k, 32 * w_cur))
        w_cur = _word_cap(cap_bits)
        out.append((w_cur, cap_bits, cap_bits < full))
    return out


def tree_pack(bits: torch.Tensor, sizes: torch.Tensor,
              max_code_bits: int = 27, cap_bits_per_elem: int = 8):
    """Pack per-element MSB-first codes into one left-aligned buffer.

    bits/sizes: (…, N) int32 with sizes in [0, max_code_bits], N a power
    of two.  Returns (words (…, W) int32 uint32 bit patterns, total_bits
    (…,) int32, overflow (…,) bool).  A level whose lengths exceed its
    capacity sets the overflow flag; the words are then still the tree's
    (truncated) words, exactly as in the JAX package."""
    *lead, n = bits.shape
    assert n & (n - 1) == 0, "band length must be padded to a power of two"

    buf = torch.where(sizes == 0, 0,
                      (u32(bits) << (32 - sizes.to(torch.int64))) & MASK32)
    buf = buf[..., None]                      # (…, N, 1) int64
    lens = sizes.to(torch.int32)
    overflow = torch.zeros(lead, dtype=torch.bool, device=bits.device)

    w_cur = 1
    for w_new, cap_bits, check in pack_schedule(max_code_bits,
                                                cap_bits_per_elem, n):
        a = F.pad(buf[..., 0::2, :], (0, w_new - w_cur))
        b = F.pad(buf[..., 1::2, :], (0, w_new - w_cur))
        la = lens[..., 0::2]
        lb = lens[..., 1::2]
        # shift b right by la bits: bit part, then the word offset by a
        # select tree whose steps are bounded by w_cur (as the JAX tree:
        # an overflowed length selects only its low offset bits)
        bshift = (la & 31).to(torch.int64)[..., None]
        b_hi = _shift_last(b, -1)
        b = torch.where(bshift == 0, b,
                        ((b >> bshift) | (b_hi << ((32 - bshift) & 31))) & MASK32)
        woff = (la >> 5)[..., None]
        step = 1
        while step <= w_cur:
            b = torch.where((woff & step) != 0, _shift_last(b, -step), b)
            step <<= 1
        buf = a | b
        lens = la + lb
        if check:
            overflow = overflow | (lens > cap_bits).any(dim=-1)
        w_cur = w_new

    return bits32(buf[..., 0, :]), lens[..., 0], overflow


# Where no level of the tree truncates, its root is the codes laid end to
# end (the argument is in csrc/chunk_pack.cu): the chunk_pack kernel packs
# such chunks by a prefix sum.  These are the plain versions of that
# criterion and that packing, for the tests.

def _node_lengths(sizes: torch.Tensor):
    """Per tree level, (…, N >> k) int64 node lengths: the sums of sizes
    over aligned groups of 2^k elements, k = 1 .. log2(N)."""
    *lead, n = sizes.shape
    return [sizes.reshape(*lead, n >> k, 1 << k).sum(-1)
            for k in range(1, n.bit_length())]


def _pack_fits(sizes: torch.Tensor, max_code_bits: int = 27,
               cap_bits_per_elem: int = 8) -> torch.Tensor:
    """(…,) bool: the chunks on which `tree_pack` truncates nothing, so
    that it equals `_pack_direct`: every size in [0, 32] and every node of
    every level within its words."""
    n = sizes.shape[-1]
    fits = ((sizes >= 0) & (sizes <= 32)).all(dim=-1)
    for (w, _, _), lens in zip(pack_schedule(max_code_bits, cap_bits_per_elem,
                                             n), _node_lengths(sizes)):
        fits &= (lens <= 32 * w).all(dim=-1)
    return fits


def _pack_direct(bits: torch.Tensor, sizes: torch.Tensor,
                 max_code_bits: int = 27, cap_bits_per_elem: int = 8):
    """`tree_pack` by a prefix sum: each left-aligned code ORed in at its
    bit offset, the overflow flag from the node lengths.  Equal to
    `tree_pack` on the chunks where `_pack_fits` holds (every chunk whose
    flag is clear, at 27-bit codes); lengths and flags equal on every
    chunk."""
    *lead, n = bits.shape
    schedule = pack_schedule(max_code_bits, cap_bits_per_elem, n)
    w = schedule[-1][0]
    size = sizes.to(torch.int64)
    code = torch.where((size > 0) & (size <= 32),
                       (u32(bits) << (32 - size).clamp(0, 31)) & MASK32, 0)
    off = torch.cumsum(size, dim=-1) - size
    word, sh = off >> 5, off & 31
    spill = torch.where(sh > 0, (code << (32 - sh)) & MASK32, 0)
    # disjoint bits, so a sum is an OR; words past the last fall in w
    out = torch.zeros((*lead, w + 1), dtype=torch.int64, device=bits.device)
    out.scatter_add_(-1, word.clamp(0, w), code >> sh)
    out.scatter_add_(-1, (word + 1).clamp(0, w), spill)
    overflow = torch.zeros(lead, dtype=torch.bool, device=bits.device)
    for (_, cap_bits, check), lens in zip(schedule, _node_lengths(sizes)):
        if check:
            overflow |= (lens > cap_bits).any(dim=-1)
    return (bits32(out[..., :w]), sizes.sum(dim=-1, dtype=torch.int32),
            overflow)


# ---------------------------------------------------------------------------
# Stage 3b: across-chunk assembly by monotone-displacement compaction
# ---------------------------------------------------------------------------

# Within-chunk buffer capacity in bits per element.  12 is generous (CFHD
# bands pack to ~2); a denser chunk flags overflow -> host fallback.
_CHUNK_CAP_BITS = 12


def _network_level(val: torch.Tensor, rem: torch.Tensor, k: int,
                   tgt: torch.Tensor | None = None):
    """One level of the displacement network: slots whose displacement has
    bit k set move 2^k to the left; a slot that stays merges with the one
    that arrives, values by OR, displacements (and targets) by max."""
    s = 1 << k
    stay = ((rem >> k) & 1) == 0
    mov_rem = _shift_last(rem, s)
    come = ((mov_rem >> k) & 1) == 1
    val = (torch.where(stay, val, 0)
           | torch.where(come, _shift_last(val, s), 0))
    rem = torch.maximum(torch.where(stay, rem, 0),
                        torch.where(come, mov_rem - s, 0))
    if tgt is not None:
        tgt = torch.maximum(torch.where(stay, tgt, 0),
                            torch.where(come, _shift_last(tgt, s), 0))
    return val, rem, tgt


def _settle_network(val: torch.Tensor, rem: torch.Tensor):
    """Settle the monotone-displacement compaction network (low-bit-first
    distance doubling with OR / max merge): the plain version of the
    merge_network kernel.  val: (…, N) int32 bit patterns, rem: (…, N)
    int32 displacements."""
    val, rem, _ = _settle_network_tgt(val, rem, None)
    return val, rem


def _settle_network_tgt(val: torch.Tensor, rem: torch.Tensor,
                        tgt: torch.Tensor | None):
    """`_settle_network` carrying a third (…, N) int32 array `tgt`, merged
    by max like `rem`: the decoder's slot compaction (the JAX
    `device_decode._compact_level` network), the plain version of the
    merge_network_tgt kernel.  Returns the settled (val, rem, tgt)."""
    n = val.shape[-1]
    k = 0
    while (1 << k) <= n:
        val, rem, tgt = _network_level(val, rem, k, tgt)
        k += 1
    return val, rem, tgt


def _settle_network_highfirst(val: torch.Tensor, rem: torch.Tensor):
    """The high-bit-first network: levels k = L-1 down to 0, L =
    max(1, bit_length(N - 1)), each as in `_settle_network`.  Equals the
    JAX `ops.pallas_merge.merge_network(val, rem, lowfirst=False)`; the
    plain version of the merge_network_highfirst kernel."""
    n = val.shape[-1]
    for k in range(max(1, (n - 1).bit_length()) - 1, -1, -1):
        val, rem, _ = _network_level(val, rem, k)
    return val, rem


# The placements: on rows that pass a guard, each network above settles to
# a placement, slot i at i - rem[i] (the argument is in
# csrc/merge_network.cu).  The kernels evaluate the guard and place in one
# pass and run the network on the other rows; these are the plain versions
# of the guards and placements, for the tests.

def _place(val: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor):
    """val at dest where keep, zeros elsewhere, along the last axis."""
    n = val.shape[-1]
    idx = torch.where(keep, dest, n).long()
    out = torch.zeros((*val.shape[:-1], n + 1), dtype=val.dtype,
                      device=val.device)
    return out.scatter_(-1, idx, torch.where(keep, val, 0))[..., :n]


def _concat_guard(rem: torch.Tensor) -> torch.Tensor:
    """(…,) bool: the rows on which `_settle_network` equals
    `_place_concat`: with rem[-1] = 0, every step rem[i] - rem[i-1] is 0 or
    1, whatever the values."""
    step = rem.to(torch.int64) - F.pad(rem.to(torch.int64), (1, 0))[..., :-1]
    return ((step == 0) | (step == 1)).all(dim=-1)


def _place_concat(val: torch.Tensor, rem: torch.Tensor):
    """The settled (val, rem) of a row that passes `_concat_guard`: at each
    target p >= 0 the OR of the slots with i - rem[i] = p, zeros elsewhere,
    rem 0.  Such slots are contiguous, so a segmented OR scan over each run
    of one target, then its last slot placed."""
    n = val.shape[-1]
    dest = torch.arange(n, dtype=rem.dtype, device=rem.device) - rem
    k = 1
    while k < n:   # the zero fill of the first k slots ORs in nothing
        same = _shift_last(dest, -k) == dest
        val = val | torch.where(same, _shift_last(val, -k), 0)
        k <<= 1
    last = F.pad(dest[..., 1:] != dest[..., :-1], (0, 1), value=True)
    return (_place(val, dest, last & (dest >= 0) & (dest < n)),
            torch.zeros_like(rem))


def _compact_guard(val: torch.Tensor, rem: torch.Tensor,
                   tgt: torch.Tensor) -> torch.Tensor:
    """(…,) bool: the rows on which `_settle_network_tgt` equals
    `_place_compact`: with rem[-1] = 0, every step rem[i] - rem[i-1] is 0
    or 1, slots whose step is 1 hold val = tgt = 0, and slots whose step is
    0 have tgt >= 0."""
    step = rem - F.pad(rem, (1, 0))[..., :-1]
    ok = torch.where(step == 0, tgt >= 0,
                     (step == 1) & (val == 0) & (tgt == 0))
    return ok.all(dim=-1)


def _place_compact(val: torch.Tensor, rem: torch.Tensor, tgt: torch.Tensor):
    """The settled (val, rem, tgt) of a row that passes `_compact_guard`:
    each slot whose step is 0 at i - rem[i], zeros elsewhere, rem 0."""
    n = val.shape[-1]
    dest = torch.arange(n, dtype=rem.dtype, device=rem.device) - rem
    keep = (rem == F.pad(rem, (1, 0))[..., :-1]) & (dest >= 0) & (dest < n)
    return (_place(val, dest, keep), torch.zeros_like(rem),
            _place(tgt, dest, keep))


def _spread_guard(rem: torch.Tensor) -> torch.Tensor:
    """(…,) bool: the rows on which `_settle_network_highfirst` equals
    `_place_spread`: rem nonincreasing, rem[-1] >= 0 and rem[0] < 2^L, L the
    network's levels."""
    n = rem.shape[-1]
    levels = max(1, (n - 1).bit_length())
    return ((rem[..., 1:] <= rem[..., :-1]).all(dim=-1)
            & (rem[..., -1] >= 0) & (rem[..., 0] < (1 << levels)))


def _place_spread(val: torch.Tensor, rem: torch.Tensor):
    """The settled (val, rem) of a row that passes `_spread_guard`: slot i
    at i - rem[i] (dropped below 0), zeros elsewhere, rem 0."""
    n = val.shape[-1]
    dest = torch.arange(n, dtype=rem.dtype, device=rem.device) - rem
    return _place(val, dest, dest >= 0), torch.zeros_like(rem)


def _concat_slots(bufs: torch.Tensor, lens: torch.Tensor):
    """Per-chunk packed buffers -> the compaction network's input.

    bufs: (…, T, W) int32 left-aligned chunk payloads; lens: (…, T) int32
    payload bit lengths.  Returns (val (…, T*(W+2)) int32, rem (…,
    T*(W+2)) int32, total_bits (…,) int32).

    Word w of chunk c must land at global word (off_c >> 5) + w after the
    buffer is funnel-shifted right by the offset phase (off_c & 31).  With
    M = W + 2 source slots per chunk, the displacement D(slot) =
    source_index - target_index is constant inside a chunk and is extended
    over the empty tail slots so that it is monotone nondecreasing with
    steps in {0, 1} across the whole flattened array: any two slots that
    meet share their final target word, and their bits are disjoint."""
    *lead, t, w = bufs.shape
    m = w + 2
    dev = bufs.device
    lens = lens.to(torch.int32)
    csum = torch.cumsum(lens, dim=-1, dtype=torch.int32)
    total = csum[..., -1]
    off = csum - lens                                  # exclusive prefix
    phase = (off & 31).to(torch.int64)[..., None]      # (…, T, 1)
    wc = off >> 5                                      # (…, T)

    # funnel shift each chunk buffer right by its phase, into W + 1 words
    words = u32(bufs)
    cur = F.pad(words, (0, 1))                         # cur[w] = buf[w]
    ext = F.pad(words, (1, 0))                         # ext[w] = buf[w-1]
    shifted = torch.where(phase == 0, cur,
                          ((cur >> phase) | (ext << ((32 - phase) & 31)))
                          & MASK32)
    val = F.pad(bits32(shifted), (0, m - w - 1))       # (…, T, M)

    # displacement assignment: used slots carry D_c = c*M - wc; empty tail
    # slots step +1 toward the next chunk's D (or +0 from the first slot
    # of a zero-length chunk, whose head shares the previous tail word)
    used = torch.where(lens > 0, ((off & 31) + lens + 31) >> 5, 0)
    cidx = torch.arange(t, dtype=torch.int32, device=dev)
    d_c = cidx * m - wc                                # (…, T)
    d_end = (t * m - (total >> 5))[..., None]
    d_next = torch.cat([d_c[..., 1:], d_end], dim=-1)
    widx = torch.arange(m, dtype=torch.int32, device=dev)
    base = torch.where((used > 0)[..., None], widx - used[..., None] + 1, widx)
    rem = torch.where(widx < used[..., None], d_c[..., None],
                      torch.minimum(d_c[..., None] + base, d_next[..., None]))
    return (val.reshape(*lead, t * m), rem.reshape(*lead, t * m).to(torch.int32),
            total)


def _concat_chunks(bufs: torch.Tensor, lens: torch.Tensor, out_words: int):
    """Concatenate per-chunk packed buffers into one contiguous bitstream:
    (words (…, out_words) int32, total_bits (…,) int32)."""
    from cineform_tpu_torch.ops.merge_network import merge_network

    val, rem, total = _concat_slots(bufs, lens)
    val, _ = merge_network(val.contiguous(), rem.contiguous())
    n = val.shape[-1]
    words = val[..., :out_words]
    if out_words > n:
        words = F.pad(words, (0, out_words - n))
    return words, total


# ---------------------------------------------------------------------------
# Band-level entry point
# ---------------------------------------------------------------------------

def chunk_codes(values: torch.Tensor, t: EncodeTables, chunk: int = 256):
    """(…, N) coefficients -> per-element (bits, sizes), each (…, T, chunk)
    int32: the chunk_pack kernel's input.

    N is padded to a multiple of `chunk` with nonzero sentinels (a virtual
    band-terminating value that emits nothing), preserving the tail zero
    run exactly as the real band end would."""
    *lead, n = values.shape
    npad = -(-max(n, chunk) // chunk) * chunk
    if npad != n:
        values = F.pad(values, (0, npad - n), value=1)  # nonzero sentinel
    bits, sizes = band_codes(values, t, chunk)
    if npad != n:
        idx = torch.arange(npad, device=values.device) < n
        sizes = torch.where(idx, sizes, 0)
        bits = torch.where(idx, bits, 0)
    nt = npad // chunk
    return (bits.reshape(*lead, nt, chunk).contiguous(),
            sizes.reshape(*lead, nt, chunk).contiguous())


def encode_band_arrays(values: torch.Tensor, codeset: int = 17,
                       cap_bits_per_elem: int = 8, chunk: int = 256):
    """(…, N) coefficients -> (words int32, total_bits int32, overflow bool).

    Packing is two-level: the chunk_pack kernel within chunks, then the
    merge_network kernel across them."""
    from cineform_tpu_torch.ops.chunk_pack import chunk_pack

    n = values.shape[-1]
    bits, sizes = chunk_codes(values, encode_tables(codeset), chunk)
    chunk_cap = max(_CHUNK_CAP_BITS, cap_bits_per_elem)
    bufs, lens, c_ovf = chunk_pack(bits, sizes, cap_bits_per_elem=chunk_cap)
    out_words = _word_cap(max(cap_bits_per_elem * n, 64))
    words, total = _concat_chunks(bufs, lens, out_words)
    overflow = c_ovf.any(dim=-1) | (total > 32 * out_words)
    return words, total, overflow


def finish_band_bytes(words: np.ndarray, total_bits: int,
                      codeset: int = 17) -> bytes:
    """Host assembly tail: append the band-end codeword and zero-pad to a
    32-bit boundary, mirroring FinishEncodeBand + getvalue(align=32).
    `words` is the band's int32 (or uint32) word array on the host."""
    t = encode_tables(codeset)
    total = int(total_bits)
    nwords = (total + t.bandend_size + 31) // 32
    w = np.zeros(nwords, dtype=np.uint32)
    avail = np.asarray(words)[:min(len(words), nwords)].view(np.uint32)
    w[:len(avail)] = avail
    word0 = total >> 5
    phase = total & 31
    be = np.uint64(t.bandend_bits) << np.uint64(64 - t.bandend_size - phase)
    w[word0] |= np.uint32(be >> np.uint64(32))
    if word0 + 1 < nwords:
        w[word0 + 1] |= np.uint32(be & np.uint64(0xFFFFFFFF))
    return w.astype(">u4").tobytes()

// The monotone-displacement merge networks of the entropy coder for Hopper
// (sm_90a), settled, in three forms:
//
// - low-bit-first on (val, rem): the encoder's across-chunk concat,
//   `entropy.device._settle_network`;
// - low-bit-first on (val, rem, tgt), tgt merged by max like rem: the
//   decoder's slot compaction, `entropy.device._settle_network_tgt`
//   (the JAX `compact_rows` / `_compact_level`,
//   cineform_tpu/entropy/device_decode.py:435, :377);
// - high-bit-first on (val, rem): `entropy.device._settle_network_highfirst`,
//   which the decoder's spread (`spread_rows`, device_decode.py:463) runs on
//   mirrored rows.
//
// Replaces the TPU kernel `local_merge` (cineform_tpu/ops/pallas_merge.py:88,
// kernel `_merge_kernel` :66) in both its modes, as driven by
// `merge_network(..., lowfirst=True)` and `merge_network(..., lowfirst=False)`
// (:141, :186-194).  Each form equals its plain PyTorch version bit for bit
// on every input.
//
// The network.  A level k: every slot whose displacement has bit k set moves
// 2^k to the left (falling off at 0), and a slot that stays is merged with
// the one that arrives: values by OR, displacements (and targets) by max.
// Low-bit-first runs k = 0, 1, ... while 2^k <= n; high-bit-first runs
// k = L-1 down to 0 with L = max(1, bit_length(n - 1)), as the Pallas
// kernel's caller does.  Each level is a pass over the row, about 20 passes
// at the decoder's 1080p rows (786,432 and 1,304,840 slots).
//
// Each form places instead, where that provably gives the network's output,
// and runs the network only on the rows where it may not.  A slot i moves
// to d_i = i - rem_i.
//
// - (val, rem) form (low-bit-first), the encoder's concat.  Guard, per row,
//   with rem[-1] = 0: every step rem[i] - rem[i-1] is 0 or 1, whatever the
//   values.  Then d is nondecreasing with steps in {0, 1}, d_0 >= -1, and
//   every rem is below 2^L (rem_i <= i + 1 <= n).  Two slots i < j that
//   meet after levels 0..k-1 sit at i - (rem_i mod 2^k) = j - (rem_j mod
//   2^k); with 0 <= rem_j - rem_i <= j - i that forces rem_j - rem_i = j - i
//   and equal high bits, so slots that meet share their target and their
//   remaining displacement, and every slot reaches its target with rem 0 or
//   falls off at 0 (d = -1).  So the settled row is the OR of all slots with
//   d_i = p at each p >= 0, zeros above d[n-1], rem 0.  Unlike the
//   decoder's compaction, several nonzero slots share a target: the last
//   word of a chunk that does not end on a word boundary and the next
//   chunk's first word, and the runs of one target can be long (the 98
//   slots of each zero-length chunk of a sparse band land on the previous
//   tail word).  `_concat_slots` builds rows that pass whenever no chunk of
//   the band overflowed; an overflowed chunk longer than its M - 1 words
//   makes the displacements fall, and the row fails.
// - tgt form (low-bit-first).  Guard, per row, with rem[-1] = 0: every step
//   rem[i] - rem[i-1] is 0 or 1; a slot whose step is 1 has val = tgt = 0; a
//   slot whose step is 0 has tgt >= 0.  Then d is nondecreasing with steps
//   in {0, 1}.  Two slots i < j that meet after levels 0..k-1 sit at
//   i - (rem_i mod 2^k) = j - (rem_j mod 2^k); with rem_j - rem_i <= j - i
//   that forces rem_j - rem_i = j - i and equal high bits, so slots that
//   meet share their target and their remaining displacement, and every
//   slot reaches its target with rem 0 (rem <= n < 2^L).  The slots landing
//   on one target are one step-0 slot and step-1 slots, which carry zeros:
//   OR and max (tgt >= 0) give the step-0 slot's val and tgt.  Every target
//   0 .. d[n-1] has its step-0 slot, and nothing lands above d[n-1]; a
//   step-1 slot at target -1 is empty.  So the settled row is: val and tgt
//   of each step-0 slot at d_i, zeros at d[n-1] + 1 .. n-1, rem 0.  The
//   decoder's `compact_inputs` builds such rows: displacement constant over
//   a chunk's valid slots, +1 steps only on its empty tail slots.
// - high-bit-first form.  Guard, per row: rem nonincreasing, rem[n-1] >= 0,
//   rem[0] < 2^L.  Two slots i < j that meet after levels L-1..k would sit at
//   i - rem_i + (rem_i mod 2^k) = j - rem_j + (rem_j mod 2^k), so
//   j - i = (q_j - q_i) 2^k with q = rem >> k, and q_j > q_i contradicts
//   rem_j <= rem_i: no two slots ever meet.  Each slot lands at d_i (or
//   falls off when d_i < 0), d is strictly increasing, and a position no
//   slot lands on holds zeros; rem settles to 0.  The decoder's
//   `spread_inputs` builds such rows: a suffix minimum, clamped, mirrored,
//   its padding given the first real slot's displacement.
//
// What bounds the placement on this card: device memory.  One read of each
// slot (8 or 12 bytes; rem[i-1] and rem[n-1] are read again, which the
// caches serve) and one write of each output slot: 16 or 24 bytes a slot in
// all.  The guard is evaluated in the same pass.  In the (val, rem) form the
// output words are zeroed first (4 bytes a slot more), each warp ORs the
// slots of each target among its 32 with shuffles, and the last slot of
// each such run ORs a nonzero result into its target with atomicOr: OR
// commutes, so the order of the blocks does not matter, and a target shared
// with the next warp or block gets one atomic from each.  In the tgt form
// each output slot is written once: by its step-0 slot, or, above d[n-1],
// as a zero by its own thread.  In the high-bit-first form a block of 1024
// slots owns the output positions d[i0] .. d[i1]-1 between its first slot's
// target and the next block's: it zero-fills them, then stores its slots,
// so no position is written by two blocks; a block whose own slots break
// the guard writes nothing.
//
// The network branch, for rows that fail a guard.  A failing row sets its
// flag in the placement pass; the network then runs on the device with no
// host synchronisation, returning at once where a row's flag is clear, and
// overwrites each flagged row's output with the network's, counting the
// row.  The encoder's concat has such rows (every band of noise content,
// and the bands of real content with a badly overflowed chunk), so its
// network spreads each flagged row over the whole card, in launches of as
// many blocks as the card holds at once, which stride over the work and
// skip the rows whose flag is clear: one shared-memory pass over levels
// 0..9 on the flagged rows' tiles (a block loads a tile of kTile slots plus
// the kHalo = 2^10 - 1 slots to its right: a level pulls from j + 2^k, so
// the stale right edge grows by 2^k per level and the halo absorbs all of
// them, in either order of the levels), then a pass per kFuse = 4 levels
// above (a slot reads 16 slots, 2^k apart, mostly from L2, where the
// flagged rows fit).  So the branch costs a pass per four levels over the
// flagged rows only, and 1 + ceil((L - 10) / 4) launches.  Kernel
// boundaries separate the passes: on the H100 a grid-wide barrier inside
// one cooperative launch cost more.  The decoder's rows never fail (no real
// decode row does), so their network is one block per row, which runs a
// flagged row's levels itself.
//
// Entry points, plain C, launched on the caller's stream, each returning
// cudaGetLastError(): cf_merge_network (low-bit-first, the encoder's
// concat), cf_merge_network_tgt (low-bit-first, three arrays),
// cf_merge_network_highfirst.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLocalLevels = 10;
constexpr int kHalo = (1 << kLocalLevels) - 1;
constexpr int kTile = 2048;
constexpr int kSpan = kTile + kHalo;
constexpr int kPer = (kSpan + kThreads - 1) / kThreads;
// slots per block of the high-bit-first placement
constexpr int kPlaceTile = 1024;
constexpr int kPlacePer = kPlaceTile / kThreads;
// slots per warp, and per block, of the (val, rem) placement
constexpr int kConcatWarp = 128;
constexpr int kConcatTile = kConcatWarp * (kThreads / 32);
constexpr unsigned kFullMask = 0xFFFFFFFFu;
// network levels a pass above the local ones, in the (val, rem) form
constexpr int kFuse = 4;

// One level at one slot: (v0, r0, t0) stays unless bit k of r0 is set;
// (v1, r1, t1), the slot 2^k to the right, arrives if bit k of r1 is set.
// t is carried only when kTgt.
template <bool kTgt>
__device__ __forceinline__ void level_step(uint32_t v0, int r0, int t0,
                                           uint32_t v1, int r1, int t1, int k,
                                           int s, uint32_t& v, int& r,
                                           int& t) {
  const bool stay = ((r0 >> k) & 1) == 0;
  const bool come = ((r1 >> k) & 1) == 1;
  v = (stay ? v0 : 0u) | (come ? v1 : 0u);
  r = max(stay ? r0 : 0, come ? r1 - s : 0);
  if (kTgt) t = max(stay ? t0 : 0, come ? t1 : 0);
}

// The arrays of one network: val as uint32, rem and (when kTgt) tgt.
struct Slots {
  uint32_t* v;
  int* r;
  int* t;
};

// The same arrays from slot `off` on.
__device__ __forceinline__ Slots at(Slots s, size_t off) {
  return Slots{s.v + off, s.r + off, s.t ? s.t + off : nullptr};
}

template <bool kTgt>
struct TileSmem {
  uint32_t v[kSpan];
  int r[kSpan];
  int t[kTgt ? kSpan : 1];
};

// Levels 0 .. levels-1 (levels <= kLocalLevels) of the tile at t0 of one row
// (src and dst point at the row), in ascending order, or descending when
// `desc`.  Ends with a barrier, so that a block may run tiles back to back
// and read dst after them.
template <bool kTgt>
__device__ __forceinline__ void tile_levels(Slots src, Slots dst, int n,
                                            int t0, int levels, bool desc,
                                            TileSmem<kTgt>& sm) {
  for (int j = threadIdx.x; j < kSpan; j += kThreads) {
    const int i = t0 + j;
    // slots beyond the row are the network's zero fill
    sm.v[j] = i < n ? src.v[i] : 0u;
    sm.r[j] = i < n ? src.r[i] : 0;
    if (kTgt) sm.t[j] = i < n ? src.t[i] : 0;
  }
  __syncthreads();
  for (int step = 0; step < levels; ++step) {
    const int k = desc ? levels - 1 - step : step;
    const int s = 1 << k;
    uint32_t nv[kPer];
    int nr[kPer], nt[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int j = threadIdx.x + e * kThreads;
      const bool in = j + s < kSpan;  // beyond: stale, never reaches the tile
      if (j < kSpan) {
        level_step<kTgt>(sm.v[j], sm.r[j], kTgt ? sm.t[j] : 0,
                         in ? sm.v[j + s] : 0u, in ? sm.r[j + s] : 0,
                         (kTgt && in) ? sm.t[j + s] : 0, k, s, nv[e], nr[e],
                         nt[e]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int j = threadIdx.x + e * kThreads;
      if (j < kSpan) {
        sm.v[j] = nv[e];
        sm.r[j] = nr[e];
        if (kTgt) sm.t[j] = nt[e];
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int i = t0 + j;
    if (i < n) {
      dst.v[i] = sm.v[j];
      dst.r[i] = sm.r[j];
      if (kTgt) dst.t[i] = sm.t[j];
    }
  }
  __syncthreads();
}

// Level k of one row (a and b point at it), by the whole block.
template <bool kTgt>
__device__ __forceinline__ void row_level(Slots a, Slots b, int n, int k) {
  const int s = 1 << k;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool in = (long long)i + s < n;
    int t = 0;
    level_step<kTgt>(a.v[i], a.r[i], kTgt ? a.t[i] : 0, in ? a.v[i + s] : 0u,
                     in ? a.r[i + s] : 0, (kTgt && in) ? a.t[i + s] : 0, k, s,
                     b.v[i], b.r[i], t);
    if (kTgt) b.t[i] = t;
  }
}

// The network's number of levels for rows of n slots.
int network_levels(int n, bool highfirst) {
  int levels = 0;
  if (highfirst) {  // bit_length(n - 1), at least 1
    while (levels < 31 && (1LL << levels) <= (long long)n - 1) ++levels;
    return levels < 1 ? 1 : levels;
  }
  while (levels < 31 && (1LL << levels) <= n) ++levels;  // 2^k <= n
  return levels;
}

// The network of each row whose flag is set, one block a row, from `in`
// into `out` with `tmp` as scratch (the block ping-pongs between them; its
// own writes are visible to it after each barrier).  Counts those rows in
// `*flagged`.  Low-bit-first: the local levels tile by tile, then the levels
// above; high-bit-first: the levels above, then the local ones.
template <bool kTgt>
__global__ void __launch_bounds__(kThreads)
guarded_network_kernel(Slots in, Slots out, Slots tmp,
                       const int* __restrict__ flags, int* flagged, int n,
                       int levels, int highfirst) {
  __shared__ TileSmem<kTgt> sm;
  const int row = blockIdx.x;
  if (flags[row] == 0) return;
  if (threadIdx.x == 0) atomicAdd(flagged, 1);
  const size_t base = (size_t)row * n;
  in = at(in, base);
  const Slots buf[2] = {at(out, base), at(tmp, base)};
  const int local = levels < kLocalLevels ? levels : kLocalLevels;
  const int global = levels - local;
  if (!highfirst) {
    int cur = global % 2;  // so that the last level writes `out`
    for (int t0 = 0; t0 < n; t0 += kTile)
      tile_levels<kTgt>(in, buf[cur], n, t0, local, false, sm);
    for (int k = local; k < levels; ++k) {
      row_level<kTgt>(buf[cur], buf[cur ^ 1], n, k);
      __syncthreads();
      cur ^= 1;
    }
    return;
  }
  Slots src = in;  // the last of the levels above lands in `tmp`
  for (int g = 0; g < global; ++g) {
    const Slots dst = buf[(global - g) % 2];
    row_level<kTgt>(src, dst, n, levels - 1 - g);
    __syncthreads();
    src = dst;
  }
  for (int t0 = 0; t0 < n; t0 += kTile)
    tile_levels<kTgt>(src, buf[0], n, t0, local, true, sm);
}

// The tgt form's placement and guard, one slot per thread (see the note at
// the top).  A row that breaks the guard sets its flag; its output is then
// rewritten by the guarded network, so writes out of the row's range are
// all that is skipped here.
__global__ void __launch_bounds__(kThreads)
place_tgt_kernel(const uint32_t* __restrict__ val,
                 const int* __restrict__ rem, const int* __restrict__ tgt,
                 uint32_t* __restrict__ oval, int* __restrict__ orem,
                 int* __restrict__ otgt, int* __restrict__ flags, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t base = (size_t)blockIdx.y * n;
  const int r = rem[base + i];
  const long long step = (long long)r - (i ? rem[base + i - 1] : 0);
  const uint32_t v = val[base + i];
  const int t = tgt[base + i];
  const long long d = (long long)i - r;
  bool ok;
  if (step == 0) {
    ok = t >= 0 && d >= 0;  // d >= 0 follows from the steps; kept as a check
    if (d >= 0 && d < n) {
      oval[base + d] = v;
      otgt[base + d] = t;
    }
  } else {
    ok = step == 1 && v == 0u && t == 0;
  }
  // above the last slot's target nothing lands
  if ((long long)i > (long long)(n - 1) - rem[base + n - 1]) {
    oval[base + i] = 0u;
    otgt[base + i] = 0;
  }
  orem[base + i] = 0;
  if (!ok) flags[blockIdx.y] = 1;
}

// The high-bit-first form's placement and guard, kPlaceTile slots a block
// (see the note at the top).
__global__ void __launch_bounds__(kThreads)
place_highfirst_kernel(const uint32_t* __restrict__ val,
                       const int* __restrict__ rem,
                       uint32_t* __restrict__ oval, int* __restrict__ orem,
                       int* __restrict__ flags, int n, int levels) {
  const size_t base = (size_t)blockIdx.y * n;
  const int i0 = blockIdx.x * kPlaceTile;
  const int i1 = min(i0 + kPlaceTile, n);
  const long long lim = 1LL << levels;
  uint32_t v[kPlacePer];
  int r[kPlacePer];
  bool ok = true;
#pragma unroll
  for (int e = 0; e < kPlacePer; ++e) {
    const int i = i0 + threadIdx.x + e * kThreads;
    if (i < i1) {
      v[e] = val[base + i];
      r[e] = rem[base + i];
      const int rn = i + 1 < n ? rem[base + i + 1] : 0;
      ok = ok && r[e] >= rn && r[e] >= 0 && r[e] < lim;
    }
  }
  if (!__syncthreads_and(ok)) {
    if (threadIdx.x == 0) flags[blockIdx.y] = 1;
    return;
  }
  // the block's slots land in [lo, hi), which no other block writes
  const long long lo = max(0LL, (long long)i0 - rem[base + i0]);
  const long long hi =
      min((long long)n, i1 < n ? (long long)i1 - rem[base + i1] : n);
  for (long long p = lo + threadIdx.x; p < hi; p += kThreads) oval[base + p] = 0u;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kPlacePer; ++e) {
    const int i = i0 + threadIdx.x + e * kThreads;
    if (i < i1) {
      const int d = i - r[e];
      if (d >= 0) oval[base + d] = v[e];
      orem[base + i] = 0;
    }
  }
}

// The (val, rem) form's placement and guard into zeroed output words (see
// the note at the top): a block of kConcatTile slots, each warp 32
// consecutive slots at a time.  A row that breaks the guard sets its flag;
// its output is then rewritten by the network, so writes out of the row's
// range are all that is skipped here.
__global__ void __launch_bounds__(kThreads)
place_concat_kernel(const uint32_t* __restrict__ val,
                    const int* __restrict__ rem, uint32_t* __restrict__ oval,
                    int* __restrict__ orem, int* __restrict__ flags, int n) {
  const size_t base = (size_t)blockIdx.y * n;
  const int lane = threadIdx.x & 31;
  const int w0 = blockIdx.x * kConcatTile + (threadIdx.x >> 5) * kConcatWarp;
  bool ok = true;
#pragma unroll
  for (int e = 0; e < kConcatWarp / 32; ++e) {
    const int i = w0 + e * 32 + lane;
    const bool in = i < n;
    uint32_t v = in ? val[base + i] : 0u;
    const int r = in ? rem[base + i] : 0;
    // the step from the slot before: the lane below's rem, or memory
    int rp = __shfl_up_sync(kFullMask, r, 1);
    if (lane == 0) rp = (i == 0 || !in) ? 0 : rem[base + i - 1];
    const long long step = (long long)r - rp;
    ok = ok && (!in || step == 0 || step == 1);
    // the target; beyond the row, one that no slot of the row has (a row
    // that breaks the guard may wrap here: it is rewritten)
    const int d = in ? (int)((long long)i - r) : n;
    // OR of the slots of each run of one target, up to this lane
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const uint32_t pv = __shfl_up_sync(kFullMask, v, s);
      const int pd = __shfl_up_sync(kFullMask, d, s);
      if (lane >= s && pd == d) v |= pv;
    }
    const int nd = __shfl_down_sync(kFullMask, d, 1);
    if (in && (lane == 31 || nd != d) && v != 0u && d >= 0 && d < n) {
      atomicOr(oval + base + d, v);
    }
    if (in) orem[base + i] = 0;
  }
  if (__any_sync(kFullMask, !ok) && lane == 0) flags[blockIdx.y] = 1;
}

// Levels k .. k + F - 1 of the network at slot i of the row at `base`,
// from a into b: the 2^F slots i + j 2^k are read, through L2, each beyond
// the row a zero, as in the network's fill; level k + m then merges, at
// each j that is a multiple of 2^(m+1), the value at j with the one 2^m on.
template <int F>
__device__ __forceinline__ void fused_levels(Slots a, Slots b, size_t base,
                                             int i, int n, int k) {
  const int s = 1 << k;
  uint32_t v[1 << F];
  int r[1 << F];
#pragma unroll
  for (int j = 0; j < (1 << F); ++j) {
    const long long p = (long long)i + (long long)j * s;
    v[j] = p < n ? __ldcg(a.v + base + p) : 0u;
    r[j] = p < n ? __ldcg(a.r + base + p) : 0;
  }
  int t = 0;
#pragma unroll
  for (int m = 0; m < F; ++m) {
#pragma unroll
    for (int j = 0; j < (1 << F); j += 2 << m) {
      level_step<false>(v[j], r[j], 0, v[j + (1 << m)], r[j + (1 << m)], 0,
                        k + m, s << m, v[j], r[j], t);
    }
  }
  b.v[base + i] = v[0];
  b.r[base + i] = r[0];
}

// Whether any row is flagged, the same answer in every block; block 0
// adds the flagged rows to `*flagged` when `count`.
__device__ __forceinline__ bool any_flagged(const int* __restrict__ flags,
                                            int rows, int* flagged,
                                            bool count) {
  int mine = 0;
  for (int r = threadIdx.x; r < rows; r += kThreads) mine += flags[r] != 0;
  if (count && blockIdx.x == 0 && mine) atomicAdd(flagged, mine);
  return __syncthreads_or(mine) != 0;
}

// The local levels of the (val, rem) form's network over the tiles of the
// flagged rows, by resident blocks striding over (row, tile); counts the
// flagged rows.
__global__ void __launch_bounds__(kThreads)
concat_local_kernel(Slots in, Slots out, const int* __restrict__ flags,
                    int* flagged, int rows, int n, int levels) {
  __shared__ TileSmem<false> sm;
  if (!any_flagged(flags, rows, flagged, true)) return;
  const int tiles = (n + kTile - 1) / kTile;
  for (long long w = blockIdx.x; w < (long long)rows * tiles; w += gridDim.x) {
    const int row = (int)(w / tiles);
    if (flags[row] == 0) continue;
    const size_t base = (size_t)row * n;
    tile_levels<false>(at(in, base), at(out, base), n,
                       (int)(w % tiles) * kTile, levels, false, sm);
  }
}

// Levels k .. k + f - 1 (f <= kFuse) of the (val, rem) form's network over
// the flagged rows, by resident threads striding over the slots of all
// rows and skipping those of rows whose flag is clear.
__global__ void __launch_bounds__(kThreads)
concat_levels_kernel(Slots a, Slots b, const int* __restrict__ flags,
                     int rows, int n, int k, int f) {
  if (!any_flagged(flags, rows, nullptr, false)) return;
  // gridDim.x * kThreads and n are below 2^31, so a step stays in 32 bits
  const unsigned stride = gridDim.x * kThreads;
  const unsigned u0 = blockIdx.x * kThreads + threadIdx.x;
  int row = (int)(u0 / (unsigned)n), i = (int)(u0 % (unsigned)n);
  while (row < rows) {
    if (flags[row]) {
      const size_t base = (size_t)row * n;
      switch (f) {
        case 1: fused_levels<1>(a, b, base, i, n, k); break;
        case 2: fused_levels<2>(a, b, base, i, n, k); break;
        case 3: fused_levels<3>(a, b, base, i, n, k); break;
        default: fused_levels<kFuse>(a, b, base, i, n, k); break;
      }
    }
    const unsigned next = (unsigned)i + stride;
    row += (int)(next / (unsigned)n);
    i = (int)(next % (unsigned)n);
  }
}

// How many blocks of 256 threads with the local levels' shared memory the
// current device holds at once; asked once per device.  Both network
// kernels launch that many.
cudaError_t resident_blocks(int* blocks) {
  static int known[64];
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device >= 0 && device < 64;
  if (cached && known[device]) {
    *blocks = known[device];
    return cudaSuccess;
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, concat_local_kernel, kThreads, 0)) != cudaSuccess) {
    return err;
  }
  *blocks = sms * per_sm;
  if (cached) known[device] = *blocks;
  return cudaSuccess;
}

bool bad_shape(long long rows, int n) {
  return rows < 1 || rows > 65535 || n < 1;
}

Slots slots(const void* v, const int* r, const int* t) {
  return Slots{(uint32_t*)v, (int*)r, (int*)t};
}

}  // namespace

// val, out_val, tmp_val: (rows, n) int32 read and written as uint32; rem,
// out_rem, tmp_rem (and tgt, out_tgt, tmp_tgt): (rows, n) int32.  tmp_* is
// scratch of the same size.  flags: (rows,) int32, zero on entry, set for
// each row that fails its guard; flagged: one int32 to which the number of
// those rows is added.
extern "C" int cf_merge_network(const void* val, const int* rem,
                                void* out_val, int* out_rem, void* tmp_val,
                                int* tmp_rem, int* flags, int* flagged,
                                long long rows, int n, void* stream) {
  if (bad_shape(rows, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaMemsetAsync(out_val, 0, (size_t)rows * n * sizeof(uint32_t),
                             st)) != cudaSuccess) {
    return (int)err;
  }
  const dim3 grid((n + kConcatTile - 1) / kConcatTile, (unsigned)rows);
  place_concat_kernel<<<grid, kThreads, 0, st>>>(
      (const uint32_t*)val, rem, (uint32_t*)out_val, out_rem, flags, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // the network on the flagged rows: local levels, then up to kFuse levels
  // a pass; ping-pong so that the last pass writes `out`
  int blocks = 0;
  if ((err = resident_blocks(&blocks)) != cudaSuccess) return (int)err;
  const int levels = network_levels(n, false);
  const int local = levels < kLocalLevels ? levels : kLocalLevels;
  const Slots buf[2] = {slots(out_val, out_rem, nullptr),
                        slots(tmp_val, tmp_rem, nullptr)};
  int cur = ((levels - local + kFuse - 1) / kFuse) % 2;
  concat_local_kernel<<<blocks, kThreads, 0, st>>>(
      slots(val, rem, nullptr), buf[cur], flags, flagged, (int)rows, n, local);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int k = local; k < levels; k += kFuse) {
    const int f = levels - k < kFuse ? levels - k : kFuse;
    concat_levels_kernel<<<blocks, kThreads, 0, st>>>(
        buf[cur], buf[cur ^ 1], flags, (int)rows, n, k, f);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    cur ^= 1;
  }
  return (int)cudaSuccess;
}
extern "C" int cf_merge_network_tgt(const void* val, const int* rem,
                                    const int* tgt, void* out_val,
                                    int* out_rem, int* out_tgt, void* tmp_val,
                                    int* tmp_rem, int* tmp_tgt, int* flags,
                                    int* flagged, long long rows, int n,
                                    void* stream) {
  if (bad_shape(rows, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + kThreads - 1) / kThreads, (unsigned)rows);
  place_tgt_kernel<<<grid, kThreads, 0, st>>>(
      (const uint32_t*)val, rem, tgt, (uint32_t*)out_val, out_rem, out_tgt,
      flags, n);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  guarded_network_kernel<true><<<(unsigned)rows, kThreads, 0, st>>>(
      slots(val, rem, tgt), slots(out_val, out_rem, out_tgt),
      slots(tmp_val, tmp_rem, tmp_tgt), flags, flagged, n,
      network_levels(n, false), 0);
  return (int)cudaGetLastError();
}

extern "C" int cf_merge_network_highfirst(const void* val, const int* rem,
                                          void* out_val, int* out_rem,
                                          void* tmp_val, int* tmp_rem,
                                          int* flags, int* flagged,
                                          long long rows, int n,
                                          void* stream) {
  if (bad_shape(rows, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int levels = network_levels(n, true);
  const dim3 grid((n + kPlaceTile - 1) / kPlaceTile, (unsigned)rows);
  place_highfirst_kernel<<<grid, kThreads, 0, st>>>(
      (const uint32_t*)val, rem, (uint32_t*)out_val, out_rem, flags, n,
      levels);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  guarded_network_kernel<false><<<(unsigned)rows, kThreads, 0, st>>>(
      slots(val, rem, nullptr), slots(out_val, out_rem, nullptr),
      slots(tmp_val, tmp_rem, nullptr), flags, flagged, n, levels, 1);
  return (int)cudaGetLastError();
}

// Stages 1-5 of the band entropy decoder for Hopper (sm_90a): band payload
// rows -> every 32-bit chunk's front-packed slots (target index, dequantized
// value), in three launches with no host synchronisation.
//
// Replaces no TPU kernel: the JAX package runs these stages as XLA
// (`cineform_tpu/entropy/device_decode.py`: `classify`, `chunk_transfers`,
// `scan_entries_rows`, `final_walk`, `emit_slots`), and the port ran them as
// plain PyTorch, some 900 launches a row class (a 31-step scatter wavefront
// twice, a 27-way reduction stack, a log-step scan that concatenates the
// whole array at every step).  Equals the plain stages
// (`entropy.device_decode.plain_band_slots`) bit for bit on every input,
// corrupt rows included: a row with no band end, a band end inside the
// padding, targets past the region, chunks past `nchunks`.
//
// The algorithm.  A row is one band's bitstream.  Every bit position has
// the codeword that would start there (the packed code of `classify`: len |
// count << 5 | mag << 14 | isend << 22 | sign << 23, from the interval
// tiling of the prefix code, by binary search).  A walk that enters a chunk
// at bit phase p (0..26) visits positions p, p + adv, ... (adv = len + 1
// for a nonzero value, its sign bit, else len) until one is a band end
// (exit DONE = 27) or it leaves the chunk at position 32 + e (exit phase
// e); the chunk's transfer is F(p) = exit, C(p) = the run counts of the
// positions visited before a band end.  F(DONE) = DONE, C(DONE) = 0.
// Chunk k's true entry is F_{k-1} o ... o F_0 (0), its first coefficient
// index the sum of C along that chain.  The final walk from the true entry
// marks the codeword starts, and each start that emits a nonzero value
// takes a slot.  A chunk whose entry is DONE walks from position 27, as
// the plain final walk seeds it.
//
// What bounds it on this card: the dependent chain of a row, not memory.
// The payload is read twice (a chunk's 8 bytes, in kernels 1 and 3) and
// the slots written once (101 bytes a chunk); the transfers between the
// kernels add 84 bytes a chunk each way.  The chain runs in three levels,
// so that its longest serial part is some 2 x 64 steps:
//
// 1. `band_transfers_kernel`, one block a tile of kTile chunks, one warp a
//    chunk: lane i classifies position i from the chunk's 8 bytes (its word
//    and the next); lanes p < 27 then walk from phase p through the chunk
//    with __shfl_sync, which gives F and C.  The block stores them (per
//    chunk, for kernel 3) and composes them over the tile in shared memory:
//    lane p of warp 0 follows phase p through the tile's chunks.
// 2. `band_scan_kernel`, one block a row: 32 warps split the row's tiles
//    into segments; lane p of each follows phase p through its segment's
//    tile functions (a segment's function), thread 0 composes the 32
//    segment functions from phase 0, and lane 0 of each warp re-walks its
//    segment from its true entry, writing each tile's entry and base.
// 3. `band_walk_kernel`, one block a tile: thread 0 follows the tile's
//    entry through its chunks' stored F and C (each chunk's entry and
//    base); each warp then classifies its chunk again, walks from the true
//    entry (one uniform chain of shuffles), and emits: an exclusive warp
//    scan of the visited positions' counts gives the targets, a ballot the
//    ranks of the valid emissions, the first NSLOT of which are stored.
//
// Chunks at or past a row's `nchunks` are neither classified nor walked
// (nothing before them depends on them) and get zero slots.  Arithmetic on
// targets and bases wraps at 32 bits, as the plain stages' int32 does.
//
// Entry points, plain C, launched on the caller's stream, each returning
// cudaGetLastError(): cf_band_transfers, cf_band_scan, cf_band_walk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kPhases = 27;        // entry phases 0..26
constexpr int kDone = 27;          // the absorbing band-ended phase
constexpr int kFun = 28;           // a transfer's entries: phases 0..27
constexpr int kSlots = 12;         // NSLOT
constexpr int kTile = 64;          // chunks a tile
constexpr int kWarps = 8;          // warps a block of kernels 1 and 3
constexpr int kBlock = kWarps * kLanes;
constexpr int kScanWarps = 32;     // warps of kernel 2's block
constexpr int kMaxLut = 512;       // interval tiling entries (cs17: 264)
constexpr uint32_t kM27 = (1u << 27) - 1;
constexpr unsigned kFull = 0xFFFFFFFFu;

// A row's chunks that are decoded, of those from k0: its nchunks clamped to
// [0, s], less k0, at most a tile.
__device__ __forceinline__ int live_chunks(int nchunks, long long s,
                                           long long k0) {
  const long long n = min((long long)max(nchunks, 0), s) - k0;
  return (int)max(0LL, min((long long)kTile, n));
}

__device__ __forceinline__ void load_lut(int* s_bounds, int* s_leaves,
                                         const int* bounds, const int* leaves,
                                         int nlut) {
  for (int i = threadIdx.x; i < nlut; i += blockDim.x) {
    s_bounds[i] = bounds[i];
    s_leaves[i] = leaves[i];
  }
}

// Stage 1 at bit position `lane` of chunk k of a row of s chunks (`row` its
// words): the 27-bit window there, MSB first, zeros past the row; the
// packed code of the last interval whose bound is at most its top 26 bits
// (bounds[0] = 0), with the sign bit that follows the codeword.
__device__ __forceinline__ uint32_t classify(const uint32_t* row, long long k,
                                             long long s, const int* s_bounds,
                                             const int* s_leaves, int nlut,
                                             int lane) {
  const uint32_t hi = __byte_perm(row[k], 0, 0x0123);
  const uint32_t lo = k + 1 < s ? __byte_perm(row[k + 1], 0, 0x0123) : 0u;
  const uint64_t cat = ((uint64_t)hi << 32) | lo;
  const uint32_t win27 = (uint32_t)(cat >> (37 - lane)) & kM27;
  const int win26 = (int)(win27 >> 1);
  int j = 0;
#pragma unroll
  for (int step = kMaxLut / 2; step > 0; step >>= 1) {
    const int m = j + step;
    if (m < nlut && s_bounds[m] <= win26) j = m;
  }
  const uint32_t packed = (uint32_t)s_leaves[j];
  const uint32_t sign = (win27 >> (26 - (packed & 31))) & 1u;
  return packed | (sign << 23);
}

__device__ __forceinline__ bool is_end(uint32_t code) {
  return (code >> 22) & 1u;
}
__device__ __forceinline__ uint32_t count_of(uint32_t code) {
  return (code >> 5) & 511u;
}
__device__ __forceinline__ uint32_t mag_of(uint32_t code) {
  return (code >> 14) & 255u;
}
__device__ __forceinline__ int adv_of(uint32_t code) {
  return (int)(code & 31u) + (mag_of(code) != 0u);
}

// Kernel 1.  payload (rows, 4 s) bytes; chunk_f/chunk_c (rows, s, kFun):
// each decoded chunk's F (uint8) and C (uint16: at most 32 x 511); agg_f /
// agg_c (rows, nt, kFun): each tile's composed F and C (int32).
__global__ void __launch_bounds__(kBlock) band_transfers_kernel(
    const uint8_t* __restrict__ payload, const int* __restrict__ nchunks,
    const int* __restrict__ bounds, const int* __restrict__ leaves, int nlut,
    uint8_t* __restrict__ chunk_f, uint16_t* __restrict__ chunk_c,
    uint8_t* __restrict__ agg_f, int* __restrict__ agg_c, long long s,
    long long nt) {
  __shared__ int s_bounds[kMaxLut], s_leaves[kMaxLut];
  __shared__ uint8_t s_f[kTile][kFun];
  __shared__ uint16_t s_c[kTile][kFun];
  const long long r = blockIdx.y;
  const long long t = blockIdx.x;
  const long long k0 = t * kTile;
  const int live = live_chunks(nchunks[r], s, k0);
  if (live == 0) return;                      // uniform across the block
  load_lut(s_bounds, s_leaves, bounds, leaves, nlut);
  __syncthreads();
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const uint32_t* row = (const uint32_t*)(payload + r * 4 * s);
  for (int j = warp; j < live; j += kWarps) {
    const long long k = k0 + j;
    const uint32_t code = classify(row, k, s, s_bounds, s_leaves, nlut, lane);
    int pos = lane;
    bool active = lane < kPhases;
    int f = kDone;
    uint32_t c = 0;
    while (__any_sync(kFull, active)) {
      const uint32_t v = __shfl_sync(kFull, code, pos & 31);
      if (active) {
        if (is_end(v)) {
          active = false;
        } else {
          c += count_of(v);
          pos += adv_of(v);
          if (pos >= kLanes) {
            f = pos - kLanes;                  // < 27: len + 1 <= 27
            active = false;
          }
        }
      }
    }
    if (lane < kFun) {
      s_f[j][lane] = (uint8_t)f;
      s_c[j][lane] = (uint16_t)c;
      const size_t at = (size_t)(r * s + k) * kFun + lane;
      chunk_f[at] = (uint8_t)f;
      chunk_c[at] = (uint16_t)c;
    }
  }
  __syncthreads();
  if (threadIdx.x < kFun) {
    int cur = threadIdx.x;
    uint32_t acc = 0;
    for (int j = 0; j < live; ++j) {
      acc += s_c[j][cur];
      cur = s_f[j][cur];
    }
    const size_t at = (size_t)(r * nt + t) * kFun + threadIdx.x;
    agg_f[at] = (uint8_t)cur;
    agg_c[at] = (int)acc;
  }
}

// Kernel 2.  tile_e / tile_b (rows, nt): each decoded tile's entry phase
// and first coefficient index.
__global__ void __launch_bounds__(kScanWarps * kLanes) band_scan_kernel(
    const uint8_t* __restrict__ agg_f, const int* __restrict__ agg_c,
    const int* __restrict__ nchunks, int* __restrict__ tile_e,
    int* __restrict__ tile_b, long long s, long long nt) {
  __shared__ uint8_t seg_f[kScanWarps][kFun];
  __shared__ uint32_t seg_c[kScanWarps][kFun];
  __shared__ int seg_e[kScanWarps];
  __shared__ uint32_t seg_b[kScanWarps];
  const long long r = blockIdx.x;
  const long long nch = min((long long)max(nchunks[r], 0), s);
  const long long ntr = (nch + kTile - 1) / kTile;
  const long long per = (ntr + kScanWarps - 1) / kScanWarps;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const long long t0 = min(ntr, warp * per);
  const long long t1 = min(ntr, t0 + per);
  const uint8_t* fr = agg_f + (size_t)r * nt * kFun;
  const int* cr = agg_c + (size_t)r * nt * kFun;
  if (lane < kFun) {
    int cur = lane;
    uint32_t acc = 0;
    for (long long t = t0; t < t1; ++t) {
      acc += (uint32_t)cr[t * kFun + cur];
      cur = fr[t * kFun + cur];
    }
    seg_f[warp][lane] = (uint8_t)cur;
    seg_c[warp][lane] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int e = 0;
    uint32_t b = 0;
    for (int w = 0; w < kScanWarps; ++w) {
      seg_e[w] = e;
      seg_b[w] = b;
      b += seg_c[w][e];
      e = seg_f[w][e];
    }
  }
  __syncthreads();
  if (lane == 0) {
    int e = seg_e[warp];
    uint32_t b = seg_b[warp];
    for (long long t = t0; t < t1; ++t) {
      tile_e[r * nt + t] = e;
      tile_b[r * nt + t] = (int)b;
      b += (uint32_t)cr[t * kFun + e];
      e = fr[t * kFun + e];
    }
  }
}

// Kernel 3.  ctgt / cval (rows, s, kSlots) int32, nval (rows, s) int32, ovf
// (rows, s) bool: `emit_slots`' outputs, every chunk written.
__global__ void __launch_bounds__(kBlock) band_walk_kernel(
    const uint8_t* __restrict__ payload, const uint8_t* __restrict__ chunk_f,
    const uint16_t* __restrict__ chunk_c, const int* __restrict__ tile_e,
    const int* __restrict__ tile_b, const int* __restrict__ nchunks,
    const int* __restrict__ quant, const int* __restrict__ linear,
    const int* __restrict__ bounds, const int* __restrict__ leaves, int nlut,
    int* __restrict__ ctgt, int* __restrict__ cval, int* __restrict__ nval,
    uint8_t* __restrict__ ovf, long long s, long long nt, int nout) {
  __shared__ int s_bounds[kMaxLut], s_leaves[kMaxLut];
  __shared__ __align__(16) uint8_t s_f[kTile][kFun];
  __shared__ __align__(16) uint16_t s_c[kTile][kFun];
  __shared__ int s_e[kTile];
  __shared__ uint32_t s_b[kTile];
  const long long r = blockIdx.y;
  const long long t = blockIdx.x;
  const long long k0 = t * kTile;
  const int in_tile = (int)min((long long)kTile, s - k0);
  const int live = live_chunks(nchunks[r], s, k0);
  if (live > 0) {                              // uniform across the block
    load_lut(s_bounds, s_leaves, bounds, leaves, nlut);
    const size_t first = (size_t)(r * s + k0) * kFun;
    const uint32_t* gf = (const uint32_t*)(chunk_f + first);
    const uint32_t* gc = (const uint32_t*)(chunk_c + first);
    uint32_t* sf = (uint32_t*)&s_f[0][0];
    uint32_t* sc = (uint32_t*)&s_c[0][0];
    for (int i = threadIdx.x; i < live * (kFun / 4); i += kBlock) sf[i] = gf[i];
    for (int i = threadIdx.x; i < live * (kFun / 2); i += kBlock) sc[i] = gc[i];
    __syncthreads();
    if (threadIdx.x == 0) {
      int e = tile_e[r * nt + t];
      uint32_t b = (uint32_t)tile_b[r * nt + t];
      for (int j = 0; j < live; ++j) {
        s_e[j] = e;
        s_b[j] = b;
        b += s_c[j][e];
        e = s_f[j][e];
      }
    }
    __syncthreads();
  }
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const uint32_t* row = (const uint32_t*)(payload + r * 4 * s);
  const int q = quant[r];
  const bool lin = linear[r] == 1;
  for (int j = warp; j < in_tile; j += kWarps) {
    const size_t ck = (size_t)(r * s + k0 + j);
    int* out_tgt = ctgt + ck * kSlots;
    int* out_val = cval + ck * kSlots;
    if (j >= live) {
      if (lane < kSlots) {
        out_tgt[lane] = 0;
        out_val[lane] = 0;
      }
      if (lane == 0) {
        nval[ck] = 0;
        ovf[ck] = 0;
      }
      continue;
    }
    const uint32_t code =
        classify(row, k0 + j, s, s_bounds, s_leaves, nlut, lane);
    // stage 4: the codeword starts of the walk from the true entry (one
    // chain, the same position on every lane), band ends excluded
    uint32_t starts = 0;
    for (int pos = s_e[j]; pos < kLanes;) {
      const uint32_t v = __shfl_sync(kFull, code, pos);
      if (is_end(v)) break;
      starts |= 1u << pos;
      pos += adv_of(v);
    }
    const bool act = (starts >> lane) & 1u;
    // stage 5: targets by an exclusive scan of the starts' counts
    const uint32_t cnt = act ? count_of(code) : 0u;
    uint32_t incl = cnt;
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int tgt = (int)(s_b[j] + incl - cnt);
    const int mag = (int)mag_of(code);
    const int expand = lin ? mag : mag + ((mag * mag * mag * 3) >> 16);
    const int v = ((code >> 23) & 1u) ? -expand : expand;
    // DeQuantFSM's int16 wrap, then its low 16 bits: the product's
    const int dq = (int)(((uint32_t)v * (uint32_t)q) & 0xFFFFu);
    const bool emitting = act && mag > 0;
    const bool valid = emitting && tgt < nout;
    const bool over = __any_sync(kFull, emitting && tgt >= nout);
    const uint32_t ballot = __ballot_sync(kFull, valid);
    const int rank = __popc(ballot & ((1u << lane) - 1u));
    const int n = __popc(ballot);
    if (valid && rank < kSlots) {
      out_tgt[rank] = tgt;
      out_val[rank] = dq;
    }
    if (lane >= n && lane < kSlots) {
      out_tgt[lane] = 0;
      out_val[lane] = 0;
    }
    if (lane == 0) {
      nval[ck] = n;
      ovf[ck] = over;
    }
  }
}

bool bad_shape(long long rows, long long s, long long max_rows) {
  return rows < 1 || rows > max_rows || s < 1 ||
         (s + kTile - 1) / kTile > 0x7FFFFFFFLL;
}

}  // namespace

// payload: (rows, 4 s) uint8, 4-byte aligned; nchunks: (rows,) int32;
// bounds, leaves: (nlut,) int32, the interval tiling; chunk_f: (rows, s,
// 28) uint8; chunk_c: (rows, s, 28) int16 read as uint16; agg_f: (rows, nt,
// 28) uint8; agg_c: (rows, nt, 28) int32, nt = ceil(s / 64).
extern "C" int cf_band_transfers(const void* payload, const int* nchunks,
                                 const int* bounds, const int* leaves,
                                 void* chunk_f, void* chunk_c, void* agg_f,
                                 int* agg_c, long long rows, long long s,
                                 int nlut, void* stream) {
  if (bad_shape(rows, s, 65535) || nlut < 1 || nlut > kMaxLut) {
    return (int)cudaErrorInvalidValue;
  }
  if ((uintptr_t)payload & 3) return (int)cudaErrorMisalignedAddress;
  const long long nt = (s + kTile - 1) / kTile;
  band_transfers_kernel<<<dim3((unsigned)nt, (unsigned)rows), kBlock, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)payload, nchunks, bounds, leaves, nlut,
      (uint8_t*)chunk_f, (uint16_t*)chunk_c, (uint8_t*)agg_f, agg_c, s, nt);
  return (int)cudaGetLastError();
}

// agg_f, agg_c as cf_band_transfers wrote them; tile_e, tile_b: (rows, nt)
// int32.
extern "C" int cf_band_scan(const void* agg_f, const int* agg_c,
                            const int* nchunks, int* tile_e, int* tile_b,
                            long long rows, long long s, void* stream) {
  if (bad_shape(rows, s, 0x7FFFFFFFLL)) return (int)cudaErrorInvalidValue;
  const long long nt = (s + kTile - 1) / kTile;
  band_scan_kernel<<<(unsigned)rows, kScanWarps * kLanes, 0,
                     (cudaStream_t)stream>>>((const uint8_t*)agg_f, agg_c,
                                             nchunks, tile_e, tile_b, s, nt);
  return (int)cudaGetLastError();
}

// payload, chunk_f, chunk_c, tile_e, tile_b as above; quant, linear:
// (rows,) int32; ctgt, cval: (rows, s, 12) int32; nval: (rows, s) int32;
// ovf: (rows, s) bool; nout: the region size, targets at or past it
// overflow.
extern "C" int cf_band_walk(const void* payload, const void* chunk_f,
                            const void* chunk_c, const int* tile_e,
                            const int* tile_b, const int* nchunks,
                            const int* quant, const int* linear,
                            const int* bounds, const int* leaves, int* ctgt,
                            int* cval, int* nval, void* ovf, long long rows,
                            long long s, int nlut, int nout, void* stream) {
  if (bad_shape(rows, s, 65535) || nlut < 1 || nlut > kMaxLut) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)payload | (uintptr_t)chunk_f | (uintptr_t)chunk_c) & 3) {
    return (int)cudaErrorMisalignedAddress;
  }
  const long long nt = (s + kTile - 1) / kTile;
  band_walk_kernel<<<dim3((unsigned)nt, (unsigned)rows), kBlock, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const uint8_t*)chunk_f,
      (const uint16_t*)chunk_c, tile_e, tile_b, nchunks, quant, linear,
      bounds, leaves, nlut, ctgt, cval, nval, (uint8_t*)ovf, s, nt, nout);
  return (int)cudaGetLastError();
}

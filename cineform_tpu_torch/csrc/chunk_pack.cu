// Within-chunk entropy bit packing for Hopper (sm_90a): one warp a
// 256-element chunk, a prefix sum of the code sizes wherever the packing
// tree would not truncate, and the tree itself on the other chunks.
//
// Replaces the TPU kernel `chunk_pack` (cineform_tpu/ops/pallas_pack.py:135,
// kernel `_pack_kernel` :54).  Equals the plain PyTorch
// `entropy.device.tree_pack(bits, sizes, max_code_bits, cap_bits_per_elem)`
// on words, lengths and overflow flags, bit for bit, on every chunk,
// overflowed chunks included.
//
// The tree.  Level k (0..7) merges node pairs (a, b) into nodes of w[k]
// words (the capacity schedule of the JAX `_schedule`, pallas_pack.py:38,
// computed by the wrapper with `entropy.device.pack_schedule`):
//     out = a | (b >> la),
// b's bit shift a funnel of two neighbouring words, its word offset the
// select tree of the JAX package, whose steps are bounded by the width of
// the level below (`entropy/device.py:286-294`), so that overflowed chunks
// truncate exactly as there.  A node's length is the exact sum of its
// children's, so every node length is a sum of sizes over an aligned group
// of 2^(k+1) elements, and the length and the overflow flag (a checked
// level's length above its capacity) are functions of the sizes alone.
//
// Where the tree is a prefix sum.  Say a chunk fits when every size is in
// [0, 32] and every node of every level fits its words (length <= 32 w[k]).
// Then, level by level: a's bits past la are zero, la <= 32 w of the level
// below so the select tree moves b by all of la, and the merged node fits
// its words; no bit is lost.  The root is the codes laid end to end: word j
// holds bits 32j .. 32j+31 of the concatenation, zeros past the length.  A
// chunk whose flag is clear fits at the main path's schedule (levels 1-4
// have room for 27-bit codes, the others are checked), so only overflowed
// chunks run the tree: rare on real content, common on noise.
//
// What bounds it on this card: device memory.  A chunk reads 2,048 bytes
// and writes 4 w[7] + 5 (389 at the main path's schedule).  A tree whose 8
// dependent levels each end in a block barrier is bound by their latency
// instead, so the tree runs only where it must.
//
// The design.  A block holds kWarps chunks, one warp each, and no block
// barrier.  A lane loads 8 consecutive (bits, size) pairs in 16-byte loads,
// sums its groups of 2, 4 and 8 sizes and, with __shfl_xor_sync, the groups
// of 16 .. 256: the length, the flag and whether the chunk fits.  A chunk
// that fits: a warp scan (__shfl_up_sync) of the lane sums gives each code
// its bit offset, each code (at most 32 bits) is ORed into at most two
// words of the warp's buffer in shared memory, and the warp stores the
// words coalesced.  A chunk that does not fit runs the tree in the warp's
// own shared buffers, node lengths from the prefix sums, with __syncwarp
// between levels, and is counted.  Left shifts are never by 32 (the
// shift-width rule): a code of size z is shifted by 32 - z only for z > 0,
// and a spill word by 32 - sh only for sh > 0.
//
// Entry point: cf_chunk_pack(), plain C, launched on the caller's stream;
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;
constexpr int kLevels = 8;
constexpr int kMaxWords = 512;  // words of one tree level, all nodes
constexpr int kLanes = 32;
constexpr int kPerLane = kChunk / kLanes;  // 8 elements a lane
constexpr int kWarps = 4;                  // chunks a block
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Schedule {
  int w[kLevels];      // words per node after level k
  int cap[kLevels];    // capacity in bits
  int check[kLevels];  // capacity below the worst case: flag overflow
};

struct WarpSmem {
  uint32_t buf[2][kMaxWords];
  int pre[kChunk + 1];  // exclusive prefix sums of the sizes
};

// A node of level k of length `len`: does it fit its words, and does a
// checked level exceed its capacity?
__device__ __forceinline__ void node(int len, int k, const Schedule& s,
                                     bool& fits, bool& ovf) {
  fits = fits && len <= 32 * s.w[k];
  ovf = ovf || (s.check[k] && len > s.cap[k]);
}

// The exact tree over one chunk by one warp, with tree_pack's arithmetic;
// lane l holds elements 8l .. 8l+7.  Leaves the root's words in buf[0].
__device__ void tree_words(const uint32_t (&b)[kPerLane],
                           const int (&sz)[kPerLane], int lane_pre,
                           const Schedule& s, WarpSmem& sm, int lane) {
  int p = lane_pre;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int z = sz[e];
    // left-align; the shift is in [0, 32)
    sm.buf[0][lane * kPerLane + e] =
        (z <= 0 || z > 32) ? 0u : (b[e] << (32 - z));
    sm.pre[lane * kPerLane + e] = p;
    p += z;
  }
  if (lane == kLanes - 1) sm.pre[kChunk] = p;
  __syncwarp();

  int src = 0, w_cur = 1;
  for (int k = 0; k < kLevels; ++k) {
    const int w_new = s.w[k];
    const int m = kChunk >> (k + 1);
    const int g = 1 << k;  // elements of a node of the level below
    // word offsets select only steps <= w_cur (see the note at the top)
    int top = 1;
    while ((top << 1) <= w_cur) top <<= 1;
    const int wmask = (top << 1) - 1;
    const uint32_t* in = sm.buf[src];
    uint32_t* out = sm.buf[src ^ 1];
    for (int idx = lane; idx < m * w_new; idx += kLanes) {
      const int i = idx / w_new, j = idx - i * w_new;
      const int la = sm.pre[(2 * i + 1) * g] - sm.pre[2 * i * g];
      const uint32_t* na = in + (2 * i) * w_cur;
      const uint32_t* nb = in + (2 * i + 1) * w_cur;
      const uint32_t a = j < w_cur ? na[j] : 0u;
      const int bs = la & 31;
      const int jj = j - ((la >> 5) & wmask);
      uint32_t bv = 0u;
      if (jj >= 0) {
        const uint32_t cur = jj < w_cur ? nb[jj] : 0u;
        if (bs == 0) {
          bv = cur;
        } else {
          const uint32_t prev = (jj >= 1 && jj - 1 < w_cur) ? nb[jj - 1] : 0u;
          bv = (cur >> bs) | (prev << (32 - bs));
        }
      }
      out[idx] = a | bv;
    }
    __syncwarp();
    src ^= 1;
    w_cur = w_new;
  }
  // 8 levels: the root is back in buf[0]
}

__global__ void __launch_bounds__(kWarps * kLanes)
chunk_pack_kernel(const uint32_t* __restrict__ bits,
                  const int* __restrict__ sizes, uint32_t* __restrict__ words,
                  int* __restrict__ lens_out, uint8_t* __restrict__ ovf_out,
                  int* __restrict__ tree_chunks, long long nchunks,
                  Schedule s) {
  __shared__ WarpSmem smem[kWarps];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const long long chunk = (long long)blockIdx.x * kWarps + warp;
  if (chunk >= nchunks) return;  // a whole warp; no block barrier follows
  WarpSmem& sm = smem[warp];

  uint32_t b[kPerLane];
  int sz[kPerLane];
  {
    const size_t e0 = (size_t)chunk * kChunk + lane * kPerLane;
    const uint4* bp = reinterpret_cast<const uint4*>(bits + e0);
    const int4* sp = reinterpret_cast<const int4*>(sizes + e0);
    const uint4 b0 = bp[0], b1 = bp[1];
    const int4 s0 = sp[0], s1 = sp[1];
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
    sz[0] = s0.x; sz[1] = s0.y; sz[2] = s0.z; sz[3] = s0.w;
    sz[4] = s1.x; sz[5] = s1.y; sz[6] = s1.z; sz[7] = s1.w;
  }

  // node lengths, level by level: pairs, quads and the lane's eight here,
  // groups of 2 .. 32 lanes by butterfly sums
  bool fits = true, ovf = false;
  int quad[2];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) fits = fits && sz[e] >= 0 && sz[e] <= 32;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p0 = sz[4 * q] + sz[4 * q + 1];
    const int p1 = sz[4 * q + 2] + sz[4 * q + 3];
    node(p0, 0, s, fits, ovf);
    node(p1, 0, s, fits, ovf);
    quad[q] = p0 + p1;
    node(quad[q], 1, s, fits, ovf);
  }
  const int lane_sum = quad[0] + quad[1];
  node(lane_sum, 2, s, fits, ovf);
  int t = lane_sum;
#pragma unroll
  for (int k = 3; k < kLevels; ++k) {
    t += __shfl_xor_sync(kFull, t, 1 << (k - 3));
    node(t, k, s, fits, ovf);
  }
  const int total = t;
  fits = __all_sync(kFull, fits);
  ovf = __any_sync(kFull, ovf);

  // the lane's first bit: an exclusive warp scan of the lane sums
  int incl = lane_sum;
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int lane_pre = incl - lane_sum;

  const int w_out = s.w[kLevels - 1];
  if (fits) {
    for (int j = lane; j < w_out; j += kLanes) sm.buf[0][j] = 0u;
    __syncwarp();
    int off = lane_pre;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int z = sz[e];
      if (z > 0) {
        // the chunk fits, so off + z <= 32 w_out: both words are in range
        const uint32_t c = b[e] << (32 - z);
        const int wi = off >> 5, sh = off & 31;
        atomicOr(&sm.buf[0][wi], c >> sh);
        if (sh != 0) {
          const uint32_t spill = c << (32 - sh);
          if (spill) atomicOr(&sm.buf[0][wi + 1], spill);
        }
      }
      off += z;
    }
  } else {
    tree_words(b, sz, lane_pre, s, sm, lane);
    if (lane == 0) atomicAdd(tree_chunks, 1);
  }
  __syncwarp();

  uint32_t* dst = words + (size_t)chunk * w_out;
  for (int j = lane; j < w_out; j += kLanes) dst[j] = sm.buf[0][j];
  if (lane == 0) {
    lens_out[chunk] = total;
    ovf_out[chunk] = (uint8_t)ovf;
  }
}

}  // namespace

// bits, sizes: (nchunks, 256) int32, 16-byte aligned; words: (nchunks, w of
// the last level) int32 read and written as uint32; lens: (nchunks,) int32;
// ovf: (nchunks,) bool; tree_chunks: one int32 to which the number of
// chunks that ran the tree is added.  schedule: host array of
// 3 x 8 ints, per tree level its words per node, capacity in bits and
// whether the capacity is checked.
extern "C" int cf_chunk_pack(const void* bits, const int* sizes, void* words,
                             int* lens, void* ovf, int* tree_chunks,
                             long long nchunks, const int* schedule,
                             void* stream) {
  if (nchunks < 1 || (nchunks + kWarps - 1) / kWarps > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)bits | (uintptr_t)sizes) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  Schedule s;
  int w_prev = 1;
  for (int k = 0; k < kLevels; ++k) {
    s.w[k] = schedule[3 * k];
    s.cap[k] = schedule[3 * k + 1];
    s.check[k] = schedule[3 * k + 2];
    // buffers never shrink, and one level's nodes fit in shared memory
    if (s.w[k] < w_prev || (kChunk >> (k + 1)) * s.w[k] > kMaxWords) {
      return (int)cudaErrorInvalidValue;
    }
    w_prev = s.w[k];
  }
  const unsigned blocks = (unsigned)((nchunks + kWarps - 1) / kWarps);
  chunk_pack_kernel<<<blocks, kWarps * kLanes, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, sizes, (uint32_t*)words, lens, (uint8_t*)ovf,
      tree_chunks, nchunks, s);
  return (int)cudaGetLastError();
}

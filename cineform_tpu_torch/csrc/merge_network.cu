// Across-chunk compaction of the entropy encoder for Hopper (sm_90a): the
// low-bit-first monotone-displacement merge network, settled.
//
// Replaces the TPU kernel `local_merge` (cineform_tpu/ops/pallas_merge.py:88,
// kernel `_merge_kernel` :66) as driven by `merge_network(..., lowfirst=True)`
// (:141), i.e. the encoder's `_settle_network`
// (cineform_tpu/entropy/device.py:382).  Equals the plain PyTorch
// `entropy.device._settle_network(val, rem)` on (val, rem) both, bit for bit,
// on every input.
//
// The network: for k = 0, 1, ... while 2^k <= n, every slot whose
// displacement has bit k set moves 2^k to the left (falling off at 0), and
// a slot that stays is merged with the one that arrives: values by OR,
// displacements by max.  On a band's inputs the displacements are
// nondecreasing with steps in {0, 1}, and then the settled network equals a
// direct OR-scatter of slot u into u - rem[u].  A band with an overflowed
// chunk breaks that order (its lengths exceed its words), and there the
// network's merges differ from a scatter.  Such bands are re-encoded on the
// host, but the kernel still has to give the network's words, so it runs
// the network itself rather than the scatter.
//
// What bounds it on this card: device memory.  Each level reads and writes
// the (value, displacement) pair of every slot, 16 bytes, and there are
// log2(n) + 1 levels (18 at the 1080p level-1 band length).
//
// What the design does about it: the low levels move slots by less than a
// tile, so one pass does ten of them in shared memory: a block loads its
// tile of kTile slots plus the kHalo = 2^10 - 1 slots to its right, runs
// levels 0..9 there (each level's stale right edge grows by 2^k, and the
// halo absorbs all of them), and writes its tile.  The remaining levels
// (moves of 1024 slots and more, 8 at 1080p) are one elementwise pass each.
// That is 9 passes instead of 18; the levels' dependence on a neighbour
// 2^k away keeps the high levels out of one block.
//
// Entry point: cf_merge_network(), plain C, launched on the caller's
// stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLocalLevels = 10;
constexpr int kHalo = (1 << kLocalLevels) - 1;
constexpr int kTile = 2048;
constexpr int kSpan = kTile + kHalo;
constexpr int kPer = (kSpan + kThreads - 1) / kThreads;

// One level at one slot: (v0, r0) stays unless bit k of r0 is set; (v1, r1),
// the slot 2^k to the right, arrives if bit k of r1 is set.
__device__ __forceinline__ void level_step(uint32_t v0, int r0, uint32_t v1,
                                           int r1, int k, int s, uint32_t& v,
                                           int& r) {
  const bool stay = ((r0 >> k) & 1) == 0;
  const bool come = ((r1 >> k) & 1) == 1;
  v = (stay ? v0 : 0u) | (come ? v1 : 0u);
  r = max(stay ? r0 : 0, come ? r1 - s : 0);
}

// Levels 0 .. levels-1 (levels <= kLocalLevels) of one tile of one row.
__global__ void __launch_bounds__(kThreads)
local_levels_kernel(const uint32_t* __restrict__ val,
                    const int* __restrict__ rem, uint32_t* __restrict__ oval,
                    int* __restrict__ orem, int n, int levels) {
  __shared__ uint32_t sv[kSpan];
  __shared__ int sr[kSpan];
  const size_t base = (size_t)blockIdx.y * n;
  const int t0 = blockIdx.x * kTile;
  for (int j = threadIdx.x; j < kSpan; j += kThreads) {
    const int i = t0 + j;
    // slots beyond the row are the network's zero fill
    sv[j] = i < n ? val[base + i] : 0u;
    sr[j] = i < n ? rem[base + i] : 0;
  }
  __syncthreads();
  for (int k = 0; k < levels; ++k) {
    const int s = 1 << k;
    uint32_t nv[kPer];
    int nr[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int j = threadIdx.x + e * kThreads;
      const bool in = j + s < kSpan;  // beyond: stale, never reaches the tile
      if (j < kSpan) {
        level_step(sv[j], sr[j], in ? sv[j + s] : 0u, in ? sr[j + s] : 0, k,
                   s, nv[e], nr[e]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int j = threadIdx.x + e * kThreads;
      if (j < kSpan) {
        sv[j] = nv[e];
        sr[j] = nr[e];
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int i = t0 + j;
    if (i < n) {
      oval[base + i] = sv[j];
      orem[base + i] = sr[j];
    }
  }
}

// Level k of every row, one slot per thread.
__global__ void __launch_bounds__(kThreads)
global_level_kernel(const uint32_t* __restrict__ val,
                    const int* __restrict__ rem, uint32_t* __restrict__ oval,
                    int* __restrict__ orem, long long total, int n, int k) {
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u >= total) return;
  const int s = 1 << k;
  const int i = (int)(u % n);
  const bool in = i + s < n;
  level_step(val[u], rem[u], in ? val[u + s] : 0u, in ? rem[u + s] : 0, k, s,
             oval[u], orem[u]);
}

}  // namespace

// val, out_val, tmp_val: (rows, n) int32 read and written as uint32; rem,
// out_rem, tmp_rem: (rows, n) int32.  tmp_* is scratch of the same size.
extern "C" int cf_merge_network(const void* val, const int* rem,
                                void* out_val, int* out_rem, void* tmp_val,
                                int* tmp_rem, long long rows, int n,
                                void* stream) {
  if (rows < 1 || rows > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  const long long total = rows * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;

  int levels = 0;  // k = 0 .. levels-1 while 2^k <= n
  while (levels < 31 && (1LL << levels) <= n) ++levels;
  const int local = levels < kLocalLevels ? levels : kLocalLevels;
  const int global = levels - local;
  // ping-pong so that the last pass writes the outputs
  uint32_t* dv[2] = {(uint32_t*)out_val, (uint32_t*)tmp_val};
  int* dr[2] = {out_rem, tmp_rem};
  int cur = global % 2;

  dim3 grid((n + kTile - 1) / kTile, (unsigned)rows);
  local_levels_kernel<<<grid, kThreads, 0, st>>>(
      (const uint32_t*)val, rem, dv[cur], dr[cur], n, local);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int k = local; k < levels; ++k) {
    global_level_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        dv[cur], dr[cur], dv[cur ^ 1], dr[cur ^ 1], total, n, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur ^= 1;
  }
  return (int)cudaSuccess;
}

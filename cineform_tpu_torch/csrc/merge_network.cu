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
// A level k: every slot whose displacement has bit k set moves 2^k to the
// left (falling off at 0), and a slot that stays is merged with the one that
// arrives: values by OR, displacements (and targets) by max.  Low-bit-first
// runs k = 0, 1, ... while 2^k <= n; high-bit-first runs k = L-1 down to 0
// with L = max(1, bit_length(n - 1)), as the Pallas kernel's caller does.
// On a band's inputs the low-bit-first displacements are nondecreasing with
// steps in {0, 1}, and the high-bit-first ones (the decoder's, mirrored)
// move strictly ordered slots that never collide; but a band with an
// overflowed chunk breaks that order, and the kernels still have to give the
// network's words, so they run the network itself rather than a scatter.
//
// What bounds it on this card: device memory.  Each level reads and writes
// the 8 or 12 bytes of every slot, and there are about log2(n) levels (20 for
// the decoder's 1080p slot rows of 786,432 and 1,304,840 slots).
//
// What the design does about it: the levels that move slots by less than
// 2^10 run in one pass in shared memory: a block loads its tile of kTile
// slots plus the kHalo = 2^10 - 1 slots to its right (a level pulls from
// j + 2^k, so the stale right edge grows by 2^k per level and the halo
// absorbs all of them, in either order of the levels), runs those levels
// there, and writes its tile.  Each level above is one elementwise pass.
// Low-bit-first runs the shared-memory pass first; high-bit-first runs its
// global levels first and the shared-memory pass over levels 9..0 last.
// With three arrays the tile and halo take 3 * 3071 * 4 = 36,852 bytes of
// static shared memory; with two, 24,568.
//
// Entry points, plain C, launched on the caller's stream, each returning
// cudaGetLastError(): cf_merge_network (low-bit-first), cf_merge_network_tgt
// (low-bit-first, three arrays), cf_merge_network_highfirst.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLocalLevels = 10;
constexpr int kHalo = (1 << kLocalLevels) - 1;
constexpr int kTile = 2048;
constexpr int kSpan = kTile + kHalo;
constexpr int kPer = (kSpan + kThreads - 1) / kThreads;

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

// Levels 0 .. levels-1 (levels <= kLocalLevels) of one tile of one row, in
// ascending order, or descending when `desc`.
template <bool kTgt>
__global__ void __launch_bounds__(kThreads)
local_levels_kernel(const uint32_t* __restrict__ val,
                    const int* __restrict__ rem, const int* __restrict__ tgt,
                    uint32_t* __restrict__ oval, int* __restrict__ orem,
                    int* __restrict__ otgt, int n, int levels, int desc) {
  __shared__ uint32_t sv[kSpan];
  __shared__ int sr[kSpan];
  __shared__ int st[kTgt ? kSpan : 1];
  const size_t base = (size_t)blockIdx.y * n;
  const int t0 = blockIdx.x * kTile;
  for (int j = threadIdx.x; j < kSpan; j += kThreads) {
    const int i = t0 + j;
    // slots beyond the row are the network's zero fill
    sv[j] = i < n ? val[base + i] : 0u;
    sr[j] = i < n ? rem[base + i] : 0;
    if (kTgt) st[j] = i < n ? tgt[base + i] : 0;
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
        level_step<kTgt>(sv[j], sr[j], kTgt ? st[j] : 0, in ? sv[j + s] : 0u,
                         in ? sr[j + s] : 0, (kTgt && in) ? st[j + s] : 0, k,
                         s, nv[e], nr[e], nt[e]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int j = threadIdx.x + e * kThreads;
      if (j < kSpan) {
        sv[j] = nv[e];
        sr[j] = nr[e];
        if (kTgt) st[j] = nt[e];
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int i = t0 + j;
    if (i < n) {
      oval[base + i] = sv[j];
      orem[base + i] = sr[j];
      if (kTgt) otgt[base + i] = st[j];
    }
  }
}

// Level k of every row, one slot per thread.
template <bool kTgt>
__global__ void __launch_bounds__(kThreads)
global_level_kernel(const uint32_t* __restrict__ val,
                    const int* __restrict__ rem, const int* __restrict__ tgt,
                    uint32_t* __restrict__ oval, int* __restrict__ orem,
                    int* __restrict__ otgt, long long total, int n, int k) {
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u >= total) return;
  const int s = 1 << k;
  const int i = (int)(u % n);
  const bool in = (long long)i + s < n;
  int t = 0;
  level_step<kTgt>(val[u], rem[u], kTgt ? tgt[u] : 0, in ? val[u + s] : 0u,
                   in ? rem[u + s] : 0, (kTgt && in) ? tgt[u + s] : 0, k, s,
                   oval[u], orem[u], t);
  if (kTgt) otgt[u] = t;
}

// The arrays of one network: val as uint32, rem and (when kTgt) tgt.
struct Slots {
  uint32_t* v;
  int* r;
  int* t;
};

// Runs the settled network from `in` into `out`, with `tmp` as scratch of
// the same size.  The input is only read.
template <bool kTgt>
int run_network(Slots in, Slots out, Slots tmp, long long rows, int n,
                bool highfirst, cudaStream_t st) {
  if (rows < 1 || rows > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  const long long total = rows * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;

  int levels = 0;
  if (highfirst) {  // bit_length(n - 1), at least 1
    while (levels < 31 && (1LL << levels) <= (long long)n - 1) ++levels;
    if (levels < 1) levels = 1;
  } else {  // k = 0 .. levels-1 while 2^k <= n
    while (levels < 31 && (1LL << levels) <= n) ++levels;
  }
  const int local = levels < kLocalLevels ? levels : kLocalLevels;
  const int global = levels - local;
  Slots buf[2] = {out, tmp};
  const dim3 grid((n + kTile - 1) / kTile, (unsigned)rows);
  cudaError_t err;

  if (!highfirst) {
    // local levels, then the global ones; ping-pong so that the last pass
    // writes `out`
    int cur = global % 2;
    local_levels_kernel<kTgt><<<grid, kThreads, 0, st>>>(
        in.v, in.r, in.t, buf[cur].v, buf[cur].r, buf[cur].t, n, local, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int k = local; k < levels; ++k) {
      const Slots a = buf[cur], b = buf[cur ^ 1];
      global_level_kernel<kTgt><<<(unsigned)blocks, kThreads, 0, st>>>(
          a.v, a.r, a.t, b.v, b.r, b.t, total, n, k);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      cur ^= 1;
    }
    return (int)cudaSuccess;
  }

  // high-bit-first: global levels L-1 .. local, the last of them into
  // `tmp`, then the local levels local-1 .. 0 from there into `out`
  Slots src = in;
  for (int i = 0; i < global; ++i) {
    const Slots dst = buf[(global - i) % 2];
    global_level_kernel<kTgt><<<(unsigned)blocks, kThreads, 0, st>>>(
        src.v, src.r, src.t, dst.v, dst.r, dst.t, total, n, levels - 1 - i);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    src = dst;
  }
  local_levels_kernel<kTgt><<<grid, kThreads, 0, st>>>(
      src.v, src.r, src.t, out.v, out.r, out.t, n, local, 1);
  return (int)cudaGetLastError();
}

Slots slots(const void* v, const int* r, const int* t) {
  return Slots{(uint32_t*)v, (int*)r, (int*)t};
}

}  // namespace

// val, out_val, tmp_val: (rows, n) int32 read and written as uint32; rem,
// out_rem, tmp_rem (and tgt, out_tgt, tmp_tgt): (rows, n) int32.  tmp_* is
// scratch of the same size.
extern "C" int cf_merge_network(const void* val, const int* rem,
                                void* out_val, int* out_rem, void* tmp_val,
                                int* tmp_rem, long long rows, int n,
                                void* stream) {
  return run_network<false>(slots(val, rem, nullptr),
                            slots(out_val, out_rem, nullptr),
                            slots(tmp_val, tmp_rem, nullptr), rows, n, false,
                            (cudaStream_t)stream);
}

extern "C" int cf_merge_network_tgt(const void* val, const int* rem,
                                    const int* tgt, void* out_val,
                                    int* out_rem, int* out_tgt, void* tmp_val,
                                    int* tmp_rem, int* tmp_tgt,
                                    long long rows, int n, void* stream) {
  return run_network<true>(slots(val, rem, tgt),
                           slots(out_val, out_rem, out_tgt),
                           slots(tmp_val, tmp_rem, tmp_tgt), rows, n, false,
                           (cudaStream_t)stream);
}

extern "C" int cf_merge_network_highfirst(const void* val, const int* rem,
                                          void* out_val, int* out_rem,
                                          void* tmp_val, int* tmp_rem,
                                          long long rows, int n,
                                          void* stream) {
  return run_network<false>(slots(val, rem, nullptr),
                            slots(out_val, out_rem, nullptr),
                            slots(tmp_val, tmp_rem, nullptr), rows, n, true,
                            (cudaStream_t)stream);
}

// Within-chunk entropy bit packing for Hopper (sm_90a): an 8-level log
// tree over 256 (codeword, size) pairs per chunk.
//
// Replaces the TPU kernel `chunk_pack` (cineform_tpu/ops/pallas_pack.py:135,
// kernel `_pack_kernel` :54).  Equals the plain PyTorch
// `entropy.device.tree_pack(bits, sizes, max_code_bits, cap_bits_per_elem)`
// on words, lengths and overflow flags, bit for bit, on every chunk,
// overflowed chunks included.
//
// What bounds it on this card: per level, a block-wide barrier and a
// shared-memory pass over at most a few hundred words; device memory sees
// one read of (bits, sizes) and one write of the packed words per chunk.
// The tree's 8 dependent levels, not bandwidth, set its time.
//
// What the design does about it: one 256-thread block per chunk runs the
// whole tree in shared memory (two ping-pong buffers of <= 512 words), so
// no level touches device memory.  At each level every thread computes
// output words of the merged nodes independently:
//     out[j] = a[j] | (b >> la)[j]
// where b's bit shift is a funnel of two neighbouring words and its word
// offset is the select tree of the JAX package, whose steps are bounded by
// the current width (`entropy/device.py:360-363`), so overflowed chunks
// truncate exactly as there.  The capacity schedule is the JAX
// `_schedule` (`pallas_pack.py:38`), computed once, by the wrapper
// (`entropy.device.pack_schedule`).  The TPU kernel's bit-reversed element
// order and lane transposes are layout for its vector unit and are not
// needed here.
//
// Entry point: cf_chunk_pack(), plain C, launched on the caller's stream;
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;
constexpr int kLevels = 8;
constexpr int kMaxWords = 512;  // words of one tree level, all nodes

struct Schedule {
  int w[kLevels];      // words per node after level k
  int cap[kLevels];    // capacity in bits
  int check[kLevels];  // capacity below the worst case: flag overflow
};

__global__ void __launch_bounds__(kChunk)
chunk_pack_kernel(const uint32_t* __restrict__ bits,
                  const int* __restrict__ sizes, uint32_t* __restrict__ words,
                  int* __restrict__ lens_out, uint8_t* __restrict__ ovf_out,
                  Schedule s) {
  __shared__ uint32_t buf[2][kMaxWords];
  __shared__ int lens[2][kChunk];
  __shared__ int ovf;

  const size_t chunk = blockIdx.x;
  const int tid = threadIdx.x;
  {
    const uint32_t b = bits[chunk * kChunk + tid];
    const int sz = sizes[chunk * kChunk + tid];
    // left-align; sizes are in [0, 27], so the shift is in [5, 32)
    buf[0][tid] = (sz <= 0 || sz > 32) ? 0u : (b << (32 - sz));
    lens[0][tid] = sz;
  }
  if (tid == 0) ovf = 0;
  __syncthreads();

  int src = 0, w_cur = 1, n = kChunk;
  for (int k = 0; k < kLevels; ++k) {
    const int w_new = s.w[k];
    const int m = n >> 1;
    // word offsets select only steps <= w_cur (see header)
    int top = 1;
    while ((top << 1) <= w_cur) top <<= 1;
    const int wmask = (top << 1) - 1;
    const uint32_t* in = buf[src];
    uint32_t* out = buf[src ^ 1];
    for (int idx = tid; idx < m * w_new; idx += kChunk) {
      const int i = idx / w_new, j = idx - i * w_new;
      const int la = lens[src][2 * i];
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
    for (int i = tid; i < m; i += kChunk) {
      const int l = lens[src][2 * i] + lens[src][2 * i + 1];
      lens[src ^ 1][i] = l;
      if (s.check[k] && l > s.cap[k]) ovf = 1;
    }
    __syncthreads();
    src ^= 1;
    w_cur = w_new;
    n = m;
  }

  for (int j = tid; j < w_cur; j += kChunk) {
    words[chunk * w_cur + j] = buf[src][j];
  }
  if (tid == 0) {
    lens_out[chunk] = lens[src][0];
    ovf_out[chunk] = (uint8_t)ovf;
  }
}

}  // namespace

// bits, sizes: (nchunks, 256) int32; words: (nchunks, w of the last level)
// int32 read and written as uint32; lens: (nchunks,) int32; ovf: (nchunks,)
// bool.  schedule: host array of 3 x 8 ints, per tree level its words per
// node, capacity in bits and whether the capacity is checked.
extern "C" int cf_chunk_pack(const void* bits, const int* sizes, void* words,
                             int* lens, void* ovf, long long nchunks,
                             const int* schedule, void* stream) {
  if (nchunks < 1 || nchunks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
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
  chunk_pack_kernel<<<(unsigned)nchunks, kChunk, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, sizes, (uint32_t*)words, lens, (uint8_t*)ovf, s);
  return (int)cudaGetLastError();
}

// One forward level of the CFHD production 2D 2-6 wavelet with dead-zone
// quantization, for Hopper (sm_90a).
//
// Replaces the TPU kernels `dwt2d_forward_pallas2`
// (cineform_tpu/ops/pallas_dwt2.py:99, kernel `_make_kernel` :37) and
// `dwt2d_forward_pallas` (cineform_tpu/ops/pallas_dwt.py:151, kernel :83).
// Both compute the same function; it equals the plain PyTorch
// `ops.intra_transform.dwt2d_forward(x, prescale, quant)`, bit for bit.
//
// What bounds it on this card: device memory.  A level reads one int32
// plane and writes four quarter-size int32 planes (2 bytes moved per input
// byte) and does ~60 integer operations per output quad, far below the
// card's integer rate.
//
// What the design does about it: one thread per output column, walking a
// tile of kRows output rows.  The horizontal 2-6 results of the six input
// rows a vertical tap needs live in a sliding window of registers, so each
// input row's horizontal filter is computed once per tile (plus a halo of
// four rows), and no intermediate plane is written to device memory.
// Reads of neighbouring threads overlap and are served by L1; writes are
// coalesced.  The image-border formulas of the vertical filter are
// selected by the true row index (no padding), as is the reference's
// width <= 16 narrow-row quirk of the horizontal filter, which the Pallas
// kernels did not need and the small goldens reach.
//
// Entry point: cf_dwt_forward_level(), plain C, launched on the caller's
// stream; returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // output columns per block
constexpr int kRows = 16;      // output rows per thread

struct LoHi {
  int lo, hi;
};

struct Quant {
  int q[3], mult[3], mid[3];
};

__device__ __forceinline__ int sat16(int v) {
  return min(max(v, -32768), 32767);
}

// Production quantizer (Codec/quantize.c:1256); |v| <= 32768 after sat16,
// so ((|v| + mid) & 0xFFFF) * mult stays below 2^31.
__device__ __forceinline__ int quantize(int v, const Quant& qt, int band) {
  if (qt.q[band] <= 1) return v;
  int mag = (((abs(v) + qt.mid[band]) & 0xFFFF) * qt.mult[band]) >> 16;
  return v > 0 ? mag : (v < 0 ? -mag : 0);
}

// Horizontal 2-6 of input row y at output column c: (low, high), saturated.
__device__ __forceinline__ LoHi hrow(const int* __restrict__ plane, int y,
                                     int c, int w, int wo, int ps, int pr) {
  const int* row = plane + (size_t)y * w;
  auto pe = [&](int j) { return (row[2 * j] + pr) >> ps; };
  auto po = [&](int j) { return (row[2 * j + 1] + pr) >> ps; };
  int lo = (row[2 * c] + row[2 * c + 1] + pr) >> ps;
  int hi;
  if (c == 0) {
    if (w <= 16) {
      // narrow-row quirk: center filter at column 0, reading the previous
      // row's last two prescaled pixels when the width is a multiple of 8
      int prev = 0;
      if (w % 8 == 0 && y > 0) {
        prev = ((row[-2] + pr) >> ps) + ((row[-1] + pr) >> ps);
      }
      hi = ((-prev + pe(1) + po(1) + 4) >> 3) + (pe(0) - po(0));
    } else {
      hi = (5 * pe(0) - 11 * po(0) + 4 * pe(1) + 4 * po(1) - pe(2) - po(2) +
            4) >> 3;
    }
  } else if (c == wo - 1) {
    int k = wo - 1;
    hi = (11 * pe(k) - 5 * po(k) - 4 * po(k - 1) - 4 * pe(k - 1) +
          po(k - 2) + pe(k - 2) + 4) >> 3;
  } else {
    hi = ((-(pe(c - 1) + po(c - 1)) + (pe(c + 1) + po(c + 1)) + 4) >> 3) +
         (pe(c) - po(c));
  }
  return {sat16(lo), sat16(hi)};
}

__global__ void __launch_bounds__(kThreads)
dwt_forward_kernel(const int* __restrict__ x, int* __restrict__ ll,
                   int* __restrict__ lh, int* __restrict__ hl,
                   int* __restrict__ hh, int h, int w, int ps, Quant qt) {
  const int wo = w >> 1, ho = h >> 1;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= wo) return;
  const int r0 = blockIdx.y * kRows;
  const int r1 = min(r0 + kRows, ho);
  const int* plane = x + (size_t)blockIdx.z * h * w;
  const size_t obase = (size_t)blockIdx.z * ho * wo;
  const int pr = (1 << ps) - 1;

  // win[j] holds input row 2r - 2 + j (zeros outside the image: those
  // entries feed only the border formulas' unused taps)
  LoHi win[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    int y = 2 * r0 - 2 + j;
    win[j] = (y >= 0 && y < h) ? hrow(plane, y, c, w, wo, ps, pr) : LoHi{0, 0};
  }
  for (int r = r0; r < r1; ++r) {
    if (r > r0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) win[j] = win[j + 2];
#pragma unroll
      for (int j = 4; j < 6; ++j) {
        int y = 2 * r - 2 + j;
        win[j] = (y < h) ? hrow(plane, y, c, w, wo, ps, pr) : LoHi{0, 0};
      }
    }
    int low_l = win[2].lo + win[3].lo;  // LL
    int low_h = win[2].hi + win[3].hi;  // LH
    int high_l, high_h;                 // HL, HH
    if (r == 0) {
      // first row: raw rows 0..5 (Codec/spatial.c:14266)
      LoHi x4 = hrow(plane, 4, c, w, wo, ps, pr);
      LoHi x5 = hrow(plane, 5, c, w, wo, ps, pr);
      high_l = (5 * win[2].lo - 11 * win[3].lo + 4 * win[4].lo +
                4 * win[5].lo - x4.lo - x5.lo + 4) >> 3;
      high_h = (5 * win[2].hi - 11 * win[3].hi + 4 * win[4].hi +
                4 * win[5].hi - x4.hi - x5.hi + 4) >> 3;
    } else if (r == ho - 1) {
      // last row: raw rows h-6..h-1 (Codec/spatial.c:9968)
      LoHi x6 = hrow(plane, 2 * r - 4, c, w, wo, ps, pr);
      LoHi x5 = hrow(plane, 2 * r - 3, c, w, wo, ps, pr);
      high_l = (11 * win[2].lo - 5 * win[3].lo - 4 * win[1].lo -
                4 * win[0].lo + x5.lo + x6.lo + 4) >> 3;
      high_h = (11 * win[2].hi - 5 * win[3].hi - 4 * win[1].hi -
                4 * win[0].hi + x5.hi + x6.hi + 4) >> 3;
    } else {
      high_l = ((-(win[0].lo + win[1].lo) + (win[4].lo + win[5].lo) + 4) >> 3) +
               (win[2].lo - win[3].lo);
      high_h = ((-(win[0].hi + win[1].hi) + (win[4].hi + win[5].hi) + 4) >> 3) +
               (win[2].hi - win[3].hi);
    }
    const size_t o = obase + (size_t)r * wo + c;
    ll[o] = sat16(low_l);
    lh[o] = quantize(sat16(low_h), qt, 0);
    hl[o] = quantize(sat16(high_l), qt, 1);
    hh[o] = quantize(sat16(high_h), qt, 2);
  }
}

}  // namespace

extern "C" int cf_dwt_forward_level(const int* x, int* ll, int* lh, int* hl,
                                    int* hh, int batch, int h, int w,
                                    int prescale, int q0, int q1, int q2,
                                    void* stream) {
  if (batch < 1 || batch > 65535 || h < 6 || w < 6 || (h & 1) || (w & 1) ||
      prescale < 0 || prescale > 8) {
    return (int)cudaErrorInvalidValue;
  }
  Quant qt;
  const int qs[3] = {q0, q1, q2};
  for (int b = 0; b < 3; ++b) {
    qt.q[b] = qs[b];
    qt.mult[b] = qs[b] > 1 ? (1 << 16) / qs[b] : 0;
    int mid = qs[b] > 1 ? qs[b] / 2 : 0;
    qt.mid[b] = mid ? mid - 1 : 0;
  }
  const int wo = w / 2, ho = h / 2;
  dim3 grid((wo + kThreads - 1) / kThreads, (ho + kRows - 1) / kRows, batch);
  dwt_forward_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, ll, lh, hl, hh, h, w, prescale, qt);
  return (int)cudaGetLastError();
}

// Forward DWT of the CFHD intra encode for Hopper (sm_90a): the production
// 2D 2-6 wavelet with prescale rounding, int16 saturation and dead-zone
// quantization of LH, HL and HH.
//
// Replaces the TPU kernels `dwt2d_forward_pallas2`
// (cineform_tpu/ops/pallas_dwt2.py:99, kernel `_make_kernel` :37) and
// `dwt2d_forward_pallas` (cineform_tpu/ops/pallas_dwt.py:151, kernel :83),
// which compute one level of one int32 plane, and at level 1 of the YUY2
// encode also the unpack in front of them (`unpack_yuy2`).  Each entry
// point equals its plain PyTorch version in `ops/dwt_forward.py` bit for
// bit.
//
// What bounds it on this card: device memory bytes.  YUY2 level 1 reads a
// byte per pixel and writes 16 bytes per output quad; the int32 levels
// (YUY2 levels 2 and 3, every level of RGB 4:4:4 and RGBA 4:4:4:4) read
// and write an int32 per pixel; the ~40 integer operations per input
// pixel stay far below the card's integer rate.  At a batch of 8 1080p
// RG48 frames the three levels must move 522,547,200 bytes, 0.156 ms at
// the H100 SXM's published 3.35 TB/s (700 W).
//
// What the design does about it:
// - Level 1 reads the YUY2 bytes.  One block takes a tile of 128 luma and
//   64 chroma output columns: the bytes of its input rows hold all three
//   channels, so each byte is read from device memory once, and the
//   channels are separated, shifted to the codec's precision and
//   prescaled as the filter reads them.  No int32 plane is built.
// - One launch per level for all the channels: Y, V, U, or the 3 or 4
//   full-width planes of RGB and RGBA.  The planes' pointers, widths, band
//   layout and quantizers go by value in one struct; on the int32 path
//   the grid is (channel, frame, tile) flattened, with the tile's height
//   chosen so that the smallest level still gives every SM several
//   blocks.
// - Staged 16-byte loads.  A block copies the input rows its tile needs
//   (its output rows' six-row taps) into shared memory with cp.async, 16
//   bytes a copy where the row is 16-byte aligned and 4 bytes otherwise
//   (a ragged end, a row pitch that is not a multiple of 16 bytes), zero
//   outside the row, then computes from shared memory only.
// - Each input row's horizontal 2-6 is computed once per tile into an
//   eight-row window of registers (rows 2r-4 .. 2r+3 for output row r).
//   The vertical filter reads that window, the border formulas too (the
//   first row's raw rows 0..5 at r = 1, the last row's h-6..h-1 at
//   r = ho-1), so no row is recomputed and no intermediate is written.
// - The bands are written once, where the entropy coder reads them:
//   (frame, channel of the group, band, row, pitch), the pad columns
//   wo..pitch-1 zeroed by the kernel.
// The reference's width <= 16 narrow-row quirk (column 0 takes the centre
// filter, reading the previous row's last two prescaled pixels when the
// width is a multiple of 8) reads that row from device memory: only
// planes of at most 16 pixels reach it.
//
// Entry points (plain C, launched on the caller's stream, returning
// cudaGetLastError()): cf_dwt_forward_yuy2 (level 1 from YUY2 frames),
// cf_dwt_forward_groups (one more level of Y, V, U held in their channel
// groups' buffers), cf_dwt_forward_planes (one level of a group of up to
// four equal int32 planes: RGB, RGBA), cf_dwt_forward_level (one level of
// one int32 plane).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;                  // output columns of a plane a tile
constexpr int kMaxPlanes = 4;               // planes a launch
constexpr int kMaxRows = 16;                // output rows a tile, at most
constexpr int kIntThreads = kCols;          // levels 2-3: one plane a block
constexpr int kYuy2Threads = 2 * kCols;     // level 1: Y, then V, then U
// staged bytes of an input row: int32 columns 2c0-4 .. 2c0+2kCols+4, and
// YUY2 bytes 4c0-16 .. 4c0+4kCols+16 (both multiples of 16)
constexpr int kIntRowBytes = (2 * kCols + 8) * 4;
constexpr int kYuy2RowBytes = 4 * kCols + 32;

struct Plane {
  const void* src;            // int32 plane, or the YUY2 frames (level 1)
  long long src_bstride;      // elements (YUY2: bytes) between frames
  int* ll;
  long long ll_bstride;
  int* bands;                 // LH; HL at +band_stride, HH at +2*band_stride
  long long bands_bstride;
  long long band_stride;
  int pitch;                  // band row pitch; columns wo..pitch-1 get 0
  int w;                      // input width in pixels
  int tiles_x;
  int first_block;
  int q[3], mult[3], mid[3];
};

struct Level {
  Plane p[kMaxPlanes];
  int nplanes;
  int h;                      // input height of every plane
  int ps;                     // prescale shift
  int shift;                  // level 1: the bytes' << (precision - 8)
  int rows;                   // output rows a tile
  int tiles_y;
};

struct LoHi {
  int lo, hi;
};

__device__ __forceinline__ int sat16(int v) {
  return min(max(v, -32768), 32767);
}

// Production quantizer (Codec/quantize.c:1256); |v| <= 32768 after sat16,
// so ((|v| + mid) & 0xFFFF) * mult stays below 2^31.
__device__ __forceinline__ int quantize(int v, const Plane& p, int band) {
  if (p.q[band] <= 1) return v;
  int mag = (((abs(v) + p.mid[band]) & 0xFFFF) * p.mult[band]) >> 16;
  return v > 0 ? mag : (v < 0 ? -mag : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Copies bytes [start, start + nbytes) of input rows ylo..yhi-1 (`start`
// may be negative, the window may pass the row's end: those bytes are 0)
// into shared-memory rows y - ybase of nbytes each.  Rows are multiples
// of 4 bytes.
__device__ void stage_rows(const uint8_t* plane, long long row_bytes,
                           int start, int nbytes, int ylo, int yhi, int ybase,
                           uint8_t* smem) {
  const int chunks = nbytes / 16;
  const int n = (yhi - ylo) * chunks;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int sr = i / chunks, k = i - sr * chunks;
    const int y = ylo + sr;
    const long long g = start + 16LL * k;
    const uint8_t* row = plane + (long long)y * row_bytes;
    uint8_t* dst = smem + (long long)(y - ybase) * nbytes + 16 * k;
    if (g >= 0 && g + 16 <= row_bytes &&
        (reinterpret_cast<uintptr_t>(row + g) & 15) == 0) {
      cp_async16(dst, row + g);
    } else {
      for (int j = 0; j < 16; j += 4) {
        if (g + j >= 0 && g + j + 4 <= row_bytes) {
          cp_async4(dst + j, row + g + j);
        } else {
          *reinterpret_cast<int*>(dst + j) = 0;
        }
      }
    }
  }
}

// Horizontal 2-6 at output column c of a row: x(k) is the row's input
// pixel 2c + k (k in -4..5) at the codec's precision, `prev` the narrow-row
// quirk's previous-row term.  Returns (low, high), saturated.
template <class X>
__device__ __forceinline__ LoHi hfilter(X x, int c, int wo, int w, int ps,
                                        int pr, int prev) {
  auto pe = [&](int d) { return (x(2 * d) + pr) >> ps; };
  auto po = [&](int d) { return (x(2 * d + 1) + pr) >> ps; };
  const int lo = (x(0) + x(1) + pr) >> ps;
  int hi;
  if (c == 0) {
    if (w <= 16) {
      hi = ((-prev + pe(1) + po(1) + 4) >> 3) + (pe(0) - po(0));
    } else {
      hi = (5 * pe(0) - 11 * po(0) + 4 * pe(1) + 4 * po(1) - pe(2) - po(2) +
            4) >> 3;
    }
  } else if (c == wo - 1) {
    hi = (11 * pe(0) - 5 * po(0) - 4 * po(-1) - 4 * pe(-1) + po(-2) +
          pe(-2) + 4) >> 3;
  } else {
    hi = ((-(pe(-1) + po(-1)) + (pe(1) + po(1)) + 4) >> 3) + (pe(0) - po(0));
  }
  return {sat16(lo), sat16(hi)};
}

// Output row r at column c: LL, and the quantized LH, HL, HH.
__device__ __forceinline__ void emit(const Plane& P, int* ll, int* bands,
                                     int r, int c, int wo, int low_l,
                                     int low_h, int high_l, int high_h) {
  ll[(long long)r * wo + c] = sat16(low_l);
  int* o = bands + (long long)r * P.pitch + c;
  o[0] = quantize(sat16(low_h), P, 0);
  o[P.band_stride] = quantize(sat16(high_l), P, 1);
  o[2 * P.band_stride] = quantize(sat16(high_h), P, 2);
}

template <bool kYuy2>
__global__ void __launch_bounds__(kYuy2 ? kYuy2Threads : kIntThreads)
dwt_forward_kernel(const __grid_constant__ Level a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kRowBytes = kYuy2 ? kYuy2RowBytes : kIntRowBytes;

  // the block's plane (levels 2-3), frame and tile
  int pi = 0, bid = blockIdx.x;
  if (!kYuy2) {
    while (pi + 1 < a.nplanes && bid >= a.p[pi + 1].first_block) ++pi;
    bid -= a.p[pi].first_block;
  }
  const Plane& T = a.p[pi];
  const int tx = bid % T.tiles_x;
  const int rest = bid / T.tiles_x;
  const int ty = rest % a.tiles_y;
  const int b = rest / a.tiles_y;
  const int h = a.h, ho = h >> 1;
  const int c0 = tx * kCols;
  const int r0 = ty * a.rows, r1 = min(r0 + a.rows, ho);

  // input rows 2r0-2 .. 2r1+1 feed output rows r0..r1-1; the last row's
  // formula also reads rows 2r-4, 2r-3
  const int ybase = 2 * r0 - 4;
  const int ylo = max(r1 == ho ? 2 * r0 - 4 : 2 * r0 - 2, 0);
  const int yhi = min(2 * r1 + 2, h);
  const uint8_t* src = static_cast<const uint8_t*>(T.src) +
                       (kYuy2 ? 1 : 4) * b * T.src_bstride;
  stage_rows(src, (kYuy2 ? 2LL : 4LL) * T.w,
             kYuy2 ? 4 * c0 - 16 : 8 * c0 - 16, kRowBytes, ylo, yhi, ybase,
             smem);
  cp_async_wait_all();
  __syncthreads();

  // this thread's plane and output column; in shared memory, its input
  // pixel 2c + k is at byte base + step * k of a staged row (YUY2: Y at
  // byte 2j of the row, U at 4j + 1, V at 4j + 3)
  int role, t, c, base, step;
  if (kYuy2) {
    const int tid = threadIdx.x;
    role = tid < kCols ? 0 : (tid < kCols + kCols / 2 ? 1 : 2);
    t = role == 0 ? tid : tid - kCols - (role == 2 ? kCols / 2 : 0);
    c = role == 0 ? c0 + t : c0 / 2 + t;
    base = role == 0 ? 4 * t + 16 : 8 * t + 16 + (role == 1 ? 3 : 1);
    step = role == 0 ? 2 : 4;
  } else {
    role = pi;
    t = threadIdx.x;
    c = c0 + t;
    base = 4 * (2 * t + 4);
    step = 4;
  }
  const Plane& P = a.p[role];
  if (c >= P.pitch) return;
  const int wo = P.w >> 1;
  int* ll = P.ll + b * P.ll_bstride;
  int* bands = P.bands + b * P.bands_bstride;
  if (c >= wo) {                                  // pad columns
    for (int r = r0; r < r1; ++r) {
      int* o = bands + (long long)r * P.pitch + c;
      o[0] = 0;
      o[P.band_stride] = 0;
      o[2 * P.band_stride] = 0;
    }
    return;
  }

  const int ps = a.ps, pr = (1 << ps) - 1, shift = a.shift;
  // the narrow-row quirk's input: pixel j of the plane's row y, at the
  // codec's precision, from device memory
  auto pixel = [&](int y, int j) -> int {
    if (kYuy2) {
      const uint8_t* row = src + (long long)y * 2 * T.w;
      const int off = role == 0 ? 2 * j : 4 * j + (role == 1 ? 3 : 1);
      return (int)row[off] << shift;
    }
    return reinterpret_cast<const int*>(src)[(long long)y * P.w + j];
  };
  auto hrow = [&](int y) -> LoHi {
    if (y < ylo || y >= yhi) return {0, 0};
    const uint8_t* s = smem + (y - ybase) * kRowBytes + base;
    auto x = [&](int k) -> int {
      if (kYuy2) return (int)s[step * k] << shift;
      return *reinterpret_cast<const int*>(s + step * k);
    };
    int prev = 0;
    if (c == 0 && P.w <= 16 && P.w % 8 == 0 && y > 0) {
      prev = ((pixel(y - 1, P.w - 2) + pr) >> ps) +
             ((pixel(y - 1, P.w - 1) + pr) >> ps);
    }
    return hfilter(x, c, wo, P.w, ps, pr, prev);
  };

  LoHi win[8];                                    // rows 2r-4 .. 2r+3
#pragma unroll
  for (int j = 0; j < 8; ++j) win[j] = hrow(2 * r0 - 4 + j);
  for (int r = r0; r < r1; ++r) {
    if (r > r0) {
#pragma unroll
      for (int j = 0; j < 6; ++j) win[j] = win[j + 2];
      win[6] = hrow(2 * r + 2);
      win[7] = hrow(2 * r + 3);
    }
    if (r == 0) continue;             // row 0 is written with row 1
    if (r == 1) {
      // first row: raw rows 0..5 (Codec/spatial.c:14266), win[2..7] here
      emit(P, ll, bands, 0, c, wo, win[2].lo + win[3].lo,
           win[2].hi + win[3].hi,
           (5 * win[2].lo - 11 * win[3].lo + 4 * win[4].lo + 4 * win[5].lo -
            win[6].lo - win[7].lo + 4) >> 3,
           (5 * win[2].hi - 11 * win[3].hi + 4 * win[4].hi + 4 * win[5].hi -
            win[6].hi - win[7].hi + 4) >> 3);
    }
    int high_l, high_h;
    if (r == ho - 1) {
      // last row: raw rows h-6..h-1 (Codec/spatial.c:9968), win[0..5]
      high_l = (11 * win[4].lo - 5 * win[5].lo - 4 * win[3].lo -
                4 * win[2].lo + win[1].lo + win[0].lo + 4) >> 3;
      high_h = (11 * win[4].hi - 5 * win[5].hi - 4 * win[3].hi -
                4 * win[2].hi + win[1].hi + win[0].hi + 4) >> 3;
    } else {
      high_l = ((-(win[2].lo + win[3].lo) + (win[6].lo + win[7].lo) + 4) >>
                3) + (win[4].lo - win[5].lo);
      high_h = ((-(win[2].hi + win[3].hi) + (win[6].hi + win[7].hi) + 4) >>
                3) + (win[4].hi - win[5].hi);
    }
    emit(P, ll, bands, r, c, wo, win[4].lo + win[5].lo,
         win[4].hi + win[5].hi, high_l, high_h);
  }
}

void set_quant(Plane& p, int q0, int q1, int q2) {
  const int qs[3] = {q0, q1, q2};
  for (int b = 0; b < 3; ++b) {
    p.q[b] = qs[b];
    p.mult[b] = qs[b] > 1 ? (1 << 16) / qs[b] : 0;
    const int mid = qs[b] > 1 ? qs[b] / 2 : 0;
    p.mid[b] = mid ? mid - 1 : 0;
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n < 1) n = 1;
  }
  return n;
}

// Sets the tiling (the rows of a tile: the most up to kMaxRows that still
// gives every SM four blocks) and launches.  Level 1 tiles all three
// planes together (p[0] carries the tile count).
int launch(Level& a, bool yuy2, int batch, int h, int ps, int shift,
           cudaStream_t stream) {
  if (batch < 1 || h < 6 || (h & 1) || ps < 0 || ps > 8 || shift < 0 ||
      shift > 8) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < a.nplanes; ++i) {
    const Plane& p = a.p[i];
    if (p.w < 6 || (p.w & 1) || p.pitch < p.w / 2) {
      return (int)cudaErrorInvalidValue;
    }
  }
  a.h = h;
  a.ps = ps;
  a.shift = shift;
  if (yuy2) {
    const int cols = max(a.p[0].pitch, 2 * a.p[1].pitch);
    a.p[0].tiles_x = (cols + kCols - 1) / kCols;
  } else {
    for (int i = 0; i < a.nplanes; ++i) {
      a.p[i].tiles_x = (a.p[i].pitch + kCols - 1) / kCols;
    }
  }
  const int ho = h / 2;
  long long blocks = 0;
  for (a.rows = kMaxRows;; a.rows /= 2) {
    a.tiles_y = (ho + a.rows - 1) / a.rows;
    blocks = 0;
    for (int i = 0; i < (yuy2 ? 1 : a.nplanes); ++i) {
      a.p[i].first_block = (int)blocks;
      blocks += (long long)batch * a.tiles_y * a.p[i].tiles_x;
    }
    if (a.rows <= 4 || blocks >= 4LL * sm_count()) break;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = yuy2 ? kYuy2Threads : kIntThreads;
  const size_t smem =
      (size_t)(2 * a.rows + 6) * (yuy2 ? kYuy2RowBytes : kIntRowBytes);
  if (yuy2) {
    dwt_forward_kernel<true><<<(unsigned)blocks, threads, smem, stream>>>(a);
  } else {
    dwt_forward_kernel<false><<<(unsigned)blocks, threads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// Planes first .. first + g - 1 of a level: one channel group, its input
// (batch, g, h, w) int32 at x (null at YUY2 level 1, which reads the
// frames), its lowpass (batch, g, h/2, w/2) and its bands
// (batch, g, 3, h/2, pitch).
void set_group(Level& a, int first, int g, const int* x, int* ll,
               int* bands, int h, int w, int pitch) {
  const long long ho = h / 2, wo = w / 2;
  for (int i = 0; i < g; ++i) {
    Plane& p = a.p[first + i];
    p.src = x ? x + (long long)i * h * w : nullptr;
    p.src_bstride = (long long)g * h * w;
    p.ll = ll + i * ho * wo;
    p.ll_bstride = g * ho * wo;
    p.bands = bands + i * 3 * ho * pitch;
    p.band_stride = ho * pitch;
    p.bands_bstride = g * 3 * ho * pitch;
    p.pitch = pitch;
    p.w = w;
  }
  a.nplanes = first + g;
}

}  // namespace

// Level 1 from YUY2 frames (batch, h, 2w) bytes, for Y, V, U (quants in
// that order), into the channel groups' buffers.  w % 4 == 0.
extern "C" int cf_dwt_forward_yuy2(const uint8_t* frames, int* ll_y,
                                   int* ll_c, int* bands_y, int* bands_c,
                                   int batch, int h, int w, int pitch_y,
                                   int pitch_c, int shift, int prescale,
                                   int qy0, int qy1, int qy2, int qv0,
                                   int qv1, int qv2, int qu0, int qu1,
                                   int qu2, void* stream) {
  if (w % 4) return (int)cudaErrorInvalidValue;
  Level a = {};
  set_group(a, 0, 1, nullptr, ll_y, bands_y, h, w, pitch_y);
  set_group(a, 1, 2, nullptr, ll_c, bands_c, h, w / 2, pitch_c);
  for (int i = 0; i < 3; ++i) {
    a.p[i].src = frames;
    a.p[i].src_bstride = (long long)h * 2 * w;
  }
  set_quant(a.p[0], qy0, qy1, qy2);
  set_quant(a.p[1], qv0, qv1, qv2);
  set_quant(a.p[2], qu0, qu1, qu2);
  return launch(a, true, batch, h, prescale, shift, (cudaStream_t)stream);
}

// One level of Y (batch, 1, h, w) and V, U (batch, 2, h, w / 2) int32, into
// the channel groups' buffers of the next level.  w % 4 == 0.
extern "C" int cf_dwt_forward_groups(const int* x_y, const int* x_c,
                                     int* ll_y, int* ll_c, int* bands_y,
                                     int* bands_c, int batch, int h, int w,
                                     int pitch_y, int pitch_c, int prescale,
                                     int qy0, int qy1, int qy2, int qv0,
                                     int qv1, int qv2, int qu0, int qu1,
                                     int qu2, void* stream) {
  if (w % 4) return (int)cudaErrorInvalidValue;
  Level a = {};
  set_group(a, 0, 1, x_y, ll_y, bands_y, h, w, pitch_y);
  set_group(a, 1, 2, x_c, ll_c, bands_c, h, w / 2, pitch_c);
  set_quant(a.p[0], qy0, qy1, qy2);
  set_quant(a.p[1], qv0, qv1, qv2);
  set_quant(a.p[2], qu0, qu1, qu2);
  return launch(a, false, batch, h, prescale, 0, (cudaStream_t)stream);
}

// One level of a group of `planes` (1..4) equal int32 planes
// (batch, planes, h, w), one quantizer triple each (q holds 12, the
// unused ones ignored), into lowpass (batch, planes, h/2, w/2) and bands
// (batch, planes, 3, h/2, pitch).
extern "C" int cf_dwt_forward_planes(const int* x, int* ll, int* bands,
                                     int batch, int planes, int h, int w,
                                     int pitch, int prescale, int q00,
                                     int q01, int q02, int q10, int q11,
                                     int q12, int q20, int q21, int q22,
                                     int q30, int q31, int q32,
                                     void* stream) {
  if (planes < 1 || planes > kMaxPlanes) return (int)cudaErrorInvalidValue;
  const int q[kMaxPlanes][3] = {
      {q00, q01, q02}, {q10, q11, q12}, {q20, q21, q22}, {q30, q31, q32}};
  Level a = {};
  set_group(a, 0, planes, x, ll, bands, h, w, pitch);
  for (int i = 0; i < planes; ++i) {
    set_quant(a.p[i], q[i][0], q[i][1], q[i][2]);
  }
  return launch(a, false, batch, h, prescale, 0, (cudaStream_t)stream);
}

// One level of one int32 plane (batch, h, w): lowpass (batch, h/2, w/2),
// bands (3, batch, h/2, w/2).
extern "C" int cf_dwt_forward_level(const int* x, int* ll, int* bands,
                                    int batch, int h, int w, int prescale,
                                    int q0, int q1, int q2, void* stream) {
  Level a = {};
  Plane& p = a.p[0];
  const long long ho = h / 2, wo = w / 2;
  p.src = x;
  p.src_bstride = (long long)h * w;
  p.ll = ll;
  p.ll_bstride = ho * wo;
  p.bands = bands;
  p.bands_bstride = ho * wo;
  p.band_stride = (long long)batch * ho * wo;
  p.pitch = w / 2;
  p.w = w;
  a.nplanes = 1;
  set_quant(p, q0, q1, q2);
  return launch(a, false, batch, h, prescale, 0, (cudaStream_t)stream);
}

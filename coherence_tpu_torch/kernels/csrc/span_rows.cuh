// Span rows for Hopper (sm_90a): what TR1 (tile_raster.cu) and SR1
// (sprite_raster.cu) share.  Both turn span lists into masks and a
// Gaussian-matte AA opacity, a 256-thread block a band of 16 pixel rows
// and 128 columns: its 1x mask rows, the words of its 16x t-rows that its
// fringe pixels' footprints read, and each fringe pixel's count through the
// table's nibble sums.
//
// A span list is read through a source (a struct with row(k), the span's
// row, and load(k, row, cols), cols its start | (end + 1) << 16 in the
// band's own columns), so the two kernels' list layouts share every
// builder.  A family's mask is the JAX package's scatter: +1 at (row,
// start), -1 at (row, end + 1), a prefix sum along the row, > 0.  A row's
// count at a column is up - down, up its spans over the column (start <= c
// < end + 1) and down its reversed spans over it (end + 1 <= c < start),
// so no row needs its events sorted:
//   * up to kLaneCap spans: one lane counts both bit-sliced over each word's
//     32 columns and sets the bits where up > down (no atomics);
//   * more: the warp sums each word's count at its first column and scans
//     the steps inside it through a window of 32 counts, a ballot making
//     the word;
//   * a row of more spans than the bins hold: the block scatters its
//     +1 / -1 into a row of counts and one warp scans it 32 columns a step.
// A band holding more spans than the bins is binned in runs of rows that
// fit, one pass over its spans a run.  The footprint count reads the
// Gaussian table as nibble sums, built in shared memory per block from the
// table (each footprint row's sums on banks of their own): 8 lookups a
// footprint row, 256 a fringe pixel, eight lanes a pixel (four footprint
// rows each, added by shuffles).  No float anywhere: the table is integers
// <= 255 and a count an exact int32 sum (at most 42,120).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStripW = 128;                        // pixel columns of a band: an atlas piece's width
constexpr int kScale = 16;                          // the AA mask's scale
constexpr int kFoot = 2 * kScale;                   // a pixel's footprint: 32 x 32 samples
constexpr int kStripT = kScale * kStripW + kScale;  // 2064 t-columns under a band's footprints
constexpr int kRowWords = (kStripT + 31) / 32;      // 65 words: a t-row of 2080 columns
constexpr int kMaskWords = kStripW / 32;            // a 1x mask row: 4 words
constexpr int kBand = 16;                           // pixel rows of a band
constexpr int kBandRows = kScale * kBand + kScale;  // a band's 272 t-rows
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBinCap = 6144;                       // spans binned at once
constexpr int kLaneCap = 32;                        // spans of a row that one lane builds
constexpr int kUnroll = 8;                          // spans a thread loads at once
constexpr int planes_for(int n) { return n < 2 ? 1 : 1 + planes_for(n / 2); }
constexpr int kPlanes = planes_for(kLaneCap);       // bit planes of a lane's counts: up to kLaneCap
constexpr int kVolume = 42285;                      // raster/aa.py volume: sum(table) * 256 / 255
constexpr int kNibbles = kFoot / 4;                 // a footprint row's 32 samples as 8 nibbles
constexpr int kTableRow = 16 * kNibbles + 2;        // a footprint row's nibble sums: 65 words, so rows fall on other banks
static_assert(kScale * (kStripW - 1) + kFoot <= 32 * kRowWords, "a footprint's last column lies in a t-row's words");
static_assert(kStripT < 32 * kRowWords && kStripT < 0x10000, "a span's end + 1 lies in a row of counts and in 16 bits");
static_assert(kThreads == kFoot * kNibbles, "one thread builds each (row, nibble) of the table");
static_assert(kLaneCap < (1 << kPlanes), "a lane's counts fit its bit planes");

// The truncated Gaussian, x255 (raster/aa.py maintable, polygon.ml:616-629):
// kTable[v][u] weighs the footprint sample at row offset v, column offset u
// (maintable[u][v]; the table is symmetric).
__device__ const int kTable[kFoot][kFoot] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 4, 4, 4, 3, 3, 2, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 4, 5, 6, 7, 8, 8, 8, 8, 7, 6, 5, 4, 3, 2, 2, 1, 1, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 1, 1, 2, 3, 4, 6, 7, 9, 10, 12, 13, 13, 13, 13, 12, 10, 9, 7, 6, 4, 3, 2, 1, 1, 0, 0, 0, 0},
    {0, 0, 0, 1, 1, 2, 3, 5, 7, 9, 12, 14, 17, 19, 20, 21, 21, 20, 19, 17, 14, 12, 9, 7, 5, 3, 2, 1, 1, 0, 0, 0},
    {0, 0, 1, 1, 2, 4, 5, 8, 11, 14, 18, 22, 25, 28, 31, 32, 32, 31, 28, 25, 22, 18, 14, 11, 8, 5, 4, 2, 1, 1, 0, 0},
    {0, 0, 1, 2, 3, 5, 8, 12, 16, 21, 26, 32, 37, 41, 45, 46, 46, 45, 41, 37, 32, 26, 21, 16, 12, 8, 5, 3, 2, 1, 0, 0},
    {0, 1, 2, 3, 5, 8, 12, 17, 22, 29, 37, 45, 52, 58, 63, 65, 65, 63, 58, 52, 45, 37, 29, 22, 17, 12, 8, 5, 3, 2, 1, 0},
    {0, 1, 2, 4, 7, 11, 16, 22, 31, 40, 50, 60, 70, 79, 85, 88, 88, 85, 79, 70, 60, 50, 40, 31, 22, 16, 11, 7, 4, 2, 1, 0},
    {1, 2, 3, 6, 9, 14, 21, 29, 40, 52, 65, 79, 91, 102, 110, 115, 115, 110, 102, 91, 79, 65, 52, 40, 29, 21, 14, 9, 6, 3, 2, 1},
    {1, 2, 4, 7, 12, 18, 26, 37, 50, 65, 82, 99, 115, 128, 138, 144, 144, 138, 128, 115, 99, 82, 65, 50, 37, 26, 18, 12, 7, 4, 2, 1},
    {1, 3, 5, 9, 14, 22, 32, 45, 60, 79, 99, 119, 138, 155, 167, 173, 173, 167, 155, 138, 119, 99, 79, 60, 45, 32, 22, 14, 9, 5, 3, 1},
    {2, 3, 6, 10, 17, 25, 37, 52, 70, 91, 115, 138, 161, 180, 194, 201, 201, 194, 180, 161, 138, 115, 91, 70, 52, 37, 25, 17, 10, 6, 3, 2},
    {2, 4, 7, 12, 19, 28, 41, 58, 79, 102, 128, 155, 180, 201, 217, 225, 225, 217, 201, 180, 155, 128, 102, 79, 58, 41, 28, 19, 12, 7, 4, 2},
    {2, 4, 8, 13, 20, 31, 45, 63, 85, 110, 138, 167, 194, 217, 234, 243, 243, 234, 217, 194, 167, 138, 110, 85, 63, 45, 31, 20, 13, 8, 4, 2},
    {2, 4, 8, 13, 21, 32, 46, 65, 88, 115, 144, 173, 201, 225, 243, 252, 252, 243, 225, 201, 173, 144, 115, 88, 65, 46, 32, 21, 13, 8, 4, 2},
    {2, 4, 8, 13, 21, 32, 46, 65, 88, 115, 144, 173, 201, 225, 243, 252, 252, 243, 225, 201, 173, 144, 115, 88, 65, 46, 32, 21, 13, 8, 4, 2},
    {2, 4, 8, 13, 20, 31, 45, 63, 85, 110, 138, 167, 194, 217, 234, 243, 243, 234, 217, 194, 167, 138, 110, 85, 63, 45, 31, 20, 13, 8, 4, 2},
    {2, 4, 7, 12, 19, 28, 41, 58, 79, 102, 128, 155, 180, 201, 217, 225, 225, 217, 201, 180, 155, 128, 102, 79, 58, 41, 28, 19, 12, 7, 4, 2},
    {2, 3, 6, 10, 17, 25, 37, 52, 70, 91, 115, 138, 161, 180, 194, 201, 201, 194, 180, 161, 138, 115, 91, 70, 52, 37, 25, 17, 10, 6, 3, 2},
    {1, 3, 5, 9, 14, 22, 32, 45, 60, 79, 99, 119, 138, 155, 167, 173, 173, 167, 155, 138, 119, 99, 79, 60, 45, 32, 22, 14, 9, 5, 3, 1},
    {1, 2, 4, 7, 12, 18, 26, 37, 50, 65, 82, 99, 115, 128, 138, 144, 144, 138, 128, 115, 99, 82, 65, 50, 37, 26, 18, 12, 7, 4, 2, 1},
    {1, 2, 3, 6, 9, 14, 21, 29, 40, 52, 65, 79, 91, 102, 110, 115, 115, 110, 102, 91, 79, 65, 52, 40, 29, 21, 14, 9, 6, 3, 2, 1},
    {0, 1, 2, 4, 7, 11, 16, 22, 31, 40, 50, 60, 70, 79, 85, 88, 88, 85, 79, 70, 60, 50, 40, 31, 22, 16, 11, 7, 4, 2, 1, 0},
    {0, 1, 2, 3, 5, 8, 12, 17, 22, 29, 37, 45, 52, 58, 63, 65, 65, 63, 58, 52, 45, 37, 29, 22, 17, 12, 8, 5, 3, 2, 1, 0},
    {0, 0, 1, 2, 3, 5, 8, 12, 16, 21, 26, 32, 37, 41, 45, 46, 46, 45, 41, 37, 32, 26, 21, 16, 12, 8, 5, 3, 2, 1, 0, 0},
    {0, 0, 1, 1, 2, 4, 5, 8, 11, 14, 18, 22, 25, 28, 31, 32, 32, 31, 28, 25, 22, 18, 14, 11, 8, 5, 4, 2, 1, 1, 0, 0},
    {0, 0, 0, 1, 1, 2, 3, 5, 7, 9, 12, 14, 17, 19, 20, 21, 21, 20, 19, 17, 14, 12, 9, 7, 5, 3, 2, 1, 1, 0, 0, 0},
    {0, 0, 0, 0, 1, 1, 2, 3, 4, 6, 7, 9, 10, 12, 13, 13, 13, 13, 12, 10, 9, 7, 6, 4, 3, 2, 1, 1, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 4, 5, 6, 7, 8, 8, 8, 8, 7, 6, 5, 4, 3, 2, 2, 1, 1, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 4, 4, 4, 3, 3, 2, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};

// The builders' shared memory, inside each kernel's own.
struct RowSmem {
  union {
    struct {
      uint16_t start[kBinCap];  // the binned spans' starts and ends + 1, row by row
      uint16_t stop[kBinCap];
    } bin;
    int diff[32 * kRowWords];  // one row's counts, where it holds more spans than the bins
  } b;
  uint16_t table[kFoot][kTableRow];     // the table's nibble sums: [v][16 k + m] = sum of kTable[v][4k + j] over m's bits j
  int first[kBandRows + 1];             // a row's first bin, a run's rows counted from the run's first
  int fill[kBandRows];                  // a row's span count, then its scatter cursor
  int win[kWarps][32];                  // each warp's window of steps (warp_row), zero between rows
};
static_assert(sizeof(int) * 32 * kRowWords <= sizeof(uint16_t) * 2 * kBinCap, "a row of counts fits the bins");

__device__ __forceinline__ int wrap(uint32_t v) { return static_cast<int>(v); }

__device__ __forceinline__ int div255(int i) {
  return wrap(static_cast<uint32_t>(i) + static_cast<uint32_t>(i >> 8) + 1u) >> 8;
}

__device__ __forceinline__ int dissolve(int c, int d) {
  return d == 0 ? 0 : d == 255 ? c : div255(wrap(static_cast<uint32_t>(c) * static_cast<uint32_t>(d)));
}

__device__ __forceinline__ bool any(uint3 m) { return (m.x | m.y | m.z) != 0; }

// Bits a .. b - 1 of a word, 0 <= a < b <= 32.
__device__ __forceinline__ uint32_t run_bits(int a, int b) {
  return (b >= 32 ? kFull : (1u << b) - 1u) & ~((1u << a) - 1u);
}

// Every 1x row is read whole.
struct Need1x {
  __device__ uint3 operator()(int) const { return make_uint3((1u << kMaskWords) - 1u, 0u, 0u); }
};

// T-row t of a band is read by the footprints of the band's pixel rows
// t / 16 and t / 16 - 1.
struct NeedAA {
  const uint32_t* need;  // (kBand, 3)
  __device__ uint3 operator()(int t) const {
    const int y = t >> 4;
    uint3 m = make_uint3(0u, 0u, 0u);
    if (y < kBand) m = make_uint3(need[3 * y], need[3 * y + 1], need[3 * y + 2]);
    if (y > 0) m.x |= need[3 * y - 3], m.y |= need[3 * y - 2], m.z |= need[3 * y - 1];
    return m;
  }
};

// f(t, c) for every span of [lo, hi) and [lo2, hi2) of `src` on rows r0 ..
// r0 + nr - 1 (t counted from r0; those of the second range from nr), c its
// packed columns where kCols (else 0).  The block's threads take
// consecutive spans, each thread kUnroll of them at once: their loads are
// in flight together.
template <bool kCols, class Src, class F>
__device__ __forceinline__ void for_spans(const Src& src, int lo, int hi, int lo2, int hi2, int r0, int nr, F f) {
  const int n1 = hi - lo, n = n1 + (hi2 - lo2);
  for (int q0 = threadIdx.x; q0 < n; q0 += kThreads * kUnroll) {
    int t[kUnroll], c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * kThreads;
      const bool first = q < n1;
      const int k = first ? lo + q : lo2 + (q - n1);
      t[u] = -1, c[u] = 0;
      if (q < n) {
        int r;
        if constexpr (kCols) src.load(k, r, c[u]);
        else r = src.row(k);
        const unsigned d = static_cast<unsigned>(r) - static_cast<unsigned>(r0);
        if (d < static_cast<unsigned>(nr)) t[u] = static_cast<int>(d) + (first ? 0 : nr);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t[u] >= 0) f(t[u], c[u]);
    }
  }
}

// first[t] = the sum of cnt[0 .. t) for t in 0 .. n (n <= kBandRows), by one warp.
__device__ void exclusive_scan(const int* cnt, int* first, int n) {
  constexpr int kPer = (kBandRows + 31) / 32;
  const int lane = threadIdx.x & 31, a = lane * kPer;
  int sum = 0;
  for (int j = 0; j < kPer; ++j) {
    if (a + j < n) sum += cnt[a + j];
  }
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  int run = x - sum;
  for (int j = 0; j < kPer; ++j) {
    if (a + j < n) first[a + j] = run, run += cnt[a + j];
  }
  if (lane == 31) first[n] = x;
}

// c += m, column by column: c is a bit-sliced counter (bit b of c[p] is bit
// p of column b's count).
__device__ __forceinline__ void count_in(uint32_t (&c)[kPlanes], uint32_t m) {
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const uint32_t carry = c[p] & m;
    c[p] ^= m;
    m = carry;
  }
}

// One row by one lane, from its k starts S and ends + 1 E (the lane's own
// bins, in any order).  A span adds 1 to the count of the columns start ..
// end where start < end + 1 and takes 1 from end + 1 .. start - 1 where it
// is reversed, so the count at a column is up - down: up the spans over it,
// down the reversed spans over it.  For each word of `need`, both are
// counted bit-sliced over its 32 columns (no sort), and its bits are the
// columns where up > down.
__device__ void lane_row(const uint16_t* S, const uint16_t* E, int k, uint3 need, uint32_t* out) {
  const uint32_t words[3] = {need.x, need.y, need.z};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    for (uint32_t m = words[q]; m; m &= m - 1) {
      const int w = 32 * q + __ffs(m) - 1, c0 = 32 * w;
      uint32_t up[kPlanes] = {}, down[kPlanes] = {};
      for (int i = 0; i < k; ++i) {
        const int s = S[i] - c0, e = E[i] - c0;
        const int a = max(min(s, e), 0), b = min(max(s, e), 32);
        if (a < b) {
          if (s < e) count_in(up, run_bits(a, b));
          else count_in(down, run_bits(a, b));
        }
      }
      uint32_t gt = 0, eq = kFull;  // compared from the top plane down
#pragma unroll
      for (int p = kPlanes - 1; p >= 0; --p) {
        gt |= eq & up[p] & ~down[p];
        eq &= ~(up[p] ^ down[p]);
      }
      out[w] = gt;
    }
  }
}

// One row by one warp (the whole warp calls it), from its k starts S and
// ends + 1 E (in any order): for each word of `need`, the count at its first
// column c0 (each lane sums its share of the spans, then the warp) and the
// steps at columns c0 + 1 .. c0 + 31 (each span's +1 / -1 into the warp's
// window of 32 counts), scanned.  `win` starts and ends zero.
__device__ void warp_row(const uint16_t* S, const uint16_t* E, int k, uint3 need, uint32_t* out, int* win) {
  const int lane = threadIdx.x & 31;
  const uint32_t words[3] = {need.x, need.y, need.z};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    for (uint32_t m = words[q]; m; m &= m - 1) {
      const int w = 32 * q + __ffs(m) - 1, c0 = 32 * w;
      int x = 0;
      for (int i = lane; i < k; i += 32) {
        const int s = S[i] - c0, e = E[i] - c0;
        x += (s <= 0) - (e <= 0);
        if (s > 0 && s < 32) atomicAdd(win + s, 1);
        if (e > 0 && e < 32) atomicAdd(win + e, -1);
      }
      const int base = __reduce_add_sync(kFull, x);
      __syncwarp();
      x = win[lane];
      win[lane] = 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      const uint32_t bits = __ballot_sync(kFull, base + x > 0);
      if (lane == 0) out[w] = bits;
      __syncwarp();
    }
  }
}

// Row t of more spans than the bins hold, by the block: its +1 / -1 into a
// row of counts, then one warp scans `words` words of it 32 columns a step.
template <class Src, class Need>
__device__ void one_row(RowSmem& s, const Src& src, int lo, int hi, int lo2, int hi2, int r0, int nr, int t,
                        Need need, uint32_t* out, int words) {
  for (int c = threadIdx.x; c < 32 * kRowWords; c += kThreads) s.b.diff[c] = 0;
  __syncthreads();
  for_spans<true>(src, lo, hi, lo2, hi2, r0, nr, [&](int tt, int c) {
    if (tt == t) {
      atomicAdd(&s.b.diff[c & 0xFFFF], 1);
      atomicAdd(&s.b.diff[c >> 16], -1);
    }
  });
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const uint3 m = need(t);
    const uint32_t mw[3] = {m.x, m.y, m.z};
    int carry = 0;
    for (int w = 0; w < words; ++w) {
      int x = s.b.diff[32 * w + lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      x += carry;
      const uint32_t bits = __ballot_sync(kFull, x > 0);
      carry = __shfl_sync(kFull, x, 31);
      if (lane == 0 && ((mw[w >> 5] >> (w & 31)) & 1u)) out[w] = bits;
    }
  }
  __syncthreads();
}

// The words `need` names of rows r0 .. r0 + nr - 1 of the spans of [lo, hi)
// (and of [lo2, hi2) as rows nr .. 2 nr - 1 where `two`) into out[t * words
// + w], binned in shared memory first.  Ends with the block synchronized.
template <class Src, class Need>
__device__ void build_rows(RowSmem& s, const Src& src, int lo, int hi, int lo2, int hi2, bool two, int r0, int nr,
                           Need need, uint32_t* out, int words) {
  const int warp = threadIdx.x >> 5, nt = two ? 2 * nr : nr;
  for (int t = threadIdx.x; t < nt; t += kThreads) s.fill[t] = 0;
  __syncthreads();
  for_spans<false>(src, lo, hi, lo2, hi2, r0, nr, [&](int t, int) {
    if (any(need(t))) atomicAdd(&s.fill[t], 1);
  });
  __syncthreads();
  if (warp == 0) exclusive_scan(s.fill, s.first, nt);
  __syncthreads();
  for (int ra = 0; ra < nt;) {
    const int base = s.first[ra];
    if (s.first[ra + 1] - base > kBinCap) {
      one_row(s, src, lo, hi, lo2, hi2, r0, nr, ra, need, out + ra * words, words);
      ++ra;
      continue;
    }
    // The run ra .. rb - 1: as many rows as the bins hold.
    int rb = ra + 1, hi_rb = nt;
    while (rb < hi_rb) {
      const int mid = (rb + hi_rb + 1) >> 1;
      if (s.first[mid] - base <= kBinCap) rb = mid;
      else hi_rb = mid - 1;
    }
    for (int t = ra + threadIdx.x; t < rb; t += kThreads) s.fill[t] = s.first[t] - base;
    __syncthreads();
    for_spans<true>(src, lo, hi, lo2, hi2, r0, nr, [&](int t, int c) {
      if (t >= ra && t < rb && any(need(t))) {
        const int at = atomicAdd(&s.fill[t], 1);
        s.b.bin.start[at] = static_cast<uint16_t>(c & 0xFFFF);
        s.b.bin.stop[at] = static_cast<uint16_t>(c >> 16);
      }
    });
    __syncthreads();
    for (int t = ra + threadIdx.x; t < rb; t += kThreads) {
      const int k = s.first[t + 1] - s.first[t], at = s.first[t] - base;
      const uint3 m = need(t);
      if (k <= kLaneCap && any(m)) lane_row(s.b.bin.start + at, s.b.bin.stop + at, k, m, out + t * words);
    }
    __syncwarp();
    for (int t = ra + warp; t < rb; t += kWarps) {
      const int k = s.first[t + 1] - s.first[t], at = s.first[t] - base;
      if (k > kLaneCap) warp_row(s.b.bin.start + at, s.b.bin.stop + at, k, need(t), out + t * words, s.win[warp]);
    }
    __syncthreads();
    ra = rb;
  }
}

// The fringe of a band's first ny pixel rows (ny <= kBand) from its coverage
// rows `cov` (kMaskWords words a row): need[y] the mask of the t-row words
// that row y's fringe footprints read (word j where pixel 2j - 1, 2j or
// 2j + 1 is fringe; zero for y >= ny), and the fringe pixels y * kStripW + x
// listed in `fringe`, their count in *listed.  Ends with the block
// synchronized.
__device__ void fringe_of(const uint32_t* cov, int ny, uint32_t (*need)[3], uint16_t* fringe, int* listed) {
  if (threadIdx.x == 0) *listed = 0;
  if (threadIdx.x < kBand * 3) {
    const int y = threadIdx.x / 3, q = threadIdx.x % 3;
    const uint32_t* f = cov + y * kMaskWords;
    uint32_t bits = 0;
    for (int h = 0; y < ny && h < 2; ++h) {  // columns 64 q + 32 h .. + 31 of the row dilated by one pixel each way
      const int i = 2 * q + h;
      const uint32_t fi = i < kMaskWords ? f[i] : 0u, before = i > 0 && i <= kMaskWords ? f[i - 1] : 0u;
      const uint32_t after = i + 1 < kMaskWords ? f[i + 1] : 0u;
      uint32_t d = fi | (fi << 1) | (before >> 31) | (fi >> 1) | (after << 31);
      d &= 0x55555555u;  // its even columns 2 j: word j
      d = (d | (d >> 1)) & 0x33333333u;
      d = (d | (d >> 2)) & 0x0F0F0F0Fu;
      d = (d | (d >> 4)) & 0x00FF00FFu;
      d = (d | (d >> 8)) & 0x0000FFFFu;
      bits |= d << (16 * h);
    }
    need[y][q] = bits;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < ny * kStripW; q += kThreads) {
    if ((cov[(q >> 7) * kMaskWords + ((q & 127) >> 5)] >> (q & 31)) & 1u) {
      fringe[atomicAdd(listed, 1)] = static_cast<uint16_t>(q);
    }
  }
  __syncthreads();
}

// The table's nibble sums into s.table: thread (v, k) its 16.
__device__ void nibble_table(RowSmem& s) {
  const int v = threadIdx.x / kNibbles, k = threadIdx.x % kNibbles;
  const int* w = kTable[v] + 4 * k;
  for (int m = 0; m < 16; ++m) {
    s.table[v][16 * k + m] = static_cast<uint16_t>((m & 1) * w[0] + ((m >> 1) & 1) * w[1] + ((m >> 2) & 1) * w[2] +
                                                   ((m >> 3) & 1) * w[3]);
  }
}

// opac[y][x] = (count * 256 + volume / 2) / volume for the `listed` pixels
// of `fringe` (y * kStripW + x), count the table summed over the set samples
// of the footprint (t-rows 16 y .. 16 y + 31 of `tbits`, columns 16 x ..
// 16 x + 31), eight lanes a pixel, four footprint rows each.  Ends with the
// block synchronized.
__device__ void footprint_opacity(const RowSmem& s, const uint32_t (*tbits)[kRowWords], const uint16_t* fringe,
                                  int listed, uint8_t (*opac)[kStripW]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, part = lane & 7;
  for (int at = 4 * warp; at < listed; at += 4 * kWarps) {
    const int q = at + (lane >> 3);
    int count = 0, y = 0, x = 0;
    if (q < listed) {
      y = fringe[q] >> 7, x = fringe[q] & 127;
      for (int v = part; v < kFoot; v += 8) {
        const uint32_t* row = &tbits[kScale * y + v][x >> 1];
        const uint32_t bits = (x & 1) ? __funnelshift_r(row[0], row[1], kScale) : row[0];
#pragma unroll
        for (int k = 0; k < kNibbles; ++k) count += s.table[v][16 * k + ((bits >> (4 * k)) & 15u)];
      }
    }
    count += __shfl_xor_sync(kFull, count, 4);
    count += __shfl_xor_sync(kFull, count, 2);
    count += __shfl_xor_sync(kFull, count, 1);
    if (q < listed && part == 0) opac[y][x] = static_cast<uint8_t>((count * 256 + kVolume / 2) / kVolume);
  }
  __syncthreads();
}

}  // namespace

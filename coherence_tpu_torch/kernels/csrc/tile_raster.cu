// The tile rasterizer for Hopper (sm_90a): per-piece span lists to packed
// 64x128 atlas pieces with the Gaussian-matte antialiasing (TR1).
//
// Replaces the XLA programs (not Pallas kernels) of the JAX package's tile
// build: coherence_tpu/raster/tile_raster.py:115 _edge_tile_kernel over
// _edge_impl (:79), and :120 _interior_tile_kernel over _interior_impl
// (:102), each a lax.map over the pieces of one batch.  As eager torch every
// 16 edge items were three index_put_ scatters, a 1040 x 2065 int32
// difference plane and its prefix sum, a float32 table product and the
// wheres (raster/tile_raster.py _edge_impl, _interior_impl: the plain
// versions, bit for bit).
//
// The function.  Item i of a block writes slot i; slots from n on are
// zero.  An item has three span families, each span (row, start, end) with
// an inclusive end, over a plane of its own: the 1x coverage and crossing
// masks (64 x 128) and the 16x AA t-plane (1040 x 2064; pixel (y, x)'s
// footprint is its rows 16y..16y+31, columns 16x..16x+31).  A family's mask
// is _scatter_mask's: +1 at (row, start), -1 at (row, end + 1), a prefix sum
// along the row, > 0.  So a reversed or overlapping span counts exactly as
// it does there: this kernel builds every row from its counts.  Rows outside
// the plane are dropped by the host (kernels.tile_span_lists, as the
// scatter's mode="drop"), which also refuses columns outside 0..w.  Then
//   interior (cross & ~cov): the fill, packed;
//   fringe (cov):            pack(dissolve(fill, opacity)), opacity =
//                            (count * 256 + volume / 2) / volume, count the
//                            Gaussian table summed over the footprint's set
//                            samples, dissolve with the 0 / 255 early outs;
//   elsewhere:               0.
// Interior mode has no coverage or AA family: the fill where the crossing
// mask holds.  The pack is the bare OR r | g << 8 | b << 16 | a << 24.
//
// No float math in the count: the table is integers <= 255 and a count is
// an exact int32 sum (at most 42,120), computed only at fringe pixels.
//
// What bounds it: bytes at the program's shapes.  Its lists read once (4
// bytes a span, 4 an offset) and its pieces written once; the AA count is
// 1024 multiply-adds a fringe pixel, and fringe pixels are few (an edge
// crosses a piece in a thin band), so the operations stay under the int32
// rate.
//
// Design.  One block of 16 warps owns one piece and keeps everything in
// shared memory (218,208 bytes: one block an SM).  A warp builds one mask row
// at a time: its spans' +1 / -1 go into the warp's own row of counts by
// shared-memory atomics, then the warp scans the row 32 columns a step (a
// shuffle scan with the carry from the step before) and a ballot makes each
// 32-column word of the mask.  The 1x masks take 128 such rows of 4 steps.
// The t-plane of a piece is 268 KB as bits, more than a block's shared
// memory, so it is built band by band (16 pixel rows, at most 272 t-rows)
// and only where the band has fringe pixels: only the t-rows and the
// word-aligned columns under the band's fringe bounding box are scanned, the
// count of the spans left of the box's first column carried in.  A band's
// fringe pixels are listed by an atomic counter, and each thread sums the
// table over its listed pixel's 32 t-rows, 32 bits a row, the table in
// constant memory (every lane of a warp reads the same entry).  A span is
// read from device memory by the warp that scans its row, in one coalesced
// read with the row's other spans (twice for the 16 t-rows two bands'
// footprints share; never where no band needs its row), so nothing is
// staged through shared memory; a row's spans are found through the item's
// per-row offsets, which the host builds (kernels.tile_span_lists).  The
// last pass writes the piece as 16-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileH = 64;                           // an atlas piece
constexpr int kTileW = 128;
constexpr int kScale = 16;                           // the AA mask's scale
constexpr int kFoot = 2 * kScale;                    // a pixel's footprint: 32 x 32 samples
constexpr int kPlaneH = kScale * kTileH + kScale;    // 1040: kernels.AA_PLANE
constexpr int kPlaneW = kScale * kTileW + kScale;    // 2064
constexpr int kRowWords = (kPlaneW + 31) / 32 + 1;   // 65 words: a t-row of 2080 columns
constexpr int kDiffW = 32 * kRowWords;               // a warp's row of counts
constexpr int kMaskWords = kTileW / 32;              // a 1x mask row: 4 words
constexpr int kBand = 16;                            // pixel rows of a band
constexpr int kBands = kTileH / kBand;
constexpr int kBandRows = kScale * kBand + kScale;   // 272 t-rows at most
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVolume = 42285;                       // raster/aa.py volume: sum(table) * 256 / 255
static_assert(kScale * (kTileW - 1) + kFoot <= kDiffW, "a footprint's last column lies in a scanned row");
static_assert(kScale * (kTileH - 1) + kFoot <= kPlaneH, "a footprint's last row lies in the plane");

constexpr int kDiffBytes = kWarps * kDiffW * 4;
constexpr int kBitsBytes = kBandRows * kRowWords * 4;
constexpr int kMaskBytes = 2 * kTileH * kMaskWords * 4;
constexpr int kBoxBytes = kBands * 8 * 4;
constexpr int kOpacBytes = kTileH * kTileW;
constexpr int kListBytes = kBand * kTileW * 2;
constexpr int kSmemBytes = kDiffBytes + kBitsBytes + kMaskBytes + kBoxBytes + kOpacBytes + kListBytes;
static_assert(kSmemBytes <= 232448, "a block's shared memory on sm_90");

// The truncated Gaussian, x255 (raster/aa.py maintable, polygon.ml:616-629):
// kTable[v][u] weighs the footprint sample at row offset v, column offset u
// (maintable[u][v]; the table is symmetric).
__constant__ int kTable[kFoot][kFoot] = {
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

struct Params {
  const uint32_t* words;  // every span: start | (end + 1) << 16, by item and row
  const int* cov_off;     // (n, kTileH + 1) row offsets into words, or null (interior mode)
  const int* cross_off;   // (n, kTileH + 1)
  const int* aa_off;      // (n, kPlaneH + 1), or null (interior mode)
  const int4* fills;      // (n) premultiplied r, g, b, a
  int* out;               // (nb, kTileH, kTileW)
  int n;
};

__device__ __forceinline__ int wrap(uint32_t v) { return static_cast<int>(v); }

__device__ __forceinline__ int div255(int i) {
  return wrap(static_cast<uint32_t>(i) + static_cast<uint32_t>(i >> 8) + 1u) >> 8;
}

__device__ __forceinline__ int dissolve(int c, int d) {
  return d == 0 ? 0 : d == 255 ? c : div255(wrap(static_cast<uint32_t>(c) * static_cast<uint32_t>(d)));
}

__device__ __forceinline__ uint32_t pack(int r, int g, int b, int a) {
  return static_cast<uint32_t>(r) | (static_cast<uint32_t>(g) << 8) | (static_cast<uint32_t>(b) << 16) |
         (static_cast<uint32_t>(a) << 24);
}

// One mask row, by one warp: the row's spans words[lo, hi) scattered as
// +1 / -1 into `diff` (the warp's zeroed row of counts), then `steps` words
// of the mask from column c0 (a multiple of 32) written to out[0, steps):
// bit b of word s says that the running count at column c0 + 32 s + b is
// positive.  Spans that end left of c0 only carry their count in; those
// past the last column are not read.  Leaves `diff` zeroed.
__device__ void scan_row(const uint32_t* __restrict__ words, int lo, int hi, int* diff, int c0, int steps,
                         uint32_t* out) {
  const int lane = threadIdx.x & 31;
  const int cend = c0 + 32 * steps;
  int carry = 0;
  for (int i = lo + lane; i < hi; i += 32) {
    const uint32_t w = words[i];
    const int s = static_cast<int>(w & 0xFFFFu), e = static_cast<int>(w >> 16);
    if (s < c0) {
      ++carry;
    } else if (s < cend) {
      atomicAdd(diff + (s - c0), 1);
    }
    if (e < c0) {
      --carry;
    } else if (e < cend) {
      atomicAdd(diff + (e - c0), -1);
    }
  }
  carry = __reduce_add_sync(kFull, carry);
  __syncwarp();
  for (int step = 0; step < steps; ++step) {
    int* d = diff + 32 * step + lane;
    int x = *d;
    *d = 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    x += carry;
    const uint32_t bits = __ballot_sync(kFull, x > 0);
    carry = __shfl_sync(kFull, x, 31);
    if (lane == 0) out[step] = bits;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1) tile_raster_kernel(Params p) {
  extern __shared__ int4 smem4[];
  int* diff = reinterpret_cast<int*>(smem4);
  uint32_t* tbits = reinterpret_cast<uint32_t*>(smem4) + kDiffBytes / 4;  // the band's t-rows
  uint32_t* cov = tbits + kBitsBytes / 4;                                  // (kTileH, kMaskWords)
  uint32_t* cross = cov + kTileH * kMaskWords;
  int* box = reinterpret_cast<int*>(cross + kTileH * kMaskWords);         // per band: y0, y1, x0, x1, fringe pixels
  unsigned char* opac = reinterpret_cast<unsigned char*>(box + kBands * 8);
  unsigned short* list = reinterpret_cast<unsigned short*>(opac + kOpacBytes);

  const int slot = blockIdx.x;
  uint4* out = reinterpret_cast<uint4*>(p.out + static_cast<long>(slot) * kTileH * kTileW);
  if (slot >= p.n) {  // a padding slot
    for (int q = threadIdx.x; q < kTileH * kTileW / 4; q += kThreads) out[q] = make_uint4(0, 0, 0, 0);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = threadIdx.x; q < kDiffBytes / 16; q += kThreads) smem4[q] = make_int4(0, 0, 0, 0);
  __syncthreads();
  int* my_diff = diff + warp * kDiffW;

  // The 1x coverage and crossing masks: 2 x 64 rows of 4 words.
  for (int r = warp; r < 2 * kTileH; r += kWarps) {
    const bool is_cov = r < kTileH;
    const int row = is_cov ? r : r - kTileH;
    const int* off = is_cov ? p.cov_off : p.cross_off;
    uint32_t* bits = (is_cov ? cov : cross) + row * kMaskWords;
    if (off == nullptr) {
      if (lane < kMaskWords) bits[lane] = 0;
      continue;
    }
    off += static_cast<long>(slot) * (kTileH + 1);
    scan_row(p.words, off[row], off[row + 1], my_diff, 0, kMaskWords, bits);
  }
  __syncthreads();

  // The AA opacity of every fringe pixel, band by band.
  if (p.aa_off != nullptr) {
    const int* aoff = p.aa_off + static_cast<long>(slot) * (kPlaneH + 1);
    for (int band = 0; band < kBands; ++band) {
      int* bb = box + band * 8;
      if (warp == 0) {  // the band's fringe bounding box
        int y0 = kTileH, y1 = -1, x0 = kTileW, x1 = -1;
        for (int k = lane; k < kBand * kMaskWords; k += 32) {
          const int y = band * kBand + k / kMaskWords, wi = k % kMaskWords;
          const uint32_t m = cov[y * kMaskWords + wi];
          if (m) {
            y0 = min(y0, y), y1 = max(y1, y);
            x0 = min(x0, 32 * wi + __ffs(m) - 1), x1 = max(x1, 32 * wi + 31 - __clz(m));
          }
        }
        y0 = __reduce_min_sync(kFull, y0), y1 = __reduce_max_sync(kFull, y1);
        x0 = __reduce_min_sync(kFull, x0), x1 = __reduce_max_sync(kFull, x1);
        if (lane == 0) {
          bb[0] = y0, bb[1] = y1, bb[2] = x0, bb[3] = x1;
          bb[4] = 0;
        }
      }
      __syncthreads();
      const int y0 = bb[0], y1 = bb[1], x0 = bb[2], x1 = bb[3];
      if (y1 < 0) continue;  // no fringe in the band (the same for every thread)
      const int r0 = kScale * y0, rows = kScale * (y1 - y0) + kFoot;
      const int c0 = (kScale * x0) & ~31;
      const int steps = (kScale * x1 + kFoot - c0 + 31) / 32;
      for (int t = warp; t < rows; t += kWarps) {
        scan_row(p.words, aoff[r0 + t], aoff[r0 + t + 1], my_diff, c0, steps, tbits + t * kRowWords);
      }
      const int bw = x1 - x0 + 1, npix = (y1 - y0 + 1) * bw;
      for (int q = threadIdx.x; q < npix; q += kThreads) {
        const int dy = q / bw, x = x0 + q % bw;
        if ((cov[(y0 + dy) * kMaskWords + (x >> 5)] >> (x & 31)) & 1u) {
          list[atomicAdd(bb + 4, 1)] = static_cast<unsigned short>(dy * kTileW + x);
        }
      }
      __syncthreads();
      const int listed = bb[4];
      for (int q = threadIdx.x; q < listed; q += kThreads) {
        const int e = list[q], dy = e / kTileW, x = e % kTileW;
        const int col = kScale * x - c0, sh = col & 31;
        const uint32_t* row = tbits + kScale * dy * kRowWords + (col >> 5);
        int count = 0;
        for (int v = 0; v < kFoot; ++v, row += kRowWords) {
          const uint32_t bits = sh ? __funnelshift_r(row[0], row[1], sh) : row[0];
#pragma unroll
          for (int u = 0; u < kFoot; ++u) count += static_cast<int>((bits >> u) & 1u) * kTable[v][u];
        }
        opac[(y0 + dy) * kTileW + x] = static_cast<unsigned char>((count * 256 + kVolume / 2) / kVolume);
      }
      __syncthreads();  // the next band's t-rows and list take these ones' place
    }
  }

  // The piece: 4 pixels a 16-byte store.
  const int4 f = p.fills[slot];
  const uint32_t solid = pack(f.x, f.y, f.z, f.w);
  for (int q = threadIdx.x; q < kTileH * kTileW / 4; q += kThreads) {
    const int y = q / (kTileW / 4), x = (q % (kTileW / 4)) * 4;
    const uint32_t cv = cov[y * kMaskWords + (x >> 5)] >> (x & 31);
    const uint32_t cr = cross[y * kMaskWords + (x >> 5)] >> (x & 31);
    uint32_t px[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t v = 0;
      if ((cv >> j) & 1u) {
        const int o = opac[y * kTileW + x + j];
        v = pack(dissolve(f.x, o), dissolve(f.y, o), dissolve(f.z, o), dissolve(f.w, o));
      } else if ((cr >> j) & 1u) {
        v = solid;
      }
      px[j] = v;
    }
    out[q] = make_uint4(px[0], px[1], px[2], px[3]);
  }
}

}  // namespace

// Launches one block a slot of the (nb, 64, 128) `out` on `stream` and
// returns the first error: the shared-memory attribute's (set per call: it
// belongs to the current device's context), else cudaGetLastError().
// Interior mode where cov_off and aa_off are null.
extern "C" int tile_raster(const void* words, const void* cov_off, const void* cross_off, const void* aa_off,
                           const void* fills, void* out, int n, int nb, void* stream) {
  const cudaError_t allowed =
      cudaFuncSetAttribute(tile_raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const Params p{static_cast<const uint32_t*>(words), static_cast<const int*>(cov_off),
                 static_cast<const int*>(cross_off), static_cast<const int*>(aa_off), static_cast<const int4*>(fills),
                 static_cast<int*>(out), n};
  tile_raster_kernel<<<nb, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

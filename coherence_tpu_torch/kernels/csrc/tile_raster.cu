// The tile rasterizer for Hopper (sm_90a): per-piece span lists to packed
// 64x128 atlas pieces with the Gaussian-matte antialiasing (TR1), every
// block of a build's flush in one launch.
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
// The function.  Item i writes its slot; a slot no item owns is zero.  An
// item has three span families, each span (row, start, end) with an
// inclusive end, over a plane of its own: the 1x coverage and crossing masks
// (64 x 128) and the 16x AA t-plane (1040 x 2064; pixel (y, x)'s footprint
// is its rows 16y..16y+31, columns 16x..16x+31).  A family's mask is
// _scatter_mask's: +1 at (row, start), -1 at (row, end + 1), a prefix sum
// along the row, > 0.  So a reversed, overlapping or empty span counts
// exactly as it does there: every row is built from its counts.  A span on
// a row outside its plane touches nothing (the scatter's mode="drop"); the
// host refuses a kept span whose columns leave 0..w.  Then
//   interior (cross & ~cov): the fill, packed;
//   fringe (cov):            pack(dissolve(fill, opacity)), opacity =
//                            (count * 256 + volume / 2) / volume, count the
//                            Gaussian table summed over the footprint's set
//                            samples, dissolve with the 0 / 255 early outs;
//   elsewhere:               0.
// An interior item has no coverage or AA family: the fill where the
// crossing mask holds.  The pack is the bare OR r | g << 8 | b << 16 |
// a << 24.  No float anywhere: the table is integers <= 255 and a count an
// exact int32 sum (at most 42,120).
//
// What bounds it: bytes at the program's shapes.  Its lists read once and
// its pieces written once; the AA count is 1024 multiply-adds a fringe pixel
// (an edge crosses a piece in a thin band, so fringe pixels are few).
//
// Design.  One launch covers a flush: a 256-thread block a unit (the host's
// unit table, kernels.tile_raster_lists), heaviest items first.  A unit is a
// band of 16 pixel rows of an edge item, a whole interior item, or a slot to
// zero.  A band needs only its own 16 coverage and crossing rows and its 272
// t-rows (256 b .. 256 b + 271; the last 16 are the next band's first), so
// the bands of an item run side by side, two blocks an SM (113 KB of shared
// memory each).  The spans arrive in the sweep's order, each item's families
// in one run (the host groups nothing): a unit bins the rows it needs itself
// by a counting sort in shared memory (a count per row, a scan, a scatter of
// each span's start and end + 1 into its row's bin), each thread loading
// kUnroll spans at once.  A band's t-rows are built only where a fringe
// pixel's footprint reads them, and only the words it reads (word j of a
// t-row is read by pixels 2j - 1, 2j and 2j + 1 of the two pixel rows over
// it).  The row builders, the fringe's words and the footprint count are
// span_rows.cuh's, shared with SR1 (sprite_raster.cu).  The last pass
// writes the unit's rows as 16-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "span_rows.cuh"

namespace {

constexpr int kTileH = 64;                          // an atlas piece
constexpr int kTileW = kStripW;
constexpr int kPlaneH = kScale * kTileH + kScale;   // 1040: kernels.AA_PLANE
constexpr int kBands = kTileH / kBand;              // kernels.TILE_BANDS
constexpr int kWhole = kBands;                      // a unit's mode: the whole piece, crossing spans only
static_assert(kScale * (kBands - 1) * kBand + kBandRows == kPlaneH, "the last band's t-rows end at the plane's");

// TR1's lists: a span's row and its packed columns, from two arrays.
struct Arrays {
  const int* rows;
  const int* cols;
  __device__ int row(int k) const { return rows[k]; }
  __device__ void load(int k, int& r, int& c) const { r = rows[k], c = cols[k]; }
};

struct Params {
  const int* rows;     // every span's row: the coverage family's items, then the crossing's, then the AA's
  const int* cols;     // every span's start | (end + 1) << 16
  const int* offsets;  // (3, n + 1): item i's spans of family f are [offsets[f][i], offsets[f][i + 1])
  const int4* fills;   // (n) premultiplied r, g, b, a
  const int2* units;   // one a block: (slot, item << 3 | mode), mode a band or kWhole; (slot, -1) zeroes the slot
  int* out;            // (slots, kTileH, kTileW)
  int n;
};

struct Smem {
  uint32_t tbits[kBandRows][kRowWords];  // the band's t-rows, only the words the footprints read
  RowSmem builder;                       // the row builders' bins, table and scan
  uint32_t masks[2 * kTileH][kMaskWords];  // the unit's coverage rows, then its crossing rows
  uint32_t need[kBand][3];              // per pixel row of a band: the 65-bit mask of the t-row words its footprints read
  uint8_t opac[kBand][kTileW];
  uint16_t fringe[kBand * kTileW];      // the band's fringe pixels, y * kTileW + x
  int listed;
};
static_assert(2 * (sizeof(Smem) + 1024) <= 233472, "two blocks share an SM's shared memory");

__device__ __forceinline__ uint32_t pack(int r, int g, int b, int a) {
  return static_cast<uint32_t>(r) | (static_cast<uint32_t>(g) << 8) | (static_cast<uint32_t>(b) << 16) |
         (static_cast<uint32_t>(a) << 24);
}

__global__ void __launch_bounds__(kThreads, 2) tile_raster_kernel(const Params p) {
  extern __shared__ int4 smem4[];
  Smem& s = *reinterpret_cast<Smem*>(smem4);
  const int2 unit = p.units[blockIdx.x];
  uint4* piece = reinterpret_cast<uint4*>(p.out + static_cast<long>(unit.x) * kTileH * kTileW);
  if (unit.y < 0) {  // a slot no item owns
    for (int q = threadIdx.x; q < kTileH * kTileW / 4; q += kThreads) piece[q] = make_uint4(0, 0, 0, 0);
    return;
  }
  const int item = unit.y >> 3, mode = unit.y & 7;
  const bool whole = mode == kWhole;
  const int y0 = whole ? 0 : kBand * mode, ny = whole ? kTileH : kBand;
  const int* cov_off = p.offsets;
  const int* cross_off = cov_off + (p.n + 1);
  const int* aa_off = cross_off + (p.n + 1);
  // The unit's list offsets and fill, loaded together.
  const int cov_lo = whole ? 0 : cov_off[item], cov_hi = whole ? 0 : cov_off[item + 1];
  const int cross_lo = cross_off[item], cross_hi = cross_off[item + 1];
  const int aa_lo = aa_off[item], aa_hi = aa_off[item + 1];
  const int4 f = p.fills[item];
  const Arrays src{p.rows, p.cols};
  uint32_t* cov = &s.masks[0][0];
  uint32_t* cross = cov + ny * kMaskWords;
  for (int q = threadIdx.x; q < kWarps * 32; q += kThreads) s.builder.win[q / 32][q % 32] = 0;

  // The unit's 1x rows: coverage (none in whole mode), then crossing.
  build_rows(s.builder, src, cov_lo, cov_hi, cross_lo, cross_hi, true, y0, ny, Need1x{}, cov, kMaskWords);

  if (!whole) {
    // The band's fringe pixels, and the t-row words their footprints read.
    fringe_of(cov, kBand, s.need, s.fringe, &s.listed);
    const int listed = s.listed;
    if (listed > 0) {
      nibble_table(s.builder);
      build_rows(s.builder, src, aa_lo, aa_hi, 0, 0, false, kScale * y0, kBandRows, NeedAA{&s.need[0][0]},
                 &s.tbits[0][0], kRowWords);
      footprint_opacity(s.builder, s.tbits, s.fringe, listed, s.opac);
    }
  }

  // The unit's rows: 4 pixels a 16-byte store.
  const uint32_t solid = pack(f.x, f.y, f.z, f.w);
  uint4* rows_out = piece + y0 * (kTileW / 4);
  for (int q = threadIdx.x; q < ny * (kTileW / 4); q += kThreads) {
    const int y = q / (kTileW / 4), x = (q % (kTileW / 4)) * 4;
    const uint32_t cv = whole ? 0u : cov[y * kMaskWords + (x >> 5)] >> (x & 31);
    const uint32_t cr = cross[y * kMaskWords + (x >> 5)] >> (x & 31);
    uint32_t px[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t v = 0;
      if ((cv >> j) & 1u) {
        const int o = s.opac[y][x + j];
        v = pack(dissolve(f.x, o), dissolve(f.y, o), dissolve(f.z, o), dissolve(f.w, o));
      } else if ((cr >> j) & 1u) {
        v = solid;
      }
      px[j] = v;
    }
    rows_out[q] = make_uint4(px[0], px[1], px[2], px[3]);
  }
}

// The attributes a launch needs, set per call (they belong to the current
// device's context): the shared memory of two blocks an SM.
cudaError_t allow() {
  const cudaError_t e =
      cudaFuncSetAttribute(tile_raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(tile_raster_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Launches one block a unit of the (slots, 64, 128) `out` on `stream` and
// returns the first error: the attributes', else cudaGetLastError().
extern "C" int tile_raster(const void* rows, const void* cols, const void* offsets, const void* fills,
                           const void* units, void* out, int n, int n_units, void* stream) {
  const cudaError_t allowed = allow();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const Params p{static_cast<const int*>(rows), static_cast<const int*>(cols), static_cast<const int*>(offsets),
                 static_cast<const int4*>(fills), static_cast<const int2*>(units), static_cast<int*>(out), n};
  tile_raster_kernel<<<n_units, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of TR1 that one SM holds at once, or minus the error.
extern "C" int tile_raster_blocks_per_sm() {
  const cudaError_t allowed = allow();
  if (allowed != cudaSuccess) return -static_cast<int>(allowed);
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tile_raster_kernel, kThreads,
                                                                      sizeof(Smem));
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

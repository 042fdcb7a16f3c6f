// The general renderer's sprite rasterizer for Hopper (sm_90a): span lists
// to each object's shape mask, minshape mask and RGBA raster, with the
// Gaussian-matte antialiasing (SR1), every member of a batched build in one
// launch; or one box's AA opacity alone.
//
// Replaces the XLA programs (not Pallas kernels) of the JAX package's
// batched sprite build and AA matte: coherence_tpu/scene/fastframe.py:170
// _build_group_kernel (a lax.map over one bucket group's sprites), and
// coherence_tpu/raster/aa.py:170 _coverage_counts_from_spans over :144
// coverage_counts_from_spans_impl and :93 _coverage_counts_jit (one
// polygon_sprite_edgelist's matte).  As eager torch every sub-batch of a
// group was three index_put_ scatters into difference planes, their prefix
// sums, a float32 table product, the wheres and three crops a member
// (scene/fastframe.py _raster_members), and every matte the same in row
// bands (raster/aa.py coverage_opacity_torch): the plain versions, bit for
// bit.
//
// The function.  Member m has a box of h x w pixels and three span
// families, each span (row, start, end + 1) relative to its plane: the 1x
// coverage and crossing masks (h x w; rows kept in 0..h-1, columns clipped
// to 0..w) and the 16x AA t-plane (16 h + 16 x 16 w + 16, origin at 16 y0 -
// 32, 16 x0 - 32; pixel (y, x)'s footprint is its rows 16y..16y+31, columns
// 16x..16x+31; rows kept in 0..16h+15, columns clipped to 0..16w+16).  The
// host does the clipping (kernels.sprite_raster_lists); a dropped row is
// 2^22 - 1, past every plane.  A family's mask is the scatter's running count > 0, so a
// reversed, overlapping or empty span counts as it does there
// (span_rows.cuh).  Then
//   shape mask:   cov | cross;
//   minshape:     cross & ~cov, where the RGBA is the fill;
//   fringe (cov): dissolve(fill, opacity), opacity = (count * 256 + volume
//                 / 2) / volume, count the Gaussian table summed over the
//                 footprint's set samples, dissolve with the 0 / 255 early
//                 outs;
//   elsewhere:    0.
// In opacity mode the box has only the AA family, and every pixel's
// opacity is written (int32).  No float anywhere.
//
// What bounds it: bytes.  Its lists read once (8 bytes a span) and its
// outputs written once (18 bytes a pixel: two mask bytes and int32 RGBA, 4
// in opacity mode); the AA count is 1024 multiply-adds a fringe pixel.
//
// Design: TR1's (tile_raster.cu), with a sprite's rows for a piece's.  One
// launch covers a build: a 256-thread block a unit (the host's unit table,
// the members with the most AA spans first), a unit a band of 16 pixel rows
// of a member cut into strips of 128 columns.  A strip's footprints read
// 2,064 t-columns, as a piece's do, so a unit is a TR1 band: it reads its
// member's spans (each one 8-byte load, its columns moved into the strip
// and clamped to it), bins the rows it needs, builds its 1x rows and the
// t-row words under its fringe pixels' footprints and counts each fringe
// pixel through the table's nibble sums (span_rows.cuh).  Every unit reads
// its member's whole lists: the cost grows with a member's bands times its
// spans, which row-sorted ranges per band would cut.  The last pass writes
// the unit's pixels, 16 bytes of RGBA a pixel.

#include <cstdint>
#include <cuda_runtime.h>

#include "span_rows.cuh"

namespace {

constexpr int kStripStep = kScale * kStripW;  // 2048: a strip's first t-column past the last strip's

// SR1's lists: each span one uint64, row << 42 | start << 21 | (end + 1),
// in its member's plane; its columns moved into the unit's strip (c0 its
// first column) and clamped to the strip's 0..cmax.
struct Packed {
  const uint2* spans;
  int c0, cmax;
  __device__ int row(int k) const { return static_cast<int>(spans[k].y >> 10); }
  __device__ void load(int k, int& r, int& c) const {
    const uint2 v = spans[k];
    r = static_cast<int>(v.y >> 10);
    const int a = static_cast<int>((v.x >> 21) | ((v.y & 0x3FFu) << 11)), b = static_cast<int>(v.x & 0x1FFFFFu);
    c = min(max(a - c0, 0), cmax) | (min(max(b - c0, 0), cmax) << 16);
  }
};

struct Params {
  const uint2* spans;   // every member's coverage spans, then every member's crossing spans, then the AA spans
  const int* offsets;   // (3, n + 1): member m's spans of family f are [offsets[f][m], offsets[f][m + 1])
  const int4* fills;    // (n) premultiplied r, g, b, a
  const int4* members;  // (n, 2): (h, w, mask, minmask), (rgba, 0, 0, 0): the outputs' offsets in 16-byte units
  const int4* units;    // one a block: (member, band, strip, 0)
  uint8_t* out;
  int n;
  int opacity;          // opacity mode: one member, its AA family only; its int32 opacity at its rgba offset
};

struct Smem {
  uint32_t tbits[kBandRows][kRowWords];  // the unit's t-rows, only the words the footprints read
  RowSmem builder;                       // the row builders' bins, table and scan
  uint32_t masks[2 * kBand][kMaskWords];  // the unit's coverage rows, then its crossing rows
  uint32_t need[kBand][3];              // per pixel row: the 65-bit mask of the t-row words its footprints read
  uint8_t opac[kBand][kStripW];
  uint16_t fringe[kBand * kStripW];     // the unit's fringe pixels, y * kStripW + x
  int listed;
};
static_assert(2 * (sizeof(Smem) + 1024) <= 233472, "two blocks share an SM's shared memory");

__device__ __forceinline__ bool bit(const uint32_t* rows, int y, int x) {
  return (rows[y * kMaskWords + (x >> 5)] >> (x & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads, 2) sprite_raster_kernel(const Params p) {
  extern __shared__ int4 smem4[];
  Smem& s = *reinterpret_cast<Smem*>(smem4);
  const int4 unit = p.units[blockIdx.x];
  const int m = unit.x;
  const int4 rec = p.members[2 * m], rec2 = p.members[2 * m + 1];
  const int h = rec.x, w = rec.y;
  const int y0 = kBand * unit.y, ny = min(kBand, h - y0);
  const int x0 = kStripW * unit.z, cw = min(kStripW, w - x0);
  const int* cov_off = p.offsets;
  const int* cross_off = cov_off + (p.n + 1);
  const int* aa_off = cross_off + (p.n + 1);
  uint32_t* cov = &s.masks[0][0];
  uint32_t* cross = cov + ny * kMaskWords;
  for (int q = threadIdx.x; q < kWarps * 32; q += kThreads) s.builder.win[q / 32][q % 32] = 0;

  if (!p.opacity) {
    // The unit's 1x rows, coverage then crossing, over the strip's columns.
    build_rows(s.builder, Packed{p.spans, x0, cw}, cov_off[m], cov_off[m + 1], cross_off[m], cross_off[m + 1], true,
               y0, ny, Need1x{}, cov, kMaskWords);
    fringe_of(cov, ny, s.need, s.fringe, &s.listed);
  } else {
    // Every pixel of the unit, and every word of its t-rows.
    if (threadIdx.x < kBand * 3) {
      const int y = threadIdx.x / 3, q = threadIdx.x % 3;
      s.need[y][q] = y < ny ? (q < 2 ? kFull : 1u) : 0u;
    }
    for (int q = threadIdx.x; q < ny * cw; q += kThreads) {
      s.fringe[q] = static_cast<uint16_t>((q / cw) * kStripW + q % cw);
    }
    if (threadIdx.x == 0) s.listed = ny * cw;
    __syncthreads();
  }
  const int listed = s.listed;
  if (listed > 0) {
    nibble_table(s.builder);
    const int t0 = kStripStep * unit.z;
    build_rows(s.builder, Packed{p.spans, t0, min(kStripT, kScale * w + kScale - t0)}, aa_off[m], aa_off[m + 1], 0, 0,
               false, kScale * y0, kScale * ny + kScale, NeedAA{&s.need[0][0]}, &s.tbits[0][0], kRowWords);
    footprint_opacity(s.builder, s.tbits, s.fringe, listed, s.opac);
  }

  // The unit's pixels, row by row of the member's planes.
  if (p.opacity) {
    int* opacity = reinterpret_cast<int*>(p.out + 16L * rec2.x);
    for (int q = threadIdx.x; q < ny * cw; q += kThreads) {
      const int y = q / cw, x = q % cw;
      opacity[static_cast<long>(y0 + y) * w + x0 + x] = s.opac[y][x];
    }
    return;
  }
  const int4 f = p.fills[m];
  uint8_t* mask = p.out + 16L * rec.z;
  uint8_t* minmask = p.out + 16L * rec.w;
  int4* rgba = reinterpret_cast<int4*>(p.out + 16L * rec2.x);
  for (int q = threadIdx.x; q < ny * cw; q += kThreads) {
    const int y = q / cw, x = q % cw;
    const bool cv = bit(cov, y, x), cr = bit(cross, y, x);
    const long at = static_cast<long>(y0 + y) * w + x0 + x;
    int4 v = make_int4(0, 0, 0, 0);
    if (cv) {
      const int o = s.opac[y][x];
      v = make_int4(dissolve(f.x, o), dissolve(f.y, o), dissolve(f.z, o), dissolve(f.w, o));
    } else if (cr) {
      v = f;
    }
    mask[at] = cv || cr;
    minmask[at] = cr && !cv;
    rgba[at] = v;
  }
}

// The attributes a launch needs, set per call (they belong to the current
// device's context): the shared memory of two blocks an SM.
cudaError_t allow() {
  const cudaError_t e =
      cudaFuncSetAttribute(sprite_raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(sprite_raster_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Launches one block a unit on `stream` and returns the first error: the
// attributes', else cudaGetLastError().
extern "C" int sprite_raster(const void* spans, const void* offsets, const void* fills, const void* members,
                             const void* units, void* out, int n, int n_units, int opacity, void* stream) {
  const cudaError_t allowed = allow();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const Params p{static_cast<const uint2*>(spans), static_cast<const int*>(offsets), static_cast<const int4*>(fills),
                 static_cast<const int4*>(members), static_cast<const int4*>(units), static_cast<uint8_t*>(out), n,
                 opacity};
  sprite_raster_kernel<<<n_units, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of SR1 that one SM holds at once, or minus the error.
extern "C" int sprite_raster_blocks_per_sm() {
  const cudaError_t allowed = allow();
  if (allowed != cudaSuccess) return -static_cast<int>(allowed);
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sprite_raster_kernel, kThreads,
                                                                      sizeof(Smem));
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

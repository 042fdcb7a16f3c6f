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
// coverage and crossing masks (h x w; columns clipped to 0..w) and the 16x
// AA t-plane (16 h + 16 x 16 w + 16, origin at 16 y0 - 32, 16 x0 - 32;
// pixel (y, x)'s footprint is its rows 16y..16y+31, columns 16x..16x+31;
// columns clipped to 0..16w+16).  The host does the clipping and drops the
// rows off the plane (kernels.sprite_raster_lists).  A family's mask is the
// scatter's running count > 0, so a reversed, overlapping or empty span
// counts as it does there (span_rows.cuh).  Then
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
// in opacity mode); the AA count is 1024 multiply-adds a fringe pixel, or a
// mixed pixel in opacity mode.
//
// Design: TR1's unit (tile_raster.cu), with a sprite's rows for a piece's.
// One launch covers a build: a 256-thread block a unit (the host's unit
// table, those that read the most spans first), a unit a band of 16 pixel
// rows of a member cut into strips of 128 columns; a strip's footprints
// read 2,064 t-columns, as a piece's do.  The host sorts each family of each
// member by 16-row groups (the native sprite_band_spans), so a band's spans
// are one range of its list: its 16 rows, or its 272 t-rows, which overlap
// the next band's first 16 (the first design read a member's whole lists in
// every unit: 12.7x the span reads at the lion's members).  A span keeps
// only its row's low 9 bits, which the unit completes from its band's first
// row, so a box's size is bounded by its columns alone (H61).  The split of
// the first design (profile_sprite.py) put its time in building rows, not
// in reading spans: a lane built a row, word by word, through every span of
// it.  Here a unit builds its rows in one pass over its range, a span a
// thread (union_rows): where no span is reversed, a running count is > 0
// exactly on the union of the spans, so each span ORs its partial end words
// in and marks the words it covers whole in its row's mask, which a last
// pass fills.  A range holding a reversed span is built again by its counts
// (span_rows.cuh's build_rows, bins and bit-sliced counts): the lion's
// sweeps make none.  Then its 1x rows give the fringe, the t-row words under the
// fringe pixels' footprints give each one's count through the table's
// nibble sums (span_rows.cuh).  In opacity mode a pixel whose footprint's
// samples are all clear writes 0, all set the full table's opacity (255,
// computed here from the table): the unit tells them from the AND and the
// OR of each 16-row group's words and counts only the mixed pixels, a few in
// a hundred of a real matte's (H63).  The last pass writes the unit's
// pixels, 16 bytes of RGBA a pixel.

#include <cstdint>
#include <cuda_runtime.h>

#include "span_rows.cuh"

namespace {

constexpr int kStripStep = kScale * kStripW;  // 2048: a strip's first t-column past the last strip's

// SR1's lists: each span one uint64, (row & 511) << 54 | start << 27 |
// (end + 1), in its member's plane; a unit's range holds only rows base ..
// base + 271 (base its band's first row in the plane), so a row is base +
// ((its 9 bits - base) mod 512), given to the builders counted from base.
// Its columns are moved into the unit's strip (c0 its first column) and
// clamped to the strip's 0..cmax.
struct BandSpans {
  const uint2* spans;
  int base, c0, cmax;
  __device__ int row(int k) const { return (static_cast<int>(spans[k].y >> 22) - base) & 511; }
  __device__ void load(int k, int& r, int& c) const {
    const uint2 v = spans[k];
    r = (static_cast<int>(v.y >> 22) - base) & 511;
    const int a = static_cast<int>((v.x >> 27) | ((v.y & 0x3FFFFFu) << 5)), b = static_cast<int>(v.x & 0x7FFFFFFu);
    c = min(max(a - c0, 0), cmax) | (min(max(b - c0, 0), cmax) << 16);
  }
};

struct Params {
  const uint2* spans;   // every member's coverage spans, then every member's crossing spans, then the AA spans
  const int4* bands;    // (bands, 2): (coverage lo, hi, crossing lo, hi), (AA lo, hi, 0, 0): a band's span ranges
  const int4* fills;    // (n) premultiplied r, g, b, a
  const int4* members;  // (n, 2): (h, w, mask, minmask), (rgba, 0, 0, 0): the outputs' offsets in 16-byte units
  const int4* units;    // one a block: (member, band, strip, its band's row of `bands`)
  uint8_t* out;
  int n;
  int opacity;          // opacity mode: one member, its AA family only; its int32 opacity at its rgba offset
};

struct Smem {
  uint32_t tbits[kBandRows][kRowWords];  // the unit's t-rows, only the words the footprints read
  RowSmem builder;                       // the row builders' bins, table and scan
  alignas(16) uint32_t masks[2 * kBand][kMaskWords];  // the unit's coverage rows, then its crossing rows
  uint32_t need[kBand][3];              // per pixel row: the 65-bit mask of the t-row words its footprints read
  uint8_t opac[kBand][kStripW];
  uint16_t fringe[kBand * kStripW];     // the unit's fringe pixels (opacity mode: mixed pixels), y * kStripW + x
  int reversed;                         // union_rows: a reversed span lies on a needed row
  int listed;
  int mixed;                            // opacity mode: the mixed pixels listed
  int full;                             // classify: the opacity of a footprint whose samples are all set
};
static_assert(2 * (sizeof(Smem) + 1024) <= 233472, "two blocks share an SM's shared memory");
static_assert(2 * (kBand + 1) * kRowWords * sizeof(uint32_t) <= sizeof(RowSmem::b), "classify's groups fit the bins");
static_assert(kBandRows * 3 * sizeof(uint32_t) <= sizeof(RowSmem::b), "union_rows' whole words fit the bins");

__device__ __forceinline__ bool bit(const uint32_t* rows, int y, int x) {
  return (rows[y * kMaskWords + (x >> 5)] >> (x & 31)) & 1u;
}

// The rows 0 .. nr - 1 of `src`'s spans [lo, hi) (and of [lo2, hi2) as rows
// nr .. 2 nr - 1) that `need` names any word of, into out[t * kWords + w]
// (kWords <= 96): the words of the first nt rows zeroed (nt * kWords a
// multiple of 4, `out` on 16 bytes), then one pass over the spans, a span a
// thread, each OR'ing its columns into its row: its first and last words by
// atomicOr where the span covers them in part, the words it covers whole as
// bits of its row's mask in `whole` (nt x 3 words of scratch), which a last
// pass, a row a thread, turns into full words.  Where no span is reversed
// (end + 1 < start in the strip), a row's running count is > 0 exactly on
// the union of its spans, so these are its words; a reversed span on a
// needed row sets *reversed, and the caller builds the rows again by their
// counts (build_rows).  Ends with the block synchronized.
template <int kWords, class Need>
__device__ void union_rows(const BandSpans& src, int lo, int hi, int lo2, int hi2, int nt, int nr, Need need,
                           uint32_t* out, uint32_t (*whole)[3], int* reversed) {
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (int q = threadIdx.x; q < nt * kWords / 4; q += kThreads) out4[q] = make_uint4(0u, 0u, 0u, 0u);
  for (int q = threadIdx.x; q < nt * 3; q += kThreads) whole[q / 3][q % 3] = 0;
  if (threadIdx.x == 0) *reversed = 0;
  __syncthreads();
  for_spans<true>(src, lo, hi, lo2, hi2, 0, nr, [&](int t, int c) {
    const int a = c & 0xFFFF, b = c >> 16;
    if (a >= b || !any(need(t))) {
      if (a > b && any(need(t))) *reversed = 1;
      return;
    }
    uint32_t* row = out + t * kWords;
    const int wa = a >> 5, wb = (b - 1) >> 5;
    if (wa == wb) {
      atomicOr(row + wa, run_bits(a & 31, b - 32 * wa));
      return;
    }
    int first = wa, last = wb;  // the words it covers whole
    if (a & 31) atomicOr(row + wa, run_bits(a & 31, 32)), ++first;
    if (b & 31) atomicOr(row + wb, run_bits(0, b & 31)), --last;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int u = max(first - 32 * q, 0), v = min(last + 1 - 32 * q, 32);
      if (u < v) atomicOr(&whole[t][q], run_bits(u, v));
    }
  });
  __syncthreads();
  for (int t = threadIdx.x; t < nt; t += kThreads) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      for (uint32_t m = whole[t][q]; m; m &= m - 1) out[t * kWords + 32 * q + __ffs(m) - 1] = kFull;
    }
  }
  __syncthreads();
}

// Opacity mode: each of the unit's ny x cw pixels whose footprint (t-rows
// 16 y .. 16 y + 31 of `tbits`, columns 16 x .. 16 x + 31) holds no set
// sample gets opacity 0, only set samples the full table's opacity (its sum
// read from the nibble sums of s.table, *full); the others are listed in
// `mixed` (y * kStripW + x), their count in *n_mixed (zero on entry).  First
// the AND and the OR of each 16-row group's words (`every`, `some`: (ny +
// 1) x kRowWords each), then a pixel's footprint is its two groups' word
// x / 2, or the halves of words x / 2 and x / 2 + 1 where x is odd.  Ends
// with the block synchronized.
__device__ void classify(const RowSmem& s, const uint32_t (*tbits)[kRowWords], int ny, int cw, int* full,
                         uint32_t* every, uint32_t* some, uint8_t (*opac)[kStripW], uint16_t* mixed, int* n_mixed) {
  if (threadIdx.x < kFoot) {
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kNibbles; ++k) sum += s.table[threadIdx.x][16 * k + 15];
    sum = __reduce_add_sync(kFull, sum);
    if (threadIdx.x == 0) *full = (sum * 256 + kVolume / 2) / kVolume;
  }
  for (int q = threadIdx.x; q < (ny + 1) * kRowWords; q += kThreads) {
    const int g = q / kRowWords, j = q % kRowWords;
    uint32_t all = kFull, one = 0;
#pragma unroll
    for (int r = 0; r < kScale; ++r) {
      const uint32_t v = tbits[kScale * g + r][j];
      all &= v, one |= v;
    }
    every[q] = all, some[q] = one;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kBand * kStripW; q += kThreads) {
    const int y = q / kStripW, x = q % kStripW, at = y * kRowWords + (x >> 1);
    if (y >= ny || x >= cw) continue;
    uint32_t all = every[at] & every[at + kRowWords], one = some[at] | some[at + kRowWords];
    if (x & 1) {
      all = __funnelshift_r(all, every[at + 1] & every[at + 1 + kRowWords], kScale);
      one = __funnelshift_r(one, some[at + 1] | some[at + 1 + kRowWords], kScale);
    }
    if (all == kFull) opac[y][x] = static_cast<uint8_t>(*full);
    else if (one == 0) opac[y][x] = 0;
    else mixed[atomicAdd(n_mixed, 1)] = static_cast<uint16_t>(q);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2) sprite_raster_kernel(const Params p) {
  extern __shared__ int4 smem4[];
  Smem& s = *reinterpret_cast<Smem*>(smem4);
  const int4 unit = p.units[blockIdx.x];
  const int m = unit.x;
  const int4 rec = p.members[2 * m], rec2 = p.members[2 * m + 1];
  const int4 rows1x = p.bands[2 * unit.w], rows_aa = p.bands[2 * unit.w + 1];
  const int h = rec.x, w = rec.y;
  const int y0 = kBand * unit.y, ny = min(kBand, h - y0);
  const int x0 = kStripW * unit.z, cw = min(kStripW, w - x0);
  uint32_t* cov = &s.masks[0][0];
  uint32_t* cross = cov + ny * kMaskWords;
  auto whole = reinterpret_cast<uint32_t (*)[3]>(&s.builder.b);  // union_rows' scratch: the bins, unused by it
  for (int q = threadIdx.x; q < kWarps * 32; q += kThreads) s.builder.win[q / 32][q % 32] = 0;

  if (!p.opacity) {
    // The unit's 1x rows, coverage then crossing, over the strip's columns.
    const BandSpans src{p.spans, y0, x0, cw};
    union_rows<kMaskWords>(src, rows1x.x, rows1x.y, rows1x.z, rows1x.w, 2 * ny, ny, Need1x{}, cov, whole, &s.reversed);
    if (s.reversed) {
      build_rows(s.builder, src, rows1x.x, rows1x.y, rows1x.z, rows1x.w, true, 0, ny, Need1x{}, cov, kMaskWords);
    }
    fringe_of(cov, ny, s.need, s.fringe, &s.listed);
  } else {
    // Every word of the unit's t-rows.
    if (threadIdx.x < kBand * 3) {
      const int y = threadIdx.x / 3, q = threadIdx.x % 3;
      s.need[y][q] = y < ny ? (q < 2 ? kFull : 1u) : 0u;
    }
    if (threadIdx.x == 0) s.listed = ny * cw, s.mixed = 0;
    __syncthreads();
  }
  const int listed = s.listed;
  if (listed > 0) {
    nibble_table(s.builder);
    const int t0 = kStripStep * unit.z, nt = kScale * ny + kScale;
    const BandSpans src{p.spans, kScale * y0, t0, min(kStripT, kScale * w + kScale - t0)};
    const NeedAA need{&s.need[0][0]};
    union_rows<kRowWords>(src, rows_aa.x, rows_aa.y, 0, 0, nt, nt, need, &s.tbits[0][0], whole, &s.reversed);
    if (s.reversed) {
      build_rows(s.builder, src, rows_aa.x, rows_aa.y, 0, 0, false, 0, nt, need, &s.tbits[0][0], kRowWords);
    }
    uint32_t* groups = reinterpret_cast<uint32_t*>(&s.builder.b);  // free once the rows are built
    if (p.opacity) classify(s.builder, s.tbits, ny, cw, &s.full, groups, groups + (kBand + 1) * kRowWords, s.opac,
                            s.fringe, &s.mixed);
    footprint_opacity(s.builder, s.tbits, s.fringe, p.opacity ? s.mixed : listed, s.opac);
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
extern "C" int sprite_raster(const void* spans, const void* bands, const void* fills, const void* members,
                             const void* units, void* out, int n, int n_units, int opacity, void* stream) {
  const cudaError_t allowed = allow();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const Params p{static_cast<const uint2*>(spans), static_cast<const int4*>(bands), static_cast<const int4*>(fills),
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

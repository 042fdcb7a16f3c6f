// The general renderer's region programs, for Hopper (sm_90a): CF1 `caf`,
// TB1 `tight_bounds` and MR1 `box_morph`.
//
// Each replaces an XLA program (not a Pallas kernel) of the JAX package that
// the port ran as a chain of eager torch launches:
//
//   CF1 caf          coherence_tpu/raster/region.py:611 _caf_kernel, with
//                    the four _window planes the port built in front of it
//                    (raster/region.py caf, _caf_planes: the plain version);
//   TB1 tight_bounds coherence_tpu/raster/region.py:459 _tight_bounds
//                    (raster/region.py _tight_bounds_torch);
//   MR1 box_morph    coherence_tpu/raster/region.py:690 _dilate and :715
//                    _erode_k over :665 _box_count (raster/region.py
//                    _box_count, bloat, erode).
//
// CF1.  One launch writes the union box's int32 RGBA (h, w, 4), its mask and
// the predicate plane f = (ma | mb) & (rgba.a == 255).  Each operand's mask
// and RGBA are read in place over the operand's own box at its offset in
// the union box, through their element strides (views of a canvas, expanded
// planes): outside an operand's box its mask reads False and its colour 0,
// as the plain version's zero-filled windows do.  The composed colour is the
// operator's where both masks are set, else the set operand's colour, else
// 0.  The four built-in operators are computed here exactly as
// colour.over_rgba, alpha_over_rgba, pd_plus_rgba and the `nocover` entry
// do, in int32 arithmetic that wraps (the plain version's `plus` has no
// clamp and its sums feed later `over`s): products and sums in unsigned
// form, arithmetic right shifts on the signed result.  Any other operator
// arrives as a given composed plane over the intersection of the two boxes
// (the wrapper computes it with the operator's torch function on the
// operands' views), read only where both masks are set.  With no output
// planes given it writes f alone (the one-operand caf).
//   Bound: bytes.  Each operand's 17 bytes a pixel read once, the result's
//   18 written once.  Design (the second): a thread a pixel.  A union box
//   of at most kernels.CAF_ONE_TRIP_PIXELS pixels (caf_kernel<true>, a
//   256-thread block 8 rows of 32) reads both masks and every operand's
//   colour over its box, each into a register of its own, none used before
//   all are issued: one round trip.  A larger box (caf_kernel<false>, a
//   128-thread block 128 pixels of a row) keeps the first design's two
//   rounds, the masks and then only the colours the result takes: there
//   the colours of unset pixels cost more bytes than the round trip saves,
//   and its 32 registers keep every thread slot of an SM filled.  Threads
//   of 2 or 4 pixels (32 apart, or 4 adjacent with 4-byte mask words and
//   ballot-packed stores) and one instantiation for both were each slower
//   at one or more of region_kernels' shapes (profile_region.py; PERF.md).
//
// TB1.  One launch reduces a bool mask (any strides) to (x0, y0, x1, y1) of
// its set cells, (w, h, -1, -1) where there is none.
//   Bound: bytes, the mask read once.  Design (the second; the first
//   design's thread walked the flattened mask a byte at a time, each load
//   feeding its fold before the next was issued, with a 64-bit division a
//   cell, and every launch folded its blocks through a fence, an atomic
//   ticket and the last block's second fold, even for one block): a warp
//   walks rows, indexed in 2D with no division.  Where the rows' cells are
//   adjacent (sx 1; the granule layout) a lane takes one 16-byte aligned
//   granule of its row a load: the nonzero bytes by __vcmpne4, the row's
//   first and last set column within the granule by __ffs and __clz.  A
//   granule holding a byte outside the mask's span (at most one at each
//   end) is read byte by byte, a byte a lane of block 0's first warp, so
//   that no load leaves the mask's bytes.  Other strides (the byte layout) take a cell a lane.  A
//   thread issues all kernels.TIGHT_BOUNDS_LOADS loads of a round into
//   registers before it uses any.  The route is chosen from the shape by
//   the wrapper (kernels.tight_bounds_route), each its own instantiation:
//   one block for a mask whose items fit one round of one block (no
//   partials, no fence, no ticket); past that blocks of one round each
//   with the first design's self-resetting ticket.  (A thread-block
//   cluster folding through distributed shared memory was slower than the
//   ticket at every mask it took: profile_region.py --routes.)  The result goes
//   to device memory, or straight to a pinned host word through its mapped
//   device address, so that the caller reads it after a stream
//   synchronize with no copy issued.

// MR1.  Bloat mode writes nbox's (H, W) = (h + 2ry, w + 2rx) mask: a cell is
// set where any cell of the source mask lies in its (2rx+1) x (2ry+1)
// window.  Erode mode writes the (h, w) mask of interior cells (their window
// inside the plane) whose window holds no unset cell.  Both are "any cell of
// a value v in a window of rows [Y+dy0, Y+dy1] and columns [X+dx0, X+dx1]",
// clipped to the source.
//   Bound: bytes, the mask read once and the output written once.  Design
//   (the second; the first design's block walked its rows and chunks as a
//   serial chain of a load, a scan and three barriers each): a 512-thread
//   block owns a 32 x 128 output tile and stages, in one round of loads,
//   every source row and column its windows reach (clipped to the source)
//   into shared memory as bit rows, 32 columns a word, of "cell == v": a
//   lane reads 4 cells (4 bytes in one load where the rows are contiguous
//   and aligned) and shuffles gather 8 lanes' nibbles into a word.  Row
//   pass: "a v in columns [a, b]" is a difference of prefix popcounts (each
//   row's exclusive scan of its words' popcounts, and __popc of the masked
//   last word), a lane a column and one ballot an output word.  Column
//   pass: a warp a column word, a lane an output row, the van Herk /
//   Gil-Werman scheme over blocks of 2ry + 1 rows (a segmented suffix OR
//   and a segmented prefix OR by shuffles): three ORs a cell whatever the
//   radius.  Then 4 bytes a lane out.  Where the tile's reach does not fit
//   kernels.MORPH_SMEM bytes, the wrapper takes the second route: the same
//   kernel as a row pass over 32 (or 1) source rows a block into a bit
//   plane in device memory, then box_morph_cols_kernel, a warp a column
//   word and a block of 2ry + 1 rows, van Herk in device memory with the
//   lanes on 32 rows at a time.  Each source row is staged (32 + 2ry) / 32
//   times (the first design read it (8 + 2ry) / 8 times).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// CF1 caf
// ---------------------------------------------------------------------------

// A block's pixels, a thread each: one round trip takes 8 rows of 32 (more
// blocks, fewer bytes each), two rounds 1 row of 128 (as the first design).
template <bool kOneTrip>
struct CafTile {
  static constexpr int kThreads = kOneTrip ? 256 : 128;
  static constexpr int kCols = kOneTrip ? 32 : 128;
  static constexpr int kRows = kThreads / kCols;
};
constexpr int kCafRowTilesMax = 65535;              // gridDim.y

enum CafOp { kOver = 0, kAlphaOver = 1, kPlus = 2, kNocover = 3, kGiven = 4 };

struct Plane {
  const unsigned char* mask;  // bool (h, w), or null (the composed plane)
  const int* rgba;            // int32 (h, w, 4)
  long long msy, msx;         // mask element strides
  long long rsy, rsx, rsc;    // rgba element strides
  int y0, x0, h, w;           // its box in the union box's coordinates; h 0: absent
  int vec;                    // rgba rows on 16 bytes with adjacent channels: one int4 load a pixel
};

struct CafParams {
  Plane a, b, c;  // c: the given composed plane over the intersection
  int op;
  int h, w;
  int4* out_rgba;            // null: f alone
  unsigned char* out_mask;   // null with out_rgba
  unsigned char* out_f;
};

__device__ __forceinline__ bool covers(const Plane& q, int y, int x) {
  return y >= q.y0 && y < q.y0 + q.h && x >= q.x0 && x < q.x0 + q.w;
}

// Plane q's colour at union (y, x), which lies in its box.
__device__ __forceinline__ int4 colour_at(const Plane& q, int y, int x) {
  const int* p = q.rgba + (y - q.y0) * q.rsy + (x - q.x0) * q.rsx;
  return q.vec ? *reinterpret_cast<const int4*>(p) : make_int4(p[0], p[q.rsc], p[2 * q.rsc], p[3 * q.rsc]);
}

__device__ __forceinline__ unsigned u(int v) { return static_cast<unsigned>(v); }

// colour.prelerp_arr(p, q, a) in int32 that wraps: p + q - (((t >> 8) + t) >> 8), t = a * p + 128.
__device__ __forceinline__ int prelerp(int p, int q, int a) {
  const int t = static_cast<int>(u(a) * u(p) + 128u);
  const int s = static_cast<int>(u(t >> 8) + u(t));
  return static_cast<int>(u(p) + u(q) - u(s >> 8));
}

__device__ __forceinline__ int4 compose(int op, int4 a, int4 b) {
  switch (op) {
    case kOver:
      if (a.w == 0) return b;
      if (a.w == 255) return a;
      return make_int4(prelerp(b.x, a.x, a.w), prelerp(b.y, a.y, a.w), prelerp(b.z, a.z, a.w),
                       prelerp(b.w, a.w, a.w));
    case kAlphaOver:
      if (a.w == 0) return b;
      if (a.w == 255) return a;
      return make_int4(0, 0, 0, prelerp(b.w, a.w, a.w));
    case kPlus:
      return make_int4(static_cast<int>(u(a.x) + u(b.x)), static_cast<int>(u(a.y) + u(b.y)),
                       static_cast<int>(u(a.z) + u(b.z)), static_cast<int>(u(a.w) + u(b.w)));
    default:  // kNocover
      return b;
  }
}

template <bool kOneTrip>
__global__ void __launch_bounds__(CafTile<kOneTrip>::kThreads) caf_kernel(CafParams p) {
  using T = CafTile<kOneTrip>;
  const int x = blockIdx.x * T::kCols + threadIdx.x % T::kCols;
  if (x >= p.w) return;
  const bool given = p.op == kGiven;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int y = blockIdx.y * T::kRows + threadIdx.x / T::kCols; y < p.h; y += gridDim.y * T::kRows) {
    bool sa, sb;
    int4 out;
    if constexpr (kOneTrip) {
      // Both masks and every colour over its box, each into a register of
      // its own, none used before all are issued: one round trip.
      const bool in_a = covers(p.a, y, x), in_b = covers(p.b, y, x), in_c = covers(p.c, y, x);
      const unsigned char ra = in_a ? p.a.mask[(y - p.a.y0) * p.a.msy + (x - p.a.x0) * p.a.msx] : 0;
      const unsigned char rb = in_b ? p.b.mask[(y - p.b.y0) * p.b.msy + (x - p.b.x0) * p.b.msx] : 0;
      const int4 ca = in_a ? colour_at(p.a, y, x) : zero, cb = in_b ? colour_at(p.b, y, x) : zero;
      const int4 cc = in_c ? colour_at(p.c, y, x) : zero;
      sa = ra != 0, sb = rb != 0;
      out = sa && sb ? (given ? cc : compose(p.op, ca, cb)) : sa ? ca : sb ? cb : zero;
    } else {
      // The masks, then only the colours the result takes.
      sa = covers(p.a, y, x) && p.a.mask[(y - p.a.y0) * p.a.msy + (x - p.a.x0) * p.a.msx] != 0;
      sb = covers(p.b, y, x) && p.b.mask[(y - p.b.y0) * p.b.msy + (x - p.b.x0) * p.b.msx] != 0;
      out = zero;
      if (sa && sb) {
        out = given ? colour_at(p.c, y, x) : compose(p.op, colour_at(p.a, y, x), colour_at(p.b, y, x));
      } else if (sa) {
        out = colour_at(p.a, y, x);
      } else if (sb) {
        out = colour_at(p.b, y, x);
      }
    }
    const long long i = static_cast<long long>(y) * p.w + x;
    p.out_f[i] = (sa || sb) && out.w == 255;
    if (p.out_rgba != nullptr) {
      p.out_rgba[i] = out;
      p.out_mask[i] = sa || sb;
    }
  }
}

template <bool kOneTrip>
int launch_caf(const CafParams& p, cudaStream_t stream) {
  using T = CafTile<kOneTrip>;
  const long long row_tiles = (p.h + T::kRows - 1LL) / T::kRows;
  const dim3 grid(static_cast<unsigned>((p.w + T::kCols - 1LL) / T::kCols),
                  static_cast<unsigned>(row_tiles < kCafRowTilesMax ? row_tiles : kCafRowTilesMax));
  caf_kernel<kOneTrip><<<grid, T::kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// TB1 tight_bounds
// ---------------------------------------------------------------------------

constexpr int kTbThreads = 256;
constexpr int kTbWarps = kTbThreads / 32;
constexpr int kTbLoads = 8;        // loads a thread issues before it uses any (kernels.TIGHT_BOUNDS_LOADS);
                                   // 16 made a longer code path and were slower (profile_region.py)
constexpr int kTbMaxBlocks = 528;  // the ticket route's partials: four blocks an SM of 132
                                   // (kernels.TIGHT_BOUNDS_MAX_BLOCKS)

enum TbLayout { kTbGranules = 0, kTbBytes = 1 };
enum TbRoute { kTbOne = 0, kTbTicket = 1 };

struct TbParams {
  const unsigned char* mask;  // cell (y, x) at mask + y sy + x sx
  long long sy, sx;           // the granule layout: sx 1 and sy >= w (h 1: sy = w)
  int h, w;
  int segs;                   // a row's warp segments, 32 units (granules or cells) each
  int rows;                   // rows a block walks
  int* scratch;               // the ticket route's partials, then its ticket
  int* out;                   // (x0, y0, x1, y1): device memory or a mapped host word
};

struct Bounds {
  int x0, y0, x1, y1;
};

__device__ __forceinline__ Bounds fold(Bounds a, const Bounds& b) {
  return {min(a.x0, b.x0), min(a.y0, b.y0), max(a.x1, b.x1), max(a.y1, b.y1)};
}

// The block's fold of each thread's `mine`, in thread 0.
__device__ Bounds block_fold(Bounds mine, Bounds (&warps)[kTbWarps]) {
  const unsigned all = 0xffffffffu;
  mine = {__reduce_min_sync(all, mine.x0), __reduce_min_sync(all, mine.y0), __reduce_max_sync(all, mine.x1),
          __reduce_max_sync(all, mine.y1)};
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warps[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kTbWarps; ++k) mine = fold(mine, warps[k]);
  }
  return mine;
}

// Bit b set where byte b of v is nonzero (b < 4): __vcmpne4's 0xff bytes'
// top bits gathered into bits 28-31 by one multiply.
__device__ __forceinline__ unsigned nonzero4(unsigned v) {
  return ((__vcmpne4(v, 0u) & 0x80808080u) * 0x00204081u) >> 28;
}

__device__ __forceinline__ unsigned nonzero16(uint4 v) {
  return nonzero4(v.x) | nonzero4(v.y) << 4 | nonzero4(v.z) << 8 | nonzero4(v.w) << 12;
}

// A warp's walk: warp `warp` takes rows y0 + warp, y0 + warp + kTbWarps,
// ... below y1, each row's segs segments in turn, a lane a unit of each.
__device__ __forceinline__ void next_item(int& y, int& s, int segs) {
  if (++s == segs) s = 0, y += kTbWarps;
}

template <int kLayout>
struct TbUnit {
  using T = typename std::conditional<kLayout == kTbGranules, uint4, unsigned>::type;
};

// The unit of item (y, s) at `lane`: in the granule layout the 16-byte
// aligned granule 32 s + lane of row y's (from the granule holding its
// first cell), zero past the row and where it holds a byte outside the
// mask's span [lo, hi) (an edge granule, read by edge_bounds); in the byte
// layout the cell at column 32 s + lane, zero past the row.
template <int kLayout>
__device__ __forceinline__ typename TbUnit<kLayout>::T load_unit(const TbParams& p, int y, int s, int lane,
                                                                 uintptr_t lo, uintptr_t hi) {
  if constexpr (kLayout == kTbGranules) {
    const uintptr_t row = lo + static_cast<uintptr_t>(y) * p.sy;
    const uintptr_t a = (row & ~static_cast<uintptr_t>(15)) + 16u * static_cast<unsigned>(32 * s + lane);
    return a >= lo && a + 16 <= hi && a < row + p.w ? __ldg(reinterpret_cast<const uint4*>(a)) : make_uint4(0, 0, 0, 0);
  } else {
    const int x = 32 * s + lane;
    return x < p.w ? static_cast<unsigned>(__ldg(p.mask + y * p.sy + x * p.sx)) : 0u;
  }
}

// Folds the set cells of item (y, s)'s unit `v` at `lane` into `mine`.
template <int kLayout>
__device__ __forceinline__ void take_unit(Bounds& mine, const TbParams& p, int y, int s, int lane, uintptr_t lo,
                                          typename TbUnit<kLayout>::T v) {
  if constexpr (kLayout == kTbGranules) {
    const long long row = static_cast<long long>(y) * p.sy;  // the row's first byte, from lo
    const long long first = static_cast<long long>(((lo + row) & ~static_cast<uintptr_t>(15)) - lo);
    const long long a = first + 16LL * (32 * s + lane);  // the granule, from lo
    const int b0 = static_cast<int>(min(max(row - a, 0LL), 16LL));
    const int b1 = static_cast<int>(min(max(row + p.w - a, 0LL), 16LL));
    const unsigned bits = nonzero16(v) & ((1u << b1) - 1u) & ~((1u << b0) - 1u);
    if (bits != 0) {
      const int x = static_cast<int>(a - row);
      mine = fold(mine, {x + __ffs(bits) - 1, y, x + 31 - __clz(bits), y});
    }
  } else {
    if (v != 0) mine = fold(mine, {32 * s + lane, y, 32 * s + lane, y});
  }
}

// The granule layout's edge granules, those holding a byte of [lo, hi)
// and one outside (at most two: one at each end; `hi` where there is
// none).  They are read byte by byte, lane b of warp 0 of block 0 taking
// byte b of each: a set byte's (y, x) from its offset, and a byte of a
// row's gap (x >= w) is not a cell.
__device__ __forceinline__ void edge_granules(uintptr_t lo, uintptr_t hi, uintptr_t& g0, uintptr_t& g1) {
  const uintptr_t first = lo & ~static_cast<uintptr_t>(15), last = (hi - 1) & ~static_cast<uintptr_t>(15);
  const bool first_edge = first != lo || first + 16 > hi, last_edge = last != first && last + 16 > hi;
  g0 = first_edge ? first : last_edge ? last : hi;
  g1 = first_edge && last_edge ? last : hi;
}

__device__ __forceinline__ unsigned char edge_byte(uintptr_t a, uintptr_t lo, uintptr_t hi) {
  return a >= lo && a < hi ? __ldg(reinterpret_cast<const unsigned char*>(a)) : 0;
}

__device__ __forceinline__ void take_edge_byte(Bounds& mine, const TbParams& p, uintptr_t a, uintptr_t lo,
                                               unsigned char v) {
  if (v == 0) return;
  const long long off = static_cast<long long>(a - lo), y = off / p.sy, x = off - y * p.sy;
  if (x < p.w) mine = fold(mine, {static_cast<int>(x), static_cast<int>(y), static_cast<int>(x), static_cast<int>(y)});
}

// The block's rows' bounds in each thread's `mine`: rounds of kTbLoads
// items a thread, every load of a round issued into registers before any
// is used (a warp issues in order: a load whose value the next instruction
// takes would hold back every later load), then folded.  Block 0's first
// 16 threads also read the granule layout's edge granules, their loads
// issued before the first round's.
template <int kLayout>
__device__ Bounds walk(const TbParams& p) {
  using Unit = typename TbUnit<kLayout>::T;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(p.mask);
  const uintptr_t hi = lo + static_cast<uintptr_t>(p.h - 1) * p.sy + p.w;
  const int y_end = min(p.h, (static_cast<int>(blockIdx.x) + 1) * p.rows);
  Bounds mine = {p.w, p.h, -1, -1};
  int y = static_cast<int>(blockIdx.x) * p.rows + warp, s = 0;
  // The edge granules' bytes, a lane each, issued before the walk's loads.
  const bool edges = kLayout == kTbGranules && blockIdx.x == 0 && threadIdx.x < 16;
  uintptr_t g0 = hi, g1 = hi;
  unsigned char e0 = 0, e1 = 0;
  if (edges) {
    edge_granules(lo, hi, g0, g1);
    g0 += threadIdx.x, g1 += threadIdx.x;
    e0 = edge_byte(g0, lo, hi), e1 = edge_byte(g1, lo, hi);
  }
  do {
    const int y_round = y, s_round = s;
    Unit v[kTbLoads];
#pragma unroll
    for (int j = 0; j < kTbLoads; ++j) {
      v[j] = y < y_end ? load_unit<kLayout>(p, y, s, lane, lo, hi) : Unit{};
      next_item(y, s, p.segs);
    }
    y = y_round, s = s_round;
#pragma unroll
    for (int j = 0; j < kTbLoads; ++j) {
      if (y < y_end) take_unit<kLayout>(mine, p, y, s, lane, lo, v[j]);
      next_item(y, s, p.segs);
    }
  } while (y < y_end);
  if (edges) {
    take_edge_byte(mine, p, g0, lo, e0);
    take_edge_byte(mine, p, g1, lo, e1);
  }
  return mine;
}

__device__ __forceinline__ void write_bounds(int* out, const Bounds& b) {
  *reinterpret_cast<int4*>(out) = make_int4(b.x0, b.y0, b.x1, b.y1);
}

// kTbOne: one block walks the mask and writes the result: no partials, no
// fence, no ticket.  kTbTicket: any number of blocks, each writing its
// partial to `scratch`; the last to finish (an atomic ticket behind a
// fence) folds them, writes the result and resets the ticket to 0 for the
// next launch.
template <int kLayout, int kRoute>
__global__ void __launch_bounds__(kTbThreads) tight_bounds_kernel(TbParams p) {
  __shared__ Bounds warps[kTbWarps];
  if constexpr (kRoute == kTbOne) {
    const Bounds mine = block_fold(walk<kLayout>(p), warps);
    if (threadIdx.x == 0) write_bounds(p.out, mine);
  } else {
    __shared__ bool last;
    const Bounds mine = block_fold(walk<kLayout>(p), warps);
    unsigned* ticket = reinterpret_cast<unsigned*>(p.scratch + 4 * kTbMaxBlocks);
    if (threadIdx.x == 0) {
      reinterpret_cast<int4*>(p.scratch)[blockIdx.x] = make_int4(mine.x0, mine.y0, mine.x1, mine.y1);
      __threadfence();
      last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    Bounds all = {p.w, p.h, -1, -1};
    for (int k = threadIdx.x; k < gridDim.x; k += kTbThreads) {
      const int4 q = __ldcg(reinterpret_cast<const int4*>(p.scratch) + k);
      all = fold(all, {q.x, q.y, q.z, q.w});
    }
    __syncthreads();  // warps[] is read again
    all = block_fold(all, warps);
    if (threadIdx.x == 0) {
      write_bounds(p.out, all);
      *ticket = 0u;
    }
  }
}

template <int kLayout, int kRoute>
int launch_tight_bounds(const TbParams& p, int blocks, cudaStream_t stream) {
  tight_bounds_kernel<kLayout, kRoute><<<blocks, kTbThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// MR1 box_morph
// ---------------------------------------------------------------------------

constexpr int kMorphThreads = 512;
constexpr int kMorphWarps = kMorphThreads / 32;
constexpr int kMorphRows = 32;                 // output rows a tile: a lane each in the column pass
constexpr int kMorphCols = 128;                // output columns a tile
constexpr int kMorphWords = kMorphCols / 32;   // output words a tile row: a warp each in the column pass
constexpr int kMorphBatch = 4;                 // staged items a warp loads before it packs any
constexpr int kMorphTilesMax = 65535;          // gridDim.y
constexpr int kMorphSmemMax = 232448;          // a block's shared memory on sm_90 (kernels.MORPH_SMEM_MAX)
constexpr int kMorphColsWarps = 4;              // warps a block of the second route's column pass
constexpr unsigned kAll = 0xffffffffu;

struct MorphParams {
  const unsigned char* src;  // bool (h, w)
  long long sy, sx;
  int h, w;
  unsigned char* out;        // bool (H, W), contiguous; null: the second route's row pass into `words`
  unsigned* words;           // the second route's bit plane (h, ww): bit X % 32 of word X / 32
  unsigned* scratch;         // the column pass's prefixes (H, ww)
  int H, W, ww;
  long long dx0, dx1, dy0, dy1;  // the window of output (Y, X) in source coordinates
  int erode;                 // look for unset cells; keep interior cells whose window holds none
  long long rx, ry;
  int vec;                   // source rows contiguous on 4 bytes: 4 bytes a lane
  int wvec;                  // W % 4 == 0 and `out` on 4 bytes: 4 output bytes a store
  int tile_rows;             // output rows a tile: kMorphRows, or 1 (a row pass too wide for 32 rows)
  int rows_cap;              // source rows a tile stages, at most: min(tile_rows + dy1 - dy0, h)
  int sw;                    // staged words a row
};

// Bits [lo, hi) of a word, 0 <= lo, hi <= 32.
__device__ __forceinline__ unsigned bit_range(long long lo, long long hi) {
  const unsigned below_hi = hi >= 32 ? kAll : (1u << hi) - 1u, below_lo = lo >= 32 ? kAll : (1u << lo) - 1u;
  return hi > lo ? below_hi & ~below_lo : 0u;
}

// Erode's interior: bits e of columns X + e, e < n, whose window lies inside the plane, at row Y.
__device__ __forceinline__ unsigned interior(const MorphParams& p, long long Y, long long X, int n) {
  if (Y < p.ry || Y >= p.h - p.ry) return 0u;
  const long long lo = min(max(p.rx - X, 0LL), static_cast<long long>(n));
  const long long hi = min(max(p.w - p.rx - X, 0LL), static_cast<long long>(n));
  return bit_range(lo, hi);
}

// 4 bits as 4 bool bytes.
__device__ __forceinline__ unsigned bytes_of(unsigned nib) {
  return (nib & 1u) | (nib & 2u) << 7 | (nib & 4u) << 14 | (nib & 8u) << 21;
}

// Stages source rows first .. first + held - 1, columns sb .. sb + 32 sw - 1,
// into `bits` as rows of sw words of "cell == want" (0 outside the source).
// An item is 4 words of a row: lane l reads the 4 cells from column sb +
// 128 g + 4 l (one 4-byte load with p.vec where they lie in the source,
// else 4 byte loads), makes their nibble, and the 8 nibbles of a word are
// ORed by shuffles.  A warp issues the loads of kMorphBatch items before it
// packs any: at the general renderer's radii, two rounds of loads a block
// (batches of 8 and 16 took more registers and were slower; the kernel is
// held to 64 registers, two blocks an SM).
__device__ __forceinline__ void stage(const MorphParams& p, unsigned* bits, int held, long long first, long long sb,
                                      bool want, int lane, int warp) {
  const int sw = p.sw, groups = (sw + 3) / 4, items = held * groups;
  for (int base = warp; base < items; base += kMorphWarps * kMorphBatch) {
    unsigned raw[kMorphBatch];
#pragma unroll
    for (int b = 0; b < kMorphBatch; ++b) {
      const int it = base + b * kMorphWarps;
      const long long c = sb + 128LL * (it % groups) + 4 * lane;
      const unsigned char* row = p.src + (first + it / groups) * p.sy;
      raw[b] = 0;
      if (it < items) {
        if (p.vec && c + 4 <= p.w) {
          raw[b] = *reinterpret_cast<const unsigned*>(row + c);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e < p.w) raw[b] |= static_cast<unsigned>(row[(c + e) * p.sx]) << (8 * e);
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kMorphBatch; ++b) {
      const int it = base + b * kMorphWarps;
      if (it >= items) break;
      const long long c = sb + 128LL * (it % groups) + 4 * lane;
      unsigned nib = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e < p.w && (((raw[b] >> (8 * e)) & 0xffu) != 0) == want) nib |= 1u << e;
      }
      unsigned v = nib << (4 * (lane % 8));
      v |= __shfl_xor_sync(kAll, v, 1);
      v |= __shfl_xor_sync(kAll, v, 2);
      v |= __shfl_xor_sync(kAll, v, 4);
      const int k = (it % groups) * 4 + lane / 8;
      if (lane % 8 == 0 && k < sw) bits[(it / groups) * sw + k] = v;
    }
  }
}

// Shared memory: bits[rows_cap][sw] (the staged rows), pre[rows_cap][sw]
// (each word's count of set bits before it in its row), rowp[rows_cap][4]
// (the row pass), tile[32][4] (the output words).
__global__ void __launch_bounds__(kMorphThreads, 2) box_morph_kernel(MorphParams p) {
  extern __shared__ unsigned morph_smem[];
  const int sw = p.sw;
  unsigned* bits = morph_smem;
  unsigned* pre = bits + p.rows_cap * sw;
  unsigned* rowp = pre + p.rows_cap * sw;
  unsigned* tile = rowp + p.rows_cap * kMorphWords;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool want = !p.erode;  // the value looked for
  const long long X0 = static_cast<long long>(blockIdx.x) * kMorphCols;
  // The source columns the tile's windows reach, clipped to the source, are
  // staged from sb, a multiple of 32.  In the row pass warp w takes output
  // word j = w % 4 of every fourth staged row: its lane's window, [X + dx0,
  // X + dx1] for X = X0 + 32 j + lane, in staged bits [a, b), clamped to
  // the staged words (outside them the source holds none).
  const long long sb = max(X0 + p.dx0, 0LL) & ~31LL, q_max = 32LL * (sw - 1);
  const int j = warp % kMorphWords;
  const long long X = X0 + 32 * j + lane;
  const int a = static_cast<int>(min(max(X + p.dx0 - sb, 0LL), q_max));
  const int b = static_cast<int>(min(max(X + p.dx1 + 1 - sb, 0LL), q_max));
  const unsigned below_a = (1u << (a & 31)) - 1u, below_b = (1u << (b & 31)) - 1u;
  // The column pass in 32-bit arithmetic: Ly < 2^31 (the output's rows).
  const unsigned Ly = static_cast<unsigned>(p.dy1 - p.dy0), n = Ly + 1;
  const unsigned i = lane, end_i = i - i % n + n - 1, end_31 = 31 - 31 % n + n - 1, before = (Ly + i) % n;
  for (long long Y0 = static_cast<long long>(blockIdx.y) * p.tile_rows; Y0 < p.H;
       Y0 += static_cast<long long>(gridDim.y) * p.tile_rows) {
    // Window row s of the tile (s in [0, tile_rows + Ly)) is source row r0 + s;
    // those inside the source, [lo, hi], are staged.
    const long long r0 = Y0 + p.dy0;
    const long long lo = max(0LL, -r0), hi = min(p.tile_rows + static_cast<long long>(Ly) - 1, p.h - 1 - r0);
    const int held = hi >= lo ? static_cast<int>(hi - lo + 1) : 0;
    stage(p, bits, held, r0 + lo, sb, want, lane, warp);
    __syncthreads();
    for (int r = threadIdx.x; r < held; r += kMorphThreads) {
      unsigned count = 0;
      for (int k = 0; k < sw; ++k) {
        pre[r * sw + k] = count;
        count += __popc(bits[r * sw + k]);
      }
    }
    __syncthreads();
    // Row pass: "a v in the window" is a difference of the counts of set bits before its ends.
    for (int r = warp / kMorphWords; r < held; r += kMorphWarps / kMorphWords) {
      const unsigned* br = bits + r * sw;
      const unsigned* pr = pre + r * sw;
      const unsigned before_b = pr[b >> 5] + __popc(br[b >> 5] & below_b);
      const unsigned before_a = pr[a >> 5] + __popc(br[a >> 5] & below_a);
      const unsigned word = __ballot_sync(kAll, before_b > before_a);
      if (lane == 0) rowp[r * kMorphWords + j] = word;
    }
    __syncthreads();
    // Column pass, van Herk / Gil-Werman: warp j takes column word j, lane i
    // output row i, whose window is rows [i, i + Ly] = the suffix of i's
    // block of n rows (from i to the block's end) and the prefix of the next
    // block (up to i + Ly).  Both are segmented scans across lanes; rows of
    // lane 31's block past row 31 are ORed in by the whole warp.
    if (warp < kMorphWords) {
      const auto row = [&](long long s) { return s >= lo && s <= hi ? rowp[(s - lo) * kMorphWords + warp] : 0u; };
      unsigned suffix = row(i);
#pragma unroll
      for (unsigned d = 1; d < 32; d *= 2) {
        const unsigned t = __shfl_down_sync(kAll, suffix, d);
        if (i + d < 32 && i + d <= end_i) suffix |= t;
      }
      unsigned rest = 0;
      for (long long s = max(32LL, lo) + i; s <= min(static_cast<long long>(end_31), hi); s += 32) {
        rest |= rowp[(s - lo) * kMorphWords + warp];
      }
      rest = __reduce_or_sync(kAll, rest);
      if (end_i == end_31) suffix |= rest;
      unsigned prefix = row(static_cast<long long>(Ly) + i);
#pragma unroll
      for (unsigned d = 1; d < 32; d *= 2) {
        const unsigned t = __shfl_up_sync(kAll, prefix, d);
        if (i >= d && d <= before) prefix |= t;
      }
      const unsigned v = i % n == 0 ? suffix : suffix | prefix;
      if (p.out != nullptr) {
        tile[i * kMorphWords + warp] = v;
      } else if (i < static_cast<unsigned>(p.tile_rows) && Y0 + i < p.H && X0 / 32 + warp < p.ww) {
        p.words[(Y0 + i) * p.ww + X0 / 32 + warp] = v;
      }
    }
    __syncthreads();
    if (p.out == nullptr) continue;
    // 4 output bytes a lane, a warp a row.
    for (int y = warp; y < kMorphRows; y += kMorphWarps) {
      const long long Y = Y0 + y, Xo = X0 + 4 * lane;
      if (Y >= p.H || Xo >= p.W) continue;
      unsigned nib = (tile[y * kMorphWords + lane / 8] >> (4 * (lane % 8))) & 0xfu;
      if (p.erode) nib = ~nib & interior(p, Y, Xo, 4);
      unsigned char* o = p.out + Y * p.W + Xo;
      if (p.wvec && Xo + 4 <= p.W) {
        *reinterpret_cast<unsigned*>(o) = bytes_of(nib);
      } else {
        for (int e = 0; Xo + e < p.W && e < 4; ++e) o[e] = (nib >> e) & 1u;
      }
    }
  }
}

// The second route's column pass over the row pass's bit plane: warp (c,
// b) takes column word c and the output rows Y = b n + t, t < n, whose
// windows start in van Herk block b of window rows (source row Y + dy0).
// Its lanes take 32 rows at a time: block b + 1's prefixes by an OR scan
// across lanes with the chunk before's carry, into `scratch`; then block
// b's suffixes from its end, each output row's the OR of the two.  O(1) a
// cell whatever the radius.
__global__ void __launch_bounds__(kMorphColsWarps * 32) box_morph_cols_kernel(MorphParams p) {
  const unsigned* __restrict__ words = p.words;
  unsigned* __restrict__ scratch = p.scratch;
  unsigned char* __restrict__ out = p.out;
  const long long n = p.dy1 - p.dy0 + 1, blocks = (p.H + n - 1) / n;
  const long long id = static_cast<long long>(blockIdx.x) * kMorphColsWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (id >= blocks * p.ww) return;
  const int c = static_cast<int>(id % p.ww);
  const long long Yb = id / p.ww * n, s0 = Yb + p.dy0;  // the block's first output row, its window's first row
  const auto row = [&](long long s) { return s >= 0 && s < p.h ? words[s * p.ww + c] : 0u; };
  // 4 chunks of 32 rows a lane's loads in flight before the scans use them.
  unsigned carry = 0;
  for (long long t0 = 1; t0 < n && Yb + t0 < p.H; t0 += 4 * 32) {
    unsigned v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long t = t0 + 32 * q + lane;  // output row Yb + t: the prefix of rows s0 + n .. s0 + n + t - 1
      v[q] = t < n ? row(s0 + n + t - 1) : 0u;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long t = t0 + 32 * q + lane;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const unsigned o = __shfl_up_sync(kAll, v[q], d);
        if (lane >= d) v[q] |= o;
      }
      v[q] |= carry;
      if (t < n && Yb + t < p.H) scratch[(Yb + t) * p.ww + c] = v[q];
      carry = __shfl_sync(kAll, v[q], 31);
    }
  }
  __syncwarp();
  const long long X = 32LL * c;
  carry = 0;
  for (long long t1 = n - 1; t1 >= 0; t1 -= 4 * 32) {
    unsigned v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long t = t1 - 32 * q - lane;  // output row Yb + t: the suffix of rows s0 + t .. s0 + n - 1
      v[q] = t >= 0 ? row(s0 + t) : 0u;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const unsigned o = __shfl_up_sync(kAll, v[q], d);
        if (lane >= d) v[q] |= o;
      }
      v[q] |= carry;
      carry = __shfl_sync(kAll, v[q], 31);
      const long long t = t1 - 32 * q - lane, Y = Yb + t;
      if (t < 0 || Y >= p.H) continue;
      unsigned w = t > 0 ? v[q] | scratch[Y * p.ww + c] : v[q];
      if (p.erode) w = ~w & interior(p, Y, X, 32);
      unsigned char* o = out + Y * p.W + X;
      if (p.wvec && X + 32 <= p.W) {
#pragma unroll
        for (int e = 0; e < 8; ++e) reinterpret_cast<unsigned*>(o)[e] = bytes_of((w >> (4 * e)) & 0xfu);
      } else {
        for (int e = 0; X + e < p.W && e < 32; ++e) o[e] = (w >> e) & 1u;
      }
    }
  }
}

MorphParams morph_params(const long long* geom, const void* src, void* out, void* words, void* scratch) {
  MorphParams p;
  p.src = static_cast<const unsigned char*>(src);
  p.h = static_cast<int>(geom[0]);
  p.w = static_cast<int>(geom[1]);
  p.sy = geom[2];
  p.sx = geom[3];
  p.H = static_cast<int>(geom[4]);
  p.W = static_cast<int>(geom[5]);
  p.dx0 = geom[6];
  p.dx1 = geom[7];
  p.dy0 = geom[8];
  p.dy1 = geom[9];
  p.erode = static_cast<int>(geom[10]);
  p.rx = geom[11];
  p.ry = geom[12];
  p.vec = static_cast<int>(geom[13]);
  p.tile_rows = static_cast<int>(geom[14]);
  p.rows_cap = static_cast<int>(geom[15]);
  p.sw = static_cast<int>(geom[16]);
  p.ww = static_cast<int>(geom[17]);
  p.out = static_cast<unsigned char*>(out);
  p.words = static_cast<unsigned*>(words);
  p.scratch = static_cast<unsigned*>(scratch);
  p.wvec = p.W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  return p;
}

// Lets box_morph_kernel take up to kMorphSmemMax bytes of dynamic shared
// memory on the current device (by default 48 KB), once a device.
constexpr int kMaxDevices = 64;

cudaError_t allow_morph_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess || (device < kMaxDevices && done[device].load(std::memory_order_acquire))) return rc;
  rc = cudaFuncSetAttribute(box_morph_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMorphSmemMax);
  if (rc == cudaSuccess && device < kMaxDevices) done[device].store(true, std::memory_order_release);
  return rc;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError().
//
// caf: geom holds h, w, op, one_trip, then for each of a, b and the composed
// plane c (y0, x0, h, w, msy, msx, rsy, rsx, rsc, vec); a plane of height 0
// is absent.  out_rgba and out_mask null: f alone.
extern "C" int caf(const long long* geom, const void* ma, const void* ra, const void* mb, const void* rb,
                   const void* rc, void* out_rgba, void* out_mask, void* out_f, void* stream) {
  CafParams p;
  p.h = static_cast<int>(geom[0]);
  p.w = static_cast<int>(geom[1]);
  p.op = static_cast<int>(geom[2]);
  Plane* planes[3] = {&p.a, &p.b, &p.c};
  const void* masks[3] = {ma, mb, nullptr};
  const void* colours[3] = {ra, rb, rc};
  for (int k = 0; k < 3; ++k) {
    const long long* g = geom + 4 + 10 * k;
    Plane& q = *planes[k];
    q.mask = static_cast<const unsigned char*>(masks[k]);
    q.rgba = static_cast<const int*>(colours[k]);
    q.y0 = static_cast<int>(g[0]);
    q.x0 = static_cast<int>(g[1]);
    q.h = static_cast<int>(g[2]);
    q.w = static_cast<int>(g[3]);
    q.msy = g[4];
    q.msx = g[5];
    q.rsy = g[6];
    q.rsx = g[7];
    q.rsc = g[8];
    q.vec = static_cast<int>(g[9]);
  }
  p.out_rgba = static_cast<int4*>(out_rgba);
  p.out_mask = static_cast<unsigned char*>(out_mask);
  p.out_f = static_cast<unsigned char*>(out_f);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return geom[3] ? launch_caf<true>(p, st) : launch_caf<false>(p, st);
}

// tight_bounds: geom holds h, w, sy, sx, layout (0 granules, 1 bytes),
// route (0 one block, 1 the ticket), segs, rows, blocks
// (kernels.tight_bounds_route).  `scratch` (the ticket route's) holds 4 *
// kTbMaxBlocks + 1 int32, the last (the ticket) 0 before the first launch;
// each launch leaves it 0.  `out`: 4 int32 in device memory, or a mapped
// host word's device address.
extern "C" int tight_bounds(const long long* geom, const void* mask, void* scratch, void* out, void* stream) {
  TbParams p;
  p.mask = static_cast<const unsigned char*>(mask);
  p.h = static_cast<int>(geom[0]);
  p.w = static_cast<int>(geom[1]);
  p.sy = geom[2];
  p.sx = geom[3];
  p.segs = static_cast<int>(geom[6]);
  p.rows = static_cast<int>(geom[7]);
  p.scratch = static_cast<int*>(scratch);
  p.out = static_cast<int*>(out);
  const int layout = static_cast<int>(geom[4]), route = static_cast<int>(geom[5]);
  const long long blocks = geom[8];
  const bool layout_ok = layout == kTbBytes || (layout == kTbGranules && p.sx == 1 && p.sy >= p.w);
  if (!layout_ok || (route != kTbOne && route != kTbTicket) || blocks < 1 ||
      blocks > (route == kTbOne ? 1 : kTbMaxBlocks) || p.segs < 1 || p.rows < 1 || blocks * p.rows < p.h ||
      (route == kTbTicket && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(blocks);
  if (layout == kTbGranules) {
    return route == kTbOne ? launch_tight_bounds<kTbGranules, kTbOne>(p, n, st)
                           : launch_tight_bounds<kTbGranules, kTbTicket>(p, n, st);
  }
  return route == kTbOne ? launch_tight_bounds<kTbBytes, kTbOne>(p, n, st)
                         : launch_tight_bounds<kTbBytes, kTbTicket>(p, n, st);
}

// The device address of the pinned host word `host` (cudaHostGetDevicePointer).
extern "C" int mapped_pointer(void* host, void** device) {
  return static_cast<int>(cudaHostGetDevicePointer(device, host, 0));
}

// box_morph: geom holds h, w, sy, sx, H, W, dx0, dx1, dy0, dy1, erode, rx,
// ry, vec, tile_rows, rows_cap, sw, ww; `smem` the launch's dynamic shared
// memory.  With `out`: the staged route's one launch into the bool (H, W)
// `out`; else the second route's row pass into the (H, ww) bit plane
// `words` (H = h, dy0 = dy1 = 0).
extern "C" int box_morph(const long long* geom, const void* src, void* out, void* words, int smem, void* stream) {
  const MorphParams p = morph_params(geom, src, out, words, nullptr);
  if (smem < 0 || smem > kMorphSmemMax || p.tile_rows < 1 || p.tile_rows > kMorphRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t rc = allow_morph_smem();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const long long tiles = (p.H + p.tile_rows - 1LL) / p.tile_rows;
  const dim3 grid(static_cast<unsigned>((p.W + kMorphCols - 1LL) / kMorphCols),
                  static_cast<unsigned>(tiles < kMorphTilesMax ? tiles : kMorphTilesMax));
  box_morph_kernel<<<grid, kMorphThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// box_morph_cols: the second route's column pass, geom as box_morph's with
// the output's H and window rows, from the bit plane `words` through the
// (H, ww) `scratch` into the bool (H, W) `out`.
extern "C" int box_morph_cols(const long long* geom, const void* words, void* scratch, void* out, void* stream) {
  MorphParams p = morph_params(geom, nullptr, out, const_cast<void*>(words), scratch);
  const long long n = p.dy1 - p.dy0 + 1, warps = (p.H + n - 1) / n * p.ww;
  const long long blocks = (warps + kMorphColsWarps - 1) / kMorphColsWarps;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  box_morph_cols_kernel<<<static_cast<unsigned>(blocks), kMorphColsWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

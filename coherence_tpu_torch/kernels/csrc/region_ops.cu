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
// the predicate plane f = (ma | mb) & (rgba.a == 255), a thread a pixel.
// Each operand's mask and RGBA are read in place over the operand's own box
// at its offset in the union box, through their element strides (views of
// a canvas, expanded planes): outside an operand's box its mask reads False
// and its colour 0, as the plain version's zero-filled windows do.  The
// composed colour is the operator's where both masks are set, else the set
// operand's colour, else 0.  The four built-in operators are computed here
// exactly as colour.over_rgba, alpha_over_rgba, pd_plus_rgba and the
// `nocover` entry do, in int32 arithmetic that wraps (the plain version's
// `plus` has no clamp and its sums feed later `over`s): products and sums in
// unsigned form, arithmetic right shifts on the signed result.  Any other
// operator arrives as a given composed plane over the intersection of the two
// boxes (the wrapper computes it with the operator's torch function on the
// operands' views), read only where both masks are set.  With no output
// planes given it writes f alone (the one-operand caf).
//   Bound: bytes.  Each operand's 17 bytes a pixel read once, the result's
//   18 written once.  Design: a warp's lanes on adjacent pixels of a row, a
//   16-byte load of an operand's pixel where its layout allows it (channels
//   adjacent, rows on 16 bytes), a 16-byte store of the result; rows in a
//   grid-stride loop over gridDim.y.
//
// TB1.  One launch reduces a bool mask (any strides) to (x0, y0, x1, y1) of
// its set cells, (w, h, -1, -1) where there is none.  A thread walks the
// flattened mask in a grid-stride loop and keeps its own extremes; a block
// folds its threads' by warp reductions and shared memory and writes its
// partial; the last block to finish (an atomic ticket behind a fence) folds
// every block's partial, writes the result and resets the ticket to 0 for
// the next launch, so that no memset is launched.  The partials and the
// ticket live in a scratch buffer the wrapper keeps per device and stream.
//   Bound: bytes, the mask read once.  A call is one launch and the 16-byte
//   readback that follows it.
//
// MR1.  Bloat mode writes nbox's (H, W) = (h + 2ry, w + 2rx) mask: a cell is
// set where any cell of the source mask lies in its (2rx+1) x (2ry+1)
// window.  Erode mode writes the (h, w) mask of interior cells (their window
// inside the plane) whose window holds no unset cell.  Both are "any cell of
// a value v in a window of rows [Y+dy0, Y+dy1] and columns [X+dx0, X+dx1]",
// clipped to the source.  A 128-thread block owns an 8 x 128 output tile and
// walks, top to bottom, the source rows its windows reach; for each row it
// scans the source columns its windows reach, left to right in chunks of
// 128 with a carry, as an inclusive max-scan of "last column holding v"
// (L); a window [a, b] of that row holds v exactly where L(b) >= a.  Each
// thread carries, down its column, the last source row whose row window
// held v, and sets its output rows' bits as their windows' last rows pass.
// Any radius runs in the same shared memory, up to and past the box's size.
//   Bound: bytes, the mask read once and the output written once.  The
//   block's walk reads each source row once per tile row it serves, (8 +
//   2ry) / 8 times in all, from L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// CF1 caf
// ---------------------------------------------------------------------------

constexpr int kCafThreads = 128;
constexpr int kCafRowsMax = 65535;  // gridDim.y

enum CafOp { kOver = 0, kAlphaOver = 1, kPlus = 2, kNocover = 3, kGiven = 4 };

struct Plane {
  const unsigned char* mask;  // bool (h, w), or null (the composed plane)
  const int* rgba;            // int32 (h, w, 4)
  long long msy, msx;         // mask element strides
  long long rsy, rsx, rsc;    // rgba element strides
  int y0, x0, h, w;           // its box in the union box's coordinates
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

__device__ __forceinline__ bool covers(const Plane& p, int y, int x) {
  return y >= p.y0 && y < p.y0 + p.h && x >= p.x0 && x < p.x0 + p.w;
}

__device__ __forceinline__ bool mask_at(const Plane& p, int y, int x) {
  return covers(p, y, x) && p.mask[(y - p.y0) * p.msy + (x - p.x0) * p.msx] != 0;
}

__device__ __forceinline__ int4 rgba_at(const Plane& p, int y, int x) {
  const int* q = p.rgba + (y - p.y0) * p.rsy + (x - p.x0) * p.rsx;
  if (p.vec) return *reinterpret_cast<const int4*>(q);
  return make_int4(q[0], q[p.rsc], q[2 * p.rsc], q[3 * p.rsc]);
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

__global__ void __launch_bounds__(kCafThreads) caf_kernel(CafParams p) {
  const int x = blockIdx.x * kCafThreads + threadIdx.x;
  if (x >= p.w) return;
  for (int y = blockIdx.y; y < p.h; y += gridDim.y) {
    const bool ma = mask_at(p.a, y, x), mb = mask_at(p.b, y, x);
    int4 out = make_int4(0, 0, 0, 0);
    if (ma && mb) {
      out = p.op == kGiven ? rgba_at(p.c, y, x) : compose(p.op, rgba_at(p.a, y, x), rgba_at(p.b, y, x));
    } else if (ma) {
      out = rgba_at(p.a, y, x);
    } else if (mb) {
      out = rgba_at(p.b, y, x);
    }
    const long long i = static_cast<long long>(y) * p.w + x;
    p.out_f[i] = (ma || mb) && out.w == 255;
    if (p.out_rgba != nullptr) {
      p.out_rgba[i] = out;
      p.out_mask[i] = ma || mb;
    }
  }
}

// ---------------------------------------------------------------------------
// TB1 tight_bounds
// ---------------------------------------------------------------------------

constexpr int kTbThreads = 256;
constexpr int kTbWarps = kTbThreads / 32;
constexpr int kTbMaxBlocks = 528;  // four blocks an SM of 132; the scratch's partials

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

// scratch: kTbMaxBlocks partials (x0, y0, x1, y1), then the ticket.
__global__ void __launch_bounds__(kTbThreads)
tight_bounds_kernel(const unsigned char* __restrict__ mask, long long sy, long long sx, int h, int w,
                    int* scratch, int* __restrict__ out) {
  __shared__ Bounds warps[kTbWarps];
  __shared__ bool last;
  Bounds mine = {w, h, -1, -1};
  const long long n = static_cast<long long>(h) * w;
  for (long long i = static_cast<long long>(blockIdx.x) * kTbThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kTbThreads) {
    const int y = static_cast<int>(i / w), x = static_cast<int>(i - static_cast<long long>(y) * w);
    if (mask[y * sy + x * sx] != 0) mine = fold(mine, {x, y, x, y});
  }
  mine = block_fold(mine, warps);
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + 4 * kTbMaxBlocks);
  if (threadIdx.x == 0) {
    reinterpret_cast<int4*>(scratch)[blockIdx.x] = make_int4(mine.x0, mine.y0, mine.x1, mine.y1);
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  Bounds all = {w, h, -1, -1};
  for (int k = threadIdx.x; k < gridDim.x; k += kTbThreads) {
    const int4 q = __ldcg(reinterpret_cast<const int4*>(scratch) + k);
    all = fold(all, {q.x, q.y, q.z, q.w});
  }
  __syncthreads();  // warps[] is read again
  all = block_fold(all, warps);
  if (threadIdx.x == 0) {
    *reinterpret_cast<int4*>(out) = make_int4(all.x0, all.y0, all.x1, all.y1);
    *ticket = 0u;
  }
}

// ---------------------------------------------------------------------------
// MR1 box_morph
// ---------------------------------------------------------------------------

constexpr int kMorphCols = 128;  // threads a block, output columns a tile, source columns a chunk
constexpr int kMorphRows = 8;    // output rows a tile (bits of a thread's word)
constexpr int kMorphWarps = kMorphCols / 32;
constexpr int kMorphRowsMax = 65535;  // gridDim.y

struct MorphParams {
  const unsigned char* src;  // bool (h, w)
  long long sy, sx;
  int h, w;
  unsigned char* out;        // bool (H, W), contiguous
  int H, W;
  long long dx0, dx1, dy0, dy1;  // the window of output (Y, X) in source coordinates
  int erode;                 // look for unset cells; keep interior cells whose window holds none
  long long rx, ry;
};

__global__ void __launch_bounds__(kMorphCols) box_morph_kernel(MorphParams p) {
  __shared__ int last_col[kMorphCols];
  __shared__ int warp_max[kMorphWarps];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const long long X0 = static_cast<long long>(blockIdx.x) * kMorphCols, Y0 = static_cast<long long>(blockIdx.y) * kMorphRows;
  const long long X = X0 + t;
  // The source columns the tile's windows reach, and this column's window in
  // them, relative to s0: [a, b], b < 0 where the window misses the plane.
  const long long s0 = max(0LL, X0 + p.dx0);
  const long long s_end = min(static_cast<long long>(p.w) - 1, X0 + kMorphCols - 1 + p.dx1);
  const long long a = max(X + p.dx0, s0) - s0;
  const long long b = min(X + p.dx1, static_cast<long long>(p.w) - 1) - s0;
  const long long ys = max(0LL, Y0 + p.dy0), ye = min(static_cast<long long>(p.h) - 1, Y0 + kMorphRows - 1 + p.dy1);
  const bool want = !p.erode;  // the value looked for
  long long last_row = -1;     // the last source row whose row window held it, down this column
  unsigned bits = 0;           // output rows of the tile whose window held it
  for (long long y = ys; y <= ye; ++y) {
    bool held = false;
    int carry = -1;
    for (long long cs = 0; cs <= s_end - s0; cs += kMorphCols) {
      const long long c = cs + t;
      int v = -1;
      if (c <= s_end - s0 && (p.src[y * p.sy + (c + s0) * p.sx] != 0) == want) v = static_cast<int>(c);
      // Inclusive max-scan over the block, on top of the carry.
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int o = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v = max(v, o);
      }
      if (lane == 31) warp_max[warp] = v;
      __syncthreads();
      for (int k = 0; k < warp; ++k) v = max(v, warp_max[k]);
      v = max(v, carry);
      last_col[t] = v;
      __syncthreads();
      if (b >= cs && b < cs + kMorphCols && b >= a) held = last_col[b - cs] >= a;
      carry = last_col[kMorphCols - 1];
      __syncthreads();
    }
    if (held) last_row = y;
    // Output rows whose window's (clipped) last row is y.
    const long long first = max(Y0, y - p.dy1);
    const long long final_ = min(Y0 + kMorphRows - 1, y == p.h - 1 ? Y0 + kMorphRows - 1 : y - p.dy1);
    for (long long Y = first; Y <= final_; ++Y) {
      if (last_row >= max(Y + p.dy0, ys)) bits |= 1u << (Y - Y0);
    }
  }
  if (X >= p.W) return;
  for (int k = 0; k < kMorphRows && Y0 + k < p.H; ++k) {
    const long long Y = Y0 + k;
    bool v = (bits >> k) & 1u;
    if (p.erode) v = !v && Y >= p.ry && Y < p.h - p.ry && X >= p.rx && X < p.w - p.rx;
    p.out[Y * p.W + X] = v;
  }
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError().
//
// caf: geom holds h, w, op, then for each of a, b and the composed plane c
// (y0, x0, h, w, msy, msx, rsy, rsx, rsc, vec); a plane of height 0 is
// absent.  out_rgba and out_mask null: f alone.
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
    const long long* g = geom + 3 + 10 * k;
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
  const dim3 grid((p.w + kCafThreads - 1) / kCafThreads, p.h < kCafRowsMax ? p.h : kCafRowsMax);
  caf_kernel<<<grid, kCafThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// tight_bounds: `scratch` holds 4 * tight_bounds_max_blocks() + 1 int32, the
// last (the ticket) 0 before the first launch; each launch leaves it 0.
extern "C" int tight_bounds(const void* mask, long long sy, long long sx, int h, int w, int blocks, void* scratch,
                            void* out, void* stream) {
  tight_bounds_kernel<<<blocks, kTbThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), sy, sx, h, w, static_cast<int*>(scratch), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tight_bounds_max_blocks() { return kTbMaxBlocks; }

// box_morph: geom holds h, w, sy, sx, H, W, dx0, dx1, dy0, dy1, erode, rx, ry.
extern "C" int box_morph(const long long* geom, const void* src, void* out, void* stream) {
  MorphParams p;
  p.src = static_cast<const unsigned char*>(src);
  p.h = static_cast<int>(geom[0]);
  p.w = static_cast<int>(geom[1]);
  p.sy = geom[2];
  p.sx = geom[3];
  p.out = static_cast<unsigned char*>(out);
  p.H = static_cast<int>(geom[4]);
  p.W = static_cast<int>(geom[5]);
  p.dx0 = geom[6];
  p.dx1 = geom[7];
  p.dy0 = geom[8];
  p.dy1 = geom[9];
  p.erode = static_cast<int>(geom[10]);
  p.rx = geom[11];
  p.ry = geom[12];
  const dim3 grid((p.W + kMorphCols - 1) / kMorphCols, (p.H + kMorphRows - 1) / kMorphRows);
  if (grid.y > kMorphRowsMax) return static_cast<int>(cudaErrorInvalidValue);
  box_morph_kernel<<<grid, kMorphCols, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

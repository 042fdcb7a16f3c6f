// The brush stamp walk for Hopper (sm_90a): Gaussian brush strokes
// alpha_over-stamped into alpha planes (plane mode) or, for one group of
// the batched brush-tile build, straight into the group's packed 64x128
// atlas pieces with each stroke's shape mask and fill (piece mode).
//
// Replaces the XLA programs (not Pallas kernels) of the JAX package:
//   plane mode <- coherence_tpu/raster/brush.py:182 _stamp_scan_alpha (the
//                 general renderer's sprite_of_brushstroke);
//   piece mode <- coherence_tpu/raster/brush_tiles.py:62 _brush_group_kernel.
// As eager torch each is about ten launches a stamp index
// (raster/brush.py _stamp_alpha_torch, raster/brush_tiles.py
// BrushTileBuild._group_block_torch: the plain versions, bit for bit).
//
// The function.  Stroke s stamps its brush patch (a (kh, kw) byte plane,
// the nonzero extent of its (bhb, bwb) patch, at (ky0, kx0) inside it) at
// each of its stamp records (oy, ox), the patch's top-left corner in plane
// coordinates, in record order.  A pixel under texel t takes
//   t == 0: unchanged;  t == 255: 255;  else prelerp(p, t, t) =
//   p + t - (((a >> 8) + a) >> 8) with a = t * p + 128 (colour.py:287),
// so each pixel's value is a fold over the stamps that cover it, in stamp
// order, independent of every other pixel.  An invalid stamp is a record
// far outside every tile (kernels.pack_brush_records).
//   plane mode writes the (s, hp, wp) int32 alpha planes;
//   piece mode writes piece j of the group's (pieces, 64, 128) block from
//     meta[j] = (stroke, row, col): the 64x128 window of that stroke's
//     plane at (row, col), where each pixel is
//       mask ? pack(dissolve(fill, alpha)) : 0,
//     mask: a stamp point (py, px) of the stroke with |y - py| <= hr and
//     |x - px| <= wr (region._box_count(points plane, wr, hr) > 0; a
//     dropped point is far outside), dissolve with the 0 / 255 early outs
//     and div255(i) = (i + (i >> 8) + 1) >> 8, pack the bare OR
//     r | g << 8 | b << 16 | a << 24.
//
// What bounds it: bytes at the brushes the program uses.  Its output
// written once (4 bytes a plane pixel or piece pixel) and its lists read
// once; the stamp-pixel updates (seven int32 operations each) stay under
// the card's int32 rate.
//
// Design.  The walk is independent from pixel to pixel, so one block of 8
// warps owns one 16x128 strip of output (of a plane, or a quarter of a
// piece) and holds its pixels in registers: a thread owns 8 rows of one
// column.  The block streams its stroke's stamp records through shared
// memory in rounds of 256; each round keeps, in order, the stamps whose
// patch extent touches the strip (an ordered ballot/popc compaction, as
// fold_layers.cu culls its layers), then folds that list into every pixel.
// In piece mode the same round keeps the stamp points whose window touches
// the strip, and each thread sets the bits of its covered rows.  The patch
// is staged in shared memory as bytes when it fits kPatchSmem (up to radius
// 90); a larger patch is read from device memory by the same code.  The
// first design gave a block a whole 64x128 tile, 32 rows a thread: each
// thread's chain of listed stamps times rows was four times as long, and
// the lion-sized planes filled a third of the card's SMs (0.11-0.21 ms at
// chip_smoke.py's shapes on an NVIDIA H100 80GB HBM3 at 700 W).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 64;                         // an atlas piece
constexpr int kTileW = 128;
constexpr int kStripH = 16;                        // a block's rows: kernels.BRUSH_BLOCK
constexpr int kStrips = kTileH / kStripH;          // blocks a piece
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kStripH * kTileW / kThreads;  // rows of one column a thread: 8
constexpr int kStrokeWords = 12;                   // kernels.STROKE_WORDS
constexpr int kPatchSmem = 32768;                  // kernels.BRUSH_PATCH_SMEM
constexpr int kFar = -(1 << 29);                   // kernels.FAR_RECORD
static_assert(kRows <= 32, "a thread's covered rows are the bits of one word");
static_assert(kThreads % kTileW == 0 && kTileH % kStripH == 0, "threads split a strip's columns evenly");

struct Params {
  const int2* stamps;            // (s, n) patch corners (row, col)
  const int2* points;            // (s, n) stamp points (row, col); piece mode
  const int* strokes;            // (s, kStrokeWords): ky0, kx0, kh, kw, wr, hr, patch byte offset, 0, fill rgba
  const unsigned char* patches;  // every stroke's (kh, kw) patch bytes
  const int* meta;               // (pieces, 3) (stroke, row, col); piece mode
  int* out;
  int n;                         // records a stroke
  int hp, wp;                    // the planes
  int tiles_x;                   // plane mode: tiles across a plane
};

__device__ __forceinline__ int wrap(uint32_t v) { return static_cast<int>(v); }

// p and t in 0..255, and so the result: no sum overflows.
__device__ __forceinline__ int prelerp(int p, int t) {
  const int a = t * p + 128;
  return p + t - (((a >> 8) + a) >> 8);
}

__device__ __forceinline__ int div255(int i) {
  return wrap(static_cast<uint32_t>(i) + static_cast<uint32_t>(i >> 8) + 1u) >> 8;
}

__device__ __forceinline__ int dissolve(int c, int d) {
  return d == 0 ? 0 : d == 255 ? c : div255(wrap(static_cast<uint32_t>(c) * static_cast<uint32_t>(d)));
}

// Appends this round's records whose `keep` is set to `list`, in thread
// (record) order; returns how many there are.  The caller syncs before
// reading the list.
__device__ __forceinline__ int compact(bool keep, int2 rec, int2* list, int* counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = counts[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (keep) list[before + __popc(ballot & ((1u << lane) - 1u))] = rec;
  return total;
}

template <bool kPiece>
__global__ void __launch_bounds__(kThreads) brush_stamp_kernel(Params p) {
  __shared__ unsigned char patch_s[kPatchSmem];
  __shared__ int2 stamp_list[kThreads];
  __shared__ int2 point_list[kPiece ? kThreads : 1];
  __shared__ int counts[2][kWarps];

  int si, ty0, tx0;  // this block's strip: kStripH x kTileW pixels of plane si at (ty0, tx0)
  if constexpr (kPiece) {
    const int* m = p.meta + 3 * static_cast<long>(blockIdx.x / kStrips);
    si = m[0], ty0 = m[1] + (blockIdx.x % kStrips) * kStripH, tx0 = m[2];
  } else {
    si = blockIdx.y;
    ty0 = (blockIdx.x / p.tiles_x) * kStripH;
    tx0 = (blockIdx.x % p.tiles_x) * kTileW;
  }
  const int* st = p.strokes + si * kStrokeWords;
  const int ky0 = st[0], kx0 = st[1], kh = st[2], kw = st[3], wr = st[4], hr = st[5];
  const unsigned char* texels = p.patches + st[6];
  if (kh * kw <= kPatchSmem) {  // the same for every thread of the block
    for (int i = threadIdx.x; i < kh * kw; i += kThreads) patch_s[i] = texels[i];
    texels = patch_s;  // read after the first round's sync
  }

  const int col = threadIdx.x % kTileW, r0 = (threadIdx.x / kTileW) * kRows;
  const int x = tx0 + col, y0 = ty0 + r0;
  int alpha[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) alpha[j] = 0;
  uint32_t covered = 0;  // piece mode: bit j says that row y0 + j lies in the stroke's mask
  const int2* stamps = p.stamps + static_cast<long>(si) * p.n;
  const int2* points = p.points + static_cast<long>(si) * p.n;

  for (int base = 0; base < p.n; base += kThreads) {
    const int i = base + threadIdx.x;
    const int2 s = i < p.n ? stamps[i] : make_int2(kFar, kFar);
    const int sy = s.x + ky0, sx = s.y + kx0;
    const bool hit = sy < ty0 + kStripH && sy + kh > ty0 && sx < tx0 + kTileW && sx + kw > tx0;
    const int m = compact(hit, s, stamp_list, counts[0]);
    int mp = 0;
    if constexpr (kPiece) {
      const int2 q = i < p.n ? points[i] : make_int2(kFar, kFar);
      const bool near = q.x - hr < ty0 + kStripH && q.x + hr >= ty0 && q.y - wr < tx0 + kTileW && q.y + wr >= tx0;
      mp = compact(near, q, point_list, counts[1]);
    }
    __syncthreads();

    // The listed stamps, in order, into this thread's column.
    for (int k = 0; k < m; ++k) {
      const int2 o = stamp_list[k];
      const int kx = x - o.y - kx0;
      if (static_cast<unsigned>(kx) >= static_cast<unsigned>(kw)) continue;
      const int ky = y0 - o.x - ky0;  // the patch row of this thread's row 0
      const unsigned char* column = texels + kx;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (static_cast<unsigned>(ky + j) < static_cast<unsigned>(kh)) {
          const int t = column[(ky + j) * kw];
          if (t != 0) alpha[j] = t == 255 ? 255 : prelerp(alpha[j], t);
        }
      }
    }
    if constexpr (kPiece) {
      for (int k = 0; k < mp; ++k) {
        const int2 q = point_list[k];
        if (abs(x - q.y) > wr) continue;
        const int lo = max(q.x - hr - y0, 0), hi = min(q.x + hr - y0, kRows - 1);
        if (lo <= hi) covered |= (0xffffffffu >> (31 - (hi - lo))) << lo;  // bits lo..hi
      }
    }
    __syncthreads();  // the next round's lists take these ones' place
  }

  if constexpr (kPiece) {
    const int fr = st[8], fg = st[9], fb = st[10], fa = st[11];
    int* out = p.out + static_cast<long>(blockIdx.x) * kStripH * kTileW + r0 * kTileW + col;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      uint32_t v = 0;
      if ((covered >> j) & 1u) {
        const int a = alpha[j];
        v = static_cast<uint32_t>(dissolve(fr, a)) | (static_cast<uint32_t>(dissolve(fg, a)) << 8) |
            (static_cast<uint32_t>(dissolve(fb, a)) << 16) | (static_cast<uint32_t>(dissolve(fa, a)) << 24);
      }
      out[j * kTileW] = static_cast<int>(v);
    }
  } else {
    if (x >= p.wp) return;
    int* out = p.out + static_cast<long>(si) * p.hp * p.wp + x;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (y0 + j < p.hp) out[static_cast<long>(y0 + j) * p.wp] = alpha[j];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError().  Plane mode
// (piece == 0): one block per 16x128 strip of each of the s planes, into
// the (s, hp, wp) `out`.  Piece mode: four blocks per piece of `meta`,
// into the (pieces, 64, 128) `out`.
extern "C" int brush_stamp(const void* stamps, const void* points, const void* strokes, const void* patches,
                           const void* meta, void* out, int piece, int s, int n, int hp, int wp, int pieces,
                           void* stream) {
  const int tiles_x = (wp + kTileW - 1) / kTileW, strips_y = (hp + kStripH - 1) / kStripH;
  const Params p{static_cast<const int2*>(stamps), static_cast<const int2*>(points), static_cast<const int*>(strokes),
                 static_cast<const unsigned char*>(patches), static_cast<const int*>(meta), static_cast<int*>(out), n,
                 hp, wp, tiles_x};
  const auto st = static_cast<cudaStream_t>(stream);
  if (piece) {
    brush_stamp_kernel<true><<<pieces * kStrips, kThreads, 0, st>>>(p);
  } else {
    brush_stamp_kernel<false><<<dim3(tiles_x * strips_y, s), kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

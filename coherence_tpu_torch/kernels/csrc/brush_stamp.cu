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
// the nonzero extent of its padded patch) at each of its valid stamps, in
// stamp order.  A pixel under texel t takes
//   t == 0: unchanged;  t == 255: 255;  else prelerp(p, t, t) =
//   p + t - (((a >> 8) + a) >> 8) with a = t * p + 128 (colour.py:287),
// so each pixel's value is a fold over the stamps that cover it, in stamp
// order, independent of every other pixel.
//   plane mode writes the (s, hp, wp) int32 alpha planes;
//   piece mode writes piece j of the group's (pieces, 64, 128) block, the
//     64x128 window of its stroke's plane at (row, col) of meta[j], where
//     each pixel is
//       mask ? pack(dissolve(fill, alpha)) : 0,
//     mask: a stamp point (py, px) of the stroke with |y - py| <= hr and
//     |x - px| <= wr (region._box_count(points plane, wr, hr) > 0),
//     dissolve with the 0 / 255 early outs and div255(i) = (i + (i >> 8) +
//     1) >> 8, pack the bare OR r | g << 8 | b << 16 | a << 24.
//
// What bounds it: bytes at the brushes the program uses.  Its output
// written once (4 bytes a plane pixel or piece pixel) and its lists read
// once; the stamp-pixel updates (seven int32 operations each) stay under
// the card's int32 rate.  At the program's shapes even the bytes take a
// fraction of a launch: a launch is a launch floor plus its slowest
// block's chain, the fold of the longest list over its pixels.
//
// Design.  A block of 4 warps owns one 8x128 strip of output (of a plane,
// or an eighth of a piece) and holds its pixels in registers: a thread
// owns the 8 rows of one column, a warp 8 rows of 32 columns.
//   * The host bins the records (kernels.brush_plane_lists,
//     brush_piece_lists, with the native library's brush_strip_lists): the
//     eight strips of a 64x128 bin (a piece, or a plane's tile) read its
//     lists, the stamps whose patch extent touches it in stamp order and in
//     piece mode the stamp points whose mask window touches it, each a
//     4-byte entry relative to the bin.  The first design read every
//     record of its stroke in rounds of 256 with an ordered compaction
//     each.
//   * The patch is staged into dynamic shared memory, 16 bytes a cp.async,
//     between 8 zero rows above and below (patch_bytes), sized to the
//     launch's largest patch while the block reads its lists; a patch that
//     needs more than kernels.BRUSH_PATCH_SMEM (past radius 230 or so) is
//     read from device memory, its rows clamped.
//   * A list entry that misses a warp's 8 x 32 pixels costs the warp one
//     uniform test.  A stamp's fold makes its eight texel loads (the column
//     clamped into the patch and masked) before its eight blends, with no
//     test of a texel: the first design tested each row and each texel, so
//     that each load waited for the blend before it (600-750 SM cycles a
//     listed stamp, chip_smoke.py's shapes 0.048-0.075 ms on an NVIDIA
//     H100 80GB HBM3 at 700 W, the launch's span its longest block's).
//   * Piece mode builds the mask first; a warp none of whose pixels lies in
//     the mask skips the fold, a block with no stamp or no point writes
//     zeros at once.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 64;                         // an atlas piece
constexpr int kTileW = 128;
constexpr int kStripH = 8;                         // a block's rows: kernels.BRUSH_BLOCK
constexpr int kStrips = kTileH / kStripH;          // blocks a piece
constexpr int kThreads = 128;
constexpr int kRows = kStripH * kTileW / kThreads;  // rows of one column a thread: 8
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;                   // list entries a block holds at once
constexpr int kBatch = 4;                          // stamps a thread folds together
constexpr int kStrokeWords = 12;                   // kernels.STROKE_WORDS
constexpr int kPatchSmemMax = 229376;              // kernels.BRUSH_PATCH_SMEM
static_assert(kRows <= 32, "a thread's covered rows are the bits of one word");
static_assert(kThreads % kTileW == 0 && kTileH % kStripH == 0, "threads split a strip's columns evenly");
static_assert(kPatchSmemMax + (2 + kWarps) * kChunk * 4 <= 232448, "the patch and the lists fit a block's shared memory");
static_assert(kChunk % kBatch == 0, "a warp's list is read kBatch entries at a time");
static_assert(kPatchSmemMax % 16 == 0, "the patch is staged 16 bytes a copy");

struct Params {
  const int4* ranges;            // (blocks): each block's stamp entries [x, y) and point entries [z, w)
  const int* stamps;             // stamp entries: patch extent corner - bin origin, row & 0xFFFF | col << 16
  const int* points;             // point entries (piece mode): point - bin origin, packed the same way
  const int* strokes;            // (s, kStrokeWords): ky0, kx0, kh, kw, wr, hr, patch byte offset, 0, fill rgba
  const unsigned char* patches;  // every stroke's (kh, kw) patch bytes, each on 16 bytes
  const int* meta;               // (pieces, 3) (stroke, row, col); piece mode
  int* out;
  int hp, wp;                    // the planes
  int tiles_x, strips_y;         // plane mode: strips across and down a plane
  int patch_smem;                // dynamic shared memory: a patch of more bytes is read from device memory
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

// An entry's row and column (signed 16-bit halves).
__device__ __forceinline__ int entry_row(int e) { return static_cast<int16_t>(e & 0xFFFF); }
__device__ __forceinline__ int entry_col(int e) { return e >> 16; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// The bytes of shared memory a (kh, kw) patch takes: kRows zero rows above
// and below it (each pad rounded up to 16 bytes), so that a fold reads
// rows past the patch's edges without a test (kernels.brush_patch_bytes).
__host__ __device__ __forceinline__ int patch_pad(int kw) { return (kRows * kw + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int patch_bytes(int kh, int kw) { return 2 * patch_pad(kw) + (kh * kw + 15) / 16 * 16; }

// Keeps, in order, the entries of list[0, m) that hit this warp's pixels
// (`hits`, the same for every lane) in the warp's own list `mine`, 32 tests
// at a time; returns how many it kept.
template <class Hits>
__device__ __forceinline__ int keep_hits(const int* list, int m, int* mine, Hits hits) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the warp is done with what `mine` held
  int n = 0;
  for (int i = 0; i < m; i += 32) {
    const int e = i + lane < m ? list[i + lane] : 0;
    const bool hit = i + lane < m && hits(e);
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (hit) mine[n + __popc(ballot & ((1u << lane) - 1u))] = e;
    n += __popc(ballot);
  }
  __syncwarp();
  return n;
}

// kBatch stamps of the warp's list (entries e, the first `live` of them
// real) into a thread's column, in order: every texel load first, then
// every blend.  A stamp's texels are those of patch column col - (its
// column), clamped into the patch and masked, rows r0 - (its row) and on;
// outside the patch they count as 0 (prelerp(p, 0) == p and prelerp(p,
// 255) == 255 for p in 0..255, so no texel needs a test).  The rows are
// clamped too where kClampRows, else the patch has kRows zero rows above
// and below (a stamp in the warp's list covers one of its rows).
template <bool kClampRows>
__device__ __forceinline__ void fold(int (&alpha)[kRows], const unsigned char* texels, int4 e, int live, int col,
                                     int r0, int kh, int kw) {
  const int entries[kBatch] = {e.x, e.y, e.z, e.w};
  int t[kBatch][kRows];
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const int kx = col - entry_col(entries[q]), ky = q < live ? r0 - entry_row(entries[q]) : 0;
    const int inside = q < live && static_cast<unsigned>(kx) < static_cast<unsigned>(kw) ? 0xFF : 0;
    const unsigned char* column = texels + min(max(kx, 0), kw - 1);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if constexpr (kClampRows) {
        const int row = ky + j;
        t[q][j] = column[min(max(row, 0), kh - 1) * kw] &
                  (static_cast<unsigned>(row) < static_cast<unsigned>(kh) ? inside : 0);
      } else {
        t[q][j] = column[(ky + j) * kw] & inside;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) alpha[j] = prelerp(alpha[j], t[q][j]);
  }
}

// The block's stamp entries [first, end), in order, folded into its
// threads' columns, a chunk at a time: each warp keeps the entries that hit
// its kRows x 32 pixels in its own list, then folds them kBatch at a time.
// A thread's rows start at row r0 of the bin the entries are relative to.
// `folds`: whether the warp folds at all (warp-uniform).
template <bool kClampRows>
__device__ __forceinline__ void walk(int (&alpha)[kRows], int* list, int* mine, const int* stamps, int first, int end,
                                     const unsigned char* texels, int kh, int kw, int col, int r0, bool folds) {
  const int wx = col & ~31;  // this warp's first column
  for (int base = first; base < end; base += kChunk) {
    const int m = min(kChunk, end - base);
    if (threadIdx.x < m) list[threadIdx.x] = stamps[base + threadIdx.x];
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (folds) {
      const int n = keep_hits(list, m, mine, [&](int e) {
        const int ry = entry_row(e), rx = entry_col(e);
        return ry < r0 + kRows && ry + kh > r0 && rx < wx + 32 && rx + kw > wx;
      });
      for (int k = 0; k < n; k += kBatch) {
        fold<kClampRows>(alpha, texels, *reinterpret_cast<const int4*>(mine + k), n - k, col, r0, kh, kw);
      }
    }
    __syncthreads();  // the next chunk takes this one's place
  }
}

template <bool kPiece>
__global__ void __launch_bounds__(kThreads) brush_stamp_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char patch_s[];
  __shared__ int stamp_list[kChunk];
  __shared__ int point_list[kPiece ? kChunk : 1];
  __shared__ __align__(16) int warp_lists[kWarps][kChunk];  // each warp's hits
  int* mine = warp_lists[threadIdx.x >> 5];

  const int b = blockIdx.x;
  int si, ty0, tx0, sub;  // this block's strip: kStripH x kTileW pixels of plane si at (ty0, tx0), row sub of its bin
  if constexpr (kPiece) {
    const int* m = p.meta + 3 * static_cast<long>(b / kStrips);
    sub = (b % kStrips) * kStripH, si = m[0], ty0 = m[1] + sub, tx0 = m[2];
  } else {
    const int per_plane = p.strips_y * p.tiles_x, at = b % per_plane, strip = at / p.tiles_x;
    sub = strip % kStrips * kStripH, si = b / per_plane, ty0 = strip * kStripH, tx0 = (at % p.tiles_x) * kTileW;
  }
  const int4 lists = p.ranges[b];
  const int col = threadIdx.x % kTileW, r0 = (threadIdx.x / kTileW) * kRows;
  const int rb = sub + r0;  // this thread's first row in its bin, where the entries are
  const int wx = col & ~31;  // this warp's first column
  int alpha[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) alpha[j] = 0;
  uint32_t covered = kPiece ? 0u : ~0u;  // piece mode: bit j says that row r0 + j lies in the stroke's mask
  const int* st = p.strokes + si * kStrokeWords;

  // Block-uniform: a piece strip with no stamp or no point is zero.
  if (lists.x < lists.y && (!kPiece || lists.z < lists.w)) {
    const int kh = st[2], kw = st[3];
    const unsigned char* texels = p.patches + st[6];
    const bool shared = patch_bytes(kh, kw) <= p.patch_smem;  // the same for every thread of the block
    if (shared) {  // zero pads around the patch, staged 16 bytes a copy
      const int pad = patch_pad(kw), body = (kh * kw + 15) / 16;
      for (int i = threadIdx.x; i < body; i += kThreads) cp_async16(patch_s + pad + 16 * i, texels + 16 * i);
      asm volatile("cp.async.commit_group;\n" ::);
      for (int i = threadIdx.x; i < pad / 8; i += kThreads) {
        const int at = i < pad / 16 ? 16 * i : pad + 16 * body + 16 * (i - pad / 16);
        *reinterpret_cast<int4*>(patch_s + at) = make_int4(0, 0, 0, 0);
      }
    }
    if constexpr (kPiece) {
      const int wr = st[4], hr = st[5];
      for (int base = lists.z; base < lists.w; base += kChunk) {
        const int m = min(kChunk, lists.w - base);
        if (threadIdx.x < m) point_list[threadIdx.x] = p.points[base + threadIdx.x];
        __syncthreads();
        const int n = keep_hits(point_list, m, mine, [&](int e) {
          const int py = entry_row(e), px = entry_col(e);
          return py - hr < rb + kRows && py + hr >= rb && px - wr < wx + 32 && px + wr >= wx;
        });
        for (int k = 0; k < n; ++k) {
          const int e = mine[k];
          const int py = entry_row(e), px = entry_col(e);
          const int lo = max(py - hr - rb, 0), hi = min(py + hr - rb, kRows - 1);
          if (abs(col - px) <= wr) covered |= (0xffffffffu >> (31 - (hi - lo))) << lo;  // bits lo..hi
        }
        __syncthreads();  // the next chunk takes this one's place
      }
    }
    const bool folds = __any_sync(0xffffffffu, covered != 0);  // warp-uniform
    if (shared) {
      walk<false>(alpha, stamp_list, mine, p.stamps, lists.x, lists.y, patch_s + patch_pad(kw), kh, kw, col, rb, folds);
    } else {
      walk<true>(alpha, stamp_list, mine, p.stamps, lists.x, lists.y, texels, kh, kw, col, rb, folds);
    }
  }

  const int x = tx0 + col, y0 = ty0 + r0;
  if constexpr (kPiece) {
    int fr = 0, fg = 0, fb = 0, fa = 0;
    if (covered) fr = st[8], fg = st[9], fb = st[10], fa = st[11];
    int* out = p.out + static_cast<long>(b) * kStripH * kTileW + r0 * kTileW + col;
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

// Lets brush_stamp_kernel<kPiece> take up to kPatchSmemMax bytes of dynamic
// shared memory on the current device: by default a kernel takes at most
// 48 KB less its static shared memory.  The attribute belongs to the
// device's context, so it is set once a device and mode.
constexpr int kMaxDevices = 64;

template <bool kPiece>
cudaError_t allow() {
  static std::atomic<bool> done[kMaxDevices];
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess || (device < kMaxDevices && done[device].load(std::memory_order_acquire))) return rc;
  rc = cudaFuncSetAttribute(brush_stamp_kernel<kPiece>, cudaFuncAttributeMaxDynamicSharedMemorySize, kPatchSmemMax);
  if (rc == cudaSuccess && device < kMaxDevices) done[device].store(true, std::memory_order_release);
  return rc;
}

template <bool kPiece>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  const cudaError_t rc = allow<kPiece>();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  brush_stamp_kernel<kPiece><<<blocks, kThreads, p.patch_smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPiece>
int blocks_per_sm(int bytes) {
  int n = 0;
  cudaError_t rc = allow<kPiece>();
  if (rc == cudaSuccess) rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, brush_stamp_kernel<kPiece>, kThreads, bytes);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

}  // namespace

// Launches on `stream` and returns the first CUDA error, 0 if none.  One
// block per 8x128 strip: in plane mode each strip of each of the (hp, wp)
// planes, plane-major and row-major within a plane, into the (s, hp, wp)
// `out`; in piece mode eight a piece of `meta`, into the (pieces, 64, 128)
// `out`.  `patch_smem` bytes of dynamic shared memory a block (a multiple of
// 16, at most kPatchSmemMax).
extern "C" int brush_stamp(const void* ranges, const void* stamps, const void* points, const void* strokes,
                           const void* patches, const void* meta, void* out, int piece, int blocks, int hp, int wp,
                           int patch_smem, void* stream) {
  if (patch_smem < 0 || patch_smem > kPatchSmemMax || patch_smem % 16) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const int4*>(ranges), static_cast<const int*>(stamps), static_cast<const int*>(points),
                 static_cast<const int*>(strokes), static_cast<const unsigned char*>(patches),
                 static_cast<const int*>(meta), static_cast<int*>(out), hp, wp, (wp + kTileW - 1) / kTileW,
                 (hp + kStripH - 1) / kStripH, patch_smem};
  const auto st = static_cast<cudaStream_t>(stream);
  return piece ? launch<true>(p, blocks, st) : launch<false>(p, blocks, st);
}

// The blocks of a launch that one SM holds with `patch_smem` bytes of
// dynamic shared memory (the occupancy calculator), in piece or plane mode;
// minus the CUDA error where the query fails.
extern "C" int brush_stamp_blocks_per_sm(int piece, int patch_smem) {
  return piece ? blocks_per_sm<true>(patch_smem) : blocks_per_sm<false>(patch_smem);
}

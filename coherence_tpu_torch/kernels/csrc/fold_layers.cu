// Front-to-back fold of a layer pack into a window, for Hopper (sm_90a).
//
// Replaces the fold body that the JAX package compiles into one XLA
// program per call: coherence_tpu/raster/framepath.py:371 fold_layers_carry,
// shared there by the window recomposite programs of FrameBuffer and by the
// batched group compositor (scene/fastframe.py _group_fold_chunk).  It is
// not a Pallas kernel; as eager torch it would be about ten launches per
// layer.
//
// The function.  Every window pixel walks the K layers in order.  Layer k
// is a sprite (int32 premultiplied RGBA and a bool mask, both (hs, ws))
// whose origin sits at (dy, dx) in window coordinates; the pixel (y, x)
// reads it at (y - dy, x - dx) when that lies inside it.  Where its mask is
// set and the pixel is still open, acc = over(acc, layer) and covered = 1;
// once acc's alpha is 255 the pixel closes and stops walking.  The carry
// (acc, open, covered) comes in and goes out, so that chunking the layers
// is the identity for this left fold.  Integer math, bit for bit the plain
// version (raster/framepath.py fold_layers_carry_torch).
//
// What bounds it: bytes.  The carry in and out (18 bytes a pixel each way)
// on a whole window, and each open pixel's mask byte of every layer over it
// until it closes, with 16 bytes of RGBA where the mask is set.  A layer
// pack covers a small part of a window, so the work that is not bytes is
// finding which layers lie over which pixels: testing every record at every
// pixel, as one thread a pixel did, is K x pixels visits (274 M for the
// lion's 132 sprites over 1920x1080) and bound the kernel by that walk.
//
// Design, step by step against that:
//  1. 2D tiles.  A block of kThreads owns a kTileH x kTileW (8x32) tile of
//     the window; a warp's lanes lie along x, so that one layer row's mask
//     bytes (one sector) and RGBA (512 contiguous bytes) coalesce; each
//     thread keeps kRows pixels of a column.  The window's ragged right and
//     bottom edges are masked.  On an NVIDIA H100 80GB HBM3 at 700 W, 8x32
//     took 5-9 % less than 16x32 (more blocks, shorter lists, 19.5 KB of
//     shared memory a block) on a whole window and a blur window; 32x32
//     needed 128 registers a thread.
//  2. A tile with no pixel open in its carry copies the carry through and
//     reads no record (most of a FrameBuffer window outside inwin, most of
//     a group's box outside its update shape).
//  3. A per-tile layer list.  The records stream through shared memory
//     kChunk at a time: each thread tests one record's box against the
//     tile, and an ordered compaction (__ballot_sync, __popc, per-warp
//     counts in shared memory) writes the tile's list in front-to-back
//     order.  Pixels walk only that list; chunk after chunk keeps the left
//     fold's order, and K has no limit.
//  4. 32-bit geometry.  A record is two 64-bit pointers and int32 hs, ws,
//     dy, dx (the wrapper raises where a value does not fit, and on a layer
//     of 2^31 pixels or more).  The box test of a pixel is one unsigned
//     compare per axis; only the final address of a layer's byte is 64-bit.
//  5. A warp whose pixels have all closed stops walking (__any_sync on
//     open, once per listed layer).  Barriers come only between cull chunks.
//  6. Load latency.  While layer j blends, layers j + 1 and j + 2 are in
//     flight: each thread copies, by cp.async into its own slots of a
//     3-stage shared-memory ring, the 4-byte word holding the mask byte and
//     the 16 bytes of RGBA of each of its open pixels inside the layer.
//     The RGBA is copied whether or not the mask is set, so that no load
//     waits on another; a pixel that closes meanwhile ignores what came.
//     Measured against a register double buffer of one layer (the mask, then
//     the RGBA where it is set), both on 16x32 tiles, the ring took 14 %
//     less on a recomposite_blur window and 10 % more on a whole 1080p
//     window (same card; PERF.md, F1); the blur window is the fold that the
//     frame path launches, 20 times a run.

#include <cstdint>

namespace {

// One record of the wrapper's table (kernels.pack_layer_records).
struct alignas(16) LayerRecord {
  unsigned long long rgba;  // const int4*: (hs, ws) RGBA
  unsigned long long mask;  // const uint8_t*: (hs, ws) bool
  int hs, ws;
  int dy, dx;  // the layer's origin in window coordinates
};
static_assert(sizeof(LayerRecord) == 32, "a record is the wrapper's 32 bytes");

constexpr int kTileW = 32;  // one warp's lanes
constexpr int kTileH = 8;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kTileH / kWarps;  // window rows of each thread, one column
constexpr int kChunk = kThreads;        // records culled per round, one a thread
static_assert(kRows * kWarps == kTileH, "the warps' rows tile the tile");

// Alvy Ray Smith's exact lerp on 0..255 (colour.prelerp_arr).
__device__ __forceinline__ int prelerp(int p, int q, int a) {
  const int t = a * p + 128;
  return p + q - (((t >> 8) + t) >> 8);
}

// colour.over_rgba(a, b) with `a` in front, keeping its alpha 0 / 255 early outs.
__device__ __forceinline__ int4 over(int4 a, int4 b) {
  if (a.w == 0) return b;
  if (a.w == 255) return a;
  return make_int4(prelerp(b.x, a.x, a.w), prelerp(b.y, a.y, a.w), prelerp(b.z, a.z, a.w),
                   prelerp(b.w, a.w, a.w));
}

constexpr int kStages = 3;  // listed layers in flight in the shared-memory ring

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage one listed layer at a thread's pixels into its own slots of the
// ring: the 4-byte word holding each open inside pixel's mask byte, and its
// RGBA, by cp.async.  Returns the pixels staged (bit r for row r).
__device__ __forceinline__ unsigned stage(const LayerRecord& rec, int y0, int x, unsigned open,
                                          unsigned* mask_slot, int4* rgba_slot) {
  const unsigned ix = static_cast<unsigned>(x) - static_cast<unsigned>(rec.dx);
  const unsigned hs = static_cast<unsigned>(rec.hs), ws = static_cast<unsigned>(rec.ws);
  unsigned in = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    // Negative offsets wrap to values of at least 2^31 > hs, ws.
    const unsigned iy = static_cast<unsigned>(y0 + r) - static_cast<unsigned>(rec.dy);
    if ((open >> r & 1u) && iy < hs && ix < ws) {
      const unsigned q = iy * ws + ix;  // < hs * ws < 2^31
      // cp.async copies 4, 8 or 16 bytes: the aligned word around the mask
      // byte lies inside the mask's allocation, which starts aligned.
      const unsigned long long m = (rec.mask + q) & ~3ull;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(mask_slot + r * kTileW)), "l"(m));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(rgba_slot + r * kTileW)),
                   "l"(rec.rgba + 16ull * q));
      in |= 1u << r;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return in;
}

__global__ void __launch_bounds__(kThreads)
fold_layers_kernel(const LayerRecord* __restrict__ table, int k_layers, const int4* __restrict__ acc_in,
                   const uint8_t* __restrict__ open_in, const uint8_t* __restrict__ cov_in,
                   int4* __restrict__ acc_out, uint8_t* __restrict__ open_out, uint8_t* __restrict__ cov_out,
                   int hb, int wb) {
  __shared__ LayerRecord list[kChunk];
  __shared__ int counts[kWarps];
  // Each thread's own slots, rows of its column: no barrier between a copy and its use.
  __shared__ int4 ring_rgba[kStages][kTileH][kTileW];
  __shared__ unsigned ring_mask[kStages][kTileH][kTileW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int ty1 = min(ty0 + kTileH, hb), tx1 = min(tx0 + kTileW, wb);
  const int y0 = ty0 + warp * kRows, x = tx0 + lane;

  // The carry: row r of this thread's column in bit r of live, open and cov.
  int4 acc[kRows];
  unsigned live = 0, open = 0, cov = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool in = y0 + r < hb && x < wb;
    const long long p = static_cast<long long>(y0 + r) * wb + x;
    acc[r] = in ? acc_in[p] : make_int4(0, 0, 0, 0);
    live |= static_cast<unsigned>(in) << r;
    open |= static_cast<unsigned>(in && open_in[p]) << r;
    cov |= static_cast<unsigned>(in && cov_in[p]) << r;
  }

  for (int k0 = 0; k0 < k_layers; k0 += kChunk) {
    // With no pixel of the tile open the rest of the records change
    // nothing.  The barrier also keeps the last chunk's list until every
    // warp has walked it.
    if (!__syncthreads_or(open != 0)) break;
    const int k = k0 + threadIdx.x;
    LayerRecord rec;
    bool meets = false;
    if (k < k_layers) {
      rec = table[k];
      meets = max(rec.dy, ty0) < min(rec.dy + rec.hs, ty1) && max(rec.dx, tx0) < min(rec.dx + rec.ws, tx1);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();
    int slot = __popc(ballot & ((1u << lane) - 1u)), n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      slot += w < warp ? counts[w] : 0;
      n += counts[w];
    }
    if (meets) list[slot] = rec;
    __syncthreads();

    // Walk the tile's list: layers j + 1 and j + 2 are in flight while layer j blends.
    if (n == 0) continue;
    const int row0 = warp * kRows;
    // in0 .. in2: the pixels staged for layers j .. j + 2.
    unsigned in0 = stage(list[0], y0, x, open, &ring_mask[0][row0][lane], &ring_rgba[0][row0][lane]);
    unsigned in1 = n > 1 ? stage(list[1], y0, x, open, &ring_mask[1][row0][lane], &ring_rgba[1][row0][lane]) : 0u;
    if (n <= 1) asm volatile("cp.async.commit_group;\n" ::);
    for (int j = 0; j < n && __any_sync(0xffffffffu, open != 0); ++j) {
      const int s2 = (j + 2) % kStages, s0 = j % kStages;
      unsigned in2 = 0;
      if (j + 2 < n) {
        in2 = stage(list[j + 2], y0, x, open, &ring_mask[s2][row0][lane], &ring_rgba[s2][row0][lane]);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      const LayerRecord& rec = list[j];
      const unsigned ix = static_cast<unsigned>(x) - static_cast<unsigned>(rec.dx);
      const unsigned live_in = in0 & open;
      unsigned hits = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (live_in >> r & 1u) {
          const unsigned iy = static_cast<unsigned>(y0 + r) - static_cast<unsigned>(rec.dy);
          const unsigned shift = 8u * static_cast<unsigned>((rec.mask + iy * static_cast<unsigned>(rec.ws) + ix) & 3ull);
          if (ring_mask[s0][row0 + r][lane] >> shift & 0xffu) {
            hits |= 1u << r;
            acc[r] = over(acc[r], ring_rgba[s0][row0 + r][lane]);
            if (acc[r].w == 255) open &= ~(1u << r);
          }
        }
      }
      cov |= hits;
      in0 = in1;
      in1 = in2;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (live >> r & 1u) {
      const long long p = static_cast<long long>(y0 + r) * wb + x;
      acc_out[p] = acc[r];
      open_out[p] = open >> r & 1u;
      cov_out[p] = cov >> r & 1u;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError().  hb, wb > 0 and
// ceil(hb / kTileH) <= 65535 (the wrapper checks both).
extern "C" int fold_layers(const void* table, const void* acc_in, const void* open_in, const void* cov_in,
                           void* acc_out, void* open_out, void* cov_out, int k_layers, int hb, int wb,
                           void* stream) {
  const dim3 grid((wb + kTileW - 1) / kTileW, (hb + kTileH - 1) / kTileH);
  fold_layers_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const LayerRecord*>(table), k_layers, static_cast<const int4*>(acc_in),
      static_cast<const uint8_t*>(open_in), static_cast<const uint8_t*>(cov_in), static_cast<int4*>(acc_out),
      static_cast<uint8_t*>(open_out), static_cast<uint8_t*>(cov_out), hb, wb);
  return static_cast<int>(cudaGetLastError());
}

// The tile: its rows for axis 0, its columns for axis 1.  The wrapper's grid
// check and the host's model of the tile lists (kernels.fold_tile) read it
// here, so that the tile is written down once.
extern "C" int fold_layers_tile(int axis) { return axis == 0 ? kTileH : kTileW; }

// Tile compositor for Hopper (sm_90a): front-to-back Porter/Duff `over` of
// each 64x128 tile's listed atlas pieces, then `over` the background tile.
//
// Replaces the Pallas TPU kernels of coherence_tpu/raster/tiled_scene.py:
//   composite_dirty  <- _kernel_subset     (launcher _render_dirty_tiles)
//   composite_full   <- _kernel_atlas_row  (launcher _render_tiles_atlas)
//                       and _kernel        (launcher _render_tiles)
// _kernel_atlas_row and _kernel compute the same function: `over` onto an
// accumulator whose alpha is 255 returns the accumulator unchanged
// (prelerp(l, q, 255) == q for every byte l), so stopping early never
// changes the output and one entry point serves both.
//
// The packed-pixel math, the tile layout and the per-tile walk
// (composite_tile) are in tile_math.cuh.
//
// What bounds it: HBM bytes.  Per tile the kernel reads 4 B/px for every
// listed piece, plus the background tile, and writes the frame tile once;
// the integer math per pixel is a few dozen ALU ops.  Design: one thread
// block per tile, 256 threads, each owning 32 pixels of the tile in
// registers (8 x 16-byte vectors, neighbouring threads on neighbouring
// addresses), so every piece and the background are read with coalesced
// 16-byte loads and the accumulator never touches memory.  After each piece
// the block votes (__syncthreads_or) and stops once every pixel is opaque,
// which skips the reads of occluded pieces.  Blocks run in no order and share
// nothing: unlike the TPU kernels' sequential grid, no DMA ring crosses tile
// boundaries.  A shared-memory ring, cp.async/TMA prefetch of the next piece
// and persistent blocks are left for later work.  CUDA rather than Triton:
// the work is a data-dependent walk of a per-tile list with indexed gathers
// and a block-wide early exit, which Triton's block model does not express.
//
// composite_dirty runs in place on the frame.  A slot whose span starts
// below 0 leaves its tile untouched.  Padding slots repeat the last real
// slot, so two blocks may write one tile; that is safe because a compositing
// slot never reads the frame, and both write the same values.

#include "tile_math.cuh"

namespace {

using namespace tile;

__global__ void __launch_bounds__(kThreads)
composite_dirty_kernel(const int* __restrict__ coords, const int* __restrict__ spans,
                       const int* __restrict__ idxs, const uint32_t* __restrict__ bg,
                       uint32_t* __restrict__ frame, const uint32_t* __restrict__ atlas, int pw) {
  int s = blockIdx.x;
  int lo = spans[2 * s];
  if (lo < 0) return;  // passthrough slot: the tile stays as it is
  long off = static_cast<long>(coords[2 * s]) * kTileH * pw + static_cast<long>(coords[2 * s + 1]) * kTileW;
  composite_tile(idxs, lo, spans[2 * s + 1], atlas, bg + off, frame + off, pw);
}

__global__ void __launch_bounds__(kThreads)
composite_full_kernel(const int* __restrict__ starts, const int* __restrict__ idxs,
                      const uint32_t* __restrict__ bg, uint32_t* __restrict__ out,
                      const uint32_t* __restrict__ atlas, int ntx, int pw) {
  int t = blockIdx.x;
  long off = static_cast<long>(t / ntx) * kTileH * pw + static_cast<long>(t % ntx) * kTileW;
  composite_tile(idxs, starts[t], starts[t + 1], atlas, bg + off, out + off, pw);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
extern "C" int composite_dirty(const void* coords, const void* spans, const void* idxs,
                               const void* bg, void* frame, const void* atlas, int n_slots,
                               int pw, void* stream) {
  composite_dirty_kernel<<<n_slots, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(coords), static_cast<const int*>(spans),
      static_cast<const int*>(idxs), static_cast<const uint32_t*>(bg),
      static_cast<uint32_t*>(frame), static_cast<const uint32_t*>(atlas), pw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int composite_full(const void* starts, const void* idxs, const void* bg, void* out,
                              const void* atlas, int nty, int ntx, void* stream) {
  composite_full_kernel<<<nty * ntx, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(idxs),
      static_cast<const uint32_t*>(bg), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(atlas), ntx, ntx * kTileW);
  return static_cast<int>(cudaGetLastError());
}

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
// changes the output and one entry point serves both.  The packed-pixel
// math is tile_math.cuh's over_packed, in the same per-pixel order.
//
// What bounds it, and the design: stripe_ring.cuh's striped TMA ring walk
// with its list source (one 128-thread block per 4-row stripe of a tile,
// the span's piece indices staged in shared memory, 8 stripes in flight).
// CUDA rather than Triton: the work is a data-dependent walk of a per-tile
// list with indexed gathers and a block-wide early exit.
//
// composite_dirty runs in place on the frame (stripe_ring.cuh
// composite_dirty_stripe: passthrough slots leave their tile, padding
// slots return at once).  It is launched with programmatic dependent launch
// (pdl.cuh), so that its launch overlaps the end of the kernel before it
// (shatter_into in an animated frame), and waits at entry for that
// kernel's writes.

#include "pdl.cuh"
#include "stripe_ring.cuh"

namespace {

using namespace ring;

__global__ void __launch_bounds__(kStripeThreads)
composite_dirty_kernel(const int* __restrict__ coords, const int* __restrict__ spans,
                       const int* __restrict__ idxs, const uint32_t* __restrict__ bg,
                       uint32_t* __restrict__ frame, const uint32_t* __restrict__ atlas, int pw) {
  pdl::wait();  // the kernel before this one has finished and its writes are visible
  composite_dirty_stripe(coords, spans, idxs, bg, frame, atlas, pw);
}

__global__ void __launch_bounds__(kStripeThreads)
composite_full_kernel(const int* __restrict__ starts, const int* __restrict__ idxs,
                      const uint32_t* __restrict__ bg, uint32_t* __restrict__ out,
                      const uint32_t* __restrict__ atlas, int ntx, int pw) {
  const int t = blockIdx.x / kStripes;
  long off = static_cast<long>(t / ntx) * kTileH * pw + static_cast<long>(t % ntx) * kTileW;
  composite_list_stripe(idxs, starts[t], starts[t + 1], atlas, bg + off, out + off, pw, blockIdx.x % kStripes);
}

}  // namespace

// Each entry point launches on `stream` and returns the launch's error, else
// cudaGetLastError().
extern "C" int composite_dirty(const void* coords, const void* spans, const void* idxs,
                               const void* bg, void* frame, const void* atlas, int n_slots,
                               int pw, void* stream) {
  return static_cast<int>(pdl::launch(composite_dirty_kernel, dim3(n_slots * kStripes), dim3(kStripeThreads), 0,
                                      static_cast<cudaStream_t>(stream), static_cast<const int*>(coords),
                                      static_cast<const int*>(spans), static_cast<const int*>(idxs),
                                      static_cast<const uint32_t*>(bg), static_cast<uint32_t*>(frame),
                                      static_cast<const uint32_t*>(atlas), pw));
}

extern "C" int composite_full(const void* starts, const void* idxs, const void* bg, void* out,
                              const void* atlas, int nty, int ntx, void* stream) {
  composite_full_kernel<<<nty * ntx * kStripes, kStripeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(idxs),
      static_cast<const uint32_t*>(bg), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(atlas), ntx, ntx * kTileW);
  return static_cast<int>(cudaGetLastError());
}

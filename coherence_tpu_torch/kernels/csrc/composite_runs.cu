// Run-contiguous full-frame compositor for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel_runs_row of
// coherence_tpu/raster/tiled_scene.py (launcher _render_tiles_runs).  The
// caller has gathered every listed piece tile-major into `runs` (the port's
// gather_runs, the JAX package's _gather_runs_kernel), so tile t's
// front-to-back pieces are runs[starts[t]:starts[t+1]], contiguous.  The
// output equals composite_full on the lists the runs were gathered from.
// The reference walks chunks of four pieces under a per-pixel open mask and
// stops between chunks; neither carries over: `over` onto an opaque pixel
// is the identity, so a walk that votes after every piece computes the
// same function.
//
// What bounds it: HBM bytes, as for composite_full: 4 B/px for each piece
// walked, plus the background tile and the output tile.  Design:
// stripe_ring.cuh's striped TMA ring with its run source.  One 128-thread
// block per 4-row stripe of each 64x128 tile, each stripe with its own
// early-stop vote; stage k holds the 2 KiB stripe of run piece lo + k, 8
// pieces in flight.  The pieces of a tile are consecutive, so no index is
// staged and the block needs only the ring's 16 KiB of shared memory.
// The TPU kernel's DMA ring across tiles and its row unrolling exist
// because its grid runs in order on one core; blocks here run in parallel
// and carry nothing from tile to tile.  The ring never reads past
// starts[t+1], so the runs' zero tail padding is never read.

#include "stripe_ring.cuh"

namespace {

using namespace ring;

__global__ void __launch_bounds__(kStripeThreads)
composite_runs_kernel(const int* __restrict__ starts, const uint32_t* __restrict__ bg,
                      uint32_t* __restrict__ out, const uint32_t* __restrict__ runs, int ntx,
                      int pw) {
  const int t = blockIdx.x / kStripes, stripe = blockIdx.x % kStripes;
  const long off = static_cast<long>(t / ntx) * kTileH * pw + static_cast<long>(t % ntx) * kTileW;
  const int lo = starts[t], hi = starts[t + 1];
  const RunSource src{runs + (static_cast<long>(lo) * kTileH + static_cast<long>(stripe) * kStripeRows) * kTileW};
  composite_stripe(src, hi - lo, bg + off, out + off, pw, stripe);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError().
extern "C" int composite_runs(const void* starts, const void* bg, void* out, const void* runs,
                              int nty, int ntx, void* stream) {
  composite_runs_kernel<<<nty * ntx * kStripes, kStripeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const uint32_t*>(bg),
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(runs), ntx, ntx * kTileW);
  return static_cast<int>(cudaGetLastError());
}

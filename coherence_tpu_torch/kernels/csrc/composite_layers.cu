// Dense layer-stack compositor for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of
// coherence_tpu/raster/pallas_compositor.py (launcher
// composite_layers_packed).  `layers` is a (K, H, W) stack of packed
// premultiplied pixels, layer 0 topmost, zero where a layer is empty; the
// walk goes k = 0..K-1, stops early once the pixels are opaque, and ends
// `over` the background.  The output equals composite_layers_xla, which
// walks every layer: on an opaque accumulator `over` is the identity, so
// the early stop changes no value.
//
// What bounds it: HBM bytes, 4 B/px for each layer a pixel walks until it
// is opaque, the background where it stays translucent, and the output; a
// pixel under an opaque layer near the top reads only down to it, so the
// bytes follow the visible depth, not K.  Design: stripe_ring.cuh's
// striped TMA ring with its layer source.  One 128-thread block per 4-row
// stripe of each 64x128 tile, each stripe with its own early-stop vote, so
// a stripe stops at its own visible depth rather than at its tile's
// deepest pixel; stage k holds layer k's four 512-byte rows of the stripe,
// 8 layers in flight.

#include "stripe_ring.cuh"

namespace {

using namespace ring;

__global__ void __launch_bounds__(kStripeThreads)
composite_layers_kernel(const uint32_t* __restrict__ bg, const uint32_t* __restrict__ layers,
                        uint32_t* __restrict__ out, int k_layers, int ntx, int pw, long plane) {
  const int t = blockIdx.x / kStripes, stripe = blockIdx.x % kStripes;
  const long off = static_cast<long>(t / ntx) * kTileH * pw + static_cast<long>(t % ntx) * kTileW;
  const LayerSource src{layers + off + static_cast<long>(stripe) * kStripeRows * pw, plane, pw};
  composite_stripe(src, k_layers, bg + off, out + off, pw, stripe);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError().
extern "C" int composite_layers(const void* bg, const void* layers, void* out, int k_layers,
                                int nty, int ntx, void* stream) {
  int pw = ntx * kTileW;
  composite_layers_kernel<<<nty * ntx * kStripes, kStripeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bg), static_cast<const uint32_t*>(layers),
      static_cast<uint32_t*>(out), k_layers, ntx, pw, static_cast<long>(nty) * kTileH * pw);
  return static_cast<int>(cudaGetLastError());
}

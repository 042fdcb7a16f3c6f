// Dense layer-stack compositor for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of
// coherence_tpu/raster/pallas_compositor.py (launcher
// composite_layers_packed).  `layers` is a (K, H, W) stack of packed
// premultiplied pixels, layer 0 topmost, zero where a layer is empty; each
// 64x128 tile walks k = 0..K-1 under the per-pixel open mask, stops once
// every pixel of the tile is opaque, and ends `over` the background.  The
// output equals composite_layers_xla, which walks every layer: on an opaque
// accumulator `over` is the identity, so the early stop changes no value.
//
// What bounds it: HBM bytes, 4 B/px for each layer a tile walks plus the
// background and output tiles; a tile under an opaque layer near the top
// reads only down to it, so the bytes follow the visible depth, not K.
// Design: one block per tile (tile_math.cuh's layout), the tile's rows read
// straight from the (H, W) planes with coalesced 16-byte loads.  The TPU
// kernel's double-buffered DMA ring becomes the card's own latency hiding
// across the many blocks resident on each SM; a cp.async or TMA ring is left
// for later work.

#include "tile_math.cuh"

namespace {

using namespace tile;

__global__ void __launch_bounds__(kThreads)
composite_layers_kernel(const uint32_t* __restrict__ bg, const uint32_t* __restrict__ layers,
                        uint32_t* __restrict__ out, int k_layers, int ntx, int pw, long plane) {
  int t = blockIdx.x;
  long off = static_cast<long>(t / ntx) * kTileH * pw + static_cast<long>(t % ntx) * kTileW;

  uint4 acc[kVecPerThread];
#pragma unroll
  for (int j = 0; j < kVecPerThread; ++j) acc[j] = make_uint4(0u, 0u, 0u, 0u);

  for (int k = 0; k < k_layers; ++k) {
    const uint32_t* tile = layers + k * plane + off;
    bool open = false;
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j) {
      uint4 l = __ldg(reinterpret_cast<const uint4*>(tile + vec_offset(j, pw)));
      acc[j] = over_open4(acc[j], l);
      open |= any_open4(acc[j]);
    }
    if (!__syncthreads_or(open)) break;
  }

  finish_tile(acc, bg + off, out + off, pw);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError().
extern "C" int composite_layers(const void* bg, const void* layers, void* out, int k_layers,
                                int nty, int ntx, void* stream) {
  int pw = ntx * kTileW;
  composite_layers_kernel<<<nty * ntx, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bg), static_cast<const uint32_t*>(layers),
      static_cast<uint32_t*>(out), k_layers, ntx, pw, static_cast<long>(nty) * kTileH * pw);
  return static_cast<int>(cudaGetLastError());
}

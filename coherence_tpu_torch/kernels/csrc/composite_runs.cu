// Run-contiguous full-frame compositor for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel_runs_row of
// coherence_tpu/raster/tiled_scene.py (launcher _render_tiles_runs).  The
// caller has gathered every listed piece tile-major into `runs` (the port's
// gather_runs, the JAX package's _gather_runs_kernel), so tile t's
// front-to-back pieces are runs[starts[t]:starts[t+1]], contiguous.  The
// tile walks them in chunks of kRunChunk pieces, composites exactly the
// chunk's valid pieces under the per-pixel open mask, and stops between
// chunks once every pixel of the tile is opaque.  The output equals
// composite_full on the lists the runs were gathered from.
//
// What bounds it: HBM bytes, as for composite_full: 4 B/px for each piece
// walked, plus the background tile and the output tile.  Design: one block
// per tile (tile_math.cuh's layout); within a chunk each thread issues the
// loads of all the chunk's pieces for one vector before it composites them,
// so up to kRunChunk independent 16-byte loads per thread are in flight
// where composite_full has one.  The TPU kernel's DMA ring, its 3-tile
// lookahead and its row unrolling exist because its grid runs in order on
// one core; blocks here run in parallel and carry nothing from tile to tile.

#include "tile_math.cuh"

namespace {

using namespace tile;

constexpr int kRunChunk = 4;

__global__ void __launch_bounds__(kThreads)
composite_runs_kernel(const int* __restrict__ starts, const uint32_t* __restrict__ bg,
                      uint32_t* __restrict__ out, const uint32_t* __restrict__ runs, int ntx,
                      int pw) {
  int t = blockIdx.x;
  long off = static_cast<long>(t / ntx) * kTileH * pw + static_cast<long>(t % ntx) * kTileW;
  int lo = starts[t], hi = starts[t + 1];

  uint4 acc[kVecPerThread];
#pragma unroll
  for (int j = 0; j < kVecPerThread; ++j) acc[j] = make_uint4(0u, 0u, 0u, 0u);

  for (int base = lo; base < hi; base += kRunChunk) {
    int valid = min(hi - base, kRunChunk);
    const uint4* chunk = reinterpret_cast<const uint4*>(runs + static_cast<long>(base) * (kTileH * kTileW));
    bool open = false;
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j) {
      int v = threadIdx.x + j * kThreads;
      uint4 l[kRunChunk];
#pragma unroll
      for (int c = 0; c < kRunChunk; ++c)
        if (c < valid) l[c] = __ldg(chunk + c * (kTileH * kTileW / 4) + v);
#pragma unroll
      for (int c = 0; c < kRunChunk; ++c)
        if (c < valid) acc[j] = over_open4(acc[j], l[c]);
      open |= any_open4(acc[j]);
    }
    if (!__syncthreads_or(open)) break;
  }

  finish_tile(acc, bg + off, out + off, pw);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError().
extern "C" int composite_runs(const void* starts, const void* bg, void* out, const void* runs,
                              int nty, int ntx, void* stream) {
  composite_runs_kernel<<<nty * ntx, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const uint32_t*>(bg),
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(runs), ntx, ntx * kTileW);
  return static_cast<int>(cudaGetLastError());
}

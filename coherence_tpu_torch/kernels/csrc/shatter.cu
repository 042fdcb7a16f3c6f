// The in-place shatter of a moved sprite into its atlas slots, for Hopper
// (sm_90a).
//
// Replaces the XLA program (not a Pallas kernel) of the JAX package's
// animated frame: coherence_tpu/raster/tiled_scene.py:62
// _shatter_into_kernel over :45 _shatter_kernel.  As eager torch it is
// about ten launches and two copies (raster/tiled_scene.py
// shatter_into_torch: the plain version, bit for bit).
//
// The function.  The sprite's (hs, ws, 4) int32 RGBA is packed as
// r | g << 8 | b << 16 | a << 24 (a bare OR, no clamp, as pack_rgba) and
// cut into n 64x128 pieces: piece j of band b, written to atlas slot
// base + j of that band's atlas, is packed[r + oys[b][j]][c + oxs[b][j]],
// zero where that lies outside the raster.  The (n,) form is one band; the
// (n_bands, n) form is BandedAtlas.update_inplace's, where out-of-range
// offsets write zero pieces.  The offsets are int32 on the card (one
// staged upload a frame); padding slots repeat a piece, and their writes
// are equal.
//
// What bounds it: bytes.  Each piece's 32 KB written once and the raster's
// pixels under it read once (16 bytes each).
//
// Design: kSplit 256-thread blocks per piece and band, each owning 8 of
// the piece's 64 rows, so that a frame's few pieces still spread over the
// card's SMs (one block a piece left 12 blocks for the lion's blob and took
// 0.0105 ms on an NVIDIA H100 80GB HBM3 at 700 W); each thread writes 4
// adjacent pixels of a row as one 16-byte store (a warp covers one 512-byte
// row), reading their RGBA from the raster's row (coalesced, 16 bytes a
// pixel).  Positions are 64-bit, so that no offset can overflow.
//
// What holds it: the launch.  Its body took 1.7 us of device time in
// config 5's frame, its launch floor about 4.7 us (an empty kernel timed as
// chip_smoke.py times a kernel; NVIDIA H100 80GB HBM3, 700 W).  The
// frame's next kernel (composite_dirty or composite_dirty_banded) is
// launched with programmatic dependent launch (pdl.cuh), so that its launch
// overlaps this kernel's end.  This kernel does not trigger its dependent
// early: with a trigger at entry here and in composite_dirty, queued lion
// frames took 1.8-3.0 us longer than with neither (pdl.cuh).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPieceH = 64;
constexpr int kPieceW = 128;
constexpr int kThreads = 256;
constexpr int kQuads = kPieceW / 4;  // 16-byte stores per piece row
constexpr int kSplit = kPieceH * kQuads / kThreads;  // blocks per piece: 8, of 8 rows each

__device__ __forceinline__ uint32_t pack(int4 v) {
  return static_cast<uint32_t>(v.x) | (static_cast<uint32_t>(v.y) << 8) | (static_cast<uint32_t>(v.z) << 16) |
         (static_cast<uint32_t>(v.w) << 24);
}

__global__ void __launch_bounds__(kThreads)
shatter_kernel(const int4* __restrict__ rgba, int hs, int ws, const int* __restrict__ oys,
               const int* __restrict__ oxs, int n, uint32_t* __restrict__ atlas, long band_words, int base) {
  const int j = blockIdx.x / kSplit, b = blockIdx.y;
  const long oy = oys[static_cast<long>(b) * n + j], ox = oxs[static_cast<long>(b) * n + j];
  uint4* piece = reinterpret_cast<uint4*>(atlas + b * band_words + static_cast<long>(base + j) * kPieceH * kPieceW);
  const int i = (blockIdx.x % kSplit) * kThreads + threadIdx.x;  // this thread's 16-byte store
  const long iy = i / kQuads + oy;
  const long ix0 = (i % kQuads) * 4 + ox;
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (iy >= 0 && iy < hs) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long ix = ix0 + q;
      if (ix >= 0 && ix < ws) v[q] = pack(rgba[iy * ws + ix]);
    }
  }
  piece[i] = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError().  `atlas` holds
// n_bands atlases of `cap` slots each, one after another.
extern "C" int shatter_into(const void* rgba, int hs, int ws, const void* oys, const void* oxs, int n, int n_bands,
                            void* atlas, int cap, int base, void* stream) {
  shatter_kernel<<<dim3(n * kSplit, n_bands), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rgba), hs, ws, static_cast<const int*>(oys), static_cast<const int*>(oxs), n,
      static_cast<uint32_t*>(atlas), static_cast<long>(cap) * kPieceH * kPieceW, base);
  return static_cast<int>(cudaGetLastError());
}

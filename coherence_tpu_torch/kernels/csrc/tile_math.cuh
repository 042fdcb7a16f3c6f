// Packed-pixel tile math shared by the Hopper compositors (sm_90a).
//
// Pixels are premultiplied RGBA packed in one 32-bit word, r | g<<8 |
// b<<16 | a<<24 (the PyTorch side stores the same bits as int32).  The
// arithmetic is the JAX package's _over_packed bit for bit, including the
// bare OR of the packed fields with no clamp.
//
// A tile is 64x128 pixels.  Every compositor walks its tiles in 4-row
// stripes through stripe_ring.cuh's ring of TMA bulk copies, with this
// file's over_packed and open-pixel vote.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tile {

constexpr int kTileH = 64;
constexpr int kTileW = 128;
constexpr int kVecPerRow = kTileW / 4;  // 32 uint4 per row

__device__ __forceinline__ int prelerp(int p, int q, int a) {
  int t = a * p + 128;
  return p + q - (((t >> 8) + t) >> 8);
}

// Porter/Duff over of packed words, acc above layer.  On an accumulator
// whose alpha is 255 it returns the accumulator unchanged (prelerp(l, q,
// 255) == q for every byte l), so a walk may stop once its pixels are
// opaque without changing the output.
__device__ __forceinline__ uint32_t over_packed(uint32_t acc, uint32_t layer) {
  int aa = static_cast<int>(acc >> 24);
  int r = prelerp(layer & 0xFF, acc & 0xFF, aa);
  int g = prelerp((layer >> 8) & 0xFF, (acc >> 8) & 0xFF, aa);
  int b = prelerp((layer >> 16) & 0xFF, (acc >> 16) & 0xFF, aa);
  int a = prelerp(layer >> 24, aa, aa);
  return static_cast<uint32_t>(r) | (static_cast<uint32_t>(g) << 8) |
         (static_cast<uint32_t>(b) << 16) | (static_cast<uint32_t>(a) << 24);
}

__device__ __forceinline__ bool is_open(uint32_t px) { return (px >> 24) != 255u; }

__device__ __forceinline__ bool any_open4(uint4 v) {
  return is_open(v.x) | is_open(v.y) | is_open(v.z) | is_open(v.w);
}

}  // namespace tile

// Packed-pixel tile math shared by the Hopper compositors (sm_90a).
//
// Pixels are premultiplied RGBA packed in one 32-bit word, r | g<<8 |
// b<<16 | a<<24 (the PyTorch side stores the same bits as int32).  The
// arithmetic is the JAX package's _over_packed bit for bit, including the
// bare OR of the packed fields with no clamp.
//
// A tile is 64x128 pixels.  composite_tile below composites one by one
// block of 256 threads; each thread owns 32 pixels of the tile in
// registers, as 8 16-byte vectors with neighbouring threads on neighbouring
// addresses, so every tile read and write is a coalesced 16-byte access.
// It keeps one piece in flight per block (a dependent idxs[k] load, the
// piece's loads, then a block vote), so a tile takes its depth times one
// round trip to memory: it is bound by latency, not by its bytes.  Only
// banded.cu's composite_full_banded (K6) still walks with it, and
// composite_runs.cu (K4) walks one block a tile the same way with
// finish_tile.  K1, K2, K5 and K7 walk row stripes through
// stripe_ring.cuh's ring of TMA bulk copies instead, with this file's
// over_packed.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tile {

constexpr int kTileH = 64;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kVecPerRow = kTileW / 4;                         // 32 uint4 per row
constexpr int kVecPerThread = kTileH * kTileW / 4 / kThreads;  // 8

__device__ __forceinline__ int prelerp(int p, int q, int a) {
  int t = a * p + 128;
  return p + q - (((t >> 8) + t) >> 8);
}

// Porter/Duff over of packed words, acc above layer.
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

// `over` only where the accumulator is still open: the reference kernels'
// per-pixel mask.  (On an opaque accumulator `over` is the identity, so the
// mask never changes a value; it is kept to mirror the reference.)
__device__ __forceinline__ uint32_t over_open(uint32_t acc, uint32_t layer) {
  return is_open(acc) ? over_packed(acc, layer) : acc;
}

__device__ __forceinline__ uint4 over_open4(uint4 acc, uint4 layer) {
  return make_uint4(over_open(acc.x, layer.x), over_open(acc.y, layer.y),
                    over_open(acc.z, layer.z), over_open(acc.w, layer.w));
}

__device__ __forceinline__ bool any_open4(uint4 v) {
  return is_open(v.x) | is_open(v.y) | is_open(v.z) | is_open(v.w);
}

// Word offset of this thread's j-th vector inside a tile whose rows lie
// `pitch` words apart.
__device__ __forceinline__ long vec_offset(int j, long pitch) {
  int v = threadIdx.x + j * kThreads;
  return (v / kVecPerRow) * pitch + (v % kVecPerRow) * 4;
}

// out = acc over bg for this thread's pixels; `bg` and `out` point at the
// tile's top-left pixel, rows `pitch` words apart.
__device__ __forceinline__ void finish_tile(const uint4 (&acc)[kVecPerThread],
                                            const uint32_t* __restrict__ bg,
                                            uint32_t* __restrict__ out, long pitch) {
#pragma unroll
  for (int j = 0; j < kVecPerThread; ++j) {
    long off = vec_offset(j, pitch);
    uint4 b = __ldg(reinterpret_cast<const uint4*>(bg + off));
    uint4 o;
    o.x = over_packed(acc[j].x, b.x);
    o.y = over_packed(acc[j].y, b.y);
    o.z = over_packed(acc[j].z, b.z);
    o.w = over_packed(acc[j].w, b.w);
    *reinterpret_cast<uint4*>(out + off) = o;
  }
}

// Composite idxs[lo:hi] of `atlas` front to back over the background tile
// `bg` into `out`; both point at the tile's top-left pixel, rows `pitch`
// words apart.  After each piece the block votes and stops once every pixel
// is opaque (an early stop never changes the output: `over` onto an opaque
// pixel is the identity).  Every thread of the block must call it.
__device__ __forceinline__ void composite_tile(const int* __restrict__ idxs, int lo, int hi,
                                               const uint32_t* __restrict__ atlas,
                                               const uint32_t* __restrict__ bg,
                                               uint32_t* __restrict__ out, long pitch) {
  uint4 acc[kVecPerThread];
#pragma unroll
  for (int j = 0; j < kVecPerThread; ++j) acc[j] = make_uint4(0u, 0u, 0u, 0u);

  for (int k = lo; k < hi; ++k) {
    const uint4* piece =
        reinterpret_cast<const uint4*>(atlas + static_cast<long>(idxs[k]) * (kTileH * kTileW));
    bool open = false;
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j) {
      uint4 l = __ldg(piece + threadIdx.x + j * kThreads);
      acc[j].x = over_packed(acc[j].x, l.x);
      acc[j].y = over_packed(acc[j].y, l.y);
      acc[j].z = over_packed(acc[j].z, l.z);
      acc[j].w = over_packed(acc[j].w, l.w);
      open |= any_open4(acc[j]);
    }
    if (!__syncthreads_or(open)) break;
  }

  finish_tile(acc, bg, out, pitch);
}

}  // namespace tile

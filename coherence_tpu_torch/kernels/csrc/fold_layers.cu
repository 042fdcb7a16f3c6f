// Front-to-back fold of a layer pack into a window, for Hopper (sm_90a).
//
// Replaces the fold body that the JAX package compiles into one XLA
// program per call: coherence_tpu/raster/framepath.py fold_layers_carry,
// shared there by the window recomposite programs of FrameBuffer and by the
// batched group compositor (scene/fastframe.py _group_fold_chunk).  It is
// not a Pallas kernel; as eager torch it would be about ten launches per
// layer.
//
// Every window pixel walks the K layers in order.  Layer k is a sprite
// (int32 premultiplied RGBA and a bool mask, both (hs, ws)) whose origin
// sits at (dy, dx) in window coordinates; the pixel (y, x) reads it at
// (y - dy, x - dx) when that lies inside it.  Where its mask is set and
// the pixel is still open, acc = over(acc, layer) and covered = 1; once
// acc's alpha is 255 the pixel closes and stops walking.  The carry
// (acc, open, covered) comes in and goes out, so that chunking the layers
// is the identity for this left fold.  Integer math, bit for bit the plain
// version (raster/framepath.py fold_layers_carry_torch).
//
// What bounds it: bytes.  Each pixel reads one mask byte per layer that
// lies over it until it closes, 16 bytes of RGBA where the mask is set,
// and its carry once in and once out.  Design, the simple one: one thread
// per window pixel, the layer records (pointer, pointer, hs, ws, dy, dx)
// staged through shared memory in chunks, and a block that stops at the
// first chunk boundary where none of its pixels is open.

#include <cstdint>

namespace {

// One row of the wrapper's (K, 6) int64 table.
struct LayerRecord {
  long long rgba;  // const int4*: (hs, ws) RGBA
  long long mask;  // const uint8_t*: (hs, ws) bool
  long long hs, ws;
  long long dy, dx;  // the layer's origin in window coordinates
};

constexpr int kThreads = 256;
constexpr int kChunk = 128;  // layer records staged in shared memory at a time

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

__global__ void __launch_bounds__(kThreads)
fold_layers_kernel(const LayerRecord* __restrict__ table, int k_layers, const int4* __restrict__ acc_in,
                   const uint8_t* __restrict__ open_in, const uint8_t* __restrict__ cov_in,
                   int4* __restrict__ acc_out, uint8_t* __restrict__ open_out, uint8_t* __restrict__ cov_out,
                   int hb, int wb) {
  __shared__ LayerRecord rec[kChunk];
  const long n = static_cast<long>(hb) * wb;
  const long p = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = p < n;
  const long y = live ? p / wb : 0, x = live ? p % wb : 0;
  int4 acc = live ? acc_in[p] : make_int4(0, 0, 0, 0);
  bool open = live && open_in[p] != 0;
  bool cov = live && cov_in[p] != 0;
  for (int k0 = 0; k0 < k_layers; k0 += kChunk) {
    // The barrier also keeps the last chunk's records until every thread is done with them.
    if (!__syncthreads_or(open)) break;
    const int nk = min(kChunk, k_layers - k0);
    for (int j = threadIdx.x; j < nk; j += kThreads) rec[j] = table[k0 + j];
    __syncthreads();
    for (int j = 0; j < nk && open; ++j) {
      const LayerRecord& r = rec[j];
      const long long iy = y - r.dy, ix = x - r.dx;
      if (iy < 0 || iy >= r.hs || ix < 0 || ix >= r.ws) continue;
      const long long q = iy * r.ws + ix;
      if (!reinterpret_cast<const uint8_t*>(r.mask)[q]) continue;
      acc = over(acc, reinterpret_cast<const int4*>(r.rgba)[q]);
      cov = true;
      if (acc.w == 255) open = false;
    }
  }
  if (live) {
    acc_out[p] = acc;
    open_out[p] = open;
    cov_out[p] = cov;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError().  hb * wb > 0.
extern "C" int fold_layers(const void* table, const void* acc_in, const void* open_in, const void* cov_in,
                           void* acc_out, void* open_out, void* cov_out, int k_layers, int hb, int wb,
                           void* stream) {
  const long n = static_cast<long>(hb) * wb;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  fold_layers_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const LayerRecord*>(table), k_layers, static_cast<const int4*>(acc_in),
      static_cast<const uint8_t*>(open_in), static_cast<const uint8_t*>(cov_in), static_cast<int4*>(acc_out),
      static_cast<uint8_t*>(open_out), static_cast<uint8_t*>(cov_out), hb, wb);
  return static_cast<int>(cudaGetLastError());
}

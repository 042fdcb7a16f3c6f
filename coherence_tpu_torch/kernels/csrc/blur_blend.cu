// The blur filter's blend pass for Hopper (sm_90a): the exact separable
// integer Gaussian of a window, blended into the display by the filter
// geometry's alpha plane.
//
// Replaces the XLA programs (not Pallas kernels) of the JAX package's blur
// paths:
//   window mode <- coherence_tpu/scene/fastframe.py:1158
//                  _blur_blend_window_kernel over raster/framepath.py:310
//                  conv_blend_window (and the blur half of framepath.py:429
//                  _recomposite_blur_kernel);
//   rect mode   <- raster/framepath.py:475 _apply_blur_rect_kernel.
// As eager torch each is about 40 launches (raster/framepath.py blur,
// conv_blend_window, apply_blur_rect: the plain versions, bit for bit).
//
// The function, in window coordinates (y, x) of an hb x wb window:
//   x pass  cx = setcanvas(sum_k w[k] * content[y][x + k - r] // total)
//   y pass  cy = setcanvas(sum_k w[k] * cx[y + k - r][x] // total)
// with zeros outside the WINDOW (not the frame: the JAX package pads the
// window slice), `//` the floor division, setcanvas the reference's clamp
// of r and g to alpha with b left alone (convolve.ml:115-119), and every
// sum wrapping in 32 bits as the JAX package's int32 sums do (unsigned
// arithmetic here).  Then blended = dissolve(content, 255 - a) +
// dissolve(cy, a), a the alpha plane's pixel, dissolve with the
// reference's 0 / 255 early outs and div255(i) = (i + (i >> 8) + 1) >> 8.
//   window mode writes blended where (in_d | (bloat(in_d, r) & a > 0)) &
//     inwin, in place in the display, and leaves every other pixel;
//   rect mode (the whole frame as the window) writes blended where a > 0
//     and the content elsewhere, into a new plane.
// The content is a packed int32 plane (r | g << 8 | b << 16 | a << 24,
// unpacked with & 0xFF) or unpacked (.., 4) int32 RGBA; each plane is read
// at its own origin and row stride.
//
// What bounds it: bytes.  The content window and the alpha window read
// once, the written pixels' 16 bytes each (the changed ones, or the whole
// plane in rect mode); its integer multiply-adds (2 (2r + 1) a pixel and
// channel) are well under the card's rate at the radii a user sets.
//
// Design, simple and for any radius:
//  1. A block of 8 warps owns a 32-row x 32-column tile of the window; a
//     warp's lanes lie along x (coalesced rows), each thread keeps 4 output
//     rows of one column, their sums in registers.  (64-row tiles gave the
//     lion's 256x512 window 64 blocks and took 0.0297 ms on an NVIDIA H100
//     80GB HBM3 at 700 W: each block's chain of x-pass reads was the time.)
//  2. Each thread first decides which of its pixels change; a block with
//     none returns before any blur (most of a window outside bloat(in_d,
//     r)).  Rect mode copies the content of its unblended pixels there.
//  3. The y pass needs x-pass values of rows [tile - r, tile + 32 + r) of
//     the tile's columns.  They are made in chunks of 64 rows, each x-pass
//     value once per block, into 32 KB of shared memory; after each chunk
//     every thread adds in the rows of it that its outputs reach.  The
//     x pass reads the content through L1 (2r + 1 reads a value, a warp's
//     along one row).  The chunks keep the shared memory fixed, so that any
//     radius runs with the same tile: the radius only lengthens the loops.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;                          // a warp across columns
constexpr int kWarps = 8;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kWarps * kRowsPerThread;  // 32
constexpr int kChunk = 64;                         // x-pass rows per shared-memory chunk

struct Params {
  const int* src;      // content: packed (rows, stride) or unpacked (rows, stride, 4)
  long src_stride;     // pixels per row
  int sy, sx;          // the window's origin in it
  const int* alpha;    // (rows, stride) int32
  long alpha_stride;
  int ay, ax;
  int4* dst;           // (rows, stride, 4) int32
  long dst_stride;
  int dy, dx;
  const int* weights;  // 2r + 1
  int radius, total;
  int hb, wb;          // the window
  int ry0, rx0, h, w;  // window mode: the logical window inside it
  int d0, d1, d2, d3;  // window mode: the dirty rect, inclusive
};

__device__ __forceinline__ int wrap(uint32_t v) { return static_cast<int>(v); }

__device__ __forceinline__ int floordiv(int s, int t) {  // t > 0
  const int q = s / t;
  return (q * t != s && s < 0) ? q - 1 : q;
}

__device__ __forceinline__ int4 setcanvas(const uint32_t (&sum)[4], int total) {
  const int r = floordiv(wrap(sum[0]), total), g = floordiv(wrap(sum[1]), total);
  const int b = floordiv(wrap(sum[2]), total), a = floordiv(wrap(sum[3]), total);
  return make_int4(min(a, r), min(a, g), b, a);
}

__device__ __forceinline__ int div255(int i) {
  return wrap(static_cast<uint32_t>(i) + static_cast<uint32_t>(i >> 8) + 1u) >> 8;
}

__device__ __forceinline__ int dissolve(int c, int d) {
  return d == 0 ? 0 : d == 255 ? c : div255(wrap(static_cast<uint32_t>(c) * static_cast<uint32_t>(d)));
}

template <bool kPacked>
__device__ __forceinline__ int4 content_at(const Params& p, int y, int x) {
  const long i = static_cast<long>(p.sy + y) * p.src_stride + p.sx + x;
  if (kPacked) {
    const uint32_t v = static_cast<uint32_t>(__ldg(p.src + i));
    return make_int4(v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF, v >> 24);
  }
  return __ldg(reinterpret_cast<const int4*>(p.src) + i);
}

__device__ __forceinline__ void mac(uint32_t (&sum)[4], uint32_t wk, int4 v) {
  sum[0] += wk * static_cast<uint32_t>(v.x);
  sum[1] += wk * static_cast<uint32_t>(v.y);
  sum[2] += wk * static_cast<uint32_t>(v.z);
  sum[3] += wk * static_cast<uint32_t>(v.w);
}

// The x pass at window pixel (y, x), its taps clipped to the window.
template <bool kPacked>
__device__ int4 xpass(const Params& p, int y, int x) {
  uint32_t sum[4] = {0u, 0u, 0u, 0u};
  const int r = p.radius;
  const int k1 = min(2 * r, p.wb - 1 - x + r);
#pragma unroll 4
  for (int k = max(0, r - x); k <= k1; ++k) {
    mac(sum, static_cast<uint32_t>(__ldg(p.weights + k)), content_at<kPacked>(p, y, x + k - r));
  }
  return setcanvas(sum, p.total);
}

template <bool kPacked, bool kRect>
__global__ void __launch_bounds__(kCols * kWarps) blur_blend_kernel(Params p) {
  __shared__ int4 cx[kChunk][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int x = blockIdx.x * kCols + lane;
  const int tile_y = blockIdx.y * kTileRows;
  const int y0 = tile_y + warp * kRowsPerThread;
  const int r = p.radius;

  // 1. Which of this thread's pixels take the blend.
  unsigned mine = 0;
  int a[kRowsPerThread];
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int y = y0 + t;
    a[t] = 0;
    if (x >= p.wb || y >= p.hb) continue;
    a[t] = __ldg(p.alpha + static_cast<long>(p.ay + y) * p.alpha_stride + p.ax + x);
    bool changed;
    if (kRect) {
      changed = a[t] > 0;
    } else {
      const bool in_d = y >= p.d0 && y <= p.d2 && x >= p.d1 && x <= p.d3;
      const bool in_blur = y >= p.d0 - r && y <= p.d2 + r && x >= p.d1 - r && x <= p.d3 + r;
      const bool inwin = y >= p.ry0 && y < p.ry0 + p.h && x >= p.rx0 && x < p.rx0 + p.w;
      changed = (in_d || (in_blur && a[t] > 0)) && inwin;
    }
    if (changed) {
      mine |= 1u << t;
    } else if (kRect) {
      p.dst[static_cast<long>(p.dy + y) * p.dst_stride + p.dx + x] = content_at<kPacked>(p, y, x);
    }
  }
  if (!__syncthreads_or(mine != 0)) return;

  // 2. The y pass, its x-pass rows made chunk by chunk in shared memory.
  uint32_t sum[kRowsPerThread][4] = {};
  const int lo = max(0, tile_y - r), hi = min(p.hb, tile_y + kTileRows + r);
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int c1 = min(hi, c0 + kChunk);
    for (int j = c0 + warp; j < c1; j += kWarps) {
      cx[j - c0][lane] = x < p.wb ? xpass<kPacked>(p, j, x) : make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    if (mine) {
      const int jhi = min(c1, y0 + kRowsPerThread + r);
      for (int j = max(c0, y0 - r); j < jhi; ++j) {
        const int4 v = cx[j - c0][lane];
#pragma unroll
        for (int t = 0; t < kRowsPerThread; ++t) {
          const int k = j - (y0 + t) + r;
          if (k >= 0 && k <= 2 * r) mac(sum[t], static_cast<uint32_t>(__ldg(p.weights + k)), v);
        }
      }
    }
    __syncthreads();
  }

  // 3. The blend of the changed pixels.
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    if (!((mine >> t) & 1u)) continue;
    const int y = y0 + t;
    const int4 cy = setcanvas(sum[t], p.total);
    const int4 c = content_at<kPacked>(p, y, x);
    const int keep = wrap(255u - static_cast<uint32_t>(a[t]));
    const int4 out = make_int4(
        wrap(static_cast<uint32_t>(dissolve(c.x, keep)) + static_cast<uint32_t>(dissolve(cy.x, a[t]))),
        wrap(static_cast<uint32_t>(dissolve(c.y, keep)) + static_cast<uint32_t>(dissolve(cy.y, a[t]))),
        wrap(static_cast<uint32_t>(dissolve(c.z, keep)) + static_cast<uint32_t>(dissolve(cy.z, a[t]))),
        wrap(static_cast<uint32_t>(dissolve(c.w, keep)) + static_cast<uint32_t>(dissolve(cy.w, a[t]))));
    p.dst[static_cast<long>(p.dy + y) * p.dst_stride + p.dx + x] = out;
  }
}

template <bool kPacked, bool kRect>
void launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.wb + kCols - 1) / kCols, (p.hb + kTileRows - 1) / kTileRows);
  blur_blend_kernel<kPacked, kRect><<<grid, dim3(kCols, kWarps), 0, stream>>>(p);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError().  `packed` says which
// form the content has; `rect` picks the mode (the geometry after it is read
// in window mode only).
extern "C" int blur_blend(const void* src, int packed, int src_stride, int sy, int sx, const void* alpha,
                          int alpha_stride, int ay, int ax, void* dst, int dst_stride, int dy, int dx,
                          const void* weights, int radius, int total, int hb, int wb, int rect, int ry0,
                          int rx0, int h, int w, int d0, int d1, int d2, int d3, void* stream) {
  const Params p{static_cast<const int*>(src), src_stride, sy, sx, static_cast<const int*>(alpha), alpha_stride,
                 ay, ax, static_cast<int4*>(dst), dst_stride, dy, dx, static_cast<const int*>(weights), radius,
                 total, hb, wb, ry0, rx0, h, w, d0, d1, d2, d3};
  const auto s = static_cast<cudaStream_t>(stream);
  if (packed) {
    rect ? launch<true, true>(p, s) : launch<true, false>(p, s);
  } else {
    rect ? launch<false, true>(p, s) : launch<false, false>(p, s);
  }
  return static_cast<int>(cudaGetLastError());
}

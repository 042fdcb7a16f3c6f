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
// channel) are under the card's int32 rate at the radii a user sets.
//
// Design (0.0090 ms at the lion's 256x512 window, 0.048 ms in rect mode at
// 1080p, on an NVIDIA H100 80GB HBM3 at 700 W; profile_blur.py):
//  1. The grid covers only the pixels that can change: in window mode the
//     wrapper launches over bloat(d_box, r) & the logical window
//     (kernels.blur_launch_rect), whose origin (gy0, gx0) the kernel takes;
//     rect mode covers the frame.  A block of 8 warps owns a 16-row x
//     32-column tile, a warp's lanes along x, each thread 2 output rows of
//     one column.
//  2. Everything a block reads comes in by one asynchronous copy
//     (cp.async: 4 bytes a packed pixel, so that any origin aligns; 16 an
//     unpacked one), waited for once: the tile's alpha, its content with
//     the halo (tile rows and columns +- r) and the weights.  Pixels
//     outside the window copy zero bytes (src-size 0), which is the
//     window-edge padding.  A window-mode block whose pixels none change
//     then leaves.
//  3. The x pass, the y pass and the blend read shared memory only.  Any
//     radius runs with the same tile and the same shared memory: the taps
//     go in fixed chunks, kTapsY of the y pass (its kRows x-pass rows a
//     chunk) and kTapsX of the x pass (its kSegCols content columns a
//     segment), each chunk and segment a copy of its own; up to r = 8 one
//     copy holds all.  A thread makes two x-pass rows at a time and keeps
//     their sums in shared memory between segments, so that 64 registers
//     hold four blocks an SM without spills.
//  4. The floor division by the weights' total is a multiply-high by a
//     magic number and a shift (kernels.blur_divider, exact for every
//     int32 sum), not the integer division's instruction sequence.
// What holds it (profile_blur.py's last rows, same card): a window takes
// one launch floor (an empty kernel, 0.0048 ms) and one block's chain of a
// cold copy, the passes and the stores: the lion's window launched over one
// tile takes 0.0085 ms against 0.0090 over its 117.  Rect mode at 1080p is
// 31 % of its bound: over an all-zero alpha (a copy only) it takes 0.027
// ms, and each unit of radius adds about 0.004 ms.
//  5. Both modes launch with programmatic dependent launch (pdl.cuh), so
//     that the launch overlaps the end of the kernel before them
//     (composite_dirty in an animated frame), and wait at entry for its
//     writes.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "pdl.cuh"

namespace {

constexpr int kCols = 32;                       // a warp across the tile's columns
constexpr int kWarps = 8;
constexpr int kMinBlocks = 4;                   // blocks an SM, for __launch_bounds__
constexpr int kThreads = kCols * kWarps;
constexpr int kTileRows = 16;
constexpr int kOutRows = kTileRows / kWarps;    // output rows a thread: 2
constexpr int kTapsY = 17;                      // y-pass taps a chunk
constexpr int kTapsX = 17;                      // x-pass taps a segment
constexpr int kRows = kTapsY + kTileRows - 1;   // x-pass rows a chunk: 32
constexpr int kSegCols = kTapsX + kCols - 1;    // content columns a segment: 48
static_assert(kOutRows == 2, "the y pass walks two adjacent output rows a thread");
static_assert(kTapsY <= kThreads && kTapsX <= kThreads, "a copy's weights take one thread each");

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
  int radius;
  uint32_t magic;      // floor(s / total) = magic * s >> shift for 0 <= s < 2^31
  int shift;
  int hb, wb;          // the window
  int gy0, gx0;        // the grid's origin in the window
  int ry0, rx0, h, w;  // window mode: the logical window inside it
  int d0, d1, d2, d3;  // window mode: the dirty rect, inclusive
};

// A block's shared memory: the content of one chunk and segment; the
// chunk's x-pass values (their raw sums until the chunk's last segment).
template <bool kPacked>
struct Tile {
  using Pixel = typename std::conditional<kPacked, uint32_t, int4>::type;
  Pixel content[kRows][kSegCols];
  int4 cx[kRows][kCols];
  int alpha[kTileRows][kCols];
  uint32_t wx[kTapsX];
  uint32_t wy[kTapsY];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies kBytes (4 or 16) to shared memory, or zeros where !`fill`.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool fill) {
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(fill ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(fill ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ int wrap(uint32_t v) { return static_cast<int>(v); }

// floor(s / total) for any int32 s: for s < 0, floor(s / t) = -1 - (-s - 1) / t,
// so with sign = s >> 31 it is sign ^ ((s ^ sign) / t), and 0 <= s ^ sign < 2^31.
__device__ __forceinline__ int floordiv(uint32_t sum, const Params& p) {
  const int s = wrap(sum), sign = s >> 31;
  const uint32_t n = static_cast<uint32_t>(s ^ sign);
  return static_cast<int>((static_cast<unsigned long long>(p.magic) * n) >> p.shift) ^ sign;
}

__device__ __forceinline__ int4 setcanvas(const uint32_t (&sum)[4], const Params& p) {
  const int r = floordiv(sum[0], p), g = floordiv(sum[1], p);
  const int b = floordiv(sum[2], p), a = floordiv(sum[3], p);
  return make_int4(min(a, r), min(a, g), b, a);
}

__device__ __forceinline__ int div255(int i) {
  return wrap(static_cast<uint32_t>(i) + static_cast<uint32_t>(i >> 8) + 1u) >> 8;
}

__device__ __forceinline__ int dissolve(int c, int d) {
  return d == 0 ? 0 : d == 255 ? c : div255(wrap(static_cast<uint32_t>(c) * static_cast<uint32_t>(d)));
}

__device__ __forceinline__ int blend1(int c, int cy, int keep, int a) {
  return wrap(static_cast<uint32_t>(dissolve(c, keep)) + static_cast<uint32_t>(dissolve(cy, a)));
}

__device__ __forceinline__ int4 channels(uint32_t v) {
  return make_int4(v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF, v >> 24);
}

__device__ __forceinline__ int4 channels(int4 v) { return v; }

template <bool kPacked>
__device__ __forceinline__ typename Tile<kPacked>::Pixel content_at(const Params& p, int y, int x) {
  const long i = static_cast<long>(p.sy + y) * p.src_stride + p.sx + x;
  if constexpr (kPacked) {
    return static_cast<uint32_t>(__ldg(p.src + i));
  } else {
    return __ldg(reinterpret_cast<const int4*>(p.src) + i);
  }
}

__device__ __forceinline__ void mac(uint32_t (&sum)[4], uint32_t wk, int4 v) {
  sum[0] += wk * static_cast<uint32_t>(v.x);
  sum[1] += wk * static_cast<uint32_t>(v.y);
  sum[2] += wk * static_cast<uint32_t>(v.z);
  sum[3] += wk * static_cast<uint32_t>(v.w);
}

// Queues the copy of window rows [row0, row0 + rows) x columns [col0, col0 +
// cols) of the content into the tile, zeros outside the window.
template <bool kPacked>
__device__ __forceinline__ void stage_content(Tile<kPacked>& s, const Params& p, int row0, int rows, int col0,
                                              int cols) {
  for (int i = threadIdx.y; i < rows; i += kWarps) {
    const int y = row0 + i;
    const bool row_in = y >= 0 && y < p.hb;
    const long row_at = static_cast<long>(p.sy + y) * p.src_stride + p.sx;
    for (int c = threadIdx.x; c < cols; c += kCols) {
      const int x = col0 + c;
      const bool in = row_in && x >= 0 && x < p.wb;
      const long at = in ? row_at + x : 0;
      if constexpr (kPacked) {
        cp_async<4>(&s.content[i][c], p.src + at, in);
      } else {
        cp_async<16>(&s.content[i][c], reinterpret_cast<const int4*>(p.src) + at, in);
      }
    }
  }
}

__device__ __forceinline__ void stage_weights(uint32_t* dst, const int* weights, int k0, int n) {
  const int t = threadIdx.y * kCols + threadIdx.x;
  if (t < n) cp_async<4>(dst + t, weights + k0 + t, true);
}

// The x pass of one segment (nkx taps) at kN chunk rows of this thread's
// column, rows `row`, row + kWarps, ...: their sums so far come from cx
// (none on the first segment) and go back to it, set on the last.
template <bool kPacked, int kN>
__device__ __forceinline__ void xpass_rows(Tile<kPacked>& s, const Params& p, int row, int nkx, bool first,
                                           bool last) {
  const int lane = threadIdx.x;
  uint32_t sum[kN][4];
#pragma unroll
  for (int t = 0; t < kN; ++t) {
    const int4 v = first ? make_int4(0, 0, 0, 0) : s.cx[row + kWarps * t][lane];
    sum[t][0] = v.x, sum[t][1] = v.y, sum[t][2] = v.z, sum[t][3] = v.w;
  }
#pragma unroll 4
  for (int k = 0; k < nkx; ++k) {
    const uint32_t wk = s.wx[k];
#pragma unroll
    for (int t = 0; t < kN; ++t) mac(sum[t], wk, channels(s.content[row + kWarps * t][lane + k]));
  }
#pragma unroll
  for (int t = 0; t < kN; ++t) {
    s.cx[row + kWarps * t][lane] =
        last ? setcanvas(sum[t], p) : make_int4(wrap(sum[t][0]), wrap(sum[t][1]), wrap(sum[t][2]), wrap(sum[t][3]));
  }
}

template <bool kPacked, bool kRect>
__global__ void __launch_bounds__(kThreads, kMinBlocks) blur_blend_kernel(Params p) {
  using Pixel = typename Tile<kPacked>::Pixel;
  __shared__ Tile<kPacked> s;
  pdl::wait();  // the kernel before this one has finished and its writes are visible
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int ty0 = p.gy0 + blockIdx.y * kTileRows, tx0 = p.gx0 + blockIdx.x * kCols;
  const int x = tx0 + lane, yl0 = warp * kOutRows;
  const int r = p.radius, taps = 2 * r + 1;
  // Whether the first copy holds the tile's own pixels (its rows and columns at tap r).
  const bool own_staged = r < kTapsY && r < kTapsX;

  // 1. One copy: the alpha tile, the first chunk and segment of content, their weights.
  for (int i = warp; i < kTileRows; i += kWarps) {
    const int y = ty0 + i;
    const bool in = y < p.hb && x < p.wb;
    cp_async<4>(&s.alpha[i][lane], p.alpha + (in ? static_cast<long>(p.ay + y) * p.alpha_stride + p.ax + x : 0), in);
  }
  const int nky0 = min(kTapsY, taps), nkx0 = min(kTapsX, taps);
  stage_content(s, p, ty0 - r, nky0 + kTileRows - 1, tx0 - r, nkx0 + kCols - 1);
  stage_weights(s.wx, p.weights, 0, nkx0);
  stage_weights(s.wy, p.weights, 0, nky0);
  Pixel own[kOutRows];  // the content of this thread's output pixels
#pragma unroll
  for (int t = 0; t < kOutRows; ++t) {
    const int y = ty0 + yl0 + t;
    own[t] = Pixel{};
    if (!own_staged && y < p.hb && x < p.wb) own[t] = content_at<kPacked>(p, y, x);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. Which of this thread's pixels take the blend.
  unsigned mine = 0;
  int a[kOutRows];
#pragma unroll
  for (int t = 0; t < kOutRows; ++t) {
    const int y = ty0 + yl0 + t;
    a[t] = s.alpha[yl0 + t][lane];
    if (own_staged) own[t] = s.content[yl0 + t + r][lane + r];
    bool changed;
    if constexpr (kRect) {
      changed = a[t] > 0;
    } else {
      const bool in_d = y >= p.d0 && y <= p.d2 && x >= p.d1 && x <= p.d3;
      const bool in_blur = y >= p.d0 - r && y <= p.d2 + r && x >= p.d1 - r && x <= p.d3 + r;
      const bool inwin = y >= p.ry0 && y < p.ry0 + p.h && x >= p.rx0 && x < p.rx0 + p.w;
      changed = (in_d || (in_blur && a[t] > 0)) && inwin;
    }
    if (changed && y < p.hb && x < p.wb) mine |= 1u << t;
  }
  const bool any = __syncthreads_or(mine != 0);
  if (!kRect && !any) return;

  // 3. The passes, chunk by chunk of the y taps, segment by segment of the x taps.
  uint32_t ysum[kOutRows][4] = {};
  for (int k0 = 0; any && k0 < taps; k0 += kTapsY) {
    const int nky = min(kTapsY, taps - k0);
    const int row0 = ty0 - r + k0, rows = nky + kTileRows - 1;
    for (int ks = 0; ks < taps; ks += kTapsX) {
      const int nkx = min(kTapsX, taps - ks);
      if (k0 > 0 || ks > 0) {
        stage_content(s, p, row0, rows, tx0 - r + ks, nkx + kCols - 1);
        stage_weights(s.wx, p.weights, ks, nkx);
        if (ks == 0) stage_weights(s.wy, p.weights, k0, nky);
        cp_async_wait_all();
        __syncthreads();
      }
      // The x pass: this warp's rows of the chunk, warp + kWarps * t, two at a time.
      const bool first = ks == 0, last = ks + kTapsX >= taps;
      for (int row = warp; row < rows; row += 2 * kWarps) {
        if (row + kWarps < rows) {
          xpass_rows<kPacked, 2>(s, p, row, nkx, first, last);
        } else {
          xpass_rows<kPacked, 1>(s, p, row, nkx, first, last);
        }
      }
      __syncthreads();  // the next segment's copy takes the content's place; the y pass reads cx
    }
    // The y pass: x-pass row yl0 + i is tap i of output row 0 and tap i - 1 of output row 1.
    int4 v = s.cx[yl0][lane];
    uint32_t w_prev = s.wy[0];
    mac(ysum[0], w_prev, v);
    for (int i = 1; i < nky; ++i) {
      v = s.cx[yl0 + i][lane];
      const uint32_t wi = s.wy[i];
      mac(ysum[0], wi, v);
      mac(ysum[1], w_prev, v);
      w_prev = wi;
    }
    mac(ysum[1], w_prev, s.cx[yl0 + nky][lane]);
    __syncthreads();  // before the next chunk's copy and x pass
  }

  // 4. The blend of the changed pixels (rect mode: the content elsewhere).
#pragma unroll
  for (int t = 0; t < kOutRows; ++t) {
    const int y = ty0 + yl0 + t;
    const int4 c = channels(own[t]);
    int4 out = c;
    if ((mine >> t) & 1u) {
      const int4 cy = setcanvas(ysum[t], p);
      const int keep = wrap(255u - static_cast<uint32_t>(a[t]));
      out = make_int4(blend1(c.x, cy.x, keep, a[t]), blend1(c.y, cy.y, keep, a[t]), blend1(c.z, cy.z, keep, a[t]),
                      blend1(c.w, cy.w, keep, a[t]));
    } else if (!kRect || y >= p.hb || x >= p.wb) {
      continue;
    }
    p.dst[static_cast<long>(p.dy + y) * p.dst_stride + p.dx + x] = out;
  }
}

template <bool kPacked, bool kRect>
cudaError_t launch(const Params& p, int gh, int gw, cudaStream_t stream) {
  const dim3 grid((gw + kCols - 1) / kCols, (gh + kTileRows - 1) / kTileRows);
  return pdl::launch(blur_blend_kernel<kPacked, kRect>, grid, dim3(kCols, kWarps), 0, stream, p);
}

}  // namespace

// Launches on `stream` over the gh x gw pixels of the window at (gy0, gx0)
// and returns the launch's error, else cudaGetLastError().  `packed` says which form the content
// has; `rect` picks the mode (the geometry after it is read in window mode
// only); (magic, shift) is kernels.blur_divider of the weights' total.
extern "C" int blur_blend(const void* src, int packed, int src_stride, int sy, int sx, const void* alpha,
                          int alpha_stride, int ay, int ax, void* dst, int dst_stride, int dy, int dx,
                          const void* weights, int radius, unsigned magic, int shift, int hb, int wb, int gy0,
                          int gx0, int gh, int gw, int rect, int ry0, int rx0, int h, int w, int d0, int d1,
                          int d2, int d3, void* stream) {
  const Params p{static_cast<const int*>(src), src_stride, sy, sx, static_cast<const int*>(alpha), alpha_stride,
                 ay, ax, static_cast<int4*>(dst), dst_stride, dy, dx, static_cast<const int*>(weights), radius,
                 magic, shift, hb, wb, gy0, gx0, ry0, rx0, h, w, d0, d1, d2, d3};
  const auto s = static_cast<cudaStream_t>(stream);
  if (packed) {
    return static_cast<int>(rect ? launch<true, true>(p, gh, gw, s) : launch<true, false>(p, gh, gw, s));
  }
  return static_cast<int>(rect ? launch<false, true>(p, gh, gw, s) : launch<false, false>(p, gh, gw, s));
}

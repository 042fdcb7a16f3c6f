// The smear filter's walk for Hopper (sm_90a): a brush-sized patch
// dragged along a stroke over an RGBA canvas, in place, every pass in one
// launch.
//
// Replaces the XLA program (not a Pallas kernel) of the JAX package's
// smear: coherence_tpu/raster/brush.py:324 _smear_scan, called twice by
// smear().  As eager torch it is about 27 launches a step
// (raster/brush.py _smear_walk_torch: the plain version, bit for bit).
//
// The function.  For each pass and each step (row, col, dx, dy), in order,
// over the (bh, bw) patch at (row, col) of the (H, W) int32 RGBA canvas:
//   src = the patch at (row - dy, col - dx), dst = the patch at (row, col),
//   both read before the step writes anything;
//   dst <- al == 0 ? src : al == 255 ? dst
//          : dissolve(dst, al) + dissolve(src, 255 - al)
// per channel, al the opacity plane's texel and dissolve(c, d) =
// div255(c * d) (1 <= d <= 254 here), div255(i) = (i + (i >> 8) + 1) >> 8.
// al == 0 writes the source: unlike a stamp, a zero texel is not a no-op.
// The host (kernels.smear_steps) gives unit directions, -1 <= dx, dy <= 1,
// and keeps every step's source and destination on the canvas.
//
// What bounds it: not bytes.  Step i reads pixels that step i - 1 wrote,
// one pixel to the side, so the walk is a serial chain of steps * passes
// dependent steps on one block.  The walk as a whole must read and write
// each pixel it touches only once (chip_smoke.py smear_bound: 1.97 MB at
// the demo's 1024 steps) under its mixed texels' int32 operations; a chain
// on one block can go no faster than one SM's share of the card's int32
// rate (smear_bound's chain_floor_ms, 0.31 ms at the demo; it counts adds
// and shifts at the multiply-add rate, which they reach at half).
//
// Two modes, one launch of one block each.  A thread owns patch pixels
// tid, tid + blockDim.x, ... (the same ones every step).  The entry point
// picks the mode by the patch's size (window_shape), a rule of the design:
// window mode where the patch takes at most kMaxHeld pixels a thread and a
// window of it with a margin of at least one pixel fits in shared memory,
// global mode beyond (past radius 44 for a round brush).  Each launch can
// report what it did (`stats`): the window's rows and columns (0 in global
// mode), the window's loads, and the step from which the walk ran in
// device memory.
//
// Window mode (smear_window_kernel).  The first design walked in device
// memory: a dependent L2 read of source and destination a step, 1.25 us a
// step.  Here the block keeps a window of the canvas around the walk in
// dynamic shared memory and each step reads and writes only there.
//  * The window is the patch with a margin of up to kMaxMargin pixels on
//    every side (the largest that fits), cut to the canvas: 95 x 95 pixels
//    for the demo's 31x31 patch.  Thread q loads window pixels q, q + 512,
//    ..., so that a warp reads contiguous 16-byte pixels of a window row (a
//    31-wide patch row does not fill a warp).
//  * A step whose source or destination leaves the window (the walk
//    drifted past the margin, a clipped point made it jump, or the second
//    pass restarts at step 0) first writes back the window's changed
//    rectangle, the union of the patches written since the load, then
//    reloads the window around that step with three quarters of its slack
//    ahead of the walk (a step's direction points back to the last point):
//    60 loads for the demo's 2048 steps where a centred window takes 86.
//    The test reads only the step record, so it is uniform across the
//    block.  The last step writes back.
//  * A step is bound by its one SM's integer pipe (16 int32 lanes a clock
//    a scheduler: a warp instruction takes two of its cycles): the blend's
//    instructions and, repeated in every warp, the step's uniform work (its
//    record, the window test, the addresses).  With int4 pixels and the
//    int32 blend the demo took 1.29-1.50 ms on 256 to 1024 threads; the 60
//    reloads took 0.045 ms in all and the read-before-write barrier 0.075
//    ms (profile_smear.py variants, NVIDIA H100 80GB HBM3, 700 W).  So:
//     - the window holds packed pixels, r | g << 16 and b | a << 16, and
//       the blend works on two channels a 32-bit word, div255 of both
//       lanes in an add and two byte permutes (div255x2): exact wherever
//       the channels and the opacity lie in 0..255, which the blend keeps.
//       Every load checks its pixels: a window with a channel outside
//       0..255 (or an opacity outside it, checked at the start) ends the
//       window walk, and the walk goes on from that step in device memory,
//       as global mode walks (device_walk), on the block's 512 threads;
//     - a thread's pixels run straight-line, so that they interleave (a
//       slot past the patch reads a real pixel and writes nothing);
//     - 512 threads of up to kMaxHeld pixels (two at the demo): 16 warps
//       hide each other's latencies and repeat the uniform work less than
//       32 would (1.03 ms at the demo, against 1.12 on 256 threads and
//       1.16 on 1024; profile_smear.py variants, same card).
//  * Each step reads all before it writes: read, __syncthreads(), write,
//    __syncthreads().  The step records come through shared memory in
//    chunks of kStepChunk.
//
// Global mode (smear_global_kernel, the first design): a patch whose window
// does not fit (radius 120 is 241 x 241 x 16 B = 929 KB) walks the canvas in
// place in device memory (device_walk).  Per step a thread reads each of
// its pixels' source and destination and keeps the new value (in registers
// for its first kHeld pixels, beyond them in the `spill` scratch the
// wrapper allocates), __syncthreads(), writes, __syncthreads().  The next
// step's record is loaded while the current step runs.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;      // global mode's block
constexpr int kHeld = 4;            // device_walk: patch pixels a thread keeps in registers
constexpr int kWinThreads = 512;    // window mode's block
constexpr int kMaxHeld = 16;        // window mode: patch pixels a thread holds, so patches of up to 8192 pixels
constexpr int kMaxMargin = 32;      // window mode: the largest margin the window keeps around the patch
constexpr int kStepChunk = 256;     // window mode: step records staged in shared memory at a time
constexpr int kSmemBytes = 232448;  // the most dynamic shared memory a block takes on sm_90

struct Params {
  int4* canvas;        // (height, width) RGBA int32
  long width;
  const int* opac;     // (bh, bw)
  const int4* steps;   // (n) (row, col, dx, dy)
  int4* spill;         // device_walk: the new values of patch pixels from kHeld * blockDim.x on
  int* stats;          // null, or 4 ints: window rows, window columns, window loads, first step in device memory
  int n, passes, bh, bw;
  int height;
  int wh, ww;          // window mode: the window's rows and columns
};

__device__ __forceinline__ int wrap(uint32_t v) { return static_cast<int>(v); }

__device__ __forceinline__ int div255(int i) {
  return wrap(static_cast<uint32_t>(i) + static_cast<uint32_t>(i >> 8) + 1u) >> 8;
}

__device__ __forceinline__ int mix(int d, int s, int al, int keep) {
  return wrap(static_cast<uint32_t>(div255(wrap(static_cast<uint32_t>(d) * static_cast<uint32_t>(al)))) +
              static_cast<uint32_t>(div255(wrap(static_cast<uint32_t>(s) * static_cast<uint32_t>(keep)))));
}

// Window mode's packed pixels: r | g << 16 and b | a << 16, for channels in
// 0..255.
__device__ __forceinline__ uint2 packed(int4 v) {
  return make_uint2(static_cast<uint32_t>(v.x) | static_cast<uint32_t>(v.y) << 16,
                    static_cast<uint32_t>(v.z) | static_cast<uint32_t>(v.w) << 16);
}

__device__ __forceinline__ int4 unpacked(uint2 w) {
  return make_int4(static_cast<int>(w.x & 0xFFFFu), static_cast<int>(w.x >> 16), static_cast<int>(w.y & 0xFFFFu),
                   static_cast<int>(w.y >> 16));
}

// (x >> 8) & 0x00FF00FF in one byte permute: bytes 1 and 3 of x to bytes 0
// and 2, zeros (byte 4 of the second operand) elsewhere.
__device__ __forceinline__ uint32_t high_bytes(uint32_t x) { return __byte_perm(x, 0u, 0x4341); }

// div255 of both 16-bit lanes of x, each lane at most 255 * 255: no lane
// carries into the other, and each result is at most 255.
__device__ __forceinline__ uint32_t div255x2(uint32_t x) { return high_bytes(x + high_bytes(x) + 0x00010001u); }

// The packed blend, two channels a word.  Exact where the channels and al lie
// in 0..255: there div255(255 c) == c, so al == 0 gives the source and al ==
// 255 the destination with no select, and every result lies in 0..255 again
// (tests/test_torch_brush_kernel.py holds it to the exact blend at every
// (d, s, al)).
__device__ __forceinline__ uint2 blend(uint2 d, uint2 s, int al) {
  const uint32_t a = static_cast<uint32_t>(al), keep = 255u - a;
  return make_uint2(div255x2(d.x * a) + div255x2(s.x * keep), div255x2(d.y * a) + div255x2(s.y * keep));
}

// The exact blend of one pixel of device memory with its source `shift`
// pixels before it (any int32 values and opacity).
__device__ __forceinline__ int4 smeared(const int4* dst, long shift, int al) {
  const int4 d = *dst, s = *(dst - shift);
  if (al == 0) return s;
  if (al == 255) return d;
  const int keep = 255 - al;
  return make_int4(mix(d.x, s.x, al, keep), mix(d.y, s.y, al, keep), mix(d.z, s.z, al, keep),
                   mix(d.w, s.w, al, keep));
}

// The walk in device memory from step t0 on, on a block of kBlock threads:
// global mode's whole walk, and window mode's from a window that held a
// channel outside 0..255.
template <int kBlock>
__device__ __forceinline__ void device_walk(const Params& p, int t0) {
  const int n_px = p.bh * p.bw;
  long at_px[kHeld];  // this thread's held pixels: canvas offset within the patch, opacity
  int al_px[kHeld];
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int i = threadIdx.x + k * kBlock;
    at_px[k] = i < n_px ? (i / p.bw) * p.width + i % p.bw : 0;
    al_px[k] = i < n_px ? p.opac[i] : 0;
  }
  const int total = p.n * p.passes;
  int4 step = p.steps[t0 % p.n];
  for (int t = t0; t < total; ++t) {
    const int4 next = p.steps[(t + 1) % p.n];  // (row, col, dx, dy), loaded ahead
    int4* corner = p.canvas + step.x * p.width + step.y;
    const long shift = step.w * p.width + step.z;  // source = destination - shift
    int4 v[kHeld];
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (threadIdx.x + k * kBlock < n_px) v[k] = smeared(corner + at_px[k], shift, al_px[k]);
    }
    for (int i = threadIdx.x + kHeld * kBlock; i < n_px; i += kBlock) {
      p.spill[i] = smeared(corner + (i / p.bw) * p.width + i % p.bw, shift, p.opac[i]);
    }
    __syncthreads();  // every read of this step before any write
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (threadIdx.x + k * kBlock < n_px) corner[at_px[k]] = v[k];
    }
    for (int i = threadIdx.x + kHeld * kBlock; i < n_px; i += kBlock) {
      corner[(i / p.bw) * p.width + i % p.bw] = p.spill[i];
    }
    __syncthreads();  // every write of this step before the next step's reads
    step = next;
  }
}

// Window mode's origin along one axis for a step whose source and destination
// span [u0, u1) of `extent` pixels: the window of `size` pixels keeps a
// quarter of its slack behind the span against the walk's travel `ahead`
// (-1, 0 or 1: minus the step's direction, which points to the last point)
// and three quarters before it, clamped to the canvas.
__device__ __forceinline__ int window_origin(int u0, int u1, int size, int extent, int ahead) {
  const int slack = size - (u1 - u0);
  return min(max(u0 - slack / 2 + ahead * (slack / 4), 0), extent - size);
}

// Loads the window at (wy0, wx0) from the canvas through registers, packed,
// thread q on pixels q, q + kWinThreads, ... (a warp on contiguous 16-byte
// pixels of a window row), each pixel checked: false, the whole block
// agreeing, where a channel lies outside 0..255 (the window is then not
// usable).
__device__ __forceinline__ bool load_window(const Params& p, uint2* win, int wy0, int wx0) {
  const int count = p.wh * p.ww;
  bool wide = false;
#pragma unroll 4
  for (int q = threadIdx.x; q < count; q += kWinThreads) {
    const int4 c = __ldcg(p.canvas + (wy0 + q / p.ww) * p.width + wx0 + q % p.ww);
    wide |= ((c.x | c.y | c.z | c.w) & ~0xFF) != 0;
    win[q] = packed(c);
  }
  return !__syncthreads_or(wide);
}

// Window mode's rectangle of the canvas at (wy0, wx0): rows [y0, y1) x
// columns [x0, x1) written from the window to the canvas, thread q on
// pixels q, q + kWinThreads, ... of the rectangle.
__device__ __forceinline__ void write_back(const Params& p, const uint2* win, int wy0, int wx0, int y0, int y1, int x0,
                                           int x1) {
  const int cols = x1 - x0, count = (y1 - y0) * cols;
  for (int q = threadIdx.x; q < count; q += kWinThreads) {
    const int y = y0 + q / cols, x = x0 + q % cols;
    p.canvas[y * p.width + x] = unpacked(win[(y - wy0) * p.ww + (x - wx0)]);
  }
}

// Window mode's walk of packed pixels.  Returns the number of steps where it
// ends: all of them, or the step whose window held a channel outside
// 0..255, with everything before it written back, from which device_walk
// goes on.  `off` and `al` are this thread's patch pixels: offset from the
// patch's corner in the window (-1 past the patch) and opacity; `loads`
// counts the window's loads.
template <int kHold>
__device__ __forceinline__ int window_walk(const Params& p, int4* smem, const int (&off)[kHold],
                                           const int (&al)[kHold], int& loads) {
  uint2* win = reinterpret_cast<uint2*>(smem);  // (wh, ww)
  int4* recs = smem + (p.wh * p.ww + 1) / 2;    // kStepChunk step records
  int wy0 = INT_MIN / 2, wx0 = INT_MIN / 2;    // the window's origin on the canvas: none loaded
  int dy0 = INT_MAX, dy1 = INT_MIN, dx0 = INT_MAX, dx1 = INT_MIN;  // changed since the load, half-open
  uint2 v[kHold];
  const int total = p.n * p.passes;
  for (int t = 0; t < total; ++t) {
    const int j = t % kStepChunk;
    if (j == 0) {
      __syncthreads();  // the last chunk's records are read
      for (int q = threadIdx.x; q < kStepChunk && t + q < total; q += kWinThreads) {
        recs[q] = p.steps[(t + q) % p.n];
      }
      __syncthreads();
    }
    const int4 s = recs[j];  // (row, col, dx, dy)
    const int r = s.x, c = s.y, sx = s.z, sy = s.w;
    const int uy0 = min(r, r - sy), uy1 = max(r, r - sy) + p.bh;
    const int ux0 = min(c, c - sx), ux1 = max(c, c - sx) + p.bw;
    if (uy0 < wy0 || uy1 > wy0 + p.wh || ux0 < wx0 || ux1 > wx0 + p.ww) {
      // The step leaves the window: write back what changed, reload around it.
      if (dy1 > dy0) write_back(p, win, wy0, wx0, dy0, dy1, dx0, dx1);
      __syncthreads();  // the window read out, the canvas written, before the reload
      wy0 = window_origin(uy0, uy1, p.wh, p.height, -sy);
      wx0 = window_origin(ux0, ux1, p.ww, static_cast<int>(p.width), -sx);
      ++loads;
      if (!load_window(p, win, wy0, wx0)) return t;
      dy0 = dx0 = INT_MAX;
      dy1 = dx1 = INT_MIN;
    }
    uint2* corner = win + (r - wy0) * p.ww + (c - wx0);
    const int shift = sy * p.ww + sx;  // source = destination - shift
    // Straight-line over this thread's pixels, so that they interleave: a
    // slot past the patch reads the patch's first pixel and writes nothing.
#pragma unroll
    for (int k = 0; k < kHold; ++k) {
      const uint2* dst = corner + max(off[k], 0);
      v[k] = blend(*dst, *(dst - shift), al[k]);
    }
    __syncthreads();  // every read of this step before any write
#pragma unroll
    for (int k = 0; k < kHold; ++k) {
      if (off[k] >= 0) corner[off[k]] = v[k];
    }
    dy0 = min(dy0, r), dy1 = max(dy1, r + p.bh), dx0 = min(dx0, c), dx1 = max(dx1, c + p.bw);
    __syncthreads();  // every write of this step before the next step's reads
  }
  if (dy1 > dy0) write_back(p, win, wy0, wx0, dy0, dy1, dx0, dx1);
  return total;
}

template <int kHold>
__global__ void __launch_bounds__(kWinThreads) smear_window_kernel(Params p) {
  extern __shared__ int4 smem[];
  const int n_px = p.bh * p.bw;
  int off[kHold], al[kHold];
  bool wide = false;  // an opacity outside 0..255
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const int i = threadIdx.x + k * kWinThreads;
    off[k] = i < n_px ? (i / p.bw) * p.ww + i % p.bw : -1;
    al[k] = i < n_px ? p.opac[i] : 0;
    wide |= (al[k] & ~0xFF) != 0;
  }
  int loads = 0;
  const int t = __syncthreads_or(wide) ? 0 : window_walk<kHold>(p, smem, off, al, loads);
  if (t < p.n * p.passes) device_walk<kWinThreads>(p, t);
  if (p.stats != nullptr && threadIdx.x == 0) {
    p.stats[0] = p.wh, p.stats[1] = p.ww, p.stats[2] = loads, p.stats[3] = t;
  }
}

__global__ void __launch_bounds__(kThreads) smear_global_kernel(Params p) {
  device_walk<kThreads>(p, 0);
  if (p.stats != nullptr && threadIdx.x == 0) p.stats[0] = p.stats[1] = p.stats[2] = p.stats[3] = 0;
}

// The shared memory of window mode's (wh, ww) window and its step records.
size_t window_bytes(int wh, int ww) {
  return ((static_cast<size_t>(wh) * ww + 1) / 2 + kStepChunk) * sizeof(int4);
}

// The mode for a (bh, bw) patch over a (height, width) canvas: window mode's
// (wh, ww), the patch with the largest margin of at most kMaxMargin pixels
// that fits, cut to the canvas; or false for global mode (a patch of more
// than kMaxHeld pixels a thread, or no margin of one pixel fits: a step's
// source lies one pixel from its patch).
bool window_shape(int bh, int bw, int height, int width, int* wh, int* ww) {
  if (bh * bw > kMaxHeld * kWinThreads) return false;
  for (int m = kMaxMargin; m > 0; --m) {
    *wh = min(bh + 2 * m, height), *ww = min(bw + 2 * m, width);
    if (window_bytes(*wh, *ww) <= static_cast<size_t>(kSmemBytes)) return true;
  }
  return false;
}

template <int kHold>
cudaError_t launch_window(const Params& p, cudaStream_t stream) {
  // Per call: the attribute belongs to the current device's context.
  const cudaError_t allowed =
      cudaFuncSetAttribute(smear_window_kernel<kHold>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (allowed != cudaSuccess) return allowed;
  smear_window_kernel<kHold><<<1, kWinThreads, window_bytes(p.wh, p.ww), stream>>>(p);
  return cudaSuccess;
}

}  // namespace

// Launches one block on `stream` and returns the launch's error, else
// cudaGetLastError().  Window mode or global mode by window_shape; `spill`
// holds bh * bw int4 (device_walk uses those past kHeld * its block's
// threads); `stats` is null or 4 int32 on the device, written at the walk's
// end: the window's rows and columns, its loads, and the step from which
// the walk ran in device memory (all 0 in global mode; n * passes where
// the window walk reached the end).
extern "C" int smear_walk(void* canvas, int height, int width, const void* opac, const void* steps, void* spill,
                          void* stats, int n, int passes, int bh, int bw, void* stream) {
  Params p{static_cast<int4*>(canvas), width, static_cast<const int*>(opac), static_cast<const int4*>(steps),
           static_cast<int4*>(spill), static_cast<int*>(stats), n, passes, bh, bw, height, 0, 0};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (!window_shape(bh, bw, height, width, &p.wh, &p.ww)) {
    p.wh = p.ww = 0;
    smear_global_kernel<<<1, kThreads, 0, s>>>(p);
  } else {
    const int held = (bh * bw + kWinThreads - 1) / kWinThreads;
    err = held <= 1 ? launch_window<1>(p, s) : held <= 2 ? launch_window<2>(p, s) : held <= 4 ? launch_window<4>(p, s)
        : held <= 8 ? launch_window<8>(p, s) : launch_window<16>(p, s);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

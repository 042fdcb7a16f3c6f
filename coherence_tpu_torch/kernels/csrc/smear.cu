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
//
// What bounds it: not bytes.  Step i reads pixels that step i - 1 wrote,
// one pixel to the side, so the walk is a serial chain of steps * passes
// dependent steps.  A step needs the union of its source and destination,
// (bh + |dy|) x (bw + |dx|) pixels, and writes its patch: about 32 bytes a
// patch pixel, from L2 (the demo's canvas is 8.4 MB of the 50 MB).  The
// walk as a whole must read and write each pixel it touches only once
// (chip_smoke.py smear_bound: 2.0 MB at the demo's 1024 steps), under its
// mixed texels' int32 operations.
//
// Design: one block of 1024 threads walks the whole chain, the canvas in
// place in device memory.  A thread owns patch pixels tid, tid + 1024, ...
// (the same ones every step): per step it reads each one's source and
// destination and keeps the new value (in registers for its first kHeld
// pixels, beyond them in the `spill` scratch the wrapper allocates),
// __syncthreads(), writes, __syncthreads().  The next step's record is
// loaded while the current step runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kHeld = 4;  // patch pixels a thread keeps in registers: 4096, radius 31

struct Params {
  int4* canvas;        // (rows, width) RGBA int32
  long width;
  const int* opac;     // (bh, bw)
  const int4* steps;   // (n) (row, col, dx, dy)
  int4* spill;         // the new values of patch pixels from kHeld * kThreads on
  int n, passes, bh, bw;
};

__device__ __forceinline__ int wrap(uint32_t v) { return static_cast<int>(v); }

__device__ __forceinline__ int div255(int i) {
  return wrap(static_cast<uint32_t>(i) + static_cast<uint32_t>(i >> 8) + 1u) >> 8;
}

__device__ __forceinline__ int mix(int d, int s, int al, int keep) {
  return wrap(static_cast<uint32_t>(div255(wrap(static_cast<uint32_t>(d) * static_cast<uint32_t>(al)))) +
              static_cast<uint32_t>(div255(wrap(static_cast<uint32_t>(s) * static_cast<uint32_t>(keep)))));
}

__device__ __forceinline__ int4 smeared(const int4* dst, long shift, int al) {
  const int4 d = *dst, s = *(dst - shift);
  if (al == 0) return s;
  if (al == 255) return d;
  const int keep = 255 - al;
  return make_int4(mix(d.x, s.x, al, keep), mix(d.y, s.y, al, keep), mix(d.z, s.z, al, keep),
                   mix(d.w, s.w, al, keep));
}

__global__ void __launch_bounds__(kThreads) smear_kernel(Params p) {
  const int n_px = p.bh * p.bw;
  long at_px[kHeld];  // this thread's held pixels: canvas offset within the patch, opacity
  int al_px[kHeld];
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int i = threadIdx.x + k * kThreads;
    at_px[k] = i < n_px ? (i / p.bw) * p.width + i % p.bw : 0;
    al_px[k] = i < n_px ? p.opac[i] : 0;
  }
  const int total = p.n * p.passes;
  int4 step = p.steps[0];
  for (int t = 0; t < total; ++t) {
    const int4 next = p.steps[(t + 1) % p.n];  // (row, col, dx, dy), loaded ahead
    int4* corner = p.canvas + step.x * p.width + step.y;
    const long shift = step.w * p.width + step.z;  // source = destination - shift
    int4 v[kHeld];
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (threadIdx.x + k * kThreads < n_px) v[k] = smeared(corner + at_px[k], shift, al_px[k]);
    }
    for (int i = threadIdx.x + kHeld * kThreads; i < n_px; i += kThreads) {
      p.spill[i] = smeared(corner + (i / p.bw) * p.width + i % p.bw, shift, p.opac[i]);
    }
    __syncthreads();  // every read of this step before any write
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (threadIdx.x + k * kThreads < n_px) corner[at_px[k]] = v[k];
    }
    for (int i = threadIdx.x + kHeld * kThreads; i < n_px; i += kThreads) {
      corner[(i / p.bw) * p.width + i % p.bw] = p.spill[i];
    }
    __syncthreads();  // every write of this step before the next step's reads
    step = next;
  }
}

}  // namespace

// Launches one block on `stream` and returns cudaGetLastError().  `spill`
// holds bh * bw int4 (the kernel uses those past kHeld * kThreads).
extern "C" int smear_walk(void* canvas, int width, const void* opac, const void* steps, void* spill, int n,
                          int passes, int bh, int bw, void* stream) {
  const Params p{static_cast<int4*>(canvas), width, static_cast<const int*>(opac), static_cast<const int4*>(steps),
                 static_cast<int4*>(spill), n, passes, bh, bw};
  smear_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The within-shape convolution of a canvas, for Hopper (sm_90a): CV1
// `convolve_canvas`.
//
// Replaces the XLA program (not a Pallas kernel) of the JAX package's
// coherence_tpu/raster/convolve.py:195 _convolve_canvas_jit, which the port
// ran as a chain of eager torch launches, one a tap and pass
// (raster/convolve.py convolve_canvas over _conv1d_exact, _conv2d_exact and
// _setcanvas_xy: the plain version, bit for bit).
//
// The function, on an int32 (H, W, 4) canvas c inside the mask m (the top
// left (H, W) of a bool plane, any strides), SAME zero padding at the
// canvas's edge, every sum an int32 sum that wraps modulo 2^32 (H52):
//   full: where m, floor(sum of w[k][l] * c[y+k-r][x+l-r] / total), else c;
//   xy:   cx = where m, setcanvas(floor(x-pass sum / total)), else c, then
//         where m, setcanvas(floor(y-pass sum of cx / total)), else cx,
//         setcanvas clamping r and g to alpha and leaving b (H6);
//   unit: as xy with every weight 1, total 2r + 1 and no clamp.
// A pass is one launch: the x pass writes cx into a scratch plane, the y
// pass reads it; `full` is one 2D launch.  The floor division of a sum by
// the total is a multiply-high by kernels.blur_divider's magic number and a
// shift on the sum's magnitude, as blur_blend.cu divides.
//
// What bounds it: bytes.  The canvas read once, the output written once and
// the mask read once (33 bytes a pixel); a tap is an int32 multiply-add.
// Design: a thread a pixel, a warp's lanes on adjacent pixels of a row, each
// tap a 16-byte load of the neighbour (from L1 and L2: a row's taps overlap
// their neighbours'), the weights read through the read-only cache; pixels
// outside the mask copy their input and read no tap.  The passes' second
// write and read of cx are the design's cost over the bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsMax = 65535;  // gridDim.y

enum Mode { kPassX = 0, kPassY = 1, kFull = 2 };

struct Params {
  const int4* src;            // (H, W) pixels, contiguous
  int4* dst;
  const unsigned char* mask;  // bool, its top-left (H, W)
  long long msy, msx;
  int H, W;
  const int* weights;         // 2r + 1, or (2r + 1)^2 row-major for kFull
  int radius;
  int mode;
  int clamp;                  // setcanvas's r, g <= a
  uint32_t magic;             // floor(n / total) = magic * n >> shift for 0 <= n < 2^31
  int shift;
};

__device__ __forceinline__ int floordiv(uint32_t sum, const Params& p) {
  const int s = static_cast<int>(sum), sign = s >> 31;
  const uint32_t n = static_cast<uint32_t>(s ^ sign);
  return static_cast<int>((static_cast<unsigned long long>(p.magic) * n) >> p.shift) ^ sign;
}

__device__ __forceinline__ void add(uint32_t (&acc)[4], uint32_t w, int4 v) {
  acc[0] += w * static_cast<uint32_t>(v.x);
  acc[1] += w * static_cast<uint32_t>(v.y);
  acc[2] += w * static_cast<uint32_t>(v.z);
  acc[3] += w * static_cast<uint32_t>(v.w);
}

__global__ void __launch_bounds__(kThreads) convolve_kernel(Params p) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= p.W) return;
  const int r = p.radius, n = 2 * r + 1;
  for (int y = blockIdx.y; y < p.H; y += gridDim.y) {
    const long long i = static_cast<long long>(y) * p.W + x;
    if (p.mask[y * p.msy + x * p.msx] == 0) {
      p.dst[i] = p.src[i];
      continue;
    }
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    if (p.mode == kPassX) {
      const int k0 = max(0, r - x), k1 = min(n, p.W + r - x);  // taps inside the row
      for (int k = k0; k < k1; ++k) add(acc, static_cast<uint32_t>(__ldg(p.weights + k)), p.src[i + k - r]);
    } else if (p.mode == kPassY) {
      const int k0 = max(0, r - y), k1 = min(n, p.H + r - y);
      for (int k = k0; k < k1; ++k) {
        add(acc, static_cast<uint32_t>(__ldg(p.weights + k)), p.src[i + static_cast<long long>(k - r) * p.W]);
      }
    } else {
      const int ky0 = max(0, r - y), ky1 = min(n, p.H + r - y);
      const int kx0 = max(0, r - x), kx1 = min(n, p.W + r - x);
      for (int ky = ky0; ky < ky1; ++ky) {
        const int4* row = p.src + i + static_cast<long long>(ky - r) * p.W - r;
        for (int kx = kx0; kx < kx1; ++kx) add(acc, static_cast<uint32_t>(__ldg(p.weights + ky * n + kx)), row[kx]);
      }
    }
    const int a = floordiv(acc[3], p);
    int rr = floordiv(acc[0], p), gg = floordiv(acc[1], p);
    if (p.clamp) {
      rr = min(a, rr);
      gg = min(a, gg);
    }
    p.dst[i] = make_int4(rr, gg, floordiv(acc[2], p), a);
  }
}

}  // namespace

// Launches one pass on `stream` and returns cudaGetLastError().  geom holds
// H, W, msy, msx, radius, mode (0 x pass, 1 y pass, 2 full), clamp, magic,
// shift; (magic, shift) is kernels.blur_divider of the total.
extern "C" int convolve_canvas(const long long* geom, const void* src, void* dst, const void* mask,
                               const void* weights, void* stream) {
  Params p;
  p.src = static_cast<const int4*>(src);
  p.dst = static_cast<int4*>(dst);
  p.mask = static_cast<const unsigned char*>(mask);
  p.weights = static_cast<const int*>(weights);
  p.H = static_cast<int>(geom[0]);
  p.W = static_cast<int>(geom[1]);
  p.msy = geom[2];
  p.msx = geom[3];
  p.radius = static_cast<int>(geom[4]);
  p.mode = static_cast<int>(geom[5]);
  p.clamp = static_cast<int>(geom[6]);
  p.magic = static_cast<uint32_t>(geom[7]);
  p.shift = static_cast<int>(geom[8]);
  const dim3 grid((p.W + kThreads - 1) / kThreads, p.H < kRowsMax ? p.H : kRowsMax);
  convolve_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

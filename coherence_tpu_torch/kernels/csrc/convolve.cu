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
// The floor division of a sum by the total is a multiply-high by
// kernels.blur_divider's magic number and a shift on the sum's magnitude,
// as blur_blend.cu divides.
//
// What bounds it: bytes.  The canvas read once, the output written once and
// the mask read once (33 bytes a pixel); a tap is an int32 multiply-add.
// Design (the second; the first design took two launches a call, the x
// pass writing cx into a scratch plane that the y pass read back, each tap
// a 16-byte load through L1 or L2):
//  - The staged route (xy and unit, where the tile and its halo fit
//    kernels.CONV_SMEM; kernels.convolve_route): one launch.  A 256-thread
//    block owns a 16 x 64 output tile.  One thread copies the canvas over
//    the tile and r rows and columns of halo into shared memory with one
//    tensor copy (TMA, cp.async.bulk.tensor, behind an mbarrier; the
//    wrapper encodes the canvas's tensor map, and the copy fills zeros
//    outside the canvas: SAME padding) while the block loads the weights
//    and the mask bytes of the tile's columns over every staged row.  The
//    x pass computes cx (sum, divide, clamp, and the canvas where the mask
//    is unset) for the tile's columns over the tile rows and the row halo,
//    zero on rows outside the canvas (the y pass's SAME padding of cx, not
//    the canvas), in halves of 16 rows, each half's values held in
//    registers over a barrier and then written over the staged canvas's
//    tile columns (so that a block's shared memory is its staged tile: four
//    blocks an SM at r = 5); the y pass reads them and writes each output
//    pixel once.  In both passes a thread keeps 4 adjacent outputs and a
//    window of 4 values sliding along the taps in registers, so that each
//    staged value is read from shared memory once a thread; a warp's lanes
//    take rows in the x pass (an odd row pitch: distinct banks) and columns
//    in the y pass.  Each thread's cp.async of a pixel instead of the
//    tensor copy, persistent blocks staging the next tile while this one's
//    passes ran, loads of four taps ahead, six blocks an SM and 32-row
//    tiles were each slower at config 4's frame, and five blocks an SM at
//    the whole render's canvas (profile_region.py; PERF.md).
//  - Past the staged route's shared memory (larger radii): the first
//    design's two passes, a thread a pixel, each tap a 16-byte load.
//  - `full` (a dense 2D kernel): the first design's one 2D launch.
// Pixels outside the mask copy their input and read no tap.

#include <atomic>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsMax = 65535;  // gridDim.y

enum Mode { kPassX = 0, kPassY = 1, kFull = 2, kStaged = 3 };

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

// ---------------------------------------------------------------------------
// The staged route: one launch for both passes.
// ---------------------------------------------------------------------------

constexpr int kTileRows = 16;                   // output rows a block
constexpr int kTileCols = 64;                   // output columns a block
constexpr int kStageThreads = 256;
constexpr int kStageWarps = kStageThreads / 32;
constexpr int kStageBlocks = 4;                 // blocks an SM, for __launch_bounds__ (64 registers)
constexpr int kRun = 4;                         // adjacent outputs a thread keeps in registers, each pass
constexpr int kMaskBatch = 4;                   // mask rows a warp loads before it stores any
constexpr int kSmemMax = 232448;                // a block's shared memory on sm_90
static_assert(kTileRows * kTileCols == kRun * kStageThreads, "the y pass gives each thread one run");
static_assert(kTileCols / kRun * kTileRows == kStageThreads, "the x pass gives each thread one run a 16-row half");

// The staged tile's shared memory, in bytes from its first 128-byte
// boundary (kernels.convolve_staged_smem; 128 bytes more are asked for):
//   int4 cs[S + 1][P]    the canvas over rows ty0 - r .. ty0 + 15 + r and columns tx0 - r .. tx0 + P - 1 - r,
//                        zero outside the canvas (SAME padding); S = 16 + 2r, P = (64 + 2r + 1) | 1 (odd:
//                        the x pass's lanes, on rows, take distinct banks).  The x pass overwrites the
//                        tile's columns of each row with cx.  Row S is never written.
//   uint32 w[2r + 1]     the weights
//   uint8 m[S][64]       the mask over the staged rows and the tile's columns
//   uint64 bar           the tile copy's mbarrier
struct StagedLayout {
  int rows, pitch;
  int cs, w, m, bar, bytes;
  __host__ __device__ explicit StagedLayout(int r) {
    rows = kTileRows + 2 * r;
    pitch = (kTileCols + 2 * r + 1) | 1;
    cs = 0;
    w = cs + 16 * (rows + 1) * pitch;
    m = w + 4 * (2 * r + 1);
    bar = (m + rows * kTileCols + 7) & ~7;
    bytes = bar + 8 + 128;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* q) {
  return static_cast<unsigned>(__cvta_generic_to_shared(q));
}

// Copies 4 bytes to shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ int4 divided(const uint32_t (&acc)[4], const Params& p) {
  const int a = floordiv(acc[3], p);
  int rr = floordiv(acc[0], p), gg = floordiv(acc[1], p);
  if (p.clamp) {
    rr = min(a, rr);
    gg = min(a, gg);
  }
  return make_int4(rr, gg, floordiv(acc[2], p), a);
}

// kRun outputs of one pass, `at` the taps' first value and `step` the
// distance between adjacent values (both in int4s): output o's tap k is
// at + (o + k) step.  A window of kRun values slides along the taps, so
// that each value is read from shared memory once.
__device__ __forceinline__ void run_taps(uint32_t (&acc)[kRun][4], const int4* at, int step, const uint32_t* w,
                                         int taps) {
  int4 win[kRun];
#pragma unroll
  for (int o = 0; o < kRun; ++o) {
    win[o] = at[o * step];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[o][c] = 0u;
  }
  for (int k = 0; k < taps; ++k) {
    const uint32_t wk = w[k];
#pragma unroll
    for (int o = 0; o < kRun; ++o) add(acc[o], wk, win[o]);
#pragma unroll
    for (int o = 0; o + 1 < kRun; ++o) win[o] = win[o + 1];
    win[kRun - 1] = at[(kRun + k) * step];  // past the last tap: a pad column or row, never used
  }
}

__global__ void __launch_bounds__(kStageThreads, kStageBlocks)
    convolve_staged_kernel(Params p, const __grid_constant__ CUtensorMap canvas) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (128 - smem_addr(smem_raw) % 128) % 128;  // the tensor copy's alignment
  const int r = p.radius, taps = 2 * r + 1;
  const StagedLayout L(r);
  int4* cs = reinterpret_cast<int4*>(smem + L.cs);
  uint32_t* w = reinterpret_cast<uint32_t*>(smem + L.w);
  unsigned char* m = smem + L.m;
  const unsigned bar = smem_addr(smem + L.bar);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ty0 = blockIdx.y * kTileRows, tx0 = blockIdx.x * kTileCols;
  const int y_top = ty0 - r, x_left = tx0 - r;  // the canvas row and column of staged row and column 0

  // 1. The canvas tile and its halo in one tensor copy (TMA: rows y_top ..
  // y_top + S - 1 and columns x_left .. x_left + P - 1 of the canvas, zeros
  // outside it), the weights by cp.async, then the mask bytes of the
  // tile's columns over every staged row, each warp's batch of loads
  // issued before it stores any.
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(16 * L.rows * L.pitch)
                 : "memory");
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        ::"r"(smem_addr(cs)), "l"(&canvas), "r"(0), "r"(x_left), "r"(y_top), "r"(bar)
        : "memory");
  }
  if (threadIdx.x < taps) cp_async4(w + threadIdx.x, p.weights + threadIdx.x);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i0 = warp; i0 < L.rows; i0 += kStageWarps * kMaskBatch) {
    unsigned char v[kMaskBatch][2];
#pragma unroll
    for (int b = 0; b < kMaskBatch; ++b) {
      const int y = y_top + i0 + b * kStageWarps;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = tx0 + lane + 32 * h;
        v[b][h] = i0 + b * kStageWarps < L.rows && y >= 0 && y < p.H && x < p.W ? p.mask[y * p.msy + x * p.msx] : 0;
      }
    }
#pragma unroll
    for (int b = 0; b < kMaskBatch; ++b) {
      const int i = i0 + b * kStageWarps;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (i < L.rows) m[i * kTileCols + lane + 32 * h] = v[b][h];
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the barrier is initialized before any thread waits on it
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar)
      : "memory");
  __syncthreads();

  // 2. The x pass over every staged row, in halves of 16 rows: thread (q,
  // i) a run of kRun adjacent tile columns from 4q at row i of the half;
  // where the mask is unset the canvas, on rows outside the canvas zero.
  // Each half's values wait in registers for a barrier, then overwrite the
  // tile's columns of their rows (no row is read by the other half).
  {
    const int q = threadIdx.x / kTileRows, x0 = kRun * q;
    for (int i = threadIdx.x % kTileRows; i - static_cast<int>(threadIdx.x % kTileRows) < L.rows; i += kTileRows) {
      const int y = y_top + i;
      int4 v[kRun];
      if (i < L.rows) {
        uint32_t acc[kRun][4];
        run_taps(acc, cs + i * L.pitch + x0, 1, w, taps);
#pragma unroll
        for (int o = 0; o < kRun; ++o) {
          const int xt = x0 + o;
          v[o] = make_int4(0, 0, 0, 0);
          if (y >= 0 && y < p.H && tx0 + xt < p.W) {
            v[o] = m[i * kTileCols + xt] ? divided(acc[o], p) : cs[i * L.pitch + xt + r];
          }
        }
      }
      __syncthreads();
      if (i < L.rows) {
#pragma unroll
        for (int o = 0; o < kRun; ++o) cs[i * L.pitch + x0 + o + r] = v[o];
      }
    }
  }
  __syncthreads();

  // 3. The y pass over cx (the tile's columns of cs): thread (g, x) a run
  // of kRun adjacent tile rows from kRun g at column x; each output pixel
  // written once, cx itself (the canvas) where the mask is unset.
  {
    const int xt = threadIdx.x % kTileCols, yt0 = kRun * (threadIdx.x / kTileCols), x = tx0 + xt;
    uint32_t acc[kRun][4];
    run_taps(acc, cs + yt0 * L.pitch + xt + r, L.pitch, w, taps);
    if (x < p.W) {
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        const int i = yt0 + o + r, y = y_top + i;  // staged row i is the output row
        if (y >= p.H) break;
        const int4 c = cs[i * L.pitch + xt + r];  // cx: the canvas where the mask is unset
        p.dst[static_cast<long long>(y) * p.W + x] = m[i * kTileCols + xt] ? divided(acc[o], p) : c;
      }
    }
  }
}

// Lets convolve_staged_kernel take `bytes` of dynamic shared memory on the
// current device (past 48 KB only by this attribute), once a device.
cudaError_t allow_staged_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess || (device < kMaxDevices && done[device].load(std::memory_order_acquire))) return rc;
  rc = cudaFuncSetAttribute(convolve_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (rc == cudaSuccess && device < kMaxDevices) done[device].store(true, std::memory_order_release);
  return rc;
}

// cuTensorMapEncodeTiled of the CUDA API below the runtime, found once
// through the runtime's entry-point query (the library links the runtime
// alone).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The staged route's tensor map of the (H, W, 4) int32 canvas at `src`:
// boxes of 4 channels x `cols` columns x `rows` rows, zeros outside it.
cudaError_t canvas_map(CUtensorMap* map, const void* src, int H, int W, int rows, int cols) {
  static std::atomic<EncodeTiled> encode{nullptr};
  EncodeTiled f = encode.load(std::memory_order_acquire);
  if (f == nullptr) {
    void* found = nullptr;
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &found, cudaEnableDefault);
    if (rc != cudaSuccess) return rc;
    if (found == nullptr) return cudaErrorSymbolNotFound;
    f = reinterpret_cast<EncodeTiled>(found);
    encode.store(f, std::memory_order_release);
  }
  const cuuint64_t dims[3] = {4, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {16, 16ull * static_cast<cuuint64_t>(W)};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {4, static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows)};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = f(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, const_cast<void*>(src), dims, strides, box, steps,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// Launches one pass, or the staged route's one launch, on `stream` and
// returns cudaGetLastError().  geom holds H, W, msy, msx, radius, mode (0 x
// pass, 1 y pass, 2 full, 3 staged), clamp, magic, shift; (magic, shift) is
// kernels.blur_divider of the total.
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.mode == kStaged) {
    const long long row_tiles = (p.H + kTileRows - 1LL) / kTileRows;
    const StagedLayout L(p.radius);
    if (p.radius < 1 || 2 * p.radius + 1 > kStageThreads || L.pitch > 256 || L.rows > 256 || L.bytes > kSmemMax ||
        row_tiles > kRowsMax) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (L.bytes > 48 * 1024) {
      const cudaError_t rc = allow_staged_smem();
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    CUtensorMap map;
    const cudaError_t rc = canvas_map(&map, src, p.H, p.W, L.rows, L.pitch);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const dim3 grid((p.W + kTileCols - 1) / kTileCols, static_cast<unsigned>(row_tiles));
    convolve_staged_kernel<<<grid, kStageThreads, L.bytes, st>>>(p, map);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((p.W + kThreads - 1) / kThreads, p.H < kRowsMax ? p.H : kRowsMax);
  convolve_kernel<<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The staged route's dynamic shared memory at `radius`, in bytes.
extern "C" int convolve_staged_smem(int radius) { return StagedLayout(radius).bytes; }

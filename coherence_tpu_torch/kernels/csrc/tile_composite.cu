// Tile compositor for Hopper (sm_90a): front-to-back Porter/Duff `over` of
// each 64x128 tile's listed atlas pieces, then `over` the background tile.
//
// Replaces the Pallas TPU kernels of coherence_tpu/raster/tiled_scene.py:
//   composite_dirty  <- _kernel_subset     (launcher _render_dirty_tiles)
//   composite_full   <- _kernel_atlas_row  (launcher _render_tiles_atlas)
//                       and _kernel        (launcher _render_tiles)
// _kernel_atlas_row and _kernel compute the same function: `over` onto an
// accumulator whose alpha is 255 returns the accumulator unchanged
// (prelerp(l, q, 255) == q for every byte l), so stopping early never
// changes the output and one entry point serves both.  The packed-pixel
// math is tile_math.cuh's over_packed, in the same per-pixel order.
//
// What bounds it: HBM bytes.  Per pixel the work reads 4 B of every listed
// piece until that pixel turns opaque, 4 B of background where it stays
// translucent, and writes 4 B once; the integer math is a few dozen ALU ops
// per pixel.
// A walk that keeps one piece in flight (tile_math.cuh composite_tile) is
// bound instead by latency: a tile takes its depth times one round trip to
// memory, whatever its bytes, and a dirty list of 9-16 tiles fills 16 of
// the 132 SMs.
//
// Design (what it does about that):
//  * Row stripes.  One 128-thread block per 4-row stripe of a tile, 16
//    stripes a tile, each with its own early-stop vote: a dirty list of 16
//    tiles is 256 blocks.  A piece is 64x128 int32 in row-major order, so a
//    stripe of a piece is one contiguous 2 KiB run of the atlas, one
//    16-byte vector per thread.
//  * Piece indices staged once.  The block copies its span of the list
//    into shared memory before the walk (up to kIdxCap entries; a longer
//    span reads the rest from global memory), so no step waits on a
//    dependent idxs[k] load.
//  * A ring of kStages stripes in flight.  One elected thread issues each
//    stripe as one 1D TMA bulk copy (cp.async.bulk, completing on that
//    stage's mbarrier); the block composes from shared memory with 16-byte
//    reads, votes, and the elected thread refills the stage it just freed
//    with the stripe kStages pieces ahead.  TMA rather than cp.async: a
//    stripe is one contiguous run, so one instruction from one thread moves
//    it with no per-thread address math or commit groups.  The depth comes
//    from the measured step times (chip_smoke.py's deep case: a stripe's
//    step against the one-piece walk's round trip per piece): 8 stages
//    keep a deep stripe's next pieces landed before it needs them, at 16
//    KiB of shared memory a block; a deeper ring only reads more pieces
//    past a stripe's early stop.  Thinner stripes and deeper rings trade
//    the same way: the full 4K frame, shallow and bandwidth-bound, pays for
//    the extra blocks and the prefetch past early stops, while the deep
//    tiles of the lion and its dirty list gain.
//  * Safe exits.  A block that stops early, or whose span is shorter than
//    the ring, waits on every stage it filled before it returns, so no bulk
//    copy into its shared memory is left pending.
// CUDA rather than Triton: the work is a data-dependent walk of a per-tile
// list with indexed gathers and a block-wide early exit.
//
// composite_dirty runs in place on the frame.  A slot whose span starts
// below 0 leaves its tile untouched.  Padding slots repeat the last real
// slot: a slot equal to the one before it returns at once (the earlier
// slot's blocks write the same values; a compositing block never reads the
// frame).

#include "tile_math.cuh"

namespace {

using namespace tile;

constexpr int kStripeRows = 4;
constexpr int kStripes = kTileH / kStripeRows;                       // 16 blocks per tile
constexpr int kStripeThreads = 128;
constexpr int kStripeVecs = kStripeRows * kVecPerRow;                // 128 uint4 = 2 KiB
constexpr int kStripeVecPerThread = kStripeVecs / kStripeThreads;    // 1
constexpr unsigned kStripeBytes = kStripeVecs * sizeof(uint4);
constexpr int kStages = 8;
constexpr int kIdxCap = 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// Expect kStripeBytes on `bar`, then copy them from `src` into `dst`.
// Issued by one thread.
__device__ __forceinline__ void bulk_load(uint4* dst, const uint32_t* src, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(kStripeBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(kStripeBytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Word offset of this thread's j-th vector of the stripe inside a tile
// whose rows lie `pitch` words apart.
__device__ __forceinline__ long stripe_offset(int j, int stripe, long pitch) {
  int v = threadIdx.x + j * kStripeThreads;
  return (static_cast<long>(stripe) * kStripeRows + v / kVecPerRow) * pitch + (v % kVecPerRow) * 4;
}

// Composite the rows of stripe `stripe` of idxs[lo:hi] of `atlas`
// front to back over the background tile `bg` into `out`; both point at
// the tile's top-left pixel, rows `pitch` words apart.  Every thread of the
// block must call it.
__device__ __forceinline__ void composite_stripe(const int* __restrict__ idxs, int lo, int hi,
                                                 const uint32_t* __restrict__ atlas,
                                                 const uint32_t* __restrict__ bg,
                                                 uint32_t* __restrict__ out, long pitch, int stripe) {
  __shared__ __align__(128) uint4 ring[kStages][kStripeVecs];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int sidx[kIdxCap];

  const int n = hi - lo;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < min(n, kIdxCap); i += kStripeThreads) sidx[i] = idxs[lo + i];
  uint4 b[kStripeVecPerThread];
#pragma unroll
  for (int j = 0; j < kStripeVecPerThread; ++j)
    b[j] = __ldg(reinterpret_cast<const uint4*>(bg + stripe_offset(j, stripe, pitch)));
  __syncthreads();

  const uint32_t* stripe_base = atlas + static_cast<long>(stripe) * kStripeRows * kTileW;
  auto piece = [&](int k) {
    int p = k < kIdxCap ? sidx[k] : __ldg(idxs + lo + k);
    return stripe_base + static_cast<long>(p) * (kTileH * kTileW);
  };
  int issued = min(n, kStages);
  if (threadIdx.x == 0)
    for (int k = 0; k < issued; ++k) bulk_load(ring[k], piece(k), &full[k]);

  uint4 acc[kStripeVecPerThread];
#pragma unroll
  for (int j = 0; j < kStripeVecPerThread; ++j) acc[j] = make_uint4(0u, 0u, 0u, 0u);
  int k = 0;
  for (; k < n; ++k) {
    const int s = k % kStages;
    mbar_wait(&full[s], (k / kStages) & 1);
    bool open = false;
#pragma unroll
    for (int j = 0; j < kStripeVecPerThread; ++j) {
      uint4 l = ring[s][threadIdx.x + j * kStripeThreads];
      acc[j].x = over_packed(acc[j].x, l.x);
      acc[j].y = over_packed(acc[j].y, l.y);
      acc[j].z = over_packed(acc[j].z, l.z);
      acc[j].w = over_packed(acc[j].w, l.w);
      open |= any_open4(acc[j]);
    }
    // The vote also tells the elected thread that every read of stage s
    // is done, so it may refill it.
    if (!__syncthreads_or(open)) break;
    if (issued < n) {
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bulk_load(ring[s], piece(issued), &full[s]);
      }
      ++issued;
    }
  }
  // An early stop leaves stages k+1 .. issued-1 filling: wait for them.
  for (int j = k + 1; j < issued; ++j) mbar_wait(&full[j % kStages], (j / kStages) & 1);

#pragma unroll
  for (int j = 0; j < kStripeVecPerThread; ++j) {
    uint4 o;
    o.x = over_packed(acc[j].x, b[j].x);
    o.y = over_packed(acc[j].y, b[j].y);
    o.z = over_packed(acc[j].z, b[j].z);
    o.w = over_packed(acc[j].w, b[j].w);
    *reinterpret_cast<uint4*>(out + stripe_offset(j, stripe, pitch)) = o;
  }
}

__global__ void __launch_bounds__(kStripeThreads)
composite_dirty_kernel(const int* __restrict__ coords, const int* __restrict__ spans,
                       const int* __restrict__ idxs, const uint32_t* __restrict__ bg,
                       uint32_t* __restrict__ frame, const uint32_t* __restrict__ atlas, int pw) {
  const int s = blockIdx.x / kStripes;
  const int lo = spans[2 * s], hi = spans[2 * s + 1];
  if (lo < 0) return;  // passthrough slot: the tile stays as it is
  const int ty = coords[2 * s], tx = coords[2 * s + 1];
  if (s > 0 && lo == spans[2 * s - 2] && hi == spans[2 * s - 1] && ty == coords[2 * s - 2] &&
      tx == coords[2 * s - 1])
    return;  // a padding slot: the slot before it writes the same values
  long off = static_cast<long>(ty) * kTileH * pw + static_cast<long>(tx) * kTileW;
  composite_stripe(idxs, lo, hi, atlas, bg + off, frame + off, pw, blockIdx.x % kStripes);
}

__global__ void __launch_bounds__(kStripeThreads)
composite_full_kernel(const int* __restrict__ starts, const int* __restrict__ idxs,
                      const uint32_t* __restrict__ bg, uint32_t* __restrict__ out,
                      const uint32_t* __restrict__ atlas, int ntx, int pw) {
  const int t = blockIdx.x / kStripes;
  long off = static_cast<long>(t / ntx) * kTileH * pw + static_cast<long>(t % ntx) * kTileW;
  composite_stripe(idxs, starts[t], starts[t + 1], atlas, bg + off, out + off, pw, blockIdx.x % kStripes);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
extern "C" int composite_dirty(const void* coords, const void* spans, const void* idxs,
                               const void* bg, void* frame, const void* atlas, int n_slots,
                               int pw, void* stream) {
  composite_dirty_kernel<<<n_slots * kStripes, kStripeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(coords), static_cast<const int*>(spans),
      static_cast<const int*>(idxs), static_cast<const uint32_t*>(bg),
      static_cast<uint32_t*>(frame), static_cast<const uint32_t*>(atlas), pw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int composite_full(const void* starts, const void* idxs, const void* bg, void* out,
                              const void* atlas, int nty, int ntx, void* stream) {
  composite_full_kernel<<<nty * ntx * kStripes, kStripeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(idxs),
      static_cast<const uint32_t*>(bg), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(atlas), ntx, ntx * kTileW);
  return static_cast<int>(cudaGetLastError());
}

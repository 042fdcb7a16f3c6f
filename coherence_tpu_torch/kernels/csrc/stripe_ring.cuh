// The striped TMA ring walk of every Hopper compositor (sm_90a): K1
// composite_dirty and K2 composite_full (tile_composite.cu), K4
// composite_runs (composite_runs.cu), K5 composite_layers
// (composite_layers.cu), K6 composite_full_banded and K7
// composite_dirty_banded (banded.cu).
//
// What bounds these kernels: HBM bytes.  Per pixel the work reads 4 B of
// every layer until that pixel turns opaque, 4 B of background where it
// stays translucent, and writes 4 B once; the integer math is a few dozen
// ALU ops per pixel.  A walk that keeps one layer in flight per tile (one
// block a tile: a dependent index load, the layer's loads, then a vote) is
// bound instead by latency: a tile takes its depth times one round trip to
// memory, whatever its bytes, and a dirty list of 9-24 tiles fills at most
// 24 of the 132 SMs.
//
// Design (what it does about that):
//  * Row stripes.  One 128-thread block per 4-row stripe of a 64x128 tile,
//    16 stripes a tile, each with its own early-stop vote: a dirty list of
//    16 tiles is 256 blocks.  A stripe of one layer is 2 KiB, one 16-byte
//    vector per thread.
//  * A ring of kStages stripes in flight.  One elected thread fills each
//    stage by TMA bulk copies (cp.async.bulk) that complete on the stage's
//    mbarrier; the block composes from shared memory with 16-byte reads,
//    votes, and the elected thread refills the stage it just freed with the
//    stripe kStages layers ahead.  TMA rather than cp.async: one thread
//    moves a stage with no per-thread address math or commit groups.  The
//    depth comes from measured step times (chip_smoke.py's deep case): 8
//    stages keep a deep stripe's next layers landed before it needs them,
//    at 16 KiB of shared memory a block; a deeper ring only reads more
//    layers past a stripe's early stop.
//  * Sources.  How stage k is filled is the caller's: ListSource copies
//    stripe `stripe` of atlas piece idxs[lo + k], one contiguous 2 KiB run,
//    with the span's indices staged in shared memory first (up to kIdxCap;
//    a longer span reads the rest from global memory), so no step waits on
//    a dependent idxs load.  RunSource copies the stripe of piece lo + k of
//    a tile-major run buffer, where a tile's pieces lie consecutive, so it
//    stages nothing.  LayerSource copies the stripe's four 512-byte rows of
//    layer k of a (K, H, W) stack, `pitch` words apart, as four copies on
//    one barrier that expects all 2048 bytes.
//  * Safe exits.  A block that stops early, or whose span is shorter than
//    the ring, waits on every stage it filled before it returns, so no bulk
//    copy into its shared memory is left pending.
//
// Every shared array here is declared inside a device function, so each
// kernel that calls it gets its own copy; nothing is shared between
// kernels or translation units (the sources compile without -rdc).

#pragma once

#include "tile_math.cuh"

namespace ring {

using namespace tile;

constexpr int kStripeRows = 4;
constexpr int kStripes = kTileH / kStripeRows;                       // 16 blocks per tile
constexpr int kStripeThreads = 128;
constexpr int kStripeVecs = kStripeRows * kVecPerRow;                // 128 uint4 = 2 KiB
constexpr int kStripeVecPerThread = kStripeVecs / kStripeThreads;    // 1
constexpr unsigned kStripeBytes = kStripeVecs * sizeof(uint4);
constexpr unsigned kRowBytes = kVecPerRow * sizeof(uint4);           // 512
constexpr int kStages = 8;
constexpr int kIdxCap = 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive on `bar` and expect `bytes` more to land on it before its phase
// completes.  Issued by one thread, before the copies it counts.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global
// `src` into shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
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

// Stage k: stripe `stripe` of atlas piece idxs[lo + k].
struct ListSource {
  const int* idxs;
  int lo, n;
  const uint32_t* stripe_base;  // the stripe's first word in piece 0
  int* sidx;                    // kIdxCap ints of shared memory

  __device__ __forceinline__ void stage() const {
    for (int i = threadIdx.x; i < min(n, kIdxCap); i += kStripeThreads) sidx[i] = idxs[lo + i];
  }
  __device__ __forceinline__ void fill(int k, uint4* dst, uint64_t* bar) const {
    int p = k < kIdxCap ? sidx[k] : __ldg(idxs + lo + k);
    mbar_expect(bar, kStripeBytes);
    bulk_copy(dst, stripe_base + static_cast<long>(p) * (kTileH * kTileW), kStripeBytes, bar);
  }
};

// Stage k: the stripe of run piece lo + k.
struct RunSource {
  const uint32_t* base;  // the stripe's first word in run piece lo

  __device__ __forceinline__ void stage() const {}
  __device__ __forceinline__ void fill(int k, uint4* dst, uint64_t* bar) const {
    mbar_expect(bar, kStripeBytes);
    bulk_copy(dst, base + static_cast<long>(k) * (kTileH * kTileW), kStripeBytes, bar);
  }
};

// Stage k: the stripe's rows of layer k of a dense stack.
struct LayerSource {
  const uint32_t* base;  // the stripe's first word in layer 0
  long plane, pitch;     // words between layers, between rows

  __device__ __forceinline__ void stage() const {}
  __device__ __forceinline__ void fill(int k, uint4* dst, uint64_t* bar) const {
    const uint32_t* src = base + static_cast<long>(k) * plane;
    mbar_expect(bar, kStripeBytes);
#pragma unroll
    for (int r = 0; r < kStripeRows; ++r) bulk_copy(dst + r * kVecPerRow, src + r * pitch, kRowBytes, bar);
  }
};

// Composite the n layers of `src` for stripe `stripe` front to back over
// the background tile `bg` into `out`; both point at the tile's top-left
// pixel, rows `pitch` words apart.  After each layer the block votes and
// stops once every pixel of the stripe is opaque (an early stop never
// changes the output: `over` onto an opaque pixel is the identity).  Every
// thread of the block must call it.
template <class Source>
__device__ __forceinline__ void composite_stripe(const Source& src, int n, const uint32_t* __restrict__ bg,
                                                 uint32_t* __restrict__ out, long pitch, int stripe) {
  __shared__ __align__(128) uint4 stages[kStages][kStripeVecs];
  __shared__ __align__(8) uint64_t full[kStages];

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  src.stage();
  uint4 b[kStripeVecPerThread];
#pragma unroll
  for (int j = 0; j < kStripeVecPerThread; ++j)
    b[j] = __ldg(reinterpret_cast<const uint4*>(bg + stripe_offset(j, stripe, pitch)));
  __syncthreads();

  int issued = min(n, kStages);
  if (threadIdx.x == 0)
    for (int k = 0; k < issued; ++k) src.fill(k, stages[k], &full[k]);

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
      uint4 l = stages[s][threadIdx.x + j * kStripeThreads];
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
        src.fill(issued, stages[s], &full[s]);
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

// Stripe `stripe` of idxs[lo:hi] of `atlas` over `bg` into `out`, as
// composite_stripe.
__device__ __forceinline__ void composite_list_stripe(const int* __restrict__ idxs, int lo, int hi,
                                                      const uint32_t* __restrict__ atlas,
                                                      const uint32_t* __restrict__ bg,
                                                      uint32_t* __restrict__ out, long pitch, int stripe) {
  __shared__ int sidx[kIdxCap];
  const ListSource src{idxs, lo, hi - lo, atlas + static_cast<long>(stripe) * kStripeRows * kTileW, sidx};
  composite_stripe(src, hi - lo, bg, out, pitch, stripe);
}

// Block x of a compacted dirty list: stripe x % kStripes of slot x /
// kStripes, in place in `frame` (tile coordinates relative to its first
// row), rows `pitch` words apart.  A slot whose span starts below 0 leaves
// its tile untouched.  Padding slots repeat the last real slot: a slot
// equal to the one before it returns at once (the earlier slot's blocks
// write the same values; a compositing block never reads the frame).
__device__ __forceinline__ void composite_dirty_stripe(const int* __restrict__ coords,
                                                       const int* __restrict__ spans,
                                                       const int* __restrict__ idxs,
                                                       const uint32_t* __restrict__ bg,
                                                       uint32_t* __restrict__ frame,
                                                       const uint32_t* __restrict__ atlas, long pitch) {
  const int s = blockIdx.x / kStripes;
  const int lo = spans[2 * s], hi = spans[2 * s + 1];
  if (lo < 0) return;  // passthrough slot: the tile stays as it is
  const int ty = coords[2 * s], tx = coords[2 * s + 1];
  if (s > 0 && lo == spans[2 * s - 2] && hi == spans[2 * s - 1] && ty == coords[2 * s - 2] &&
      tx == coords[2 * s - 1])
    return;  // a padding slot: the slot before it writes the same values
  long off = static_cast<long>(ty) * kTileH * pitch + static_cast<long>(tx) * kTileW;
  composite_list_stripe(idxs, lo, hi, atlas, bg + off, frame + off, pitch, blockIdx.x % kStripes);
}

}  // namespace ring

// Banded tile compositors for Hopper (sm_90a): the composition of
// tile_composite.cu for every row band one device holds under a mesh, each
// band from its own local atlas, in one launch per device.
//
// Replace the Pallas calls that coherence_tpu/raster/tiled_scene.py makes
// per band under shard_map:
//   composite_full_banded  <- render_sharded.band_render (:1354), whose two
//                             pallas_calls (:1358 _kernel_atlas_row, :1385
//                             _kernel) compute one function
//   composite_dirty_banded <- render_dirty_sharded.band_dirty (:1509), its
//                             pallas_call of _kernel_subset (:1516)
// shard_map runs one program per device over its band; here one launch per
// device covers all of its bands, with the band as the grid's y index.
//
// Band-strided stacks, for the n_bands bands of one device:
//   starts  (n_bands, band_tiles + 1)      idxs (n_bands, idx_stride)
//   coords, spans (n_bands, 2 * n_slots)   atlas (n_bands, local_cap, 64, 128)
//   bg, out / frame: the bands' rows, (n_bands * band_rows, pw), band b
//   starting at row b * band_rows.
// Tile coordinates and atlas slots in the lists are band-local.
//
// What bounds the work: HBM bytes, as for composite_full and
// composite_dirty.  Both walk as their unbanded kernels do, on
// stripe_ring.cuh's striped TMA ring with its list source, the band as the
// grid's y index.  composite_full_banded: block (x, b) composites stripe
// x % 16 of band-local tile x / 16 of band b from that band's lists and
// local atlas; an empty tile (a band whose lists are empty included)
// writes its background unchanged.  composite_dirty_banded: block (x, b)
// composites stripe x % 16 of slot x / 16 of band b, so an idle band's
// blocks (its slots all passthrough) and padding slots (repeating a band's
// last real slot) return at once.  composite_dirty_banded is launched with
// programmatic dependent launch (pdl.cuh), as composite_dirty is: its
// launch overlaps the end of the kernel before it (the banded
// shatter_into), and it waits at entry for that kernel's writes.

#include "pdl.cuh"
#include "stripe_ring.cuh"

namespace {

using namespace ring;

__global__ void __launch_bounds__(kStripeThreads)
composite_full_banded_kernel(const int* __restrict__ starts, const int* __restrict__ idxs,
                             const uint32_t* __restrict__ bg, uint32_t* __restrict__ out,
                             const uint32_t* __restrict__ atlas, int band_tiles, int ntx,
                             int idx_stride, long atlas_stride) {
  const int t = blockIdx.x / kStripes;
  const int b = blockIdx.y;
  const long pw = static_cast<long>(ntx) * kTileW;
  const int* s = starts + static_cast<long>(b) * (band_tiles + 1);
  const long off = (static_cast<long>(b) * (band_tiles / ntx) + t / ntx) * kTileH * pw +
                   static_cast<long>(t % ntx) * kTileW;
  composite_list_stripe(idxs + static_cast<long>(b) * idx_stride, s[t], s[t + 1], atlas + b * atlas_stride,
                        bg + off, out + off, pw, blockIdx.x % kStripes);
}

__global__ void __launch_bounds__(kStripeThreads)
composite_dirty_banded_kernel(const int* __restrict__ coords, const int* __restrict__ spans,
                              const int* __restrict__ idxs, const uint32_t* __restrict__ bg,
                              uint32_t* __restrict__ frame, const uint32_t* __restrict__ atlas,
                              int n_slots, int pw, int band_rows, int idx_stride,
                              long atlas_stride) {
  pdl::wait();  // the kernel before this one has finished and its writes are visible
  const int b = blockIdx.y;
  const long band = static_cast<long>(b) * 2 * n_slots;
  const long off = static_cast<long>(b) * band_rows * pw;
  composite_dirty_stripe(coords + band, spans + band, idxs + static_cast<long>(b) * idx_stride, bg + off,
                         frame + off, atlas + b * atlas_stride, pw);
}

}  // namespace

// Each entry point launches on `stream` and returns the launch's error, else
// cudaGetLastError().
extern "C" int composite_full_banded(const void* starts, const void* idxs, const void* bg, void* out,
                                     const void* atlas, int n_bands, int band_tiles, int ntx,
                                     int idx_stride, int local_cap, void* stream) {
  dim3 grid(band_tiles * kStripes, n_bands);
  composite_full_banded_kernel<<<grid, kStripeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(idxs),
      static_cast<const uint32_t*>(bg), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(atlas), band_tiles, ntx, idx_stride,
      static_cast<long>(local_cap) * kTileH * kTileW);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int composite_dirty_banded(const void* coords, const void* spans, const void* idxs,
                                      const void* bg, void* frame, const void* atlas, int n_bands,
                                      int n_slots, int pw, int band_rows, int idx_stride,
                                      int local_cap, void* stream) {
  return static_cast<int>(pdl::launch(
      composite_dirty_banded_kernel, dim3(n_slots * kStripes, n_bands), dim3(kStripeThreads), 0,
      static_cast<cudaStream_t>(stream), static_cast<const int*>(coords), static_cast<const int*>(spans),
      static_cast<const int*>(idxs), static_cast<const uint32_t*>(bg), static_cast<uint32_t*>(frame),
      static_cast<const uint32_t*>(atlas), n_slots, pw, band_rows, idx_stride,
      static_cast<long>(local_cap) * kTileH * kTileW));
}

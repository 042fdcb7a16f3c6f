// An empty kernel, launched through the same C entry and ctypes path as
// every kernel of the library: its time on the card, taken as chip_smoke.py
// takes a kernel's (cold L2, queued behind a device-side wait), is the
// floor under every kernel's time there.  It replaces no kernel of the JAX
// package and does none of the program's work.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches one block of one warp on `stream` and returns cudaGetLastError().
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

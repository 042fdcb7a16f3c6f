// Programmatic dependent launch (PDL, sm_90) for the animated frame's chain
// of kernels: shatter_into (S1) -> composite_dirty (K1) or
// composite_dirty_banded (K7) -> blur_blend (B1).
//
// A kernel launched with the programmatic stream serialization attribute
// (launch below) may start once every block of the kernel before it in its
// stream has exited (or executed griddepcontrol.launch_dependents, which no
// kernel here does), without waiting for that kernel's completion to be
// signalled to the stream: its launch overlaps the end of the kernel before
// it.  It must then execute wait() before it reads or writes anything,
// since only after wait() has the kernel before it finished and are its
// writes visible.  K1, K7 and B1 launch with the attribute and call wait()
// as their first instruction; every caller stays correct, whatever kernel
// comes before them.
//
// Why no kernel triggers early: with S1 and K1 triggering at entry (their
// dependents launched while they ran, then waiting) 100 queued lion frames
// took 0.0143-0.0195 ms a frame, against 0.0125-0.0165 without a trigger
// and 0.0146-0.0184 with no PDL at all: without a trigger every range of
// frames gained 2.0-2.2 us on no PDL, with the triggers the heavier frames
// lost 0.8-1.0 us (profile_frame.py --chain-only, trees in turns; NVIDIA
// H100 80GB HBM3, 700 W).

#pragma once

#include <cuda_runtime.h>

namespace pdl {

// Block until the kernel before this one in its stream has finished and its
// memory is visible (returns at once where there is no such dependency).
__device__ __forceinline__ void wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// `kernel` on `stream` with programmatic stream serialization: the
// launch's own error, else cudaGetLastError().
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace pdl

// What the card says of a kernel variant, for the launchers' *_info entry
// points (the scans', the router kernels').  Internal linkage, like the
// other headers here: each source that includes it gets its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

// the kernels' variants and what the card says of each: registers a
// thread, local (spilled) bytes a thread, static and dynamic shared
// memory a block, resident blocks an SM, the card's SMs, threads a block.
// The kernel's dynamic shared memory limit is raised to `smem` where it
// is lower, never lowered: a launcher that sets it only above the 48 KB
// default must find it at least that high afterwards.
template <typename K>
int kernel_info(K kernel, int threads, int smem, int* info) {
  cudaFuncAttributes attr{};
  int device = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && smem > attr.maxDynamicSharedSizeBytes)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[4], kernel,
                                                        threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&info[5], cudaDevAttrMultiProcessorCount,
                                 device);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = smem;
  info[6] = threads;
  return static_cast<int>(err);
}

}  // namespace

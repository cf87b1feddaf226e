// A kernel that does nothing, launched through the same ctypes path as the
// port's kernels: its time on the card is the floor under every small
// kernel's (a launch that moves no data and does no work), against which
// the router kernels and MoE gating are read.  No Pallas kernel has a
// counterpart; nothing on a model path launches it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One block of 32 threads on `stream`; returns the launch's cudaError_t.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Mamba2 SSD scan for the one-shot prefill, written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/mamba2/kernel.py
// (_ssd_kernel, launched by ssd_fwd).  For each (batch b, head h), over
// the tokens t in order, with a P x N fp32 state H (P = 64):
//
//     H[p, n] <- H[p, n] * exp(dt_t * A_h) + dt_t * x_t[p] * B_t[n]
//     y_t[p]  =  sum_n C_t[n] * H[p, n]
//
// starting from h0 (zeros when null); the final H is written to h_fin.
// B and C have one group: every head reads the same (b, t) rows.
//
// What bounds it on an H100: operations.  Per token and head it does
// about 5 P N fp32 operations (the decay-and-add update, then C.H) on the
// CUDA cores, against 4 bytes of x and y per (t, h, p) in bf16: at the
// zamba2-7b prefill (B=1 S=4096 H=112 N=64) 9.4 GFLOP against 0.12 GB,
// so ~0.14 ms of fp32 arithmetic against ~0.04 ms of bytes.  The
// recurrence is sequential in t, so the parallelism is only across
// (b, h, p).
//
// Design (simple and right first; the chunked tensor-core form is later
// work):
//   * the per-token form, not the Pallas kernel's exp(cum_t - cum_s)
//     chunk factorization: every exp is of dt * A <= 0, so it underflows
//     cleanly to 0 and never overflows;
//   * one block per (b, h, half of the P rows): 128 threads, four lanes
//     per row p, each lane holding N/4 of the row's state in registers
//     (columns n = 4j + lane % 4, so the four lanes' shared-memory reads
//     fall in distinct banks).  y[p] is the sum of the four lanes' partial
//     sums, two __shfl_xor_sync steps;
//   * x, dt, exp(dt * A), B and C of 32 tokens at a time are staged in
//     shared memory (upcast to fp32 once); y is staged and written back
//     coalesced in the input dtype;
//   * N is a template parameter (16, 32, 64 or 128) so the state stays in
//     registers; a ragged S needs no divisor.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kP = 64;                      // head size (MAMBA_HEAD_DIM)
constexpr int kSplit = 4;                   // lanes sharing a row p
constexpr int kPPerBlock = 32;              // rows p per block
constexpr int kThreads = kPPerBlock * kSplit;
constexpr int kChunk = 32;                  // tokens staged per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const T* __restrict__ bmat, const T* __restrict__ cmat,
           const float* __restrict__ a, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ h_fin, int s_len, int h) {
  constexpr int kColsPerLane = N / kSplit;
  constexpr int kPBlocks = kP / kPPerBlock;
  const int bh = blockIdx.x / kPBlocks;               // b * h + head
  const int b = bh / h;
  const int head = bh % h;
  const int p0 = (blockIdx.x % kPBlocks) * kPPerBlock;
  const int tid = threadIdx.x;
  const int lane_n = tid % kSplit;
  const int pl = tid / kSplit;                        // row in the block
  const int pc = p0 + pl;                             // row in the head

  __shared__ float sx[kChunk][kPPerBlock];
  __shared__ float sb[kChunk][N];
  __shared__ float sc[kChunk][N];
  __shared__ float sdt[kChunk];
  __shared__ float sda[kChunk];                       // exp(dt * A)
  __shared__ float sy[kChunk][kPPerBlock];

  const size_t state_base = (static_cast<size_t>(bh) * kP + pc) * N;
  float state[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j)
    state[j] = h0 ? h0[state_base + j * kSplit + lane_n] : 0.0f;
  const float a_h = a[head];

  // x, y: (B, S, H, P); dt: (B, S, H); B, C: (B, S, N)
  const size_t x_tok = static_cast<size_t>(h) * kP;
  const size_t x_base = static_cast<size_t>(b) * s_len * x_tok
                        + static_cast<size_t>(head) * kP + p0;
  const size_t dt_base = static_cast<size_t>(b) * s_len * h + head;
  const size_t bc_base = static_cast<size_t>(b) * s_len * N;
  for (int t0 = 0; t0 < s_len; t0 += kChunk) {
    const int n = min(kChunk, s_len - t0);
    for (int i = tid; i < n * kPPerBlock; i += kThreads) {
      const int t = i / kPPerBlock, c = i % kPPerBlock;
      sx[t][c] = to_f32(x[x_base + static_cast<size_t>(t0 + t) * x_tok + c]);
    }
    for (int i = tid; i < n * N; i += kThreads) {
      const int t = i / N, c = i % N;
      const size_t off = bc_base + static_cast<size_t>(t0 + t) * N + c;
      sb[t][c] = to_f32(bmat[off]);
      sc[t][c] = to_f32(cmat[off]);
    }
    for (int t = tid; t < n; t += kThreads) {
      const float d = dt[dt_base + static_cast<size_t>(t0 + t) * h];
      sdt[t] = d;
      sda[t] = expf(d * a_h);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float da = sda[t];
      const float dx = sx[t][pl] * sdt[t];
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int col = j * kSplit + lane_n;
        state[j] = fmaf(state[j], da, dx * sb[t][col]);
        acc = fmaf(sc[t][col], state[j], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (lane_n == 0) sy[t][pl] = acc;
    }
    __syncthreads();
    for (int i = tid; i < n * kPPerBlock; i += kThreads) {
      const int t = i / kPPerBlock, c = i % kPPerBlock;
      y[x_base + static_cast<size_t>(t0 + t) * x_tok + c] =
          from_f32<T>(sy[t][c]);
    }
  }
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j)
    h_fin[state_base + j * kSplit + lane_n] = state[j];
}

template <typename T>
int launch_typed(const void* x, const float* dt, const void* bmat,
                 const void* cmat, const float* a, const float* h0, void* y,
                 float* h_fin, int b, int s, int h, int n,
                 cudaStream_t st) {
  const dim3 grid(b * h * (kP / kPPerBlock));
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(bmat);
  const T* cp = static_cast<const T*>(cmat);
  T* yp = static_cast<T*>(y);
  switch (n) {
    case 16:
      ssd_kernel<T, 16><<<grid, kThreads, 0, st>>>(xp, dt, bp, cp, a, h0,
                                                    yp, h_fin, s, h);
      break;
    case 32:
      ssd_kernel<T, 32><<<grid, kThreads, 0, st>>>(xp, dt, bp, cp, a, h0,
                                                    yp, h_fin, s, h);
      break;
    case 64:
      ssd_kernel<T, 64><<<grid, kThreads, 0, st>>>(xp, dt, bp, cp, a, h0,
                                                    yp, h_fin, s, h);
      break;
    case 128:
      ssd_kernel<T, 128><<<grid, kThreads, 0, st>>>(xp, dt, bp, cp, a, h0,
                                                     yp, h_fin, s, h);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (b, s, h, p), B and C (b, s, n) of one dtype (0 = fp32, 1 = bf16);
// dt (b, s, h) fp32; A (h,) fp32; h0 (b, h, p, n) fp32 or null for zeros;
// y (b, s, h, p) in x's dtype; h_fin (b, h, p, n) fp32; all contiguous on
// the device.  Returns the launch's cudaError_t (0 = launched);
// cudaErrorInvalidValue, without launching, for a shape the kernel does
// not take (p != 64, n not one of 16, 32, 64, 128) or an unknown dtype.
extern "C" int mamba2_launch(const void* x, const float* dt, const void* bmat,
                             const void* cmat, const float* a,
                             const float* h0, void* y, float* h_fin, int b,
                             int s, int h, int p, int n, int dtype,
                             void* stream) {
  if (p != kP || b < 0 || s < 0 || h < 1 || (dtype != 0 && dtype != 1) ||
      (n != 16 && n != 32 && n != 64 && n != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(x, dt, bmat, cmat, a, h0, y, h_fin, b, s, h,
                               n, st);
  return launch_typed<__nv_bfloat16>(x, dt, bmat, cmat, a, h0, y, h_fin, b,
                                     s, h, n, st);
}

// RWKV6 WKV scan for the one-shot prefill, written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6/kernel.py
// (_wkv_kernel, launched by wkv_fwd).  For each (batch b, head h), over
// the tokens t in order, with a K x K fp32 state S (K = 64):
//
//     y_t[v] = sum_k r_t[k] * (S[k, v] + u[k] * k_t[k] * v_t[v])
//     S[k, v] <- S[k, v] * exp(logw_t[k]) + k_t[k] * v_t[v]
//
// starting from s0 (zeros when null); the final S is written to s_fin.
//
// What bounds it on an H100: operations.  Per token and head it does
// about 5 K^2 fp32 operations (r.S, and the decay-and-add update) on the
// CUDA cores, against 12 bytes of r, k, v, logw and y per element in the
// model's dtypes: at the rwkv6-1.6b prefill (B=2 S=2048 H=32) 2.7 GFLOP
// against 101 MB, so ~0.04 ms of fp32 arithmetic against ~0.03 ms of
// bytes.  The recurrence is sequential in t, so the parallelism is only across
// (b, h, v): 4096 value columns at that shape.
//
// Design (simple and right first; the chunked tensor-core form is later
// work):
//   * the per-token form, not the Pallas kernel's exp(+-cumsum) chunk
//     factorization: no exp of a positive sum, so no overflow however
//     negative logw is, and exp(logw) underflows cleanly to 0;
//   * one block per (b, h, half of the value columns): 128 threads, four
//     lanes per value column v, each lane holding 16 of the column's 64
//     state rows in registers (rows k = 4j + lane % 4, so the four lanes'
//     shared-memory reads fall in distinct banks).  y[v] is the sum of the
//     four lanes' partial sums, two __shfl_xor_sync steps;
//   * r, k, exp(logw) and v of 32 tokens at a time are staged in shared
//     memory (coalesced loads along K, upcast to fp32 once); y is staged
//     and written back coalesced in the input dtype;
//   * a ragged S needs no divisor: the last pass stages fewer tokens.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 64;                      // head size (RWKV_HEAD_DIM)
constexpr int kSplit = 4;                   // lanes sharing a value column
constexpr int kRowsPerLane = kK / kSplit;   // 16 state rows in registers
constexpr int kVPerBlock = 32;              // value columns per block
constexpr int kThreads = kVPerBlock * kSplit;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ y, float* __restrict__ s_fin, int s_len, int h) {
  constexpr int kVBlocks = kK / kVPerBlock;
  const int bh = blockIdx.x / kVBlocks;               // b * h + head
  const int b = bh / h;
  const int head = bh % h;
  const int v0 = (blockIdx.x % kVBlocks) * kVPerBlock;
  const int tid = threadIdx.x;
  const int lane_k = tid % kSplit;
  const int vl = tid / kSplit;                        // column in the block
  const int vc = v0 + vl;                             // column in the head

  __shared__ float sr[kChunk][kK];
  __shared__ float sk[kChunk][kK];
  __shared__ float sw[kChunk][kK];                    // exp(logw)
  __shared__ float sv[kChunk][kVPerBlock];
  __shared__ float sy[kChunk][kVPerBlock];

  const size_t state_base = static_cast<size_t>(bh) * kK * kK;
  float state[kRowsPerLane];
  float uk[kRowsPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int row = j * kSplit + lane_k;
    state[j] = s0 ? s0[state_base + row * kK + vc] : 0.0f;
    uk[j] = u[head * kK + row];
  }

  // element (b, t, head, c) of a (B, S, H, K) tensor
  const size_t tok_stride = static_cast<size_t>(h) * kK;
  const size_t base = static_cast<size_t>(b) * s_len * tok_stride
                      + static_cast<size_t>(head) * kK;
  for (int t0 = 0; t0 < s_len; t0 += kChunk) {
    const int n = min(kChunk, s_len - t0);
    for (int i = tid; i < n * kK; i += kThreads) {
      const int t = i / kK, c = i % kK;
      const size_t off = base + static_cast<size_t>(t0 + t) * tok_stride + c;
      sr[t][c] = to_f32(r[off]);
      sk[t][c] = to_f32(k[off]);
      sw[t][c] = expf(logw[off]);
    }
    for (int i = tid; i < n * kVPerBlock; i += kThreads) {
      const int t = i / kVPerBlock, c = i % kVPerBlock;
      sv[t][c] = to_f32(
          v[base + static_cast<size_t>(t0 + t) * tok_stride + v0 + c]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vv = sv[t][vl];
      float acc = 0.0f, bonus = 0.0f;
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const int row = j * kSplit + lane_k;
        const float rk = sr[t][row];
        const float kk = sk[t][row];
        acc = fmaf(rk, state[j], acc);
        bonus = fmaf(rk * uk[j], kk, bonus);
        state[j] = fmaf(state[j], sw[t][row], kk * vv);
      }
      float part = fmaf(bonus, vv, acc);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (lane_k == 0) sy[t][vl] = part;
    }
    __syncthreads();
    for (int i = tid; i < n * kVPerBlock; i += kThreads) {
      const int t = i / kVPerBlock, c = i % kVPerBlock;
      y[base + static_cast<size_t>(t0 + t) * tok_stride + v0 + c] =
          from_f32<T>(sy[t][c]);
    }
    // the next pass's staging writes sr/sk/sw/sv only, and its compute
    // writes sy only after the next __syncthreads: no barrier needed here
  }
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int row = j * kSplit + lane_k;
    s_fin[state_base + row * kK + vc] = state[j];
  }
}

}  // namespace

// r, k, v (b, s, h, kd) of one dtype (0 = fp32, 1 = bf16); logw (b, s, h,
// kd) fp32; u (h, kd) fp32; s0 (b, h, kd, kd) fp32 or null for zeros;
// y (b, s, h, kd) in r's dtype; s_fin (b, h, kd, kd) fp32; all contiguous
// on the device.  Returns the launch's cudaError_t (0 = launched);
// cudaErrorInvalidValue, without launching, for a shape the kernel does
// not take (kd != 64) or an unknown dtype code.
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const float* logw, const float* u,
                            const float* s0, void* y, float* s_fin, int b,
                            int s, int h, int kd, int dtype, void* stream) {
  if (kd != kK || b < 0 || s < 0 || h < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const dim3 grid(b * h * (kK / kVPerBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    wkv_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), logw, u, s0, static_cast<float*>(y),
        s_fin, s, h);
  } else {
    wkv_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(r),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), logw, u, s0,
        static_cast<__nv_bfloat16*>(y), s_fin, s, h);
  }
  return static_cast<int>(cudaGetLastError());
}

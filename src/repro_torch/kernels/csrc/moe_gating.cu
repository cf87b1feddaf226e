// Fused top-k softmax gating for the MoE router, written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/moe_gating/kernel.py
// (_gate_kernel, launched by topk_gating_fwd).  For each row t of the
// (T, E) fp32 router logits:
//
//     k argmax sweeps: take the largest remaining logit, ties to the lowest
//     expert index (as lax.top_k), then set it to NEG_INF = -1e30;
//     weights[t] = p / sum(p) with p = exp(g - g0) over the k chosen gates.
//
// What bounds it on an H100: bytes, and at the serving shapes launch
// latency.  It reads T x E x 4 bytes and writes T x k x 8; the work is
// k x E comparisons per row, nothing for the card's arithmetic units.  At
// a decode tick (T = 4) or a chunk tick (T = 32) one launch is a few
// microseconds of latency for a few kilobytes.
//
// Design (simple and exact first):
//   * one warp per row, 8 rows per 256-thread block; lane l holds the
//     logits of experts l, l + 32, ... in registers (E <= 256);
//   * each sweep: every lane takes its best (value, index) pair, then a
//     butterfly of __shfl_xor_sync leaves the row's best pair in every
//     lane.  A pair wins if its value is larger, or equal with a lower
//     index, so the order of the butterfly cannot change the choice;
//   * the lane that holds the chosen expert sets it to NEG_INF;
//   * lane 0 computes the k weights in fp32 (expf, one division each).
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxPerLane = 8;              // E <= 32 * 8 = 256
constexpr int kMaxK = 4;                    // the reference's bound (k <= 4)
constexpr int kRowsPerBlock = 8;            // warps of a 256-thread block
constexpr float kNegInf = -1e30f;           // the Pallas kernel's NEG_INF

__device__ __forceinline__ bool beats(float v, int i, float best, int bi) {
  return v > best || (v == best && i < bi);
}

__global__ void moe_gating_kernel(const float* __restrict__ logits,
                                  float* __restrict__ weights,
                                  int* __restrict__ idx, int t, int e, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= t) return;                     // the whole warp leaves together
  const float* x = logits + static_cast<size_t>(row) * e;

  float val[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int c = lane + 32 * j;
    val[j] = c < e ? x[c] : -INFINITY;
  }

  float gate[kMaxK];
  int chosen[kMaxK];
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (r >= k) break;
    float best = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int c = lane + 32 * j;
      if (c < e && beats(val[j], c, best, bi)) {
        best = val[j];
        bi = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (beats(ob, oi, best, bi)) {
        best = ob;
        bi = oi;
      }
    }
    gate[r] = best;
    chosen[r] = bi;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j)
      if (lane + 32 * j == bi) val[j] = kNegInf;
  }

  if (lane == 0) {
    float p[kMaxK];
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      if (r >= k) break;
      p[r] = expf(gate[r] - gate[0]);       // gate[0] is the largest
      sum += p[r];
    }
    const size_t base = static_cast<size_t>(row) * k;
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      if (r >= k) break;
      weights[base + r] = p[r] / sum;
      idx[base + r] = chosen[r];
    }
  }
}

}  // namespace

// logits fp32 (t, e), weights fp32 (t, k), idx int32 (t, k), all contiguous
// on the device.  Returns the launch's cudaError_t (0 = launched);
// cudaErrorInvalidValue, without launching, for a shape the kernel does not
// take: e outside [1, 256] (eight logits a lane), or k outside [1, min(4, e)].
extern "C" int moe_gating_launch(const float* logits, float* weights, int* idx,
                                 int t, int e, int k, void* stream) {
  if (e < 1 || e > 32 * kMaxPerLane || k < 1 || k > kMaxK || k > e)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t <= 0) return 0;
  const int blocks = (t + kRowsPerBlock - 1) / kRowsPerBlock;
  moe_gating_kernel<<<blocks, 32 * kRowsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(logits, weights,
                                                           idx, t, e, k);
  return static_cast<int>(cudaGetLastError());
}

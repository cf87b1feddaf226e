// Hashed-embedding featurization for the router, written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/featurize/kernel.py
// (_featurize_kernel, launched by hashed_embed_fwd).  For each row q:
//
//     counts[h] = sum_l weights[q, l] * [ids[q, l] == h]     (-1 = pad)
//     v         = log1p(counts) @ proj                       (proj: H x D)
//     out[q]    = v / max(|v|, 1e-30) if |v| > 0 else v
//
// What bounds it on an H100: bytes.  The projection (2048 x 384 fp32, 3 MB)
// is the only large operand; it stays in the 50 MB L2 across rows and calls.
// A row has a few hundred non-zero buckets at most, so the useful work is
// nnz x D fused multiply-adds per row, far below the card's fp32 rate.  At
// the router's batch sizes (<= 128 rows) the kernel is launch-bound.
//
// Design (simple and exact first):
//   * one block per row, one thread per output column (D <= 1024);
//   * the H-float count vector lives in shared memory, zeroed, then filled
//     with shared-memory atomics.  The router's weights are 1.0, 0.5 and
//     0.75 (word, trigram, bigram), and every partial sum of such values is
//     a multiple of 0.25 far below 2^22, so fp32 sums are exact in any
//     order: the atomics' order cannot change a bit of the result;
//   * each column sums tf[h] * proj[h, j] over the non-zero buckets in
//     ascending h with fp32 FMA — the dense product with its exact zeros
//     left out.  The branch on tf[h] is uniform across the block (tf is a
//     shared broadcast), and proj rows are read coalesced across threads;
//   * a warp-shuffle block reduction gives the L2 norm.
// No TF32 and no tensor cores: the router's decisions depend on this
// output matching the host encoder to 1e-5.
#include <cuda_runtime.h>

namespace {

__global__ void featurize_kernel(const int* __restrict__ ids,
                                 const float* __restrict__ weights,
                                 const float* __restrict__ proj,
                                 float* __restrict__ out,
                                 int seq_l, int hash_dim, int dim) {
  extern __shared__ float smem[];
  float* tf = smem;                 // hash_dim counts, then log1p(counts)
  float* v = smem + hash_dim;       // dim unnormalized outputs
  __shared__ float partial[32];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int* row_ids = ids + static_cast<size_t>(row) * seq_l;
  const float* row_w = weights + static_cast<size_t>(row) * seq_l;

  for (int h = tid; h < hash_dim; h += blockDim.x) tf[h] = 0.0f;
  __syncthreads();
  for (int l = tid; l < seq_l; l += blockDim.x) {
    const int id = row_ids[l];
    // an id outside [0, hash_dim) matches no bucket, as in the Pallas
    // kernel's one-hot: padding (-1) and anything past the last bucket
    if (id >= 0 && id < hash_dim) atomicAdd(&tf[id], row_w[l]);
  }
  __syncthreads();
  for (int h = tid; h < hash_dim; h += blockDim.x) tf[h] = log1pf(tf[h]);
  __syncthreads();

  float sumsq = 0.0f;
  for (int j = tid; j < dim; j += blockDim.x) {
    float acc = 0.0f;
    for (int h = 0; h < hash_dim; ++h) {
      const float t = tf[h];
      if (t != 0.0f) acc = fmaf(t, proj[static_cast<size_t>(h) * dim + j], acc);
    }
    v[j] = acc;
    sumsq = fmaf(acc, acc, sumsq);
  }

  // block reduction of sumsq: shuffle within warps, then across warps
  for (int off = 16; off > 0; off >>= 1)
    sumsq += __shfl_down_sync(0xffffffffu, sumsq, off);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) partial[warp] = sumsq;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    float s = lane < n_warps ? partial[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) partial[0] = s;
  }
  __syncthreads();
  const float norm = sqrtf(partial[0]);
  float* row_out = out + static_cast<size_t>(row) * dim;
  for (int j = tid; j < dim; j += blockDim.x)
    row_out[j] = norm > 0.0f ? v[j] / fmaxf(norm, 1e-30f) : v[j];
}

}  // namespace

// ids int32 (q, seq_l), weights fp32 (q, seq_l), proj fp32 (hash_dim, dim),
// out fp32 (q, dim), all contiguous on the device.  Returns the launch's
// cudaError_t (0 = launched); cudaErrorInvalidValue, without launching, for
// a shape the kernel does not take: dim > 1024 (one thread per column), or
// counts and outputs beyond the 48 KB of shared memory a block gets without
// opting in ((hash_dim + dim) * 4 bytes plus the reduction's 128).
extern "C" int featurize_launch(const int* ids, const float* weights,
                                const float* proj, float* out, int q,
                                int seq_l, int hash_dim, int dim,
                                void* stream) {
  if (q <= 0) return 0;
  const size_t smem = static_cast<size_t>(hash_dim + dim) * sizeof(float);
  if (hash_dim <= 0 || dim <= 0 || dim > 1024 ||
      smem + 32 * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((dim + 31) / 32) * 32;
  featurize_kernel<<<q, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ids, weights, proj, out, seq_l, hash_dim, dim);
  return static_cast<int>(cudaGetLastError());
}

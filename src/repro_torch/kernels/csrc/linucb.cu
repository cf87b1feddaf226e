// Batched LinUCB arm scoring (paper Eq. 13), written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/linucb/kernel.py
// (_linucb_kernel, launched by linucb_scores_fwd):
//
//     s[q, m] = theta_m . x_q + alpha * sqrt(max(x_q^T A_m^-1 x_q, 0))
//
// What bounds it on an H100: at the router's sizes (M = 64 arms, d = 12,
// Q <= 128) the inputs are ~40 KB and the work ~2 MFLOP, so the kernel is
// launch-bound; at the docstring's production shape (d = 128, Q = 1024) it
// is fp32 FMA-bound (2 d^2 operations per output, no reuse of A across
// arms).  Tensor cores would need TF32 or a split-precision scheme and are
// deliberately not used: the routing decision is an argmax over these
// scores, which must agree with the host reference to 1e-4.
//
// Design: one thread per (q, m) output.  Block (blockIdx.y = arm m,
// blockIdx.x = a tile of kTileQ queries) stages theta_m, the tile's x_q
// rows (padded stride d + 1, so a thread's row walk never bank-conflicts)
// and A_m^-1 in row tiles of up to kRowFloats floats through shared memory
// (under the 48 KB a block gets without opting in, up to d = 150); every
// thread reads the same A element at a time (a broadcast).
// The quadratic form is summed as sum_i x_i * (sum_j A_ij x_j) with fp32
// FMA, then clamped at 0 exactly where the Pallas kernel clamps, then
// square-rooted.  The masked argmax over arms stays outside the kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kTileQ = 64;         // queries per block (= threads)
constexpr int kRowFloats = 2048;   // floats of A_m^-1 staged at a time (8 KB)

// rows of A_m^-1 per shared-memory tile: as many as kRowFloats holds, >= 1
__host__ __device__ inline int rows_per_tile(int d) {
  const int r = kRowFloats / d;
  return r < 1 ? 1 : (r > d ? d : r);
}

__global__ void linucb_kernel(const float* __restrict__ a_inv,
                              const float* __restrict__ theta,
                              const float* __restrict__ x,
                              float* __restrict__ out,
                              int q_total, int m_total, int d, float alpha) {
  extern __shared__ float smem[];
  const int xs_stride = d + 1;
  float* th = smem;                            // d
  float* xs = th + d;                          // kTileQ x (d + 1)
  float* as = xs + kTileQ * xs_stride;         // rows_per_tile x d

  const int m = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  const int tid = threadIdx.x;
  const int q = q0 + tid;
  const int tile_rows = rows_per_tile(d);
  const float* a_m = a_inv + static_cast<size_t>(m) * d * d;

  for (int j = tid; j < d; j += blockDim.x)
    th[j] = theta[static_cast<size_t>(m) * d + j];
  for (int e = tid; e < kTileQ * d; e += blockDim.x) {
    const int r = e / d, c = e % d;
    xs[r * xs_stride + c] =
        (q0 + r < q_total) ? x[static_cast<size_t>(q0 + r) * d + c] : 0.0f;
  }
  __syncthreads();

  const float* xq = xs + tid * xs_stride;
  float mean = 0.0f;
  for (int j = 0; j < d; ++j) mean = fmaf(th[j], xq[j], mean);

  float var = 0.0f;
  for (int i0 = 0; i0 < d; i0 += tile_rows) {
    const int rows = min(tile_rows, d - i0);
    __syncthreads();                           // previous tile fully read
    for (int e = tid; e < rows * d; e += blockDim.x)
      as[e] = a_m[static_cast<size_t>(i0) * d + e];
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float* arow = as + r * d;
      float ax = 0.0f;
      for (int j = 0; j < d; ++j) ax = fmaf(arow[j], xq[j], ax);
      var = fmaf(xq[i0 + r], ax, var);
    }
  }
  var = fmaxf(var, 0.0f);
  if (q < q_total)
    out[static_cast<size_t>(q) * m_total + m] = mean + alpha * sqrtf(var);
}

}  // namespace

// a_inv fp32 (m, d, d), theta fp32 (m, d), x fp32 (q, d), out fp32 (q, m),
// all contiguous on the device.  Returns the launch's cudaError_t;
// cudaErrorInvalidValue, without launching, for a shape the kernel does not
// take: more than 65535 arms (grid y), or staging beyond the 48 KB of shared
// memory a block gets without opting in (d > 150).
extern "C" int linucb_launch(const float* a_inv, const float* theta,
                             const float* x, float* out, int q, int m, int d,
                             float alpha, void* stream) {
  if (q <= 0 || m <= 0) return 0;
  if (d <= 0 || m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(d) + kTileQ * (d + 1) +
                       static_cast<size_t>(rows_per_tile(d)) * d) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((q + kTileQ - 1) / kTileQ, m);
  linucb_kernel<<<grid, kTileQ, smem, static_cast<cudaStream_t>(stream)>>>(
      a_inv, theta, x, out, q, m, d, alpha);
  return static_cast<int>(cudaGetLastError());
}

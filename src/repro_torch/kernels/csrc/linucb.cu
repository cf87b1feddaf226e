// Batched LinUCB arm scoring (paper Eq. 13), written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/linucb/kernel.py
// (_linucb_kernel, launched by linucb_scores_fwd):
//
//     s[q, m] = theta_m . x_q + alpha * sqrt(max(x_q^T A_m^-1 x_q, 0))
//
// What bounds it on an H100: at the router's sizes (d = 12, M <= 64, Q <=
// 128) the inputs are ~40 KB and the work ~2 MFLOP, so the kernel is
// launch-bound; at the docstring's production shape (d = 128, Q = 1024,
// M = 64) it is fp32 FMA-bound: 2 d^2 operations an output, 2.15 GFLOP,
// 0.032 ms at the card's 67 TFLOP/s.  Tensor cores would need TF32 or a
// split-precision scheme and are deliberately not used: the routing
// decision is an argmax over these scores, which must agree with the host
// reference to 1e-4.  Everything is fp32 FMA.
//
// Two paths, chosen by kernels/linucb/kernel.py: layout from (q, m, d):
//   * small d (<= 32, the router's 12): a group of G = next_pow2(d) lanes
//     a (query, arm) output; lane i forms (A_m x_q)_i over j ascending
//     from L2 (no shared memory, no barrier), times x_qi, beside
//     theta_mi x_qi, and the group adds both by a butterfly of shuffles.
//     A launch is one dependent load and a few shuffles deep;
//   * larger d: per arm the variances are a product W = X A_m (a tile of
//     kBQ = 128 queries x d, by d x d), then the row-wise dot of W with X.
//     A block takes one arm and one query tile: the tile's X (all d
//     columns, kept for the epilogue, stored transposed) and A_m's rows
//     arrive through shared memory in k-slabs of kBK = 32,
//     double-buffered with cp.async, so the next slab's loads overlap
//     this slab's FMAs.  Each of the 256 threads holds an 8
//     x 8 (query x column) micro-tile of W in registers; a k-step is four
//     16-byte shared loads (8 queries of X^T's row k, 8 columns of A's row
//     k) and 64 FMAs, so one loaded value feeds 8 FMAs.  Columns come in
//     tiles of kBJ = 128 (two for d = 150).  The epilogue multiplies by x_qj and
//     sums over the thread's columns in order, then across the 16 threads
//     that share a query by a butterfly of shuffles; theta_m . x_q is
//     summed the same way.
// Both clamp the quadratic form at 0 exactly where the Pallas kernel
// clamps, then take the square root.  The masked argmax over arms stays
// outside the kernel.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_info.cuh"

namespace {

constexpr int kSmallMaxD = 32;     // the small path: a group of <= 32 lanes
constexpr int kSmallThreads = 128;
constexpr int kBQ = 128;           // queries of a block (tiled path)
constexpr int kBJ = 128;           // columns of W a pass
constexpr int kBK = 32;            // k-steps a slab
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 each
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void linucb_small_kernel(const float* __restrict__ a_inv,
                                    const float* __restrict__ theta,
                                    const float* __restrict__ x,
                                    float* __restrict__ out, int q_total,
                                    int m_total, int d, int group_log2,
                                    float alpha) {
  const int gsize = 1 << group_log2;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long o = t >> group_log2;       // output index q * M + m
  const int i = static_cast<int>(t & (gsize - 1));
  const bool live = o < static_cast<long long>(q_total) * m_total;
  float var = 0.0f, mean = 0.0f;
  if (live && i < d) {
    const int q = static_cast<int>(o / m_total);
    const int m = static_cast<int>(o - static_cast<long long>(q) * m_total);
    const float* xq = x + static_cast<size_t>(q) * d;
    const float* arow = a_inv + (static_cast<size_t>(m) * d + i) * d;
    float ax = 0.0f;
#pragma unroll 4
    for (int j = 0; j < d; ++j) ax = fmaf(__ldg(arow + j), __ldg(xq + j), ax);
    const float xi = __ldg(xq + i);
    var = xi * ax;
    mean = __ldg(theta + static_cast<size_t>(m) * d + i) * xi;
  }
  for (int off = gsize >> 1; off > 0; off >>= 1) {
    var += __shfl_xor_sync(0xffffffffu, var, off);
    mean += __shfl_xor_sync(0xffffffffu, mean, off);
  }
  if (live && i == 0) out[o] = mean + alpha * sqrtf(fmaxf(var, 0.0f));
}

// tiled path: X^T of the query tile (rows of kXS floats: 16-byte rows,
// and the writes of a slab's k-steps for two queries land on distinct
// banks), two slabs of A, theta
constexpr int kXS = kBQ + 4;
__host__ __device__ inline int k_rows(int d) {
  return (d + kBK - 1) / kBK * kBK;
}
inline size_t tiled_smem(int d) {
  return (static_cast<size_t>(k_rows(d)) * kXS + 2 * kBK * kBJ +
          (d + 3) / 4 * 4) * sizeof(float);
}

// the thread's queries and columns within the tile: 4 from its group of 4
// in each half of 64, so a quarter-warp's 16-byte loads of A cover 32
// banks once, and a warp's loads of X^T are two addresses
__device__ __forceinline__ int half_index(int t, int r) {
  return (r < 4 ? 0 : 64) + t * 4 + (r & 3);
}

// the thread's 8 queries of X^T's row k: two 16-byte loads
__device__ __forceinline__ void load_x8(const float* row, int tq,
                                        float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(row + tq * 4);
  const float4 hi = *reinterpret_cast<const float4*>(row + 64 + tq * 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__global__ void __launch_bounds__(kThreads, 2)
    linucb_tiled_kernel(const float* __restrict__ a_inv,
                        const float* __restrict__ theta,
                        const float* __restrict__ x, float* __restrict__ out,
                        int q_total, int m_total, int d, int q_tiles,
                        float alpha) {
  extern __shared__ __align__(16) float smem[];
  float* xt = smem;                                  // k_rows(d) x kXS
  float* as = xt + k_rows(d) * kXS;                  // 2 x kBK x kBJ
  float* th = as + 2 * kBK * kBJ;                    // d

  const int m = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - m * q_tiles) * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tj = lane & 15, tq = warp * 2 + (lane >> 4);
  const float* a_m = a_inv + static_cast<size_t>(m) * d * d;
  const int slabs = k_rows(d) / kBK;
  // A's rows go in 16-byte copies where they are 16-byte aligned
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a_inv) % 16 == 0;
  const int passes = (d + kBJ - 1) / kBJ;
  const int steps = slabs * passes;

  for (int j = tid; j < d; j += kThreads)
    th[j] = theta[static_cast<size_t>(m) * d + j];

  // step t: slab s = t % slabs of column pass t / slabs; the first pass
  // also brings X's columns k0 .. k0 + kBK as rows of X^T (zeros past d
  // and past q_total)
  auto load = [&](int t) {
    const int pass = t / slabs, k0 = (t - pass * slabs) * kBK;
    float* dst = as + (t & 1) * kBK * kBJ;
    if (vec) {
      for (int e = tid; e < kBK * kBJ / 4; e += kThreads) {
        const int kk = e / (kBJ / 4), jj = (e - kk * (kBJ / 4)) * 4;
        const int j = pass * kBJ + jj;
        const bool ok = k0 + kk < d && j < d;
        cp_async16(dst + kk * kBJ + jj,
                   ok ? a_m + static_cast<size_t>(k0 + kk) * d + j : a_m,
                   ok);
      }
    } else {
      for (int e = tid; e < kBK * kBJ; e += kThreads) {
        const int kk = e / kBJ, j = pass * kBJ + (e - kk * kBJ);
        const bool ok = k0 + kk < d && j < d;
        cp_async4(dst + e, ok ? a_m + static_cast<size_t>(k0 + kk) * d + j
                              : a_m, ok);
      }
    }
    if (pass == 0) {
      for (int e = tid; e < kBQ * kBK; e += kThreads) {
        const int r = e / kBK, k = k0 + (e - r * kBK);
        const bool ok = k < d && q0 + r < q_total;
        cp_async4(xt + k * kXS + r,
                  ok ? x + static_cast<size_t>(q0 + r) * d + k : x, ok);
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
  float vsum[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    vsum[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  }

  load(0);
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      load(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int pass = t / slabs, k0 = (t - pass * slabs) * kBK;
    const float* ab = as + (t & 1) * kBK * kBJ;
    const float* xb = xt + k0 * kXS;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float xr[8];
      load_x8(xb + kk * kXS, tq, xr);
      const float4 a0 = *reinterpret_cast<const float4*>(ab + kk * kBJ +
                                                         tj * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(ab + kk * kBJ +
                                                         64 + tj * 4);
      const float ac[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xr[r], ac[c], acc[r][c]);
    }
    if (t - pass * slabs == slabs - 1) {     // the pass's columns are done
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = pass * kBJ + half_index(tj, c);
        if (j < d) {
          float xr[8];
          load_x8(xt + j * kXS, tq, xr);
#pragma unroll
          for (int r = 0; r < 8; ++r)
            vsum[r] = fmaf(acc[r][c], xr[r], vsum[r]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r][c] = 0.0f;
      }
    }
    __syncthreads();              // the slab's buffer is free for step t + 2
  }

  float msum[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) msum[r] = 0.0f;
  for (int pass = 0; pass < passes; ++pass) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = pass * kBJ + half_index(tj, c);
      if (j < d) {
        const float tjv = th[j];
        float xr[8];
        load_x8(xt + j * kXS, tq, xr);
#pragma unroll
        for (int r = 0; r < 8; ++r) msum[r] = fmaf(tjv, xr[r], msum[r]);
      }
    }
  }
  // the 16 threads of a query group are lanes 16 (lane >> 4) + 0..15
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      vsum[r] += __shfl_xor_sync(0xffffffffu, vsum[r], off);
      msum[r] += __shfl_xor_sync(0xffffffffu, msum[r], off);
    }
  }
  // lane tj of the group writes row tj (tj < 8)
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int q = q0 + half_index(tq, r);
    if (tj == r && q < q_total)
      out[static_cast<size_t>(q) * m_total + m] =
          msum[r] + alpha * sqrtf(fmaxf(vsum[r], 0.0f));
  }
}

struct Geometry {
  int grid, threads, group_log2, q_tiles;
  size_t smem;
};

// the geometry of (q, m, d, path), or false where the kernel takes none
bool geometry(int q, int m, int d, int path, Geometry* g) {
  if (q < 0 || m < 0 || d <= 0) return false;
  if (path == 0) {
    if (d > kSmallMaxD) return false;
    int lg = 0;
    while ((1 << lg) < d) ++lg;
    const long long lanes = (static_cast<long long>(q) * m) << lg;
    const long long grid = (lanes + kSmallThreads - 1) / kSmallThreads;
    if (grid > 0x7fffffffLL) return false;
    g->grid = static_cast<int>(grid);
    g->threads = kSmallThreads;
    g->group_log2 = lg;
    g->q_tiles = 0;
    g->smem = 0;
    return true;
  }
  if (path != 1) return false;
  g->q_tiles = (q + kBQ - 1) / kBQ;
  const long long grid = static_cast<long long>(g->q_tiles) * m;
  g->smem = tiled_smem(d);
  if (grid > 0x7fffffffLL || g->smem > kSmemLimit) return false;
  g->grid = static_cast<int>(grid);
  g->threads = kThreads;
  g->group_log2 = 0;
  return true;
}

}  // namespace

// What the card says of a path at a shape: info[0] registers a thread,
// [1] local (spilled) bytes a thread, [2] static and [3] dynamic shared
// memory a block, [4] resident blocks an SM, [5] the device's SMs, [6]
// threads a block, [7] the grid, [8] lanes an output (small path) or
// queries a block (tiled).  cudaErrorInvalidValue for a geometry
// linucb_launch does not take.
extern "C" int linucb_info(int q, int m, int d, int path, int* info) {
  Geometry g{};
  if (!geometry(q, m, d, path, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  info[7] = g.grid;
  info[8] = path == 0 ? 1 << g.group_log2 : kBQ;
  if (path == 0)
    return kernel_info(linucb_small_kernel, g.threads, 0, info);
  return kernel_info(linucb_tiled_kernel, g.threads,
                     static_cast<int>(g.smem), info);
}

// a_inv fp32 (m, d, d), theta fp32 (m, d), x fp32 (q, d), out fp32 (q, m),
// all contiguous on the device; `path` 0 (small, d <= 32) or 1 (tiled),
// as kernel.py: layout chooses.  Returns the launch's cudaError_t (0 =
// launched); cudaErrorInvalidValue, without launching, for a shape the
// path does not take: d > 32 on the small path; on the tiled path X's
// tile and the slabs beyond a block's 227 KB of shared memory (d > 352);
// a grid of 2^31 blocks or more.
extern "C" int linucb_launch(const float* a_inv, const float* theta,
                             const float* x, float* out, int q, int m, int d,
                             float alpha, int path, void* stream) {
  Geometry g{};
  if (!geometry(q, m, d, path, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0 || m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    linucb_small_kernel<<<g.grid, g.threads, 0, s>>>(
        a_inv, theta, x, out, q, m, d, g.group_log2, alpha);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = cudaFuncSetAttribute(
      linucb_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  linucb_tiled_kernel<<<g.grid, g.threads, g.smem, s>>>(
      a_inv, theta, x, out, q, m, d, g.q_tiles, alpha);
  return static_cast<int>(cudaGetLastError());
}

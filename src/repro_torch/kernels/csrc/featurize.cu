// Hashed-embedding featurization for the router, written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/featurize/kernel.py
// (_featurize_kernel, launched by hashed_embed_fwd).  For each row q:
//
//     counts[h] = sum_l weights[q, l] * [ids[q, l] == h]     (-1 = pad)
//     v         = log1p(counts) @ proj                       (proj: H x D)
//     out[q]    = v / max(|v|, 1e-30) if |v| > 0 else v
//
// What bounds it on an H100: bytes, and far below them latency.  The
// projection (2048 x 384 fp32, 3 MB) is the only large operand; it stays
// in the 50 MB L2 across rows and calls.  A row hits a few hundred of the
// 2048 buckets, so the useful work is nnz x D fused multiply-adds, and at
// the router's batch sizes (1 to 128 rows) the time is the length of each
// row's dependent chain, not a rate.
//
// Design (kernels/featurize/kernel.py: layout gives the geometry):
//   * a row is a thread-block cluster of `cluster` blocks on neighbouring
//     SMs, each block taking `tiles` tiles of 128 columns (a float4 a
//     lane of a warp).  Every block of the cluster builds the row's list
//     itself (the ids are 2-8 KB), so the blocks share only the norm;
//   * scatter into shared-memory counts.  The router's weights are 1.0,
//     0.5 and 0.75 (word, trigram, bigram), and every partial sum of such
//     values is a multiple of 0.25 far below 2^22, so fp32 sums are exact
//     in any order: the atomics' order cannot change a bit of the result;
//   * compact the non-zero buckets into an ascending list of (bucket,
//     log1p(count)) in one block-wide pass: each thread counts its run of
//     buckets, a warp-shuffle prefix scan and the warps' totals give its
//     offset.  log1p(0) = 0, so no later step looks at a zero bucket;
//   * the product runs over the list only.  Warp w takes tile w % tiles
//     and, of the list, entries g, g + G, g + 2G, ... (g = w / tiles, G =
//     warps / tiles groups), kUnroll entries at a time: their rows of proj
//     are loaded (16 bytes a lane, a row's tile read coalesced) before the
//     FMAs that use them, so kUnroll L2 loads are in flight a warp;
//   * the G partial sums of a column are added in group order through
//     shared memory; each writer warp's sum of squares is written into
//     every block of the cluster (distributed shared memory), and after
//     a cluster barrier each block adds the (rank, warp) sums in order
//     from its own shared memory, so no block reads another's after the
//     barrier and none waits for another to leave (the barrier that
//     makes sure every block has started is arrived at on entry and
//     waited on only before the writes).  No float atomics in
//     the product or the norm: the output is the same bits from run to
//     run.
// No TF32 and no tensor cores: the router's decisions depend on this
// output matching the host encoder to 1e-5.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_info.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileCols = 128;     // columns of a tile: a float4 a lane
constexpr int kUnroll = 8;         // list entries a warp loads ahead
constexpr int kScatter = 4;        // ids a thread loads ahead
constexpr int kMaxCluster = 8;     // the portable cluster size

// dynamic shared memory: counts, the list's buckets and values (hash_dim
// each, rounded to 16 bytes), then a float4 partial sum per thread
__host__ __device__ inline int counts_floats(int hash_dim) {
  return (hash_dim + 3) / 4 * 4;
}
inline size_t smem_bytes(int hash_dim, int threads) {
  return static_cast<size_t>(3 * counts_floats(hash_dim)) * 4 +
         static_cast<size_t>(threads) * 16;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void featurize_kernel(const int* __restrict__ ids,
                                 const float* __restrict__ weights,
                                 const float* __restrict__ proj,
                                 float* __restrict__ out, int seq_l,
                                 int hash_dim, int dim, int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int hpad = counts_floats(hash_dim);
  float* counts = smem;
  int* list_h = reinterpret_cast<int*>(smem + hpad);
  float* list_t = smem + 2 * hpad;
  float4* part = reinterpret_cast<float4*>(smem + 3 * hpad);
  __shared__ int warp_n[32];
  // the sums of squares of every (rank, writer warp) of the cluster, each
  // written here by its own block
  __shared__ float cluster_ss[kMaxCluster * 32];

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / n_ranks;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = nthreads >> 5;
  const int* row_ids = ids + static_cast<size_t>(row) * seq_l;
  const float* row_w = weights + static_cast<size_t>(row) * seq_l;
  // the cluster's blocks must all have started before one writes another's
  // shared memory: arrive now, wait just before the writes
  cluster_arrive_relaxed();

  // kScatter ids and weights a thread loads together (the first of them
  // while the counts are zeroed), then adds; an id outside [0, hash_dim)
  // matches no bucket, as in the Pallas kernel's one-hot: padding (-1)
  // and anything past the last bucket
  int id[kScatter];
  float wt[kScatter];
  auto fetch = [&](int l0) {
#pragma unroll
    for (int u = 0; u < kScatter; ++u) {
      const int l = l0 + u * nthreads;
      id[u] = l < seq_l ? __ldg(row_ids + l) : -1;
      wt[u] = l < seq_l ? __ldg(row_w + l) : 0.0f;
    }
  };
  fetch(tid);
  for (int h = tid; h < hash_dim; h += nthreads) counts[h] = 0.0f;
  __syncthreads();
  for (int l0 = tid; l0 < seq_l; l0 += kScatter * nthreads) {
    if (l0 != tid) fetch(l0);
#pragma unroll
    for (int u = 0; u < kScatter; ++u)
      if (id[u] >= 0 && id[u] < hash_dim) atomicAdd(&counts[id[u]], wt[u]);
  }
  __syncthreads();

  // compaction: thread t owns buckets [t * per, (t + 1) * per); its offset
  // is the warp's inclusive scan of the runs' lengths plus the earlier
  // warps' totals (one reduction each)
  const int per = (hash_dim + nthreads - 1) / nthreads;
  const int h0 = min(tid * per, hash_dim), h1 = min(h0 + per, hash_dim);
  int mine = 0;
  for (int h = h0; h < h1; ++h) mine += counts[h] != 0.0f;
  int incl = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_n[warp] = incl;
  __syncthreads();
  const unsigned wn = lane < warps ? warp_n[lane] : 0u;
  const int n = static_cast<int>(__reduce_add_sync(0xffffffffu, wn));
  int pos = static_cast<int>(__reduce_add_sync(0xffffffffu,
                                               lane < warp ? wn : 0u)) +
            incl - mine;
  for (int h = h0; h < h1; ++h) {
    const float c = counts[h];
    if (c != 0.0f) {
      list_h[pos] = h;
      list_t[pos] = log1pf(c);
      ++pos;
    }
  }
  __syncthreads();

  // the product over the list: warp -> (tile, group)
  const int tile = warp % tiles, group = warp / tiles;
  const int groups = warps / tiles;
  const int col = (rank * tiles + tile) * kTileCols + lane * 4;
  const bool live = col < dim;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) {
    for (int e0 = group; e0 < n; e0 += groups * kUnroll) {
      float4 p[kUnroll];
      float t[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * groups;
        t[u] = 0.0f;
        p[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (e < n) {
          t[u] = list_t[e];
          p[u] = __ldg(reinterpret_cast<const float4*>(
              proj + static_cast<size_t>(list_h[e]) * dim + col));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (e0 + u * groups < n) {
          acc.x = fmaf(t[u], p[u].x, acc.x);
          acc.y = fmaf(t[u], p[u].y, acc.y);
          acc.z = fmaf(t[u], p[u].z, acc.z);
          acc.w = fmaf(t[u], p[u].w, acc.w);
        }
      }
    }
  }
  part[tid] = acc;
  __syncthreads();

  // combine the groups in order: the writers are warps 0 .. tiles - 1,
  // thread (tile, lane); each writer warp's sum of squares goes to every
  // block of the cluster, and after the barrier every block adds the
  // (rank, warp) sums in order from its own shared memory
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float ss = 0.0f;
  const int my_col = (rank * tiles + warp) * kTileCols + lane * 4;
  const bool writer = warp < tiles && my_col < dim;
  if (writer) {
    for (int g = 0; g < groups; ++g) {
      const float4 p = part[(g * tiles + warp) * 32 + lane];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    ss = fmaf(v.x, v.x, ss);
    ss = fmaf(v.y, v.y, ss);
    ss = fmaf(v.z, v.z, ss);
    ss = fmaf(v.w, v.w, ss);
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_down_sync(0xffffffffu, ss, off);
  ss = __shfl_sync(0xffffffffu, ss, 0);         // the warp's sum, lane 0's
  cluster_wait();                   // every block of the cluster has started
  if (warp < tiles && lane < n_ranks)           // lane r writes to rank r
    *cluster.map_shared_rank(&cluster_ss[rank * tiles + warp], lane) = ss;
  cluster.sync();                   // every (rank, warp) sum has arrived
  if (writer) {
    float total = 0.0f;
    for (int i = 0; i < n_ranks * tiles; ++i) total += cluster_ss[i];
    const float norm = sqrtf(total);
    if (norm > 0.0f) {
      const float inv = fmaxf(norm, 1e-30f);
      v.x /= inv;
      v.y /= inv;
      v.z /= inv;
      v.w /= inv;
    }
    *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * dim +
                               my_col) = v;
  }
}

// the geometry featurize_launch runs for (q, hash_dim, dim, threads,
// cluster), or false where it takes none: tiles of 128 columns a block
bool geometry(int q, int hash_dim, int dim, int threads, int cluster,
              int* tiles, size_t* smem) {
  if (q < 0 || hash_dim <= 0 || dim <= 0 || dim % 4 != 0 || cluster < 1 ||
      cluster > kMaxCluster || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return false;
  const int col_tiles = (dim + kTileCols - 1) / kTileCols;
  *tiles = (col_tiles + cluster - 1) / cluster;
  *smem = smem_bytes(hash_dim, threads);
  return (threads / 32) % *tiles == 0 && *smem <= 232448 &&
         static_cast<long long>(q) * cluster <= 0x7fffffffLL;
}

}  // namespace

// What the card says of the kernel at a geometry: info[0] registers a
// thread, [1] local (spilled) bytes a thread, [2] static and [3] dynamic
// shared memory a block, [4] resident blocks an SM, [5] the device's SMs,
// [6] threads a block, [7] the grid for q rows, [8] the cluster size.
// Returns the cudaError_t of the queries; cudaErrorInvalidValue for a
// geometry featurize_launch does not take.
extern "C" int featurize_info(int q, int hash_dim, int dim, int threads,
                              int cluster, int* info) {
  int tiles = 0;
  size_t smem = 0;
  if (!geometry(q, hash_dim, dim, threads, cluster, &tiles, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  info[7] = q * cluster;
  info[8] = cluster;
  return kernel_info(featurize_kernel, threads, static_cast<int>(smem),
                     info);
}

// ids int32 (q, seq_l), weights fp32 (q, seq_l), proj fp32 (hash_dim, dim),
// out fp32 (q, dim), all contiguous on the device; `threads` a block and
// `cluster` blocks a row (kernel.py: layout).  Returns the launch's
// cudaError_t (0 = launched); cudaErrorInvalidValue, without launching,
// for a shape the kernel does not take: dim not a multiple of 4, more
// columns than 8 blocks of `threads / 32` tiles cover, counts and list
// beyond a block's 227 KB of shared memory, a grid of 2^31 blocks, proj
// or out not 16-byte aligned (rows are read and written as float4).
extern "C" int featurize_launch(const int* ids, const float* weights,
                                const float* proj, float* out, int q,
                                int seq_l, int hash_dim, int dim, int threads,
                                int cluster, void* stream) {
  int tiles = 0;
  size_t smem = 0;
  if (!geometry(q, hash_dim, dim, threads, cluster, &tiles, &smem) ||
      seq_l < 0 || reinterpret_cast<uintptr_t>(proj) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        featurize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(q * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, featurize_kernel, ids,
                                             weights, proj, out, seq_l,
                                             hash_dim, dim, tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

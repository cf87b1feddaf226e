// Flash-attention prefill (GQA, causal or not, sliding window), written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (_fa_kernel, launched by flash_attention_fwd).  For q (B, Sq, Hq, hd),
// k/v (B, Sk, Hk, hd), fp32 or bf16, and a window w:
//
//     out[b, i, h] = softmax_j(q_i . k_j / sqrt(hd)) v_j  over the visible j:
//                    j > i - w, and j <= i when causal (positions from 0),
//
// with kv head = h / (Hq / Hk).  Online softmax in fp32 (running max m,
// sum l, accumulator acc), masked scores NEG_INF = -2.3819763e38, p of a
// masked pair 0, out = acc / max(l, 1e-30): a row with nothing visible
// comes out 0, never NaN.  q is scaled before the dot, as the Pallas kernel
// does (the jnp flash_prefill scales after).
//
// What bounds it on an H100: operations.  A prefill at S = 2048 does
// 4 x hd flops per visible (q, k) pair and head, ~70 GFLOP per granite
// layer, against ~130 MB of q/k/v/o; the tensor cores would take that in
// 0.07 ms, HBM in 0.04 ms.  This first version uses scalar fp32 FMA (67
// TFLOP/s peak outside the tensor cores), so it sits well above that
// bound; a wgmma redesign (hd padded to a multiple of 16) is later work.
//
// Design (simple and right first):
//   * one 256-thread block per (q tile of BQ rows, q head, batch row);
//   * the block loops only over the kv tiles of 64 that the causal and
//     window mask leave visible to some row of its q tile — the Pallas
//     kernel's pl.when skip turned into loop bounds;
//   * q (pre-scaled), k and v tiles are upcast to fp32 in shared memory
//     (opted in above the default 48 KB); rows are padded by one float so
//     the per-column reads hit distinct banks;
//   * thread (ty, tx) of a 16 x 16 grid owns rows ty + 16i (i < BQ / 16):
//     scores of columns tx + 16j (j < 4) and output columns tx + 16j (j <
//     HD / 16, < hd).  A row's 16 threads sit in one half-warp, so its max
//     and sum are shuffle butterflies; each thread keeps m and l of its
//     rows;
//   * two tile configurations, one kernel template: hd <= 128 (e.g. 120
//     for h2o-danube-3-4b) takes q tiles of 64 rows and 113 KB of shared
//     memory, two blocks per SM; hd <= 256 (gemma3-12b's 256) would need
//     214 KB and twice the accumulators at 64 rows, so it takes q tiles of
//     32 rows: 172.5 KB, one block per SM, 2 x 16 accumulators a thread;
//   * ragged Sq and Sk are masked in the kernel (no divisor-picking).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBK = 64;                 // kv rows per tile
constexpr int kThreads = 256;
constexpr int kPStride = kBK + 1;       // padded rows of the p tile
constexpr int kHdLimit = 256;           // the widest configuration's hd
constexpr float kNegInf = -2.3819763e38f;

// A tile configuration: q rows per block and the largest hd it holds.
template <int BQ, int HD>
struct Tile {
  static constexpr int kBQ = BQ;
  static constexpr int kHdMax = HD;
  static constexpr int kRows = BQ / 16;     // q rows a thread owns
  static constexpr int kCols = HD / 16;     // output columns a thread owns
  static constexpr int kQKStride = HD + 1;  // padded rows of the q, k tiles
  static constexpr size_t kSmemBytes =
      (static_cast<size_t>(BQ) * kQKStride + kBK * kQKStride + kBK * HD +
       BQ * kPStride) * sizeof(float);
};
using NarrowTile = Tile<64, 128>;           // hd <= 128: 113 KB
using WideTile = Tile<32, kHdLimit>;        // hd <= 256: 172.5 KB

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int qp, int kp, int sq, int sk,
                                        int window, int causal) {
  return qp < sq && kp < sk && kp > qp - window && (!causal || kp <= qp);
}

// max / sum over the 16 lanes of a half-warp (a row's threads)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int sk, int hq, int hk, int hd, int window, int causal,
                       float scale) {
  constexpr int kBQ = C::kBQ;
  constexpr int kHdMax = C::kHdMax;
  constexpr int kRows = C::kRows;
  constexpr int kCols = C::kCols;
  constexpr int kQKStride = C::kQKStride;
  extern __shared__ float smem[];
  float* qs = smem;                       // kBQ x kQKStride
  float* ks = qs + kBQ * kQKStride;       // kBK x kQKStride
  float* vs = ks + kBK * kQKStride;       // kBK x kHdMax
  float* ps = vs + kBK * kHdMax;          // kBQ x kPStride

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int qp = q0 + r;
    float x = 0.0f;
    if (qp < sq)
      x = to_f32(q[((static_cast<size_t>(b) * sq + qp) * hq + h) * hd + d]) *
          scale;
    qs[r * kQKStride + d] = x;
  }

  // kv tiles visible to some row of [q0, q_last]: k > q0 - window, and
  // k <= q_last when causal
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_lo = (max(0, q0 - window + 1) / kBK) * kBK;
  const int k_hi = causal ? min(sk, q_last + 1) : sk;      // exclusive

  float m[kRows], l[kRows], o[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[i][j] = 0.0f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();                      // the previous tile is consumed
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const int kp = k0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (kp < sk) {
        const size_t off =
            ((static_cast<size_t>(b) * sk + kp) * hk + kvh) * hd + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[r * kQKStride + d] = kx;
      vs[r * kHdMax + d] = vx;
    }
    __syncthreads();

    float s[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], kv[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = qs[(ty + 16 * i) * kQKStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kQKStride + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(qp, k0 + tx + 16 * j, sq, sk, window, causal))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(qp, k0 + c, sq, sk, window, causal)
                            ? expf(s[i][j] - m_new)
                            : 0.0f;
        ps[r * kPStride + c] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) o[i][j] *= corr;
    }
    __syncthreads();                      // the p tile is complete

    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = ps[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vx = vs[c * kHdMax + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) o[i][j] = fmaf(pv[i], vx, o[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = out + ((static_cast<size_t>(b) * sq + qp) * hq + h) * hd;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(row + d, o[i][j] / denom);
    }
  }
}

template <typename T, typename C>
int launch_tile(const void* q, const void* k, const void* v, void* out,
                int b, int sq, int sk, int hq, int hk, int hd, int window,
                int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + C::kBQ - 1) / C::kBQ, hq, b);
  flash_attention_kernel<T, C><<<grid, kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, hq, hk, hd,
      window, causal,
      static_cast<float>(1.0 / sqrt(static_cast<double>(hd))));  // hd ** -0.5
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int hq, int hk, int hd, int window, int causal,
           cudaStream_t stream) {
  return hd <= NarrowTile::kHdMax
             ? launch_tile<T, NarrowTile>(q, k, v, out, b, sq, sk, hq, hk,
                                          hd, window, causal, stream)
             : launch_tile<T, WideTile>(q, k, v, out, b, sq, sk, hq, hk, hd,
                                        window, causal, stream);
}

}  // namespace

// q (b, sq, hq, hd), k/v (b, sk, hk, hd), out (b, sq, hq, hd), all
// contiguous on the device in one dtype: dtype 0 = fp32, 1 = bf16.
// window counts the visible past positions including self; causal is 0 or
// 1.  Returns the launch's cudaError_t (0 = launched);
// cudaErrorInvalidValue, without launching, for what the kernel does not
// take: hd outside [1, 256], hk < 1 or hq not a multiple of hk, more than
// 65535 heads or batch rows (grid y and z), or another dtype.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int sq,
                                      int sk, int hq, int hk, int hd,
                                      int window, int causal, int dtype,
                                      void* stream) {
  if (hd < 1 || hd > kHdLimit || hk < 1 || hq < hk || hq % hk ||
      hq > 65535 || b > 65535 || sq < 0 || sk < 0 || b < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || sq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<float>(q, k, v, out, b, sq, sk, hq, hk, hd, window,
                             causal, s)
             : launch<__nv_bfloat16>(q, k, v, out, b, sq, sk, hq, hk, hd,
                                     window, causal, s);
}

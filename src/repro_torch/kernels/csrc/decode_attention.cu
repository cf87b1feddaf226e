// Decode attention (one query token per row against a KV cache, GQA,
// sliding window), written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention/kernel.py
// (_fd_kernel, launched by flash_decode_fwd).  For q (B, 1, Hq, hd), caches
// k/v (B, S, Hk, hd), fp32 or bf16, and two int32 scalars on the device,
// cache_len and window:
//
//     out[b, h] = softmax_j(q_h . k_j / sqrt(hd)) v_j
//                 over the visible j: cache_len - window <= j < cache_len,
//
// with kv head = h / G, G = Hq / Hk.  fp32 throughout: q is upcast and
// scaled before the dot (as the Pallas kernel does; the jnp decode_attend
// scales the scores), k and v are upcast as they are read, the output is
// rounded to q's dtype once.  A row with nothing visible comes out 0
// (out = acc / max(l, 1e-30)), never NaN.
//
// What bounds it on an H100: bytes.  Each cache position is read once for
// all G heads of its kv head: 4 hd bytes of k and v in bf16 against 4 G hd
// flops, one flop per byte at G = 2 (gemma3-12b) — far below the ~295
// flops per byte where the tensor cores would start to matter.  So the
// design is about keeping enough loads in flight, on scalar fp32 FMA:
//
//   * cache_len and window are read in the kernel through pointers (the
//     Pallas kernel reads them from SMEM), so a decode step never waits on
//     the host; the visible range [max(cache_len - window, 0),
//     min(cache_len, S)) becomes the loop bounds — positions outside it are
//     never read, the Pallas kernel's pl.when block skip at the finest
//     grain, and any S is taken with no divisor-picking;
//   * at gemma3's B = 4, Hk = 8 one block per (row, kv head) would fill 32
//     of 132 SMs, so the cache is split: grid (split, kv head, row), the
//     split length chosen by the wrapper from the shapes alone (a few
//     blocks per SM); each split writes its unnormalised (acc, m, l) to a
//     fp32 scratch and a second kernel merges the splits with a
//     log-sum-exp combine;
//   * a block is 4 warps; each half-warp takes cache positions in turn,
//     its 16 lanes reading the k and v rows in 16-byte vectors (hd *
//     sizeof(T) must be a multiple of 16: 256, 128, 120 and 112 all are),
//     the rows of several positions loaded before the first is used, so
//     that 256 bytes a lane are in flight; q of the G heads sits in
//     registers; the dot is reduced with four shuffles and each half-warp
//     keeps its own online softmax (m, l, acc) in registers, merged with
//     its partner by one shuffle and across the 4 warps in shared memory
//     (at most 32 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLanesPerKey = 16;
constexpr int kKeysPerPass = kThreads / kLanesPerKey;  // one per half-warp
constexpr int kHdMax = 256;
constexpr int kGroupMax = 8;
constexpr int kCombineThreads = 256;
constexpr float kNegInf = -2.3819763e38f;
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of T: loaded as they lie (raw), upcast to fp32 when used
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* x) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One block per (split, kv head, row).  G bounds the query heads per kv
// head (group <= G), NV the 16-byte vectors each of a half-warp's lanes
// holds of a row (hd / (16 bytes) <= 16 NV).  A half-warp loads the k and
// v rows of 8 / NV positions before it computes on the first, so each
// lane keeps 8 k and 8 v vectors (256 bytes) in flight whatever hd is.
// Writes, per head g of the group, acc[g][0:hd] (unnormalised), m[g] and
// l[g] of this split's positions to part.
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part,
                    const int* __restrict__ cache_len_p,
                    const int* __restrict__ window_p, int s, int hq, int hk,
                    int hd, int split_len, int n_split, float scale) {
  constexpr int kN = Vec16<T>::kN;
  constexpr int kE = NV * kN;                   // elements a lane holds
  constexpr int kU = 8 / NV;                    // positions in flight
  constexpr int kPass = kKeysPerPass * kU;      // positions a block pass
  __shared__ float sm_acc[kWarps * G * kHdMax];
  __shared__ float sm_m[kWarps * G];
  __shared__ float sm_l[kWarps * G];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int sub = lane & (kLanesPerKey - 1);    // lane within the half-warp
  const int half = tid / kLanesPerKey;          // half-warp of the block
  const int nvec = hd / kN;

  // the visible range, cut to this split (64-bit: window may be large)
  const long long cache_len = *cache_len_p;
  const long long window = *window_p;
  const long long lo = max(max(cache_len - window, 0LL),
                           static_cast<long long>(split) * split_len);
  const long long hi = min(min(cache_len, static_cast<long long>(s)),
                           static_cast<long long>(split + 1) * split_len);

  float qr[G][kE];
  const T* q_row = q + (static_cast<size_t>(b) * hq + h * group) * hd;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = sub + kLanesPerKey * i;
      if (g < group && vi < nvec) {
        Vec16<T>::unpack(load16(q_row + g * hd + vi * kN), &qr[g][i * kN]);
#pragma unroll
        for (int j = 0; j < kN; ++j) qr[g][i * kN + j] *= scale;
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) qr[g][i * kN + j] = 0.0f;
      }
    }

  float m[G], l[G], acc[G][kE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.0f;
  }

  // every warp runs the same passes, so both halves of a warp always
  // reach the shuffles together; a position past the end updates nothing
  for (long long base = lo; base < hi; base += kPass) {
    uint4 kr[kU][NV], vr[kU][NV];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long key = base + half + kKeysPerPass * u;
      const size_t off = ((static_cast<size_t>(b) * s + key) * hk + h) *
                         static_cast<size_t>(hd);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = sub + kLanesPerKey * i;
        if (key < hi && vi < nvec) {
          kr[u][i] = load16(k + off + vi * kN);
          vr[u][i] = load16(v + off + vi * kN);
        } else {
          kr[u][i] = vr[u][i] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kx[kE], vx[kE];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        Vec16<T>::unpack(kr[u][i], &kx[i * kN]);
        Vec16<T>::unpack(vr[u][i], &vx[i * kN]);
      }
      float sc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < kE; ++e) d = fmaf(qr[g][e], kx[e], d);
        sc[g] = d;
      }
#pragma unroll
      for (int off_l = kLanesPerKey / 2; off_l > 0; off_l >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          sc[g] += __shfl_xor_sync(kFull, sc[g], off_l);
      if (base + half + kKeysPerPass * u < hi) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < group) {
            const float m_new = fmaxf(m[g], sc[g]);
            const float corr = expf(m[g] - m_new);
            const float p = expf(sc[g] - m_new);
            l[g] = l[g] * corr + p;
#pragma unroll
            for (int e = 0; e < kE; ++e)
              acc[g][e] = fmaf(p, vx[e], acc[g][e] * corr);
            m[g] = m_new;
          }
        }
      }
    }
  }

  // merge the two half-warps of each warp (lanes i and i + 16 hold the
  // same elements of different positions)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float m_o = __shfl_xor_sync(kFull, m[g], kLanesPerKey);
    const float l_o = __shfl_xor_sync(kFull, l[g], kLanesPerKey);
    const float m_t = fmaxf(m[g], m_o);
    const float c_s = expf(m[g] - m_t), c_o = expf(m_o - m_t);
    l[g] = l[g] * c_s + l_o * c_o;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float a_o = __shfl_xor_sync(kFull, acc[g][e], kLanesPerKey);
      acc[g][e] = acc[g][e] * c_s + a_o * c_o;
    }
    m[g] = m_t;
  }
  if (lane < kLanesPerKey) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = sub + kLanesPerKey * i;
        if (g < group && vi < nvec) {
#pragma unroll
          for (int j = 0; j < kN; ++j)
            sm_acc[(warp * G + g) * kHdMax + vi * kN + j] = acc[g][i * kN + j];
        }
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
  }
  __syncthreads();

  // merge the warps: this split's (acc, m, l) per head of the group
  float* dst = part + ((static_cast<size_t>(b) * hk + h) * n_split + split) *
                          group * static_cast<size_t>(hd + 2);
  for (int idx = tid; idx < group * hd; idx += kThreads) {
    const int g = idx / hd, d = idx - g * hd;
    float m_t = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_t = fmaxf(m_t, sm_m[w * G + g]);
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a += sm_acc[(w * G + g) * kHdMax + d] * expf(sm_m[w * G + g] - m_t);
    dst[idx] = a;
  }
  if (tid < group) {
    float m_t = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_t = fmaxf(m_t, sm_m[w * G + tid]);
    float l_t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      l_t += sm_l[w * G + tid] * expf(sm_m[w * G + tid] - m_t);
    dst[group * hd + tid] = m_t;
    dst[group * hd + group + tid] = l_t;
  }
}

// One block per (kv head, row): the splits' partials merged, divided by
// the total sum, written in T.  Splits with nothing visible (m = NEG_INF,
// l = 0, acc = 0) weigh 0 beside any that saw a position; when none did,
// out = 0 / 1e-30 = 0.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                      int hq, int hk, int hd, int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int group = hq / hk;
  const size_t stride = static_cast<size_t>(group) * (hd + 2);
  const float* base =
      part + (static_cast<size_t>(b) * hk + h) * n_split * stride;
  for (int idx = threadIdx.x; idx < group * hd; idx += kCombineThreads) {
    const int g = idx / hd, d = idx - g * hd;
    float m_t = kNegInf;
    for (int sp = 0; sp < n_split; ++sp)
      m_t = fmaxf(m_t, base[sp * stride + group * hd + g]);
    float a = 0.0f, l_t = 0.0f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float* p = base + sp * stride;
      const float w = expf(p[group * hd + g] - m_t);
      a += p[idx] * w;
      l_t += p[group * hd + group + g] * w;
    }
    store(out + (static_cast<size_t>(b) * hq + h * group + g) * hd + d,
          a / fmaxf(l_t, 1e-30f));
  }
}

template <typename T, int G, int NV>
int launch_split(const void* q, const void* k, const void* v, float* part,
                 const int* cache_len, const int* window, int b, int s,
                 int hq, int hk, int hd, int split_len, int n_split,
                 float scale, cudaStream_t stream) {
  const dim3 grid(n_split, hk, b);
  decode_split_kernel<T, G, NV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part, cache_len, window, s, hq, hk, hd,
      split_len, n_split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_split_nv(int nv, const void* q, const void* k, const void* v,
                    float* part, const int* cache_len, const int* window,
                    int b, int s, int hq, int hk, int hd, int split_len,
                    int n_split, float scale, cudaStream_t stream) {
  if (nv <= 1)
    return launch_split<T, G, 1>(q, k, v, part, cache_len, window, b, s, hq,
                                 hk, hd, split_len, n_split, scale, stream);
  if (nv <= 2)
    return launch_split<T, G, 2>(q, k, v, part, cache_len, window, b, s, hq,
                                 hk, hd, split_len, n_split, scale, stream);
  return launch_split<T, G, 4>(q, k, v, part, cache_len, window, b, s, hq,
                               hk, hd, split_len, n_split, scale, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part, const int* cache_len, const int* window, int b, int s,
           int hq, int hk, int hd, int split_len, int n_split,
           cudaStream_t stream) {
  const int group = hq / hk;
  const int nvec = hd / Vec16<T>::kN;
  const int nv = (nvec + kLanesPerKey - 1) / kLanesPerKey;
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));  // hd ** -0.5
  int err = 0;
  if (n_split > 0) {
    if (group <= 1)
      err = launch_split_nv<T, 1>(nv, q, k, v, part, cache_len, window, b, s,
                                  hq, hk, hd, split_len, n_split, scale,
                                  stream);
    else if (group <= 2)
      err = launch_split_nv<T, 2>(nv, q, k, v, part, cache_len, window, b, s,
                                  hq, hk, hd, split_len, n_split, scale,
                                  stream);
    else if (group <= 4)
      err = launch_split_nv<T, 4>(nv, q, k, v, part, cache_len, window, b, s,
                                  hq, hk, hd, split_len, n_split, scale,
                                  stream);
    else
      err = launch_split_nv<T, kGroupMax>(nv, q, k, v, part, cache_len,
                                          window, b, s, hq, hk, hd, split_len,
                                          n_split, scale, stream);
    if (err) return err;
  }
  decode_combine_kernel<T><<<dim3(hk, b), kCombineThreads, 0, stream>>>(
      part, static_cast<T*>(out), hq, hk, hd, n_split);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// q (b, 1, hq, hd), k/v (b, s, hk, hd), out (b, 1, hq, hd), contiguous on
// the device in one dtype (0 = fp32, 1 = bf16); part: fp32 scratch of
// b * hk * n_split * (hq / hk) * (hd + 2) floats; cache_len and window:
// one int32 each on the device.  Positions [split * split_len, (split + 1)
// * split_len) form split `split`, n_split = ceil(s / split_len).
// Returns the launches' cudaError_t (0 = launched); cudaErrorInvalidValue,
// without launching, for what the kernel does not take: hd outside [1,
// 256] or hd * sizeof(dtype) not a multiple of 16, hk < 1 or hq not a
// multiple of hk, more than 8 query heads per kv head, more than 65535 kv
// heads or rows, a split layout that does not cover s, q/k/v not 16-byte
// aligned, or another dtype.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* out, void* part,
                                       const void* cache_len,
                                       const void* window, int b, int s,
                                       int hq, int hk, int hd, int split_len,
                                       int n_split, int dtype, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || hd < 1 || hd > kHdMax ||
      (hd * elem) % 16 || hk < 1 || hq < hk || hq % hk ||
      hq / hk > kGroupMax || hk > 65535 || b < 0 || b > 65535 || s < 0 ||
      split_len < 1 || n_split != (s + split_len - 1) / split_len ||
      !aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cl = static_cast<const int*>(cache_len);
  const int* w = static_cast<const int*>(window);
  float* p = static_cast<float*>(part);
  return dtype == 0
             ? launch<float>(q, k, v, out, p, cl, w, b, s, hq, hk, hd,
                             split_len, n_split, st)
             : launch<__nv_bfloat16>(q, k, v, out, p, cl, w, b, s, hq, hk,
                                     hd, split_len, n_split, st);
}

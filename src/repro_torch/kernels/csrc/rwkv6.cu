// RWKV6 WKV scan for the one-shot prefill, written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6/kernel.py
// (_wkv_kernel, launched by wkv_fwd).  For each (batch b, head h), over
// the tokens t in order, with a K x K fp32 state S (K = 64):
//
//     y_t[v] = sum_k r_t[k] * (S[k, v] + u[k] * k_t[k] * v_t[v])
//     S[k, v] <- S[k, v] * w_t[k] + k_t[k] * v_t[v],   w_t = exp(logw_t)
//
// starting from s0 (zeros when null); the final S is written to s_fin.
//
// What bounds it on an H100: bytes.  The chunked form below does about
// 2 L K + 4 K^2 operations per token and head on the bf16 tensor cores
// (L = 64: the attention within the chunk and its product with v, r S and
// the state update; more with the operands' bf16 parts): ~3.2 GFLOP at
// the rwkv6-1.6b prefill (B=2 S=2048 H=32), ~0.003 ms at 989 TFLOP/s,
// against ~103 MB of r, k, v, logw, y and the states, ~0.031 ms at 3.35
// TB/s.  (The per-token form it replaces, 5 K^2 fp32 operations per token
// and head on the CUDA cores, was bound by those operations: ~0.04 ms.)
// The recurrence is sequential across chunks, so a block walks its head's
// chunks in order and the card is filled across (b, h, half of the value
// columns): 128 blocks at that shape.  What holds it back on the card is
// the latency of each chunk's five barrier-separated phases at eight
// warps an SM (tools/scan_phase_clocks.py; PERF.md).
//
// Design: the Pallas kernel's chunk factorization (an inter-chunk read of
// the state, an intra-chunk lower-triangular attention, a rank-L state
// update) with its products on the tensor cores, made safe for this
// card's inputs:
//   * chunks of L = 64 tokens, any S: the last chunk's missing tokens are
//     copied in as zeros (logw = 0 gives w = 1, r = k = v = 0 no
//     contribution), so no divisor of S is needed;
//   * per chunk, with D(t, s)[k] = prod_{s < m < t} w_m[k]:
//       y_t = (r_t * D(t, -1)) S + sum_{s < t} (sum_k r_t k_s D(t, s)) v_s
//             + (sum_k r_t u k_t) v_t
//       S  <- D(L, -1) S + sum_s (k_s * D(L, s)) (x) v_s;
//   * no exponent is ever positive, and no decay is a difference of two
//     cumulative sums: the Pallas kernel's k exp(-cum) overflows once a
//     channel's decay is large, and a difference of large cumulative sums
//     loses the small decays after a large one (logw = -1e30 mid-chunk).
//     Here every decay is a product of w = exp(logw) <= 1.  The chunk is
//     cut into 8-token blocks: per (block, channel) the exclusive prefix
//     a_t and suffix z_s products and the total T; across blocks D(t, s)
//     = a_t (prod of the totals strictly between) z_s, a product of
//     factors <= 1, so the attention between blocks is a tensor-core
//     product of r a (times the totals) and k z; within a block (and the
//     bonus u on the diagonal) it is summed per channel in fp32, and the
//     mask is applied before anything is used.  The products of block
//     totals the phases need (before a block, after it, between a block
//     and a tile's start) are tabled once a chunk;
//   * the state keeps fp32 accuracy: v goes into the products as the
//     bf16 it is; r a, k z, the attention and the state read in r S are
//     fp32 and go in as hi + lo bf16 parts (scan_mma.cuh).  With fp32
//     inputs every operand goes in as three bf16 parts, which carry
//     fp32's 24 bits: two parts leave ~2^-17 of each term, and where y is
//     a small sum of terms of ~40 (slow decays let S grow) that is past
//     the 2e-4 limit.  S is carried in fp32 registers from chunk to chunk
//     and kept in shared memory for r S (split once into hi and lo planes
//     for bf16 inputs, read by ldmatrix);
//   * one block of 8 warps per (b, h, 32 value columns): the attention
//     (shared by the columns) is built by all warps into shared memory
//     (warp w sums the in-block part of block w; the 16 tensor-core
//     blocks between 8-token blocks go two a warp, two of one tile
//     sharing their A operand), then warp (j, c) computes y for the
//     tokens of tile j (16 rows) and columns 16 c .., and rows 16 j .. of
//     S for those columns.  The schedulers take warps w and w + 4, so
//     tiles are paired 0 with 3 and 1 with 2 on each;
//   * the next chunk's r, k, v and logw are in flight by cp.async into
//     the other stage of a two-stage ring while the current one computes;
//   * shared-memory rows are padded so the fragment reads fall in
//     distinct banks.
// Tried on the card and dropped (PERF.md): 16 warps a block (one
// tensor-core block a warp; more work built twice, 14% slower), and r
// D(t, -1) split once into shared memory with y balanced across warps
// (13% slower).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "scan_mma.cuh"

namespace {

constexpr int kK = 64;          // head size (RWKV_HEAD_DIM)
constexpr int kL = 64;          // tokens per chunk
constexpr int kBlk = 8;         // tokens per decay block; 8 a chunk
constexpr int kCols = 32;       // value columns per block
constexpr int kThreads = 256;   // 8 warps

template <typename T>
struct Cfg {
  static constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kNI = In<T>::kN;     // parts of r, k, v
  static constexpr int kNC = kExact ? 2 : 3;  // of fp32 operands
  static constexpr int kTS = static_cast<int>(sizeof(T));
  // row strides (elements)
  static constexpr int kKS = kK + 8;        // staged r and k, T
  static constexpr int kVS = kCols + 8;     // staged v, T
  static constexpr int kFS = kK + 8;        // r a, k z and att, fp32
  static constexpr int kSS = kK + 8;        // state buffers [v][k]
  // a stage: r, k (kL x kKS), v (kL x kVS) in T, logw (kL x kK) fp32,
  // which becomes w = exp(logw) in place
  static constexpr int kStageK = kL * kKS * kTS;
  static constexpr int kStageV = kStageK + kL * kKS * kTS;
  static constexpr int kStageW = kStageV + kL * kVS * kTS;
  static constexpr int kStage = kStageW + kL * kK * 4;
  // after the two stages: r a, k z; att, 4 bytes an element (Store<T>);
  // the block totals T [8][kK] and
  // the products of them the products use (P: before a block, 9 rows; Q:
  // after a block, 8; TB: strictly between block i and tile start 2 jj,
  // 12 rows); u; two buffers of the state, 4 bytes an element of
  // [kCols][kSS] (Store<T> in scan_mma.cuh)
  static constexpr int kRD = 2 * kStage;
  static constexpr int kKD = kRD + kL * kFS * 4;
  static constexpr int kAtt = kKD + kL * kFS * 4;
  static constexpr int kT = kAtt + kL * kFS * 4;
  static constexpr int kP = kT + 8 * kK * 4;
  static constexpr int kQ = kP + 9 * kK * 4;
  static constexpr int kTB = kQ + 8 * kK * 4;
  static constexpr int kU = kTB + 12 * kK * 4;
  static constexpr int kS = kU + kK * 4;
  static constexpr int kBuf = kCols * kSS * 4;
  static constexpr int kBytes = kS + 2 * kBuf;
};

__device__ __forceinline__ void load16(const float* p, float (&o)[16]) {
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    o[i] = v.x;
    o[i + 1] = v.y;
    o[i + 2] = v.z;
    o[i + 3] = v.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&o)[16]) {
#pragma unroll
  for (int i = 0; i < 16; i += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      o[i + 2 * m] = __uint_as_float(w[m] << 16);
      o[i + 2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ y, float* __restrict__ s_fin, int s_len, int h) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  // token tile j (rows 16 j ..) and column part c (columns 16 c .. of the
  // block): the SM's four schedulers take warps w and w + 4, so tiles are
  // paired 0 with 3 and 1 with 2 on each (the tiles' y work grows with j)
  const int c = warp >> 2, j = c == 0 ? warp : 7 - warp;
  constexpr int kParts = kK / kCols;
  const int bh = blockIdx.x / kParts;      // b * h + head
  const int b = bh / h, head = bh % h;
  const int v0 = (blockIdx.x % kParts) * kCols;

  float* sRD = reinterpret_cast<float*>(smem + C::kRD);
  float* sKD = reinterpret_cast<float*>(smem + C::kKD);
  char* sAtt = smem + C::kAtt;             // att, 4 bytes an element
  float* sT = reinterpret_cast<float*>(smem + C::kT);
  float* sP = reinterpret_cast<float*>(smem + C::kP);
  float* sQ = reinterpret_cast<float*>(smem + C::kQ);
  float* sTB = reinterpret_cast<float*>(smem + C::kTB);
  float* sU = reinterpret_cast<float*>(smem + C::kU);
  char* sS = smem + C::kS;                 // state buffers
  for (int i = tid; i < kK; i += kThreads) sU[i] = u[head * kK + i];

  // element (b, t, head, c) of a (B, S, H, K) tensor
  const size_t tok = static_cast<size_t>(h) * kK;
  const size_t base = static_cast<size_t>(b) * s_len * tok +
                      static_cast<size_t>(head) * kK;

  // this warp's part of the state: rows k = 16 j + g (+8), columns v =
  // 16 c + 8 nn + 2 q (+1) of the block; element e of a tile at (row + 8
  // (e >= 2), column + e % 2)
  float ss[2][4];
  const size_t st_base = static_cast<size_t>(bh) * kK * kK;
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = 16 * j + g + (e >= 2 ? 8 : 0);
      const int vc = v0 + 16 * c + 8 * nn + 2 * q + (e & 1);
      ss[nn][e] = s0 != nullptr ? s0[st_base + kr * kK + vc] : 0.0f;
    }
  // the state into buffer `buf`, by columns v (each holding its k values)
  auto write_state = [&](int buf) {
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Store<T>::put(sS + buf * C::kBuf, kCols, C::kSS,
                      16 * c + 8 * nn + 2 * q + (e & 1),
                      16 * j + g + (e >= 2 ? 8 : 0), ss[nn][e]);
  };
  write_state(1);                 // chunk 0 reads buffer 1

  auto load_chunk = [&](int ci) {
    char* st = smem + (ci & 1) * C::kStage;
    const int t0 = ci * kL, valid = min(kL, s_len - t0);
    const size_t off = base + static_cast<size_t>(t0) * tok;
    copy_rows(st, C::kKS * C::kTS, reinterpret_cast<const char*>(r + off),
              tok * C::kTS, kL, kK * C::kTS, valid, tid, kThreads);
    copy_rows(st + C::kStageK, C::kKS * C::kTS,
              reinterpret_cast<const char*>(k + off), tok * C::kTS, kL,
              kK * C::kTS, valid, tid, kThreads);
    copy_rows(st + C::kStageV, C::kVS * C::kTS,
              reinterpret_cast<const char*>(v + off + v0), tok * C::kTS, kL,
              kCols * C::kTS, valid, tid, kThreads);
    copy_rows(st + C::kStageW, kK * 4,
              reinterpret_cast<const char*>(logw + off), tok * 4, kL, kK * 4,
              valid, tid, kThreads);
    cp_async_commit();
  };

  const int n_chunks = (s_len + kL - 1) / kL;
  if (n_chunks > 0) load_chunk(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    cp_async_wait_all();
    __syncthreads();               // chunk ci landed; chunk ci - 1 done
    if (ci + 1 < n_chunks) load_chunk(ci + 1);
    char* st = smem + (ci & 1) * C::kStage;
    const T* sr = reinterpret_cast<const T*>(st);
    const T* sk = reinterpret_cast<const T*>(st + C::kStageK);
    const T* sv = reinterpret_cast<const T*>(st + C::kStageV);
    float* sw = reinterpret_cast<float*>(st + C::kStageW);
    const int t0 = ci * kL, valid = min(kL, s_len - t0);

    // A. per (8-token block, pair of channels), one a thread: w = exp(logw)
    // in place, r a with a the exclusive prefix product and k z with z the
    // exclusive suffix product within the block, and the block's total T
    {
      static_assert((kL / kBlk) * (kK / 2) == kThreads, "a pair a thread");
      const int kc = 2 * (tid & (kK / 2 - 1)), blk = tid / (kK / 2);
      float2 wv[kBlk];
#pragma unroll
      for (int i = 0; i < kBlk; ++i) {
        float2* p = reinterpret_cast<float2*>(sw + (kBlk * blk + i) * kK + kc);
        const float2 lw = *p;
        wv[i] = make_float2(expf(lw.x), expf(lw.y));   // logw <= 0: w <= 1
        *p = wv[i];
      }
      float2 pre = make_float2(1.0f, 1.0f);
#pragma unroll
      for (int i = 0; i < kBlk; ++i) {
        const int t = kBlk * blk + i;
        const T* rp = sr + t * C::kKS + kc;
        *reinterpret_cast<float2*>(sRD + t * C::kFS + kc) =
            make_float2(to_f32(rp[0]) * pre.x, to_f32(rp[1]) * pre.y);
        pre.x *= wv[i].x;
        pre.y *= wv[i].y;
      }
      *reinterpret_cast<float2*>(sT + blk * kK + kc) = pre;
      float2 suf = make_float2(1.0f, 1.0f);
#pragma unroll
      for (int i = kBlk - 1; i >= 0; --i) {
        const int t = kBlk * blk + i;
        const T* kp = sk + t * C::kKS + kc;
        *reinterpret_cast<float2*>(sKD + t * C::kFS + kc) =
            make_float2(to_f32(kp[0]) * suf.x, to_f32(kp[1]) * suf.y);
        suf.x *= wv[i].x;
        suf.y *= wv[i].y;
      }
    }
    __syncthreads();

    // B. the products of block totals the products below use, thread
    // (channel kc, part): P (part 0), Q (part 1), TB for tiles 1 and 2
    // (part 2) and tile 3 (part 3).  Then the in-block part of the
    // attention, block `warp`: lane (s, part) sums channels 16 part .. of
    // att[t][s] = sum_k r_t k_s D(t, s) over t = s + 1 .. 7 and the bonus
    // sum_k r_s u k_s at t = s, then the four parts are added
    {
      static_assert(4 * kK == kThreads, "four parts a channel");
      const int kc = tid & (kK - 1), part = tid / kK;
      float tb[kL / kBlk];
#pragma unroll
      for (int m = 0; m < kL / kBlk; ++m) tb[m] = sT[m * kK + kc];
      float run = 1.0f;
      if (part == 0) {
#pragma unroll
        for (int m = 0; m <= kL / kBlk; ++m) {
          sP[m * kK + kc] = run;
          if (m < kL / kBlk) run *= tb[m];
        }
      } else if (part == 1) {
#pragma unroll
        for (int m = kL / kBlk - 1; m >= 0; --m) {
          sQ[m * kK + kc] = run;
          run *= tb[m];
        }
      } else {
#pragma unroll
        for (int jj = 1; jj < kL / 16; ++jj) {
          if ((jj == 3) != (part == 3)) continue;
          run = 1.0f;
#pragma unroll
          for (int i = 2 * jj - 1; i >= 0; --i) {
            sTB[(jj * (jj - 1) + i) * kK + kc] = run;
            run *= tb[i];
          }
        }
      }
    }
    {
      const int sl = lane >> 2, kc0 = 16 * (lane & 3);
      const int s = kBlk * warp + sl;
      float kq[16], rs[16], uu[16];
      load16(sk + s * C::kKS + kc0, kq);
      load16(sr + s * C::kKS + kc0, rs);
      load16(sU + kc0, uu);
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < 16; ++m)
        part[m & 3] = fmaf(rs[m] * uu[m], kq[m], part[m & 3]);
      const float bonus = (part[0] + part[1]) + (part[2] + part[3]);
      float out[kBlk];
#pragma unroll
      for (int tl = 0; tl < kBlk; ++tl) {
        out[tl] = tl == sl ? bonus : 0.0f;
        if (tl > sl) {
          const int t = kBlk * warp + tl;
          float rt[16], wt[16];
          load16(sr + t * C::kKS + kc0, rt);
          load16(sw + t * kK + kc0, wt);
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            acc[m & 3] = fmaf(rt[m], kq[m], acc[m & 3]);
            kq[m] *= wt[m];
          }
          out[tl] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        }
      }
#pragma unroll
      for (int tl = 0; tl < kBlk; ++tl) {
        out[tl] += __shfl_xor_sync(0xffffffffu, out[tl], 1);
        out[tl] += __shfl_xor_sync(0xffffffffu, out[tl], 2);
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int tl = 0; tl < kBlk; ++tl)
          Store<T>::put(sAtt, kL, C::kFS, kBlk * warp + tl, s, out[tl]);
      } else if ((lane & 3) == 1 && (warp & 1) == 0) {
        // right of an even block, above the diagonal of its 16-row tile
#pragma unroll
        for (int tl = 0; tl < kBlk; ++tl)
          Store<T>::put(sAtt, kL, C::kFS, kBlk * warp + tl, s + kBlk, 0.0f);
      }
    }
    __syncthreads();

    // C. the attention between 8-token blocks: item (jj, i), i <= 2 jj, is
    // rows 16 jj .. 16 jj + 15 and columns 8 i .. 8 i + 7.  Rows 8 .. 15
    // (block 2 jj + 1) carry the total of block 2 jj beside the totals
    // strictly between block i and block 2 jj, which go with the columns.
    // Warps 0 .. 5 take two neighbouring items i < 2 jj of one tile (one
    // A operand for both); warps 6 and 7 the items i = 2 jj of two tiles,
    // whose rows 0 .. 7 are the in-block part (B) and stay.
    if (warp < 6) {
      const int jj = warp == 0 ? 1 : warp < 3 ? 2 : 3;
      const int i0 = warp == 0 ? 0 : 2 * (warp - (warp < 3 ? 1 : 3));
      const int ta = 16 * jj + g, tb = ta + 8;
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        FragA<C::kNC> at;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {        // channels 2q.., 2q + 8..
          const int k0 = 16 * kk + 2 * q + 8 * hf;
          const float2 tj = *reinterpret_cast<const float2*>(
              sT + 2 * jj * kK + k0);
          const float2 ra = *reinterpret_cast<const float2*>(
              sRD + ta * C::kFS + k0);
          const float2 rb = *reinterpret_cast<const float2*>(
              sRD + tb * C::kFS + k0);
          at.set(2 * hf, split2<C::kNC>(ra.x, ra.y));
          at.set(2 * hf + 1, split2<C::kNC>(rb.x * tj.x, rb.y * tj.y));
        }
#pragma unroll
        for (int it = 0; it < 2; ++it) {
          const int i = i0 + it, sc = 8 * i + g;
          FragB<C::kNC> kb;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int k0 = 16 * kk + 2 * q + 8 * hf;
            const float2 tbv = *reinterpret_cast<const float2*>(
                sTB + (jj * (jj - 1) + i) * kK + k0);
            const float2 kz = *reinterpret_cast<const float2*>(
                sKD + sc * C::kFS + k0);
            kb.set(hf, split2<C::kNC>(kz.x * tbv.x, kz.y * tbv.y));
          }
          mma_parts<C::kNC, C::kNC>(acc[it], at, kb);
        }
      }
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int col = 8 * (i0 + it) + 2 * q;
        Store<T>::put2(sAtt, kL, C::kFS, ta, col, acc[it][0], acc[it][1]);
        Store<T>::put2(sAtt, kL, C::kFS, tb, col, acc[it][2], acc[it][3]);
      }
    } else {
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int jj = 2 * (warp - 6) + it, i = 2 * jj;
        const int tb = 16 * jj + 8 + g, sc = 8 * i + g;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < kK / 16; ++kk) {
          FragA<C::kNC> at;
          FragB<C::kNC> kb;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int k0 = 16 * kk + 2 * q + 8 * hf;
            const float2 rb = *reinterpret_cast<const float2*>(
                sRD + tb * C::kFS + k0);
            const float2 kz = *reinterpret_cast<const float2*>(
                sKD + sc * C::kFS + k0);
            at.set(2 * hf, Parts<C::kNC>{});   // rows 0 .. 7: zero
            at.set(2 * hf + 1, split2<C::kNC>(rb.x, rb.y));
            kb.set(hf, split2<C::kNC>(kz.x, kz.y));
          }
          mma_parts<C::kNC, C::kNC>(acc, at, kb);
        }
        Store<T>::put2(sAtt, kL, C::kFS, tb, 8 * i + 2 * q, acc[2], acc[3]);
      }
    }
    __syncthreads();

    // D. y of tile j, columns 16 c .. 16 c + 15: att v, plus (r_t D(t,
    // -1)) S with S the state at the chunk's start (buffer ci ^ 1);
    // D(t, -1) = a_t (totals of the blocks before t's)
    {
      float yi[2][4] = {}, yc[2][4] = {};
#pragma unroll
      for (int kq = 0; kq < kL / 16; ++kq) {
        if (kq > j) break;
        const auto at = Store<T>::frag_a(sAtt, kL, C::kFS, 16 * j, 16 * kq,
                                         lane);
        FragB<C::kNI> vb[2];
        frag_b_rows2(sv + 16 * kq * C::kVS + 16 * c, C::kVS, lane, vb[0],
                     vb[1]);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
          mma_parts<Store<T>::kN, C::kNI>(yi[nn], at, vb[nn]);
      }
      const char* sprev = sS + ((ci & 1) ^ 1) * C::kBuf;
      const int ta = 16 * j + g, tb = ta + 8;
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        FragA<C::kNC> ra;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int k0 = 16 * kk + 2 * q + 8 * hf;
          // the blocks before 2 j (rows ta) and before 2 j + 1 (rows tb)
          const float2 pa = *reinterpret_cast<const float2*>(
              sP + 2 * j * kK + k0);
          const float2 pb = *reinterpret_cast<const float2*>(
              sP + (2 * j + 1) * kK + k0);
          const float2 xa = *reinterpret_cast<const float2*>(
              sRD + ta * C::kFS + k0);
          const float2 xb = *reinterpret_cast<const float2*>(
              sRD + tb * C::kFS + k0);
          ra.set(2 * hf, split2<C::kNC>(xa.x * pa.x, xa.y * pa.y));
          ra.set(2 * hf + 1, split2<C::kNC>(xb.x * pb.x, xb.y * pb.y));
        }
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const auto sb = Store<T>::frag_b(sprev, kCols, C::kSS,
                                           16 * c + 8 * nn, 16 * kk, lane);
          mma_parts<C::kNC, Store<T>::kN>(yc[nn], ra, sb);
        }
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const size_t col = base + v0 + 16 * c + 8 * nn + 2 * q;
        if (ta < valid)
          store2(y + col + static_cast<size_t>(t0 + ta) * tok,
                 yi[nn][0] + yc[nn][0], yi[nn][1] + yc[nn][1]);
        if (tb < valid)
          store2(y + col + static_cast<size_t>(t0 + tb) * tok,
                 yi[nn][2] + yc[nn][2], yi[nn][3] + yc[nn][3]);
      }
    }

    // E. S <- D(L, -1) S + (k D(L, .))^T v, rows k = 16 j + g (+8): the A
    // operand is (k z)^T times the totals of the blocks after s's, rows k,
    // columns s
    {
      const int ka = 16 * j + g, kb = ka + 8;
      const float tota = sP[(kL / kBlk) * kK + ka];
      const float totb = sP[(kL / kBlk) * kK + kb];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        ss[nn][0] *= tota;
        ss[nn][1] *= tota;
        ss[nn][2] *= totb;
        ss[nn][3] *= totb;
      }
#pragma unroll
      for (int kq = kL / 16 - 1; kq >= 0; --kq) {
        // the blocks after 2 kq (rows sl) and after 2 kq + 1 (rows sh)
        const float qa0 = sQ[2 * kq * kK + ka], qb0 = sQ[2 * kq * kK + kb];
        const float qa = sQ[(2 * kq + 1) * kK + ka];
        const float qb = sQ[(2 * kq + 1) * kK + kb];
        float kv[4][2];                          // (k z)^T: rows k, cols s
        load_at(sKD + 16 * kq * C::kFS + 16 * j, C::kFS, lane, kv);
        FragA<C::kNC> za;
        za.set(0, split2<C::kNC>(kv[0][0] * qa0, kv[0][1] * qa0));
        za.set(1, split2<C::kNC>(kv[1][0] * qb0, kv[1][1] * qb0));
        za.set(2, split2<C::kNC>(kv[2][0] * qa, kv[2][1] * qa));
        za.set(3, split2<C::kNC>(kv[3][0] * qb, kv[3][1] * qb));
        FragB<C::kNI> vb[2];
        frag_b_rows2(sv + 16 * kq * C::kVS + 16 * c, C::kVS, lane, vb[0],
                     vb[1]);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
          mma_parts<C::kNC, C::kNI>(ss[nn], za, vb[nn]);
      }
      write_state(ci & 1);
    }
  }

#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = 16 * j + g + (e >= 2 ? 8 : 0);
      const int vc = v0 + 16 * c + 8 * nn + 2 * q + (e & 1);
      s_fin[st_base + kr * kK + vc] = ss[nn][e];
    }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, void* y, float* s_fin, int b,
           int s, int h, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<T>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_kernel<T><<<b * h * (kK / kCols), kThreads, Cfg<T>::kBytes, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, static_cast<T*>(y), s_fin, s,
      h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What the launch needs of the variant for `dtype` on the current device:
// info[0] registers a thread, [1] local (spilled) bytes a thread, [2]
// static and [3] dynamic shared memory a block, [4] resident blocks an
// SM, [5] the device's SMs, [6] threads a block.  Returns the cudaError_t
// of the queries; cudaErrorInvalidValue for an unknown dtype.
extern "C" int rwkv6_info(int dtype, int* info) {
  if (dtype == 0)
    return kernel_info(wkv_kernel<float>, kThreads, Cfg<float>::kBytes, info);
  if (dtype == 1)
    return kernel_info(wkv_kernel<__nv_bfloat16>, kThreads,
                       Cfg<__nv_bfloat16>::kBytes, info);
  return static_cast<int>(cudaErrorInvalidValue);
}

// r, k, v (b, s, h, kd) of one dtype (0 = fp32, 1 = bf16); logw (b, s, h,
// kd) fp32; u (h, kd) fp32; s0 (b, h, kd, kd) fp32 or null for zeros;
// y (b, s, h, kd) in r's dtype; s_fin (b, h, kd, kd) fp32; all contiguous
// on the device.  One block per (b, h, 32 value columns), `smem` bytes of
// dynamic shared memory (info[3] of rwkv6_info).  Returns the launch's
// cudaError_t (0 = launched); cudaErrorInvalidValue, without launching,
// for a shape the kernel does not take (kd != 64, a grid of 2^31 blocks
// or more), another smem or an unknown dtype code.
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const float* logw, const float* u,
                            const float* s0, void* y, float* s_fin, int b,
                            int s, int h, int kd, int smem, int dtype,
                            void* stream) {
  if (kd != kK || b < 0 || s < 0 || h < 1 || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(b) * h * (kK / kCols) > 0x7fffffffLL ||
      smem != (dtype == 0 ? Cfg<float>::kBytes : Cfg<__nv_bfloat16>::kBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, logw, u, s0, y, s_fin, b, s, h, st);
  return launch<__nv_bfloat16>(r, k, v, logw, u, s0, y, s_fin, b, s, h, st);
}

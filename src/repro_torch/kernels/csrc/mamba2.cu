// Mamba2 SSD scan for the one-shot prefill, written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/mamba2/kernel.py
// (_ssd_kernel, launched by ssd_fwd).  For each (batch b, head h), over
// the tokens t in order, with a P x N fp32 state H (P = 64):
//
//     H[p, n] <- H[p, n] * w_t + dt_t * x_t[p] * B_t[n],  w_t = exp(dt_t A_h)
//     y_t[p]  =  sum_n C_t[n] * H[p, n]
//
// starting from h0 (zeros when null); the final H is written to h_fin.
// B and C have one group: every head reads the same (b, t) rows.
//
// What bounds it on an H100: bytes.  The chunked form below does about
// 2 L P + 4 N P operations per token and head on the bf16 tensor cores
// (L = 64): at the zamba2-7b prefill (B=1 S=4096 H=112 N=64) ~11 GFLOP,
// ~0.011 ms at 989 TFLOP/s, against ~122 MB of x, y, dt, B, C and the
// final state, ~0.037 ms at 3.35 TB/s.  (The per-token form it replaces,
// 5 P N fp32 operations per token and head on the CUDA cores, was bound
// by those operations: ~0.14 ms.)  The recurrence is sequential across
// chunks, so a block walks its head's chunks in order and the card is
// filled across (b, h, part of the P columns): 112 blocks at that shape.
// What holds it back on the card is the latency of each chunk's four
// barrier-separated phases (tools/scan_phase_clocks.py; PERF.md).
//
// Design: the Pallas kernel's chunk factorization (SSD's block
// decomposition) with its three products on the tensor cores, made safe
// for this card's inputs:
//   * chunks of L = 64 tokens, any S: the last chunk's missing tokens are
//     copied in as zeros (dt = 0 gives w = 1 and no update), so no
//     divisor of S is needed;
//   * per chunk, with E(t, s) = prod_{m = s+1}^{t} w_m for s <= t:
//       y_t   = sum_{s <= t} (C_t . B_s) E(t, s) dt_s x_s
//               + E(t, -1) C_t . H                        (H: chunk start)
//       H    <- E(L-1, -1) H + sum_s E(L-1, s) dt_s x_s (x) B_s;
//     G = C B^T, M = G E dt (masked), M x, C H^T and (x dt E)^T B are
//     mma.sync m16n8k16 bf16 products with fp32 accumulation;
//   * no exponent is ever positive, and no decay is a difference of two
//     cumulative sums: the Pallas kernel's exp(cum_t - cum_s) over the
//     whole L x L square reaches exp of hundreds above the diagonal
//     (dt A down to ~-80 per token), and a difference of large
//     cumulative sums loses the small decays after a large one.  Here
//     every decay is a product of w_m = exp(dt_m A) <= 1: within each
//     16-token tile by prefix, suffix and column products, across tiles
//     as (prefix in the later tile) x (totals of the tiles between) x
//     (suffix in the earlier tile).  Underflow to 0 is exact, and the
//     mask is applied before any product is used;
//   * the state keeps fp32 accuracy: x, B and C go into the products as
//     the bf16 they are; M, x dt E and the state read in C H^T are fp32
//     and go in as hi + lo bf16 parts (scan_mma.cuh).  With fp32 inputs
//     every operand goes in as three bf16 parts, which carry fp32's 24
//     bits: two parts leave ~2^-17 of each term, which is past the 3e-4
//     limit where a sum of large terms cancels.  H is carried in fp32
//     registers from chunk to chunk and kept in shared memory for C H^T
//     (split once into hi and lo planes for bf16 inputs);
//   * one block per (b, h, COLS of the P columns), 4 COLS / 16 warps:
//     warp (j, c) owns the tokens of tile j and the columns 16 c .. of
//     y, and rows 16 c .. of H with a quarter of its n-tiles; the
//     schedulers take warps w, w + 4, ..., so each holds one warp of
//     every tile.  The L x L matrix M (C B^T is shared by all heads, so
//     computed by the block from B and C read once per chunk, through
//     L2) is built by all warps into shared memory as bf16 parts, read
//     by ldmatrix; warps 2 and 3 table each token's E(t, -1) and E(L-1,
//     t) dt_t while warps 0 and 1 finish the in-tile decays.  The layout
//     (kernel.py: layout) picks COLS, and so the grid: whole heads
//     wherever their block fits in shared memory;
//   * the next chunk's x, B, C and dt are in flight by cp.async into the
//     other stage of a two-stage ring while the current one computes;
//   * shared-memory rows are padded (by 8 elements) so that the fragment
//     reads fall in distinct banks.
// Tried on the card and dropped (PERF.md): half heads (COLS 32, 224
// blocks, C B^T computed twice: 7% slower), and x dt E split once into
// shared memory with y balanced across warps (8% slower).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "scan_mma.cuh"

namespace {

constexpr int kP = 64;          // head size (MAMBA_HEAD_DIM)
constexpr int kL = 64;          // tokens per chunk
constexpr int kTiles = 4;       // 16-token tiles per chunk
constexpr int kItems = 20;      // (tile jj, n-tile i <= 2 jj + 1) blocks of M

template <typename T, int N, int COLS>
struct Cfg {
  static constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kNI = In<T>::kN;             // parts of x, B, C
  static constexpr int kNC = kExact ? 2 : 3;        // of fp32 operands
  static constexpr int kWarps = 4 * (COLS / 16);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kNT = N / 8;                 // n-tiles of the state
  static constexpr int kHT = (kNT + 3) / 4;         // of them per warp
  // row strides (elements)
  static constexpr int kXS = COLS + 8;              // staged x, T
  static constexpr int kBS = N + 8;                 // staged B and C, T
  static constexpr int kMS = kL + 8;                // M, fp32
  static constexpr int kDS = 24;                    // in-tile decays, fp32
  static constexpr int kHS = N + 8;                 // state buffers
  // a stage: x (kL x kXS), B, C (kL x kBS), then dt (kL floats)
  static constexpr int kStageB = kL * kXS * static_cast<int>(sizeof(T));
  static constexpr int kStageC = kStageB + kL * kBS * static_cast<int>(sizeof(T));
  static constexpr int kStageDt = kStageC + kL * kBS * static_cast<int>(sizeof(T));
  static constexpr int kStage = kStageDt + kL * 4;
  // after the two stages: M; in-tile decays D; w, a (prefix), z
  // (suffix), E(t, -1) and E(L-1, t) dt_t per token; the four tile totals;
  // two buffers of the state, 4 bytes an element of [COLS][kHS] (Store<T>
  // in scan_mma.cuh)
  static constexpr int kM = 2 * kStage;
  static constexpr int kD = kM + kL * kMS * 4;
  static constexpr int kW = kD + kL * kDS * 4;
  static constexpr int kT = kW + 5 * kL * 4;
  static constexpr int kH = kT + 16;
  static constexpr int kBuf = COLS * kHS * 4;
  static constexpr int kBytes = kH + 2 * kBuf;
};

template <typename T, int N, int COLS>
__global__ void __launch_bounds__(Cfg<T, N, COLS>::kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const T* __restrict__ bmat, const T* __restrict__ cmat,
           const float* __restrict__ a, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ h_fin, int s_len, int h) {
  using C = Cfg<T, N, COLS>;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  // token tile j (rows 16 j ..) and column part c (columns 16 c .. of the
  // block): the SM's four schedulers take warps w, w + 4, ..., so each
  // holds one warp of every tile and the tiles' unequal work is shared
  const int j = warp / (COLS / 16), c = warp % (COLS / 16);
  constexpr int kParts = kP / COLS;
  const int bh = blockIdx.x / kParts;      // b * h + head
  const int b = bh / h, head = bh % h;
  const int col0 = (blockIdx.x % kParts) * COLS;
  const float a_h = a[head];

  char* sM = smem + C::kM;                 // M, 4 bytes an element
  float* sD = reinterpret_cast<float*>(smem + C::kD);
  float* sw = reinterpret_cast<float*>(smem + C::kW);
  float* sa = sw + kL;
  float* sz = sa + kL;
  float* spre = sz + kL;                   // E(t, -1)
  float* swt = spre + kL;                  // E(L-1, t) dt_t
  float* sT = reinterpret_cast<float*>(smem + C::kT);
  char* sH = smem + C::kH;                 // state buffers

  // x, y: (B, S, H, P); dt: (B, S, H); B, C: (B, S, N)
  const size_t x_tok = static_cast<size_t>(h) * kP;
  const size_t x_off = static_cast<size_t>(b) * s_len * x_tok +
                       static_cast<size_t>(head) * kP + col0;
  const T* xg = x + x_off;
  T* yg = y + x_off;
  const float* dtg = dt + static_cast<size_t>(b) * s_len * h + head;
  const T* bg = bmat + static_cast<size_t>(b) * s_len * N;
  const T* cg = cmat + static_cast<size_t>(b) * s_len * N;

  // this warp's part of the state: rows p = 16 c + g (+8) of the block,
  // n-tiles j + 4 i; element e of a tile at (row + 8 (e >= 2), 2 q + e % 2)
  float hs[C::kHT][4];
  const size_t st_base = (static_cast<size_t>(bh) * kP + col0) * N;
#pragma unroll
  for (int i = 0; i < C::kHT; ++i) {
    const int nt = j + 4 * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * c + g + (e >= 2 ? 8 : 0);
      const int n = 8 * nt + 2 * q + (e & 1);
      hs[i][e] = (h0 != nullptr && nt < C::kNT)
                     ? h0[st_base + static_cast<size_t>(p) * N + n]
                     : 0.0f;
    }
  }
  // the state into buffer `buf`, by rows p (each holding its n values)
  auto write_state = [&](int buf) {
#pragma unroll
    for (int i = 0; i < C::kHT; ++i) {
      const int nt = j + 4 * i;
      if (nt >= C::kNT) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        Store<T>::put2(sH + buf * C::kBuf, COLS, C::kHS, 16 * c + g + 8 * r,
                       8 * nt + 2 * q, hs[i][2 * r], hs[i][2 * r + 1]);
    }
  };
  write_state(1);                  // chunk 0 reads buffer 1

  auto load_chunk = [&](int ci) {
    char* st = smem + (ci & 1) * C::kStage;
    const int t0 = ci * kL, valid = min(kL, s_len - t0);
    copy_rows(st, C::kXS * sizeof(T),
              reinterpret_cast<const char*>(xg + t0 * x_tok),
              x_tok * sizeof(T), kL, COLS * sizeof(T), valid, tid,
              C::kThreads);
    copy_rows(st + C::kStageB, C::kBS * sizeof(T),
              reinterpret_cast<const char*>(bg + static_cast<size_t>(t0) * N),
              N * sizeof(T), kL, N * sizeof(T), valid, tid, C::kThreads);
    copy_rows(st + C::kStageC, C::kBS * sizeof(T),
              reinterpret_cast<const char*>(cg + static_cast<size_t>(t0) * N),
              N * sizeof(T), kL, N * sizeof(T), valid, tid, C::kThreads);
    for (int t = tid; t < kL; t += C::kThreads) {
      const bool ok = t < valid;
      cp_async4(st + C::kStageDt + 4 * t,
                ok ? dtg + static_cast<size_t>(t0 + t) * h : dtg, ok);
    }
    cp_async_commit();
  };

  const int n_chunks = (s_len + kL - 1) / kL;
  if (n_chunks > 0) load_chunk(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    cp_async_wait_all();
    __syncthreads();               // chunk ci landed; chunk ci - 1 done
    if (ci + 1 < n_chunks) load_chunk(ci + 1);
    const char* st = smem + (ci & 1) * C::kStage;
    const T* sx = reinterpret_cast<const T*>(st);
    const T* sb = reinterpret_cast<const T*>(st + C::kStageB);
    const T* sc = reinterpret_cast<const T*>(st + C::kStageC);
    const float* sdt = reinterpret_cast<const float*>(st + C::kStageDt);
    const int t0 = ci * kL, valid = min(kL, s_len - t0);

    // 1. decays, by warps 0 and 1 (token t = tid): w_t, the inclusive
    // prefix product a_t and the exclusive suffix product z_t within the
    // token's tile, the tile totals, and the column products D[t'][t] =
    // prod_{m = t+1}^{t'} w_m for t' >= t in the tile; then by warps 2 and
    // 3 (token t = tid - 64), once the tile totals are there, E(t, -1) and
    // E(L-1, t) dt_t
    if (tid >= kL && tid < 2 * kL) {
      sync_first(2 * kL);
      const int t = tid - kL, tile = t >> 4;
      float before = 1.0f, after = 1.0f;
#pragma unroll
      for (int m = 0; m < kTiles; ++m) {
        if (m < tile) before *= sT[m];
        if (m > tile) after *= sT[m];
      }
      spre[t] = sa[t] * before;
      swt[t] = sz[t] * after * sdt[t];
    }
    if (tid < kL) {
      const int t = tid, tl = t & 15;
      const float w = expf(sdt[t] * a_h);        // dt >= 0, A < 0: <= 1
      float pre = w, suf = w;
#pragma unroll
      for (int d = 1; d < 16; d <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, pre, d);
        if (tl >= d) pre *= o;
      }
#pragma unroll
      for (int d = 1; d < 16; d <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, suf, d);
        if (tl + d < 16) suf *= o;
      }
      float ex = __shfl_down_sync(0xffffffffu, suf, 1);
      if (tl == 15) ex = 1.0f;
      sw[t] = w;
      sa[t] = pre;
      sz[t] = ex;
      if (tl == 15) sT[t >> 4] = pre;
      __syncwarp();
      float e = 1.0f;
      sD[t * C::kDS + tl] = 1.0f;
      sync_first(2 * kL);
      for (int m = t + 1; m <= (t | 15); ++m) {
        e *= sw[m];
        sD[m * C::kDS + tl] = e;
      }
    }
    __syncthreads();

    // 2. M = (C B^T) E dt, 0 above the diagonal, into sM: block (jj, i) is
    // rows 16 jj .. 16 jj + 15 and columns 8 i .. 8 i + 7
#pragma unroll
    for (int it = 0; it < (kItems + C::kWarps - 1) / C::kWarps; ++it) {
      const int item = warp + it * C::kWarps;
      if (item >= kItems) break;
      const int jj = item < 2 ? 0 : item < 6 ? 1 : item < 12 ? 2 : 3;
      const int i = item - jj * (jj + 1);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const auto ca = frag_a(sc + 16 * jj * C::kBS + 16 * kk, C::kBS, lane);
        const auto bb = frag_b_cols(sb + 8 * i * C::kBS + 16 * kk, C::kBS,
                                    lane);
        mma_parts<C::kNI, C::kNI>(acc, ca, bb);
      }
      const int is = i >> 1;                     // tile of the columns
      float between = 1.0f;                      // tiles strictly between
      for (int m = is + 1; m < jj; ++m) between *= sT[m];
      const int s0 = 8 * i + 2 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * jj + g + (e >= 2 ? 8 : 0);
        const int s = s0 + (e & 1);
        float dec;
        if (s > t)
          dec = 0.0f;
        else if (is == jj)
          dec = sD[t * C::kDS + (s & 15)];
        else
          dec = sa[t] * between * sz[s];
        acc[e] *= dec * sdt[s];
      }
      Store<T>::put2(sM, kL, C::kMS, 16 * jj + g, s0, acc[0], acc[1]);
      Store<T>::put2(sM, kL, C::kMS, 16 * jj + g + 8, s0, acc[2], acc[3]);
    }
    __syncthreads();

    // 3. y of tile j, columns 16 c .. 16 c + 15: M x, plus E(t, -1) C H^T
    // with H the state at the chunk's start (buffer ci ^ 1)
    {
      float yi[2][4] = {}, yc[2][4] = {};
#pragma unroll
      for (int kq = 0; kq < kTiles; ++kq) {
        if (kq > j) break;
        const auto m = Store<T>::frag_a(sM, kL, C::kMS, 16 * j, 16 * kq,
                                        lane);
        FragB<C::kNI> xb[2];
        frag_b_rows2(sx + 16 * kq * C::kXS + 16 * c, C::kXS, lane, xb[0],
                     xb[1]);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
          mma_parts<Store<T>::kN, C::kNI>(yi[nn], m, xb[nn]);
      }
      const char* hprev = sH + ((ci & 1) ^ 1) * C::kBuf;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const auto ca = frag_a(sc + 16 * j * C::kBS + 16 * kk, C::kBS, lane);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const auto hb = Store<T>::frag_b(hprev, COLS, C::kHS,
                                           16 * c + 8 * nn, 16 * kk, lane);
          mma_parts<C::kNI, Store<T>::kN>(yc[nn], ca, hb);
        }
      }
      const int ta = 16 * j + g, tb = ta + 8;
      const float pa = spre[ta], pb = spre[tb];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int col = 16 * c + 8 * nn + 2 * q;
        if (ta < valid)
          store2(yg + static_cast<size_t>(t0 + ta) * x_tok + col,
                 yi[nn][0] + pa * yc[nn][0], yi[nn][1] + pa * yc[nn][1]);
        if (tb < valid)
          store2(yg + static_cast<size_t>(t0 + tb) * x_tok + col,
                 yi[nn][2] + pb * yc[nn][2], yi[nn][3] + pb * yc[nn][3]);
      }
    }

    // 4. H <- E(L-1, -1) H + (x dt E(L-1, .))^T B, rows 16 c .. of the
    // block, n-tiles j + 4 i: the A operand is x^T scaled per token, rows
    // p, columns s
    {
      const float total = sT[0] * sT[1] * sT[2] * sT[3];
#pragma unroll
      for (int i = 0; i < C::kHT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[i][e] *= total;
#pragma unroll
      for (int kq = kTiles - 1; kq >= 0; --kq) {
        const int sl = 16 * kq + 2 * q, sh = sl + 8;
        const float w0 = swt[sl], w1 = swt[sl + 1];
        const float w2 = swt[sh], w3 = swt[sh + 1];
        float xv[4][2];                          // x^T: rows p, columns s
        load_at(sx + 16 * kq * C::kXS + 16 * c, C::kXS, lane, xv);
        FragA<C::kNC> xa;
        xa.set(0, split2<C::kNC>(xv[0][0] * w0, xv[0][1] * w1));
        xa.set(1, split2<C::kNC>(xv[1][0] * w0, xv[1][1] * w1));
        xa.set(2, split2<C::kNC>(xv[2][0] * w2, xv[2][1] * w3));
        xa.set(3, split2<C::kNC>(xv[3][0] * w2, xv[3][1] * w3));
#pragma unroll
        for (int i = 0; i < C::kHT; ++i) {
          const int nt = j + 4 * i;
          if (nt >= C::kNT) continue;
          const auto bb = frag_b_rows(sb + 16 * kq * C::kBS + 8 * nt,
                                      C::kBS, lane);
          mma_parts<C::kNC, C::kNI>(hs[i], xa, bb);
        }
      }
      write_state(ci & 1);
    }
  }

#pragma unroll
  for (int i = 0; i < C::kHT; ++i) {
    const int nt = j + 4 * i;
    if (nt >= C::kNT) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * c + g + (e >= 2 ? 8 : 0);
      const int n = 8 * nt + 2 * q + (e & 1);
      h_fin[st_base + static_cast<size_t>(p) * N + n] = hs[i][e];
    }
  }
}

struct Args {
  const void *x, *bmat, *cmat;
  const float *dt, *a, *h0;
  void* y;
  float* h_fin;
  int b, s, h, smem;
  cudaStream_t stream;
};

// The two things done with a variant, each a functor over <T, N, COLS>
struct Launch {
  const Args& a;
  template <typename T, int N, int COLS>
  int run() const {
    using C = Cfg<T, N, COLS>;
    if (a.smem != C::kBytes) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, N, COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_kernel<T, N, COLS>
        <<<a.b * a.h * (kP / COLS), C::kThreads, C::kBytes, a.stream>>>(
            static_cast<const T*>(a.x), a.dt, static_cast<const T*>(a.bmat),
            static_cast<const T*>(a.cmat), a.a, a.h0, static_cast<T*>(a.y),
            a.h_fin, a.s, a.h);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Info {
  int* info;
  template <typename T, int N, int COLS>
  int run() const {
    using C = Cfg<T, N, COLS>;
    return kernel_info(ssd_kernel<T, N, COLS>, C::kThreads, C::kBytes, info);
  }
};

template <typename T, int COLS, typename Op>
int with_n(int n, const Op& op) {
  switch (n) {
    case 16: return op.template run<T, 16, COLS>();
    case 32: return op.template run<T, 32, COLS>();
    case 64: return op.template run<T, 64, COLS>();
    case 128: return op.template run<T, 128, COLS>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Op>
int dispatch(int dtype, int n, int cols, const Op& op) {
  if (cols == 64)
    return dtype == 0 ? with_n<float, 64>(n, op)
                      : with_n<__nv_bfloat16, 64>(n, op);
  return dtype == 0 ? with_n<float, 32>(n, op)
                    : with_n<__nv_bfloat16, 32>(n, op);
}

bool shape_ok(int p, int n, int cols, int dtype) {
  return p == kP && (n == 16 || n == 32 || n == 64 || n == 128) &&
         (cols == 32 || cols == 64) && (dtype == 0 || dtype == 1);
}

}  // namespace

// What the layout needs of the variant (dtype, n, cols) on the current
// device: info[0] registers a thread, [1] local (spilled) bytes a thread,
// [2] static and [3] dynamic shared memory a block, [4] resident blocks
// an SM, [5] the device's SMs, [6] threads a block.  Returns the
// cudaError_t of the queries; cudaErrorInvalidValue for a variant
// mamba2_launch does not take.
extern "C" int mamba2_info(int dtype, int n, int cols, int* info) {
  if (!shape_ok(kP, n, cols, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, n, cols, Info{info});
}

// x (b, s, h, p), B and C (b, s, n) of one dtype (0 = fp32, 1 = bf16);
// dt (b, s, h) fp32; A (h,) fp32; h0 (b, h, p, n) fp32 or null for zeros;
// y (b, s, h, p) in x's dtype; h_fin (b, h, p, n) fp32; all contiguous on
// the device.  The layout (kernel.py: layout): one block per (b, h, cols
// of the p columns), `smem` bytes of dynamic shared memory (info[3] of
// mamba2_info).  Returns the launch's cudaError_t (0 = launched);
// cudaErrorInvalidValue, without launching, for a shape the kernel does
// not take (p != 64, n not one of 16, 32, 64, 128, cols not 32 or 64, a
// grid of 2^31 blocks or more), another smem or an unknown dtype.
extern "C" int mamba2_launch(const void* x, const float* dt, const void* bmat,
                             const void* cmat, const float* a,
                             const float* h0, void* y, float* h_fin, int b,
                             int s, int h, int p, int n, int cols, int smem,
                             int dtype, void* stream) {
  if (!shape_ok(p, n, cols, dtype) || b < 0 || s < 0 || h < 1 ||
      static_cast<long long>(b) * h * (kP / cols) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const Args args{x, bmat, cmat, dt, a, h0, y, h_fin, b, s, h, smem,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, n, cols, Launch{args});
}

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
// comes out 0, never NaN.
//
// What bounds it on an H100: operations.  Both products do 4 x hd flops
// per visible (q, k) pair and head, against 989 TFLOP/s on the bf16 tensor
// cores: a granite layer at S = 2048 does ~70 GFLOP (0.07 ms) against ~130
// MB of q/k/v/o (0.04 ms of HBM).
//
// Two routes, chosen by the caller from the dtype and hd alone before the
// launch (kernels/flash_attention/kernel.py: route), never after a failure:
//
// "wgmma" (flash_attention_wgmma_launch): bf16 with hd a multiple of 8 up
// to 256 — every model's prefill.  Both products on the tensor cores:
//   * one block of three warpgroups per (q tile of 128 rows, q head, batch
//     row).  Warpgroups 0 and 1 consume, 64 q rows each; in warpgroup 2 one
//     thread issues every load, and setmaxnreg moves registers from it to
//     the consumers;
//   * q, k and v arrive by TMA (4-d tensor maps over (hd, heads, seq,
//     batch), made with libcuda's cuTensorMapEncodeTiled) in chunks of
//     64 hd columns, one 128-byte row per position, swizzled 128B: the
//     layout wgmma reads.  TMA fills columns past hd and rows past Sq or Sk
//     with zeros, so hd is padded to a multiple of 64 in shared memory (120
//     -> 128, 40 -> 64) and ragged tiles need no special copy;
//   * q is loaded once per block; k and v go through a ring of 2 stages
//     with their own full and empty mbarriers: a k tile is released once S
//     is computed, so the next one's load has about two turns to arrive;
//   * S = Q K^T by wgmma m64n{BK}k16 with both operands K-major in shared
//     memory, scaled in fp32 after the product by hd^-0.5 log2(e) (the
//     Pallas kernel scales q first: the two differ by fp32 rounding).  The
//     row max is taken on the raw scores, so p = 2^(s c - m) is one FMA and
//     one ex2.approx (relative error ~2^-22, far below p's rounding);
//   * O += P V by wgmma m64n64k16 with P in registers: the S accumulator's
//     fragment, exponentiated and packed to bf16x2, is the A fragment of
//     the next wgmma, so P takes no shuffle and no trip through shared
//     memory.  P goes in as two bf16 parts (below), so P V is two products
//     on the same V tile.  V is the B operand MN-major (the transpose
//     flag), so it is never transposed in memory.  n64 instructions,
//     composed over the hd chunks, keep the code to three instruction
//     forms;
//   * the two consumers take turns to issue (named barriers 1 and 2): a
//     turn issues P V of tile t with S of tile t + 1, and one warpgroup's
//     softmax runs while the other's products keep the tensor cores busy.
//     Every product of a turn is issued unconditionally (a tile that a
//     warpgroup does not see gives P = 0) and nothing touches an
//     accumulator between a turn's first product and its wait: otherwise
//     the compiler serializes the products;
//   * a row's max and sum are butterflies over the quad of threads holding
//     it; l stays per thread and is summed over the quad once at the end;
//   * per warpgroup and kv tile: no softmax where the mask hides the whole
//     tile, no per-element mask where it hides none of it; only tiles
//     across the diagonal, the window's edge or the ragged end of Sk are
//     masked;
//   * hd <= 128 takes kv tiles of 128 rows: Q 32 KB + 2 x (K 32 + V 32) =
//     160 KB.  hd <= 256 takes kv tiles of 64 (the O accumulator alone is
//     then 128 registers a thread): 192 KB.  One block per SM;
//   * blocks start in the order of their linear index: (batch row, head)
//     on grid x and the q tiles reversed on y start the causal tiles with
//     the most kv tiles first, those of every head in the first wave.
// The A operand of a 16-bit wgmma is bf16; the Pallas kernel keeps p in
// fp32.  p rounded once to bf16 moves an output by up to 2^-8 sum_j p_j
// |v_j| / l, which at full width flips enough near-tied expert choices of
// a MoE stack to move its logits past the port's checks.  So p is split
// into hi = bf16(p) and lo = bf16(p - hi), both multiplied by V: p is
// carried to a relative error of 2^-16, an output moves by at most 2^-16
// sum_j p_j |v_j| / l, and the products take 1.5 times the tensor-core
// work of the single rounding.
//
// "scalar" (flash_attention_launch): fp32 — which serves the checks, whose
// 2e-5 tolerance TF32 tensor cores would break — and bf16 at an hd that is
// not a multiple of 8.  Scalar fp32 FMA (67 TFLOP/s outside the tensor
// cores), q pre-scaled as the Pallas kernel does, p kept in fp32:
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
#include <cstdint>

#include "tma.cuh"           // mbarriers and the tensor-map encoder

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

// ---------------------------------------------------------------------------
// The wgmma route: bf16, hd a multiple of 8 up to 256
// ---------------------------------------------------------------------------

namespace {

constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;                  // warpgroups of 64 q rows
constexpr int kWgBQ = 64 * kConsumers;         // q rows per block
constexpr int kWgThreads = (kConsumers + 1) * kWarpgroup;
constexpr int kStages = 2;                     // the k/v ring
constexpr int kChunk = 64;                     // hd columns per 128-byte row
constexpr int kRowBytes = kChunk * 2;
// 128 x 24 + 256 x 240 <= 65,536 registers of the SM
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// The mbarriers of a ring stage.  k and v have their own, so a k tile is
// released once S is computed, a product before its v tile: the next k
// tile's load then has about two turns to arrive.
enum StageBar { kKFull, kVFull, kKEmpty, kVEmpty, kStageBars };

// Shared memory of one block, in 1024-byte aligned pieces (the period of
// the 128B swizzle): q (NC chunks of kWgBQ rows), then kStages k tiles and
// kStages v tiles (NC chunks of BK rows each), then the mbarriers: q full,
// then each stage's StageBar.
template <int NC, int BK>
struct WgTile {
  static constexpr int kQBytes = NC * kWgBQ * kRowBytes;
  static constexpr int kKVBytes = NC * BK * kRowBytes;    // k or v, a stage
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr size_t kSmemBytes =
      kBarOff + 8 + 8 * kStageBars * kStages + 1024;  // + slack to align
  __host__ __device__ static constexpr int bar(int stage, StageBar which) {
    return kBarOff + 8 + 8 * (kStageBars * stage + which);
  }
};

// one box of `map` at (column, head, position, batch row) into dst,
// completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int pos, int row) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(pos), "r"(row)
      : "memory");
}

// The wgmma descriptor of an operand tile in shared memory laid out as TMA
// writes it with the 128B swizzle: 128-byte rows, 8-row groups 1024 bytes
// apart (the stride offset).  The leading offset — the next 64-element
// atom along the swizzled dimension — is never read: every operand here is
// one atom wide along it (a k16 slice of a 64-column chunk for K-major q
// and k, n64 of one chunk for MN-major v), so it is set to the same 1024.
// Bits: start >> 4 at 0, leading >> 4 at 16, stride >> 4 at 32, layout 1
// (128B swizzle) at 62.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | kGroup << 16 |
         kGroup << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accesses of an accumulator across the
// asynchronous products that write it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define WG_D64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"
#define WG_OUT32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define WG_OUT64(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),        \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),        \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),        \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),        \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),        \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A B for a 64 x N fp32 tile: A (64 x 16) and B (16 x N) bf16, both
// K-major in shared memory; d = A B when accumulate is 0.  N = BK: 128 or
// 64.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n\t}"
      : WG_OUT64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B for a 64 x 64 fp32 tile: A (64 x 16) bf16 in registers (the
// m16n8k16 A fragment of each warp's 16 rows), B (16 x 64) bf16 MN-major
// in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D32
#undef WG_D64
#undef WG_OUT32
#undef WG_OUT64

// p of two neighbouring columns as two bf16x2 A-fragment registers: hi =
// bf16(p) and lo = bf16(p - hi), so hi + lo carries p to a relative error
// of 2^-16 (bf16 alone: 2^-8)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x by the special-function unit (relative error ~2^-22, far below the
// 2^-8 of p's rounding to bf16; 0 for x below -126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The loading thread: q once, then the kv tiles through the ring.
template <int NC, int BK>
__device__ __forceinline__ void wgmma_producer(
    uint32_t smem, const CUtensorMap* q_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, int q0, int b, int h, int kvh, int k_lo,
    int n_tiles) {
  using C = WgTile<NC, BK>;
  const uint32_t q_full = smem + C::kBarOff;
  mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load(smem + c * kWgBQ * kRowBytes, q_map, q_full, c * kChunk, h, q0,
             b);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * BK;
    const uint32_t off = stage * C::kKVBytes;
    mbar_wait(smem + C::bar(stage, kKEmpty), phase ^ 1);
    mbar_expect_tx(smem + C::bar(stage, kKFull), C::kKVBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(smem + C::kKOff + off + c * BK * kRowBytes, k_map,
               smem + C::bar(stage, kKFull), c * kChunk, kvh, k0, b);
    mbar_wait(smem + C::bar(stage, kVEmpty), phase ^ 1);
    mbar_expect_tx(smem + C::bar(stage, kVFull), C::kKVBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(smem + C::kVOff + off + c * BK * kRowBytes, v_map,
               smem + C::bar(stage, kVFull), c * kChunk, kvh, k0, b);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The consumer warpgroups take turns to issue their products: warpgroup g
// waits on named barrier 1 + g (0 is __syncthreads'), issues, then lets
// the other go by arriving on 2 - g.  So one warpgroup's softmax runs
// while the other's products keep the tensor cores busy.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kConsumers * kWarpgroup)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kConsumers * kWarpgroup)
               : "memory");
}

// S = Q K^T of one kv tile: NC chunks of 4 k16 steps, N = BK.  The caller
// fences before and commits after (also for issue_pv): nothing may touch
// an accumulator between the first product of a turn and its wait, or the
// compiler serializes the products.
template <int NC, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_tile,
                                         uint32_t k_tile) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      wgmma_ss<BK>(s, sw128_desc(q_tile + c * kWgBQ * kRowBytes + kk * 32),
                   sw128_desc(k_tile + c * BK * kRowBytes + kk * 32),
                   c > 0 || kk > 0);
}

// O += P V of one kv tile: BK / 16 k16 steps of NC n64 products, each of
// P's two bf16 parts (hi, then lo)
template <int NC, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[NC][32],
                                         const uint32_t (&pa)[2][BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t v = sw128_desc(v_tile + (c * BK + 16 * j) * kRowBytes);
      wgmma_rs(o[c], pa[0][j], v);
      wgmma_rs(o[c], pa[1][j], v);
    }
}

template <int NC>
__device__ __forceinline__ void fence_accumulators(float (&o)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(o[c]);
}

// The online softmax of one kv tile at k0 for this thread's rows row0 and
// row0 + 8: S (fp32 scores) in, P out as the A fragments of its two bf16
// parts (all 0 where the warpgroup sees nothing of the tile); m, l and O
// rescaled.  The
// per-element mask runs only where the tile is not wholly visible.
template <int NC, int BK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], uint32_t (&pa)[2][BK / 16][4], float (&o)[NC][32],
    float (&m)[2], float (&l)[2], int k0, int row0, int col0, int wg_lo,
    int wg_hi, int sk, int window, int causal, float scale_log2) {
  // some pair of the tile visible to some row of the warpgroup ...
  const bool seen = wg_lo <= wg_hi && (!causal || k0 <= wg_hi) &&
                    k0 + BK - 1 > wg_lo - window;
  if (!seen) {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[0][j][x] = pa[1][j][x] = 0u;
    return;
  }
  // ... and every pair visible to every row
  const bool inside = k0 + BK <= sk && (!causal || k0 + BK - 1 <= wg_lo) &&
                      k0 > wg_hi - window;
  // the row max of the raw scores (scale_log2 > 0 keeps the order); m is
  // kept scaled, so p = 2^(s scale_log2 - m) is one FMA and one ex2
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int r = 0; r < BK / 2; ++r) {
    if (!inside) {
      const int qp = row0 + 8 * ((r / 2) % 2);
      const int kp = k0 + 8 * (r / 4) + col0 + r % 2;
      if (!(kp < sk && kp > qp - window && (!causal || kp <= qp)))
        s[r] = kNegInf;
    }
    mx[(r / 2) % 2] = fmaxf(mx[(r / 2) % 2], s[r]);
  }
  float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(mx[i]) * scale_log2);
    corr[i] = fast_exp2(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int r = 0; r < BK / 2; ++r) {
    float p = fast_exp2(fmaf(s[r], scale_log2, -m[(r / 2) % 2]));
    if (!inside && s[r] == kNegInf) p = 0.0f;
    s[r] = p;
    sum[(r / 2) % 2] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[c][r] *= corr[(r / 2) % 2];
  // k16 step j of P V takes columns 16j..16j+15 of S: registers 8j..8j+7,
  // pairwise, which is the A fragment (of each part)
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      split_bf16(s[8 * j + 2 * x], s[8 * j + 2 * x + 1], pa[0][j][x],
                 pa[1][j][x]);
}

// A consumer warpgroup: 64 q rows against every kv tile of the block.
// Thread (warp w, lane) holds rows 16w + lane/4 + {0, 8} of the warpgroup
// and, of each 8 columns of an accumulator, columns 2 (lane % 4) + {0, 1}:
// register r of an accumulator is row 8 ((r / 2) % 2), column 8 (r / 4) +
// 2 (lane % 4) + r % 2.  Its turns: S of tile 0; then P V of tile t with S
// of tile t + 1; then P V of the last tile.  Each product is issued
// unconditionally (a tile the warpgroup does not see gives P = 0), so the
// compiler keeps the accumulators in place between issue and wait.
template <int NC, int BK>
__device__ __forceinline__ void wgmma_consumer(
    uint32_t smem, int wg, int q0, int b, int h, int sq, int sk, int hq,
    int hd, int window, int causal, int k_lo, int n_tiles, float scale_log2,
    __nv_bfloat16* __restrict__ out) {
  using C = WgTile<NC, BK>;
  const int tid = threadIdx.x % kWarpgroup;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * (tid / 32) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int wg_lo = q0 + 64 * wg;
  const int wg_hi = min(wg_lo + 63, sq - 1);     // its last row with output
  const uint32_t q_tile = smem + 64 * wg * kRowBytes;

  float o[NC][32], s[BK / 2];
  uint32_t pa[2][BK / 16][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[c][r] = 0.0f;
#pragma unroll
  for (int r = 0; r < BK / 2; ++r) s[r] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  mbar_wait(smem + C::kBarOff, 0);
  if (n_tiles > 0) {
    if (wg == 1) bar_arrive(1);      // warpgroup 0 takes the first turn
    mbar_wait(smem + C::bar(0, kKFull), 0);
    bar_sync(1 + wg);
    fence_regs(s);
    wgmma_fence();
    issue_qk<NC, BK>(s, q_tile, smem + C::kKOff);
    wgmma_commit();
    bar_arrive(2 - wg);
    wgmma_wait_all();
    fence_regs(s);
    mbar_arrive(smem + C::bar(0, kKEmpty));

    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t + 1 < n_tiles; ++t) {
      const int k0 = k_lo + t * BK;
      softmax_tile<NC, BK>(s, pa, o, m, l, k0, row0, col0, wg_lo, wg_hi, sk,
                           window, causal, scale_log2);
      const int next = stage + 1 == kStages ? 0 : stage + 1;
      const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
      mbar_wait(smem + C::bar(stage, kVFull), phase);
      mbar_wait(smem + C::bar(next, kKFull), next_phase);
      bar_sync(1 + wg);
      fence_accumulators(o);
      fence_regs(s);
      wgmma_fence();
      issue_pv<NC, BK>(o, pa, smem + C::kVOff + stage * C::kKVBytes);
      issue_qk<NC, BK>(s, q_tile, smem + C::kKOff + next * C::kKVBytes);
      wgmma_commit();
      bar_arrive(2 - wg);
      wgmma_wait_all();
      fence_accumulators(o);
      fence_regs(s);
      mbar_arrive(smem + C::bar(stage, kVEmpty));
      mbar_arrive(smem + C::bar(next, kKEmpty));
      stage = next;
      phase = next_phase;
    }
    softmax_tile<NC, BK>(s, pa, o, m, l, k_lo + (n_tiles - 1) * BK, row0,
                         col0, wg_lo, wg_hi, sk, window, causal, scale_log2);
    mbar_wait(smem + C::bar(stage, kVFull), phase);
    bar_sync(1 + wg);
    fence_accumulators(o);
    wgmma_fence();
    issue_pv<NC, BK>(o, pa, smem + C::kVOff + stage * C::kKVBytes);
    wgmma_commit();
    if (wg == 0) bar_arrive(2);      // 1 has the last turn
    wgmma_wait_all();
    fence_accumulators(o);
    mbar_arrive(smem + C::bar(stage, kVEmpty));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float denom = fmaxf(quad_sum(l[i]), 1e-30f);
    const int qp = row0 + 8 * i;
    if (qp >= sq) continue;
    __nv_bfloat16* row = out + ((static_cast<size_t>(b) * sq + qp) * hq + h) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kChunk * c + 8 * j + col0;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * i] / denom,
                                    o[c][4 * j + 2 * i + 1] / denom);
      }
  }
}

template <int NC, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ out, int sq, int sk,
                             int hq, int hk, int hd, int window, int causal,
                             float scale_log2) {
  using C = WgTile<NC, BK>;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t smem =
      (static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem)) + 1023u) &
      ~1023u;
  // blocks start in the order of their linear index, x fastest: (batch
  // row, head) on x and the q tiles reversed on y start the causal tiles
  // with the most kv tiles first, those of every head in the first wave
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;
  const int h = blockIdx.x % hq;
  const int b = blockIdx.x / hq;
  // kv tiles visible to some row of [q0, q_last], as the scalar kernel
  const int q_last = min(q0 + kWgBQ, sq) - 1;
  const int k_lo = (max(0, q0 - window + 1) / BK) * BK;
  const int k_hi = causal ? min(sk, q_last + 1) : sk;      // exclusive
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(smem + C::kBarOff, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem + C::bar(s, kKFull), 1);
      mbar_init(smem + C::bar(s, kVFull), 1);
      mbar_init(smem + C::bar(s, kKEmpty), kConsumers * kWarpgroup);
      mbar_init(smem + C::bar(s, kVEmpty), kConsumers * kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * kWarpgroup)
      wgmma_producer<NC, BK>(smem, &q_map, &k_map, &v_map, q0, b, h,
                             h / (hq / hk), k_lo, n_tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    wgmma_consumer<NC, BK>(smem, wg, q0, b, h, sq, sk, hq, hd, window,
                           causal, k_lo, n_tiles, scale_log2,
                           out);
  }
}

// A map over a contiguous bf16 (batch, seq, heads, hd) tensor as the 4-d
// (hd, heads, seq, batch), in boxes of 64 hd columns x `rows` positions of
// one head, swizzled 128B; columns and rows out of range read as 0.
bool make_map(CUtensorMap* map, const void* base, int hd, int heads, int seq,
              int batch, int rows) {
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {dims[0] * e, dims[0] * dims[1] * e,
                                 dims[0] * dims[1] * dims[2] * e};
  const cuuint32_t box[4] = {kChunk, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return tensor_map_encode()(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int b, int sq, int sk, int hq, int hk, int hd, int window,
                 int causal, cudaStream_t stream) {
  using C = WgTile<NC, BK>;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, hd, hq, sq, b, kWgBQ) ||
      !make_map(&k_map, k, hd, hk, sk, b, BK) ||
      !make_map(&v_map, v, hd, hk, sk, b, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<NC, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (sq + kWgBQ - 1) / kWgBQ);
  flash_attention_wgmma_kernel<NC, BK>
      <<<grid, kWgThreads, C::kSmemBytes, stream>>>(
          q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), sq, sk, hq,
          hk, hd, window, causal,
          static_cast<float>(1.4426950408889634 /       // log2(e) hd ** -0.5
                             sqrt(static_cast<double>(hd))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor-core route: bf16 q (b, sq, hq, hd), k/v (b, sk, hk, hd), out
// (b, sq, hq, hd), contiguous on the device, q, k and v 16-byte aligned
// (TMA).  window and causal as flash_attention_launch.  Returns the
// launch's cudaError_t (0 = launched); cudaErrorInvalidValue, without
// launching, for what the kernel does not take: hd not a multiple of 8 in
// [8, 256], hk < 1 or hq not a multiple of hk, more than 65535 q tiles
// (grid y) or 65535 heads or batch rows, or a misaligned pointer;
// cudaErrorNotSupported where libcuda has no cuTensorMapEncodeTiled.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int b,
                                            int sq, int sk, int hq, int hk,
                                            int hd, int window, int causal,
                                            void* stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (hd < 8 || hd > kHdLimit || hd % 8 || hk < 1 || hq < hk || hq % hk ||
      hq > 65535 || b > 65535 || sq < 0 || sk < 0 || b < 0 ||
      sq > 65535 * kWgBQ || misaligned(q) || misaligned(k) || misaligned(v))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || sq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sk == 0)     // no key at all: every row comes out 0 (and a tensor map
    return static_cast<int>(cudaMemsetAsync(     // takes no empty dimension)
        out, 0, static_cast<size_t>(b) * sq * hq * hd * sizeof(__nv_bfloat16),
        s));
  if (tensor_map_encode() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  switch ((hd + kChunk - 1) / kChunk) {
    case 1:
      return launch_wgmma<1, 128>(q, k, v, out, b, sq, sk, hq, hk, hd, window,
                                  causal, s);
    case 2:
      return launch_wgmma<2, 128>(q, k, v, out, b, sq, sk, hq, hk, hd, window,
                                  causal, s);
    case 3:
      return launch_wgmma<3, 64>(q, k, v, out, b, sq, sk, hq, hk, hd, window,
                                 causal, s);
    default:
      return launch_wgmma<4, 64>(q, k, v, out, b, sq, sk, hq, hk, hd, window,
                                 causal, s);
  }
}

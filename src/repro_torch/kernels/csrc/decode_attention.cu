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
// (out = acc / max(l, 1e-30)), never NaN.  cache_len and window are read
// in the kernel through pointers (the Pallas kernel reads them from SMEM),
// so a decode step never waits on the host; positions outside the visible
// range are never loaded.
//
// What bounds it on an H100: bytes.  Each visible position is read once
// for all G heads of its kv head: 4 hd bytes of k and v in bf16 against
// 4 G hd flops, one flop per byte at G = 2 (gemma3-12b), far below the
// ~295 flops per byte where the tensor cores would start to matter.  So
// the design is about keeping HBM busy from the first block to the last,
// on scalar fp32 FMA.  What held back the first version (a 17-way split
// per (row, kv head), a half-warp per position loading into registers,
// and a second kernel for the combine: 78% of the bound at gemma3's
// shape), and what this one does about it:
//
//   * Loads in flight.  The first version issued a half-warp's loads for
//     a few positions, waited, computed, and only then issued the next:
//     the register budget capped the bytes in flight.  Here one producer
//     thread streams k and v tiles into a ring of 4 stages of 16 KB in
//     shared memory with the Tensor Memory Accelerator: a 2-d tensor map
//     over the cache viewed as (B S, Hk hd), boxes of `tile` positions x
//     hd (tile = 32, 16 or 8 positions for rows of at most 256, 512 or
//     1024 bytes), full and empty mbarriers per stage.  Tiles start at
//     the visible range's first position; a split's last tile, where it
//     holds fewer than `tile` positions (the visible range's ragged end),
//     is loaded row by row with 1-d bulk copies, so no position outside
//     the visible range is read.  Every shape the launcher takes goes
//     through TMA (rows of hd * sizeof(T) bytes, a multiple of 16; hd 120
//     and 112 included).
//   * Waves.  The first version's grid had 544 blocks at gemma3's shape,
//     4.12 per SM: its last wave ran part-empty; and its splits were cut
//     from [0, S), so a short cache_len or window left most of them
//     empty.  Here the kernel cuts the visible range of each (row, kv
//     head) into the same n_split splits of whole tiles, one block each.
//     n_split comes from the shapes and the card alone (kernel.py:
//     layout, from the SM count and the resident blocks per SM that
//     decode_attention_occupancy reports): the grid fills whole waves of
//     at most two blocks an SM as nearly as splits allow, 8 splits and
//     256 blocks at gemma3's B = 4, Hk = 8, two on every SM but 8.  A
//     block on an SM that holds more blocks than others streams slower
//     and finishes last; with the same split boundaries in every segment
//     the blocks of a row's 8 kv heads read the same 4 KB cache rows at
//     about the same time.
//   * The combine.  Each split's block writes its (acc, m, l) partial,
//     then takes a ticket from its (row, kv head)'s int32 counter
//     (__threadfence, atomicAdd); the block that arrives last merges the
//     partials with the log-sum-exp combine, writes the output and resets
//     the counter to 0.  The counters live in a zeroed buffer that the
//     wrapper keeps per device and stream, so no memset is issued per
//     call.  With one split a block writes the output directly.  One
//     launch per call.
//
// Consumers: 4 warps, each half-warp taking positions half, half + 8, ...
// of a tile, its 16 lanes reading the k and v rows from shared memory in
// 16-byte vectors (NV per lane: hd * sizeof(T) <= 16 * 16 NV); q of the G
// heads of the kv head sits in registers; a dot is reduced with four
// shuffles; each half-warp keeps its own online softmax (m, l, acc)
// rescaled once per tile, merged with its partner by shuffles and across
// the warps in shared memory at the end of the split.
//
// Tried on the card and dropped.  Split counts (tools/decode_splits.py,
// gemma3's bf16 row on an H100, in PERF.md): 12 splits at three
// blocks an SM (0.359 ms against 8's 0.349); 6, 7 or 10, which leave SMs
// with one block beside SMs with two or three (0.375-0.388); 4 at one
// block an SM (0.347, but 1.4x slower at granite's shape and 1.3x at the
// ring's).  In throwaway design calls, whose numbers are not kept: one
// persistent wave walking equal chunks of the flattened (row, kv head,
// tile) list (slower: its chunks start at other positions in every kv
// head), 3 or 6 stages (no faster), 32-position tiles in 32 KB stages
// (slower), no L2 promotion in the tensor map (no change).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tma.cuh"           // mbarriers and the tensor-map encoder

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;         // + one producer warp
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;                // k tile, then v tile
constexpr int kHalfStage = kStageBytes / 2;
constexpr int kLanesPerKey = 16;
// half-warps of the consumers: the positions of a tile taken in one step
constexpr int kHalves = kConsumers / kLanesPerKey;
constexpr int kHdMax = 256;
constexpr int kGroupMax = 8;
constexpr int kMergeBar = 1;      // named barrier of the consumer warps
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// A variant of the kernel: T, at most G query heads per kv head, NV
// 16-byte vectors of a row per lane.
template <typename T, int G, int NV>
struct Config {
  static constexpr int kN = Vec16<T>::kN;
  static constexpr int kE = NV * kN;              // elements a lane holds
  static constexpr int kHd = kLanesPerKey * kE;   // widest row taken
  static constexpr int kTile = 32 / NV;           // positions of a stage
  static constexpr int kU = kTile / kHalves;      // of them, a half-warp's
  // blocks an SM should hold: the two of the layout (kernel.py:
  // MAX_BLOCKS_PER_SM; 204 registers a thread) where q and acc take at
  // most 128 (2 G kE), else one
  static constexpr int kMinBlocks = 2 * G * kE <= 128 ? 2 : 1;
  // shared memory: the ring, the warps' (acc, m, l) for the merge, the
  // stages' full and empty mbarriers, the last-block flag; + slack to
  // align the base to 128 bytes
  static constexpr int kAccOff = kStages * kStageBytes;
  static constexpr int kMOff = kAccOff + kConsumerWarps * G * kHd * 4;
  static constexpr int kLOff = kMOff + kConsumerWarps * G * 4;
  static constexpr int kBarOff = (kLOff + kConsumerWarps * G * 4 + 7) & ~7;
  static constexpr int kFlagOff = kBarOff + 2 * kStages * 8;
  static constexpr int kBytes = kFlagOff + 16 + 128;
  static_assert(kTile * kHd * static_cast<int>(sizeof(T)) <= kHalfStage,
                "a tile of k rows must fit half a stage");
};

// The work layout (kernel.py: layout): the visible range of every (row,
// kv head) segment, cut into tiles of `tile` positions from its first
// position (the last tile ragged), is cut at the same tiles into n_split
// splits, the first ones a tile longer where the tiles do not divide;
// block seg * n_split + split takes one split of one segment.
struct Work {
  int s, hq, hk, hd, tile, n_split;
};

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int stage) {
  return bars + 8 * stage;
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int stage) {
  return bars + 8 * (kStages + stage);
}
__device__ __forceinline__ void merge_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kMergeBar), "n"(kConsumers)
               : "memory");
}

// one box of `map` at (column, row) into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// `bytes` (a multiple of 16) from src into dst, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The positions [a, e) of split `split` of the visible range [lo, hi) of
// every segment; empty where e <= a.
struct Span {
  int a, e;
};
__device__ __forceinline__ Span split_span(const Work& w, int split, int lo,
                                           int hi) {
  const int tiles = (max(hi - lo, 0) + w.tile - 1) / w.tile;
  const int base = tiles / w.n_split, rem = tiles % w.n_split;
  const int t0 = split * base + min(split, rem);
  const int t1 = t0 + base + (split < rem ? 1 : 0);
  return {lo + t0 * w.tile, min(lo + t1 * w.tile, hi)};
}

// The producer: one thread issuing every load of the block's split, tile
// by tile, into the ring.
template <typename T, int G, int NV>
__device__ void produce(const Work& w, const CUtensorMap* k_map,
                        const CUtensorMap* v_map, const T* k, const T* v,
                        uint32_t ring, uint32_t bars, int b, int h, Span pc) {
  using C = Config<T, G, NV>;
  const int row_bytes = w.hd * static_cast<int>(sizeof(T));
  int stage = 0;
  uint32_t phase = 0;
  for (int p0 = pc.a; p0 < pc.e; p0 += C::kTile) {
    const int rows = min(C::kTile, pc.e - p0);
    const uint32_t full = full_bar(bars, stage);
    const uint32_t dst = ring + stage * kStageBytes;
    const int row0 = b * w.s + p0;
    mbar_wait(empty_bar(bars, stage), phase ^ 1);
    mbar_expect_tx(full, 2 * rows * row_bytes);
    if (rows == C::kTile) {
      tma_load_2d(dst, k_map, full, h * w.hd, row0);
      tma_load_2d(dst + kHalfStage, v_map, full, h * w.hd, row0);
    } else {
      for (int r = 0; r < rows; ++r) {
        const size_t off = (static_cast<size_t>(row0 + r) * w.hk + h) * w.hd;
        bulk_load(dst + r * row_bytes, k + off, row_bytes, full);
        bulk_load(dst + kHalfStage + r * row_bytes, v + off, row_bytes, full);
      }
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// One tile of `rows` positions in shared memory (k rows at kt, v rows at
// vt, row_bytes apart) into a half-warp's online softmax: positions half,
// half + kHalves, ... of the tile.  Every lane runs every shuffle; a
// position past `rows` is never read and updates nothing.
template <typename T, int G, int NV>
__device__ __forceinline__ void tile_step(
    const unsigned char* kt, const unsigned char* vt, int rows, int row_bytes,
    int half, int sub, int nvec, const float (&qr)[G][Config<T, G, NV>::kE],
    float (&m)[G], float (&l)[G], float (&acc)[G][Config<T, G, NV>::kE]) {
  using C = Config<T, G, NV>;
  constexpr int kU = C::kU, kE = C::kE, kN = C::kN;
  uint4 kr[kU][NV], vr[kU][NV];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int r = half + kHalves * u;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = sub + kLanesPerKey * i;
      if (r < rows && vi < nvec) {
        kr[u][i] = *reinterpret_cast<const uint4*>(kt + r * row_bytes +
                                                   vi * 16);
        vr[u][i] = *reinterpret_cast<const uint4*>(vt + r * row_bytes +
                                                   vi * 16);
      } else {
        kr[u][i] = vr[u][i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  float sc[kU][G];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    float kx[kE];
#pragma unroll
    for (int i = 0; i < NV; ++i) Vec16<T>::unpack(kr[u][i], &kx[i * kN]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.0f;
#pragma unroll
      for (int e = 0; e < kE; ++e) d = fmaf(qr[g][e], kx[e], d);
      sc[u][g] = d;
    }
  }
#pragma unroll
  for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
        sc[u][g] += __shfl_xor_sync(kFull, sc[u][g], off);
  float p[kU][G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float m_new = m[g];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (half + kHalves * u < rows) m_new = fmaxf(m_new, sc[u][g]);
    const float corr = expf(m[g] - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      p[u][g] = half + kHalves * u < rows ? expf(sc[u][g] - m_new) : 0.0f;
      sum += p[u][g];
    }
    l[g] = l[g] * corr + sum;
    m[g] = m_new;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] *= corr;
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    float vx[kE];
#pragma unroll
    for (int i = 0; i < NV; ++i) Vec16<T>::unpack(vr[u][i], &vx[i * kN]);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(p[u][g], vx[e], acc[g][e]);
  }
}

// One block: a producer warp and kConsumerWarps consumer warps over one
// split of one (row, kv head) segment.  part holds per (segment, split)
// the partial acc[group][hd], m[group], l[group]; tickets one int32 per
// segment, 0 between launches.
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kThreads, Config<T, G, NV>::kMinBlocks)
decode_attention_kernel(const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ tickets,
                        const int* __restrict__ cache_len_p,
                        const int* __restrict__ window_p, Work w,
                        float scale) {
  using C = Config<T, G, NV>;
  constexpr int kE = C::kE, kN = C::kN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 127u) & ~127u;
  unsigned char* smem = smem_raw + (ring - raw);
  float* sm_acc = reinterpret_cast<float*>(smem + C::kAccOff);
  float* sm_m = reinterpret_cast<float*>(smem + C::kMOff);
  float* sm_l = reinterpret_cast<float*>(smem + C::kLOff);
  int* sm_flag = reinterpret_cast<int*>(smem + C::kFlagOff);
  const uint32_t bars = ring + C::kBarOff;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int seg = blockIdx.x / w.n_split;
  const int split = blockIdx.x - seg * w.n_split;
  const int b = seg / w.hk, h = seg - b * w.hk;
  // the visible range (64-bit: window may be large), cut to this split
  const long long cache_len = *cache_len_p, window = *window_p;
  const Span pc = split_span(
      w, split,
      static_cast<int>(min(max(cache_len - window, 0LL),
                           static_cast<long long>(w.s))),
      static_cast<int>(max(min(cache_len, static_cast<long long>(w.s)),
                           0LL)));

  if (warp == kConsumerWarps) {
    if (lane == 0)
      produce<T, G, NV>(w, &k_map, &v_map, k, v, ring, bars, b, h, pc);
    return;
  }

  const int group = w.hq / w.hk;
  const int hd = w.hd;
  const int row_bytes = hd * static_cast<int>(sizeof(T));
  const int nvec = hd / kN;
  const int sub = lane & (kLanesPerKey - 1);     // lane within the half-warp
  const int half = tid / kLanesPerKey;           // half-warp of the block

  float qr[G][kE];
  const T* q_row = q + (static_cast<size_t>(b) * w.hq + h * group) * hd;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = sub + kLanesPerKey * i;
      if (g < group && vi < nvec) {
        Vec16<T>::unpack(
            *reinterpret_cast<const uint4*>(q_row + g * hd + vi * kN),
            &qr[g][i * kN]);
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

  int stage = 0;
  uint32_t phase = 0;
  for (int p0 = pc.a; p0 < pc.e; p0 += C::kTile) {
    const unsigned char* kt = smem + stage * kStageBytes;
    mbar_wait(full_bar(bars, stage), phase);
    tile_step<T, G, NV>(kt, kt + kHalfStage, min(C::kTile, pc.e - p0),
                        row_bytes, half, sub, nvec, qr, m, l, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(bars, stage));
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // merge the two half-warps of each warp (lanes i and i + 16 hold the
  // same elements of different positions), then the warps in shared memory
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
            sm_acc[(warp * G + g) * C::kHd + vi * kN + j] = acc[g][i * kN + j];
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
  merge_sync();

  // this split's (acc, m, l) per head of the group; with one split, the
  // output itself
  T* out_row = out + (static_cast<size_t>(b) * w.hq + h * group) * hd;
  const size_t stride = static_cast<size_t>(group) * (hd + 2);
  float* dst = part + static_cast<size_t>(blockIdx.x) * stride;
  for (int idx = tid; idx < group * hd; idx += kConsumers) {
    const int g = idx / hd, d = idx - g * hd;
    float m_t = kNegInf;
#pragma unroll
    for (int i = 0; i < kConsumerWarps; ++i) m_t = fmaxf(m_t, sm_m[i * G + g]);
    float a = 0.0f, l_t = 0.0f;
#pragma unroll
    for (int i = 0; i < kConsumerWarps; ++i) {
      const float c = expf(sm_m[i * G + g] - m_t);
      a += sm_acc[(i * G + g) * C::kHd + d] * c;
      l_t += sm_l[i * G + g] * c;
    }
    if (w.n_split == 1) {
      store(out_row + idx, a / fmaxf(l_t, 1e-30f));
    } else {
      dst[idx] = a;
      if (d == 0) {
        dst[group * hd + g] = m_t;
        dst[group * hd + group + g] = l_t;
      }
    }
  }
  if (w.n_split == 1) return;

  // the last of the segment's splits to arrive merges the partials
  __threadfence();
  merge_sync();
  if (tid == 0)
    *sm_flag = atomicAdd(&tickets[seg], 1) == w.n_split - 1;
  merge_sync();
  if (!*sm_flag) return;
  __threadfence();
  const float* src = part + static_cast<size_t>(seg) * w.n_split * stride;
  for (int idx = tid; idx < group * hd; idx += kConsumers) {
    const int g = idx / hd;
    float m_t = kNegInf;
    // unrolled, so that the splits' loads are in flight together
#pragma unroll 8
    for (int sp = 0; sp < w.n_split; ++sp)
      m_t = fmaxf(m_t, __ldcg(src + sp * stride + group * hd + g));
    float a = 0.0f, l_t = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < w.n_split; ++sp) {
      const float* ps = src + sp * stride;
      const float c = expf(__ldcg(ps + group * hd + g) - m_t);
      a += __ldcg(ps + idx) * c;
      l_t += __ldcg(ps + group * hd + group + g) * c;
    }
    store(out_row + idx, a / fmaxf(l_t, 1e-30f));
  }
  if (tid == 0) tickets[seg] = 0;
}

// A 2-d map over a contiguous (rows, cols) cache of T, in boxes of
// box_cols x box_rows, no swizzle; rows past the end read as 0
template <typename T>
bool make_map(CUtensorMap* map, const void* base, long long rows, int cols,
              int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return tensor_map_encode()(
             map,
             sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct LaunchArgs {
  const void *q, *k, *v;
  void *out, *part, *tickets;
  const void *cache_len, *window;
  int b;
  Work w;
  cudaStream_t stream;
};

// The two things done with a variant, each a functor over <T, G, NV>
struct Launch {
  const LaunchArgs& a;
  template <typename T, int G, int NV>
  int run() const {
    using C = Config<T, G, NV>;
    if (a.w.tile != C::kTile) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap k_map, v_map;
    const long long rows = static_cast<long long>(a.b) * a.w.s;
    const int cols = a.w.hk * a.w.hd;
    if (!make_map<T>(&k_map, a.k, rows, cols, a.w.hd, C::kTile) ||
        !make_map<T>(&v_map, a.v, rows, cols, a.w.hd, C::kTile))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, G, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_attention_kernel<T, G, NV>
        <<<a.b * a.w.hk * a.w.n_split, kThreads, C::kBytes, a.stream>>>(
            k_map, v_map, static_cast<const T*>(a.q),
            static_cast<const T*>(a.k), static_cast<const T*>(a.v),
            static_cast<T*>(a.out), static_cast<float*>(a.part),
            static_cast<int*>(a.tickets),
            static_cast<const int*>(a.cache_len),
            static_cast<const int*>(a.window), a.w,
            static_cast<float>(1.0 / sqrt(static_cast<double>(a.w.hd))));
    return static_cast<int>(cudaGetLastError());
  }
};

struct Occupancy {
  int* info;
  template <typename T, int G, int NV>
  int run() const {
    using C = Config<T, G, NV>;
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, G, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    cudaFuncAttributes attr{};
    int device = 0;
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, decode_attention_kernel<T, G, NV>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &info[1], decode_attention_kernel<T, G, NV>, kThreads, C::kBytes);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&info[2], cudaDevAttrMultiProcessorCount,
                                   device);
    info[0] = attr.numRegs;
    info[3] = C::kTile;
    return static_cast<int>(err);
  }
};

template <typename T, int G, typename Op>
int with_nv(int nv, const Op& op) {
  if (nv <= 1) return op.template run<T, G, 1>();
  if (nv <= 2) return op.template run<T, G, 2>();
  return op.template run<T, G, 4>();
}

template <typename T, typename Op>
int with_variant(int group, int nv, const Op& op) {
  if (group <= 1) return with_nv<T, 1>(nv, op);
  if (group <= 2) return with_nv<T, 2>(nv, op);
  if (group <= 4) return with_nv<T, 4>(nv, op);
  return with_nv<T, kGroupMax>(nv, op);
}

// the variant for (dtype, hd, group): NV from the 16-byte vectors of a row
template <typename Op>
int dispatch(int dtype, int hd, int group, const Op& op) {
  const int nvec = hd * (dtype == 0 ? 4 : 2) / 16;
  const int nv = (nvec + kLanesPerKey - 1) / kLanesPerKey;
  return dtype == 0 ? with_variant<float>(group, nv, op)
                    : with_variant<__nv_bfloat16>(group, nv, op);
}

bool shape_ok(int dtype, int hd, int hq, int hk) {
  const int elem = dtype == 0 ? 4 : 2;
  return (dtype == 0 || dtype == 1) && hd >= 1 && hd <= kHdMax &&
         (hd * elem) % 16 == 0 && hk >= 1 && hq >= hk && hq % hk == 0 &&
         hq / hk <= kGroupMax;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// What the wrapper needs to lay out a launch, for the variant that takes
// (dtype, hd, hq / hk) on the current device: info[0] registers per
// thread, [1] resident blocks per SM, [2] the device's SMs, [3]
// positions per tile.  Returns the
// cudaError_t of the queries; cudaErrorInvalidValue for a shape that
// decode_attention_launch does not take.
extern "C" int decode_attention_occupancy(int dtype, int hd, int hq, int hk,
                                          int* info) {
  if (!shape_ok(dtype, hd, hq, hk))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, hd, hq / hk, Occupancy{info});
}

// q (b, 1, hq, hd), k/v (b, s, hk, hd), out (b, 1, hq, hd), contiguous on
// the device in one dtype (0 = fp32, 1 = bf16), 16-byte aligned; cache_len
// and window: one int32 each on the device.  The layout (kernel.py:
// layout): `tile` positions per tile (info[3] of decode_attention_
// occupancy), each (row, kv head)'s visible range cut into n_split
// splits of whole tiles, one block each (n_split at most ceil(s /
// tile)); part: fp32 scratch of b hk n_split
// (hq / hk) (hd + 2) floats (unused at n_split 1); tickets: b hk int32 on
// the device, all 0, left 0.
// Returns the launch's cudaError_t (0 = launched); cudaErrorInvalidValue,
// without launching, for what the kernel does not take: hd outside [1,
// 256] or hd * sizeof(dtype) not a multiple of 16, hk < 1 or hq not a
// multiple of hk, more than 8 query heads per kv head, b s of 2^31 or
// more, a layout other than the one above, q/k/v not 16-byte aligned, or
// another dtype; cudaErrorNotSupported where libcuda has no
// cuTensorMapEncodeTiled.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* out, void* part,
                                       void* tickets, const void* cache_len,
                                       const void* window, int b, int s,
                                       int hq, int hk, int hd, int tile,
                                       int n_split, int dtype, void* stream) {
  if (!shape_ok(dtype, hd, hq, hk) || b < 0 || s < 0 ||
      static_cast<long long>(b) * s >= (1LL << 31) || tile < 1 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s == 0)      // nothing to see: every row comes out 0 (and a tensor
    return static_cast<int>(cudaMemsetAsync(      // map takes no empty
        out, 0, static_cast<size_t>(b) * hq * hd * (dtype == 0 ? 4 : 2),
        st));                                     // dimension)
  if (n_split < 1 || n_split > (s + tile - 1) / tile ||
      static_cast<long long>(b) * hk * n_split > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tensor_map_encode() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  const LaunchArgs args{q, k, v, out, part, tickets, cache_len, window, b,
                        Work{s, hq, hk, hd, tile, n_split}, st};
  return dispatch(dtype, hd, hq / hk, Launch{args});
}

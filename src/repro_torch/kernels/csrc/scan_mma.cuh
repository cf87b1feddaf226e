// Helpers shared by the chunked scan kernels (mamba2.cu, rwkv6.cu): bf16
// tensor-core products by mma.sync m16n8k16 with fp32 accumulation, fp32
// operands carried as bf16 parts, fragment loads from shared memory, and
// cp.async copies into a ring of shared-memory stages.  Everything
// here has internal linkage, so each source that includes it gets its own
// copy.
//
// Fragments of mma.sync.m16n8k16.row.col (bf16 in, fp32 out), for lane
// = 4 g + q (g = lane / 4, q = lane % 4):
//   A (16 x 16, rows m, columns k): a0 = (g, 2q..2q+1), a1 = (g+8, 2q..),
//     a2 = (g, 2q+8..2q+9), a3 = (g+8, 2q+8..), the lower column in the
//     low half of each register;
//   B (16 x 8, rows k, columns n): b0 = (2q..2q+1, g), b1 = (2q+8.., g);
//   C (16 x 8): c0, c1 = (g, 2q..2q+1), c2, c3 = (g+8, 2q..2q+1).
// So the accumulators of two neighbouring n-tiles, 16 columns, are the A
// fragment of a 16-deep k-step as they stand.
//
// An fp32 operand x goes in as bf16 parts: hi = bf16(x), lo = bf16(x -
// hi) (x - hi is exact in fp32, and |x - hi - lo| <= 2^-18 |x|), and for
// fp32 inputs a third part of what is left.  A product of operands in
// parts sums the products of their parts down to the size of the last
// part.  An operand that is bf16 already goes in as it is.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_info.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// two bf16 in one register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two neighbouring outputs of type T
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) =
      pack_bf16(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
}

// A pair of neighbouring operand values (one register of a fragment) as
// kN bf16 parts whose sum is the pair: kN = 1 for an operand that is
// bf16 already; an fp32 value x as hi = bf16(x), then bf16 of what is
// left, and so on.  Two parts carry x to about 2^-17, three to fp32's
// 2^-24.
template <int kN>
struct Parts {
  uint32_t r[kN];
};

template <int kN>
__device__ __forceinline__ Parts<kN> split2(float x0, float x1) {
  Parts<kN> o;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
    const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
    o.r[i] = pack_bf16(h0, h1);
    x0 -= __bfloat162float(h0);
    x1 -= __bfloat162float(h1);
  }
  return o;
}

// The parts an input operand of type T goes in as: bf16 as it is, fp32 in
// three parts (the fp32 kernels hold every operand to fp32's accuracy).
template <typename T>
struct In {
  static constexpr int kN = 3;
};
template <>
struct In<__nv_bfloat16> {
  static constexpr int kN = 1;
};

// p[0], p[1] (neighbours in a row)
__device__ __forceinline__ Parts<3> pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return split2<3>(v.x, v.y);
}
// p[0], p[stride] (neighbours in a column)
__device__ __forceinline__ Parts<3> pair_strided(const float* p,
                                                 int stride) {
  return split2<3>(p[0], p[stride]);
}

template <int kN>
struct FragA {
  uint32_t r[kN][4];
  __device__ __forceinline__ void set(int i, const Parts<kN>& p) {
#pragma unroll
    for (int n = 0; n < kN; ++n) r[n][i] = p.r[n];
  }
};
template <int kN>
struct FragB {
  uint32_t r[kN][2];
  __device__ __forceinline__ void set(int i, const Parts<kN>& p) {
#pragma unroll
    for (int n = 0; n < kN; ++n) r[n][i] = p.r[n];
  }
};

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b over the parts: part i of a times part j of b where i + j <
// max(kNA, kNB), the larger terms first (two parts each: hi hi, hi lo,
// lo hi; lo lo, at most 2^-16 of |a b|, is left out)
template <int kNA, int kNB>
__device__ __forceinline__ void mma_parts(float (&d)[4], const FragA<kNA>& a,
                                          const FragB<kNB>& b) {
  constexpr int kTerms = kNA > kNB ? kNA : kNB;
#pragma unroll
  for (int sum = 0; sum < kTerms; ++sum)
#pragma unroll
    for (int i = 0; i < kNA; ++i) {
      const int jb = sum - i;
      if (jb >= 0 && jb < kNB) mma16816(d, a.r[i], b.r[jb][0], b.r[jb][1]);
    }
}

// An A fragment from a row-major fp32 matrix in shared memory (rows m,
// columns k; row stride ld floats), in kN parts.
template <int kN>
__device__ __forceinline__ FragA<kN> frag_a_f32(const float* base, int ld,
                                                int lane) {
  const int g = lane >> 2, q = lane & 3;
  const float* p0 = base + g * ld + 2 * q;
  const float* p1 = p0 + 8 * ld;
  const float2 v0 = *reinterpret_cast<const float2*>(p0);
  const float2 v1 = *reinterpret_cast<const float2*>(p1);
  const float2 v2 = *reinterpret_cast<const float2*>(p0 + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p1 + 8);
  FragA<kN> a;
  a.set(0, split2<kN>(v0.x, v0.y));
  a.set(1, split2<kN>(v1.x, v1.y));
  a.set(2, split2<kN>(v2.x, v2.y));
  a.set(3, split2<kN>(v3.x, v3.y));
  return a;
}

// ---- fragment loads from shared memory --------------------------------
// bf16 operands come by ldmatrix: each lane gives the address of one
// 16-byte row of an 8 x 8 matrix (lanes 8 m .. 8 m + 7 the rows of matrix
// m), and receives its fragment registers; .trans gives the transposed
// matrices.  Rows must be 16-byte aligned; rows that fall in distinct
// 16-byte groups of a 128-byte line (row strides of 16 mod 128 bytes, or
// 48, 80, ...) load without bank conflicts.  fp32 operands are read as
// values and split.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// An A fragment of a row-major matrix of the input type (rows m, columns
// k, row stride ld elements) at `base`.
__device__ __forceinline__ FragA<1> frag_a(const __nv_bfloat16* base, int ld,
                                           int lane) {
  FragA<1> a;
  ldsm_x4(a.r[0], base + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
                      8 * (lane >> 4));
  return a;
}
__device__ __forceinline__ FragA<3> frag_a(const float* base, int ld,
                                           int lane) {
  return frag_a_f32<3>(base, ld, lane);
}

// A B fragment of a matrix of the input type stored by columns (row n
// holds the 16 k values of column n; row stride ld elements).
__device__ __forceinline__ FragB<1> frag_b_cols(const __nv_bfloat16* base,
                                                int ld, int lane) {
  FragB<1> b;
  ldsm_x2(b.r[0], base + (lane & 7) * ld + 8 * ((lane >> 3) & 1));
  return b;
}
__device__ __forceinline__ FragB<3> frag_b_cols(const float* base, int ld,
                                                int lane) {
  const int g = lane >> 2, q = lane & 3;
  const float* p = base + g * ld + 2 * q;
  FragB<3> b;
  b.set(0, pair(p));
  b.set(1, pair(p + 8));
  return b;
}

// A B fragment of a row-major matrix of the input type (rows k, columns
// n; row stride ld elements).
__device__ __forceinline__ FragB<1> frag_b_rows(const __nv_bfloat16* base,
                                                int ld, int lane) {
  FragB<1> b;
  ldsm_x2_t(b.r[0], base + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld);
  return b;
}
__device__ __forceinline__ FragB<3> frag_b_rows(const float* base, int ld,
                                                int lane) {
  const int g = lane >> 2, q = lane & 3;
  const float* p = base + 2 * q * ld + g;
  FragB<3> b;
  b.set(0, pair_strided(p, ld));
  b.set(1, pair_strided(p + 8 * ld, ld));
  return b;
}
// the B fragments of two neighbouring n-tiles (columns n .. n + 15)
__device__ __forceinline__ void frag_b_rows2(const __nv_bfloat16* base,
                                             int ld, int lane, FragB<1>& b0,
                                             FragB<1>& b1) {
  uint32_t r[4];
  ldsm_x4_t(r, base + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
                   8 * (lane >> 4));
  b0.r[0][0] = r[0];
  b0.r[0][1] = r[1];
  b1.r[0][0] = r[2];
  b1.r[0][1] = r[3];
}
__device__ __forceinline__ void frag_b_rows2(const float* base, int ld,
                                             int lane, FragB<3>& b0,
                                             FragB<3>& b1) {
  b0 = frag_b_rows(base, ld, lane);
  b1 = frag_b_rows(base + 8, ld, lane);
}

// The A fragment of the transpose of a row-major matrix of type T (stored
// rows k, columns m; row stride ld elements) as fp32 values: v[i] is the
// pair of register i (a0 .. a3), for the caller to scale and split.
__device__ __forceinline__ void load_at(const __nv_bfloat16* base, int ld,
                                        int lane, float (&v)[4][2]) {
  uint32_t r[4];
  ldsm_x4_t(r, base + ((lane & 7) + 8 * (lane >> 4)) * ld +
                   8 * ((lane >> 3) & 1));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i][0] = __uint_as_float(r[i] << 16);
    v[i][1] = __uint_as_float(r[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_at(const float* base, int ld, int lane,
                                        float (&v)[4][2]) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = base + (2 * q + 8 * (i >> 1)) * ld + g + 8 * (i & 1);
    v[i][0] = p[0];
    v[i][1] = p[ld];
  }
}

// fp32 values split once into bf16 parts and read often as operands (M
// and att, the states), `rows` x ld elements at 4 bytes an element.  For
// bf16 inputs: two planes of bf16, hi then lo (two parts, read by
// ldmatrix); for fp32 inputs: the fp32 values, split in three on each
// read.
template <typename T>
struct Store {
  static constexpr int kN = 2;
  __device__ __forceinline__ static void put2(void* base, int rows, int ld,
                                              int r, int c, float v0,
                                              float v1) {
    const Parts<2> p = split2<2>(v0, v1);
    uint32_t* hi = reinterpret_cast<uint32_t*>(
        static_cast<__nv_bfloat16*>(base) + r * ld + c);
    hi[0] = p.r[0];
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(base) +
                                 rows * ld + r * ld + c) = p.r[1];
  }
  __device__ __forceinline__ static void put(void* base, int rows, int ld,
                                             int r, int c, float v) {
    __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(base);
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    hi[r * ld + c] = h;
    hi[rows * ld + r * ld + c] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
  // the A fragment of rows m0 .., columns k0 .. (row-major)
  __device__ __forceinline__ static FragA<2> frag_a(const void* base,
                                                    int rows, int ld, int m0,
                                                    int k0, int lane) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(base) +
                             (m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
                             k0 + 8 * (lane >> 4);
    FragA<2> a;
    ldsm_x4(a.r[0], p);
    ldsm_x4(a.r[1], p + rows * ld);
    return a;
  }
  // the B fragment of columns n0 .. n0 + 7 and k0 .. k0 + 15, stored by
  // columns (row n holds the k values)
  __device__ __forceinline__ static FragB<2> frag_b(const void* base,
                                                    int rows, int ld, int n0,
                                                    int k0, int lane) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(base) +
                             (lane >> 4) * rows * ld +
                             (n0 + (lane & 7)) * ld + k0 +
                             8 * ((lane >> 3) & 1);
    uint32_t r[4];
    ldsm_x4(r, p);
    FragB<2> b;
    b.r[0][0] = r[0];
    b.r[0][1] = r[1];
    b.r[1][0] = r[2];
    b.r[1][1] = r[3];
    return b;
  }
};
template <>
struct Store<float> {
  static constexpr int kN = 3;
  __device__ __forceinline__ static void put2(void* base, int, int ld, int r,
                                              int c, float v0, float v1) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + r * ld + c) =
        make_float2(v0, v1);
  }
  __device__ __forceinline__ static void put(void* base, int, int ld, int r,
                                             int c, float v) {
    static_cast<float*>(base)[r * ld + c] = v;
  }
  __device__ __forceinline__ static FragA<3> frag_a(const void* base, int,
                                                    int ld, int m0, int k0,
                                                    int lane) {
    return frag_a_f32<3>(static_cast<const float*>(base) + m0 * ld + k0, ld,
                         lane);
  }
  __device__ __forceinline__ static FragB<3> frag_b(const void* base, int,
                                                    int ld, int n0, int k0,
                                                    int lane) {
    return frag_b_cols(static_cast<const float*>(base) + n0 * ld + k0, ld,
                       lane);
  }
};

// a barrier of the block's first `threads` threads (id 1; __syncthreads
// is id 0)
__device__ __forceinline__ void sync_first(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// ---- cp.async into shared memory -------------------------------------
// A copy with valid false reads nothing and fills its bytes with zeros;
// its global address is still a valid one (the caller passes the base).

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies `rows` rows of `row_bytes` bytes (a multiple of 16) from global
// rows `gstride` bytes apart into shared rows `sstride` bytes apart, by
// the block's `nthreads` threads; rows at or past `valid` are zeros.
__device__ __forceinline__ void copy_rows(char* dst, int sstride,
                                          const char* src, size_t gstride,
                                          int rows, int row_bytes, int valid,
                                          int tid, int nthreads) {
  const int per_row = row_bytes / 16;
  for (int i = tid; i < rows * per_row; i += nthreads) {
    const int r = i / per_row, c = (i - r * per_row) * 16;
    const bool ok = r < valid;
    cp_async16(dst + r * sstride + c,
               ok ? src + r * gstride + c : src, ok);
  }
}

}  // namespace

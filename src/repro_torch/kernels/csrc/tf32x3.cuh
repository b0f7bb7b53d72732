// tf32x3.cuh: f32 products on the tensor cores in 3xTF32
// (mma.sync.m16n8k8), shared by flash_prefill.cu's non-causal mode and
// flash_prefill_bwd.cu.
//
// Each f32 operand x is split into hi, x's TF32 bits (the 13 mantissa bits
// below TF32's 10 cleared), and lo = x - hi (exact in f32), whose TF32 bits
// the tensor core reads; a product is lo*hi + hi*lo + hi*hi accumulated in
// f32. One TF32 product keeps about 2^-10 of |a||b| and is never taken.
// hi is taken one of two ways (RN):
//  * truncated (the backward; its bits are pinned by its tests): lo < 2^-10
//    |x| has x's sign, so reading lo as TF32 and dropping lo*lo shrink each
//    product by about 2^-21 on average, up to 2^-20;
//  * rounded to nearest (the forward): lo < 2^-11 |x| and of either sign, so
//    the dropped terms are under 2^-22 of |a||b| and carry no bias. The
//    forward's LSE (held within 1e-5) follows its largest scores, and a
//    bias of 2^-21 in every product moves a score of 10 by 5e-6.
// The tensor core truncates as it adds into its accumulator, so a long
// chain of products into one register drifts toward zero; mma3_add<true>
// and add_product sum a short chain from zero and add it in f32 (rounded).
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x -> hi + lo (see above): RN rounds hi to nearest (half away from zero,
// by carrying into bit 12), else truncates
template <bool RN = false>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (RN)
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  else
    hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (16 x 8) split in two, and a B fragment (8 x 8)
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// c += a b; with FRESH the product is summed from zero on the tensor
// cores and then added to c in f32
template <bool FRESH>
__device__ __forceinline__ void mma3_add(float (&c)[4], const FragA& a,
                                         const FragB& b) {
  if constexpr (FRESH) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma3(t, a, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += t[e];
  } else {
    mma3(c, a, b);
  }
}

// Fragment loads from a row-major tile of stride R (f32 or bf16 elements);
// lane = 4 g + t. A (m16 x k8) at rows r0 + {g, g + 8}, cols c0 + {t, t + 4}
template <int R, bool RN = false, typename T>
__device__ __forceinline__ void load_a(FragA& f, const T* tile, int r0,
                                       int c0, int g, int t) {
  const T* p = tile + (r0 + g) * R + c0 + t;
  split<RN>(to_f(p[0]), f.hi[0], f.lo[0]);
  split<RN>(to_f(p[8 * R]), f.hi[1], f.lo[1]);
  split<RN>(to_f(p[4]), f.hi[2], f.lo[2]);
  split<RN>(to_f(p[8 * R + 4]), f.hi[3], f.lo[3]);
}

// B (k8 x n8) = T^T: B[k][n] = T[n0 + n][c0 + k], at n = g, k = t, t + 4
template <int R, bool RN = false, typename T>
__device__ __forceinline__ void load_b_t(FragB& f, const T* tile, int n0,
                                         int c0, int g, int t) {
  const T* p = tile + (n0 + g) * R + c0 + t;
  split<RN>(to_f(p[0]), f.hi[0], f.lo[0]);
  split<RN>(to_f(p[4]), f.hi[1], f.lo[1]);
}

// B (k8 x n8) = T rows r0.. in the order of an accumulator turned A
// fragment: k = t is row r0 + 2t, k = t + 4 is row r0 + 2t + 1; n = g
template <int R, bool RN = false, typename T>
__device__ __forceinline__ void load_b_rows(FragB& f, const T* tile,
                                            int r0, int c0, int g, int t) {
  const T* p = tile + (r0 + 2 * t) * R + c0 + g;
  split<RN>(to_f(p[0]), f.hi[0], f.lo[0]);
  split<RN>(to_f(p[R]), f.hi[1], f.lo[1]);
}

// The m16n8 accumulator (rows g, g + 8; cols 2t, 2t + 1) as the A
// fragment of a product over its columns (see load_b_rows)
template <bool RN = false>
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&c)[4]) {
  split<RN>(c[0], f.hi[0], f.lo[0]);
  split<RN>(c[2], f.hi[1], f.lo[1]);
  split<RN>(c[1], f.hi[2], f.lo[2]);
  split<RN>(c[3], f.hi[3], f.lo[3]);
}

// acc (16 x HD) += A B for one streamed tile, A (16 x 8 NT) the
// accumulator tiles `a` of S^T-like products (see acc_to_a), B = rows
// [0, 8 NT) of the tile T (stride R). The tile's sum is taken from zero
// on the tensor cores (a chain of 3 NT products into each output) and
// then added to acc in f32: a long chain of tensor-core sums drifts (each
// add truncates the running sum), an f32 add rounds.
template <int HD, int NT, int R = HD + 4, bool RN = false, typename T>
__device__ __forceinline__ void add_product(float (&acc)[HD / 8][4],
                                            const float (&a)[NT][4],
                                            const T* tile, int g, int t) {
  constexpr int NC = HD / 8 < 8 ? HD / 8 : 8;   // output n-tiles at once
#pragma unroll
  for (int c0 = 0; c0 < HD / 8; c0 += NC) {
    float part[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA fa;
      acc_to_a<RN>(fa, a[j]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        FragB fb;
        load_b_rows<R, RN>(fb, tile, 8 * j, 8 * (c0 + n), g, t);
        mma3(part[n], fa, fb);
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 + n][e] += part[n][e];
  }
}

}  // namespace

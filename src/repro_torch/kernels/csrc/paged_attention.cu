// paged_attention: one-query-token GQA attention per sequence over a paged
// KV pool, with an online softmax in f32 across pages.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention.py:paged_attention_pallas
// (pl.pallas_call at paged_attention.py:94), which runs in every attention
// layer of the fused decode step.
//
// Shapes: q (B, nq, hd); pages (NB, BS, 2*kvd) with K in the first kvd
// columns and V in the last; block_table (B, MAXB) int32, -1 padded;
// lens (B,) valid tokens including the current one. Out (B, nq, hd) in
// q's dtype. A token is live iff its index is below lens[b] and its table
// entry names a block in [0, NB); rows with no live token output exactly 0.
//
// Bound on the H100: bytes. Each live token's K and V rows are read once
// for all g = nq/nkv query heads, at two flops per element per head, far
// below the card's ~295 flops-per-byte balance point. Design: one CTA per
// (sequence, kv head) handles all g query heads of that kv head, so each
// K/V row is loaded once. Its four warps take tokens round robin; lane l
// holds head dims l, l+32, ... so a warp's row load is one coalesced
// transaction, the dot product is a warp shuffle reduction, and every warp
// keeps its own running (m, l, acc) per head. The warps' partial softmax
// states are merged through shared memory at the end, flash-decoding
// style, inside the CTA. The page loop stops at lens[b]: no work on pad.
// No host synchronisation, fixed launch shape per (B, nkv).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pages,
                       const int32_t* __restrict__ bt,
                       const int32_t* __restrict__ lens, T* __restrict__ out,
                       int nq, int nkv, int g, int nb, int bs, int maxb,
                       float scale) {
  constexpr int E = HD / 32;  // head dims per lane
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t kvd = int64_t(nkv) * HD;
  const int64_t width = 2 * kvd;

  float qr[kMaxG][E];
  float m[kMaxG], l[kMaxG], acc[kMaxG][E];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    m[gi] = -1e30f;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[gi][e] = 0.f;
      qr[gi][e] = gi < g
          ? to_f(q[(int64_t(b) * nq + kh * g + gi) * HD + lane + 32 * e])
          : 0.f;
    }
  }

  int len = lens[b];
  len = len < 0 ? 0 : len;
  const int nt = min(len, maxb * bs);
  for (int t = warp; t < nt; t += kWarps) {
    const int blk = bt[int64_t(b) * maxb + t / bs];
    if (blk < 0 || blk >= nb) continue;  // warp-uniform
    const T* row = pages + (int64_t(blk) * bs + t % bs) * width;
    float kk[E], vv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kk[e] = to_f(row[kh * HD + lane + 32 * e]);
      vv[e] = to_f(row[kvd + kh * HD + lane + 32 * e]);
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi >= g) break;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part += qr[gi][e] * kk[e];
      const float s = warp_sum(part) * scale;
      const float m_new = fmaxf(m[gi], s);
      const float alpha = expf(m[gi] - m_new);
      const float p = expf(s - m_new);
      l[gi] = l[gi] * alpha + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] = acc[gi][e] * alpha + p * vv[e];
      m[gi] = m_new;
    }
  }

  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][kMaxG][HD];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi >= g) break;
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][gi][lane + 32 * e] = acc[gi][e];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < g * HD; o += blockDim.x) {
    const int gi = o / HD;
    const int d = o % HD;
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][gi] - mx);
      den += sm_l[w][gi] * c;
      num += sm_acc[w][gi][d] * c;
    }
    out[(int64_t(b) * nq + kh * g + gi) * HD + d] =
        from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pages, const int32_t* bt,
                   const int32_t* lens, void* out, int B, int nq, int nkv,
                   int nb, int bs, int maxb, cudaStream_t stream) {
  dim3 grid(B, nkv);
  paged_attention_kernel<T, HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages), bt, lens,
      static_cast<T*>(out), nq, nkv, nq / nkv, nb, bs, maxb,
      1.0f / sqrtf(float(HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const void* q, const void* pages,
                  const int32_t* bt, const int32_t* lens, void* out, int B,
                  int nq, int nkv, int nb, int bs, int maxb,
                  cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, pages, bt, lens, out, B, nq, nkv, nb, bs, maxb,
                           st);
    case 64:
      return launch<T, 64>(q, pages, bt, lens, out, B, nq, nkv, nb, bs, maxb,
                           st);
    case 128:
      return launch<T, 128>(q, pages, bt, lens, out, B, nq, nkv, nb, bs,
                            maxb, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).
// Returns cudaGetLastError() after the launch (0 == launched).
extern "C" int paged_attention(const void* q, const void* pages,
                               const void* block_table, const void* lens,
                               void* out, int B, int nq, int nkv, int hd,
                               int nb, int bs, int maxb, int dtype,
                               void* stream) {
  if (B == 0) return 0;
  if (nkv <= 0 || nq % nkv != 0 || nq / nkv > kMaxG || B > 2147483647 ||
      nkv > 65535)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto btp = static_cast<const int32_t*>(block_table);
  auto lp = static_cast<const int32_t*>(lens);
  if (dtype == 0)
    return by_hd<float>(hd, q, pages, btp, lp, out, B, nq, nkv, nb, bs, maxb,
                        st);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, q, pages, btp, lp, out, B, nq, nkv, nb,
                                bs, maxb, st);
  return int(cudaErrorInvalidValue);
}

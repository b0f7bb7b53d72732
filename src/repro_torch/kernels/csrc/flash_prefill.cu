// flash_prefill: causal flash attention for prefill, GQA in the kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py:
// flash_prefill_pallas (pl.pallas_call at flash_prefill.py:126). The JAX
// package computes the same contract in jnp inside attention_seq
// (modeling.py:80) and names this kernel as its lowering.
//
// Shapes: q (b, s, nq, hd); k, v (b, sk, nkv, hd) with sk = P + s, where P
// (prefix_pad) >= q_offset rows of reused prefix come first and only the
// first q_offset of them are real. Query row i sits at absolute position
// q_offset + i; key row r sits at r when r < P (real iff r < q_offset) and
// at q_offset + r - P otherwise. q_valid (b,) int32 (nullable) marks how
// many leading query rows of each batch row are real; the others output
// exactly 0. f32 or bf16 in, f32 accumulation, out in q's dtype.
//
// Bound on the H100: operations for long prompts (4*s*sk*hd flops per
// head, halved by causality, against s+sk rows of bytes), bytes for the
// 16-token buckets. This first version runs on the CUDA cores in f32, not
// the tensor cores: its ceiling is the 67 TFLOP/s f32 rate, and wgmma is
// a later step. Design: one CTA per (16-row query tile, query head, batch
// row); query head h reads kv head h / (nq/nkv), so K/V are never
// repeated in memory. K/V stream through shared memory in 32-row tiles
// (K rows padded by one word so that lane j reading key j is bank-conflict
// free); lane j of a warp owns key j of the tile for the QK^T dot products,
// then the 32 probabilities are broadcast by shuffles for the PV product,
// where lane l owns head dims l, l+32, ... . Each warp carries an online
// softmax (m, l, acc) for 4 query rows. Key tiles that are fully masked for
// the whole query tile (past the causal frontier, or padded prefix) are
// skipped, and a tile with no valid query row writes zeros and exits.
// Any s and sk are handled: tail rows are masked, not asserted away.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per CTA
constexpr int kBK = 32;                  // key rows per tile (one per lane)

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     const int32_t* __restrict__ q_valid, int s, int sk,
                     int nq, int nkv, int q_offset, int pfx, float scale) {
  constexpr int E = HD / 32;
  __shared__ float sq[kBQ][HD];
  __shared__ float skt[kBK][HD + 1];
  __shared__ float svt[kBK][HD];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kh = h / (nq / nkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  int qv = q_valid ? q_valid[bi] : s;
  qv = max(0, min(qv, s));
  const int last_q = min(q0 + kBQ, qv) - 1;  // last real query row here

  const int64_t q_row_stride = int64_t(nq) * HD;
  const int64_t kv_row_stride = int64_t(nkv) * HD;
  T* o_base = out + int64_t(bi) * s * q_row_stride + int64_t(h) * HD;

  if (last_q < q0) {  // no real query row in this tile: exact zeros
    for (int i = threadIdx.x; i < kBQ * HD; i += blockDim.x) {
      const int r = q0 + i / HD;
      if (r < s) o_base[r * q_row_stride + i % HD] = from_f<T>(0.f);
    }
    return;
  }

  const T* q_base = q + int64_t(bi) * s * q_row_stride + int64_t(h) * HD;
  for (int i = threadIdx.x; i < kBQ * HD; i += blockDim.x) {
    const int r = i / HD;
    const int d = i % HD;
    sq[r][d] = (q0 + r < s) ? to_f(q_base[(q0 + r) * q_row_stride + d])
                            : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -1e30f;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const T* k_base = k + int64_t(bi) * sk * kv_row_stride + int64_t(kh) * HD;
  const T* v_base = v + int64_t(bi) * sk * kv_row_stride + int64_t(kh) * HD;

  for (int ts = 0; ts < sk; ts += kBK) {
    // a tile does work iff it holds a real prefix key, or a suffix key
    // whose relative index does not pass the tile's last real query row
    const bool work = ts < q_offset ||
                      (ts + kBK > pfx && max(ts, pfx) - pfx <= last_q);
    if (!work) continue;  // uniform across the CTA
    __syncthreads();      // previous tile fully consumed
    for (int i = threadIdx.x; i < kBK * HD; i += blockDim.x) {
      const int r = i / HD;
      const int d = i % HD;
      const bool in = ts + r < sk;
      skt[r][d] = in ? to_f(k_base[(ts + r) * kv_row_stride + d]) : 0.f;
      svt[r][d] = in ? to_f(v_base[(ts + r) * kv_row_stride + d]) : 0.f;
    }
    __syncthreads();

    // this lane's key row, its absolute position and validity
    const int kr = ts + lane;
    const bool is_pfx = kr < pfx;
    const int kpos = is_pfx ? kr : q_offset + (kr - pfx);
    const bool kvalid = kr < sk && (!is_pfx || kr < q_offset);

    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = skt[lane][d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sc[r] += sq[warp * kRows + r][d] * kd;
    }

    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qrel = q0 + warp * kRows + r;
      const bool live = kvalid && qrel < qv && kpos <= q_offset + qrel;
      const float x = live ? sc[r] * scale : -1e30f;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      p[r] = live ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
      m[r] = m_new;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vj[e] = svt[j][lane + 32 * e];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] += pj * vj[e];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qrel = q0 + warp * kRows + r;
    if (qrel >= s) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e)
      o_base[qrel * q_row_stride + lane + 32 * e] = from_f<T>(acc[r][e] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int32_t* q_valid, int b, int s, int sk, int nq,
                   int nkv, int q_offset, int pfx, cudaStream_t stream) {
  dim3 grid((s + kBQ - 1) / kBQ, nq, b);
  flash_prefill_kernel<T, HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), q_valid, s, sk, nq, nkv,
      q_offset, pfx, 1.0f / sqrtf(float(HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const void* q, const void* k, const void* v,
                  void* out, const int32_t* q_valid, int b, int s, int sk,
                  int nq, int nkv, int q_offset, int pfx, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, q_valid, b, s, sk, nq, nkv, q_offset,
                           pfx, st);
    case 64:
      return launch<T, 64>(q, k, v, out, q_valid, b, s, sk, nq, nkv, q_offset,
                           pfx, st);
    case 128:
      return launch<T, 128>(q, k, v, out, q_valid, b, s, sk, nq, nkv,
                            q_offset, pfx, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). q_valid may
// be null (every query row is real). Returns cudaGetLastError() after the
// launch (0 == launched).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, const void* q_valid, int b, int s,
                             int sk, int nq, int nkv, int hd, int q_offset,
                             int prefix_pad, int dtype, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (nkv <= 0 || nq % nkv != 0 || nq > 65535 || b > 65535 ||
      prefix_pad < q_offset || sk != prefix_pad + s)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto qv = static_cast<const int32_t*>(q_valid);
  if (dtype == 0)
    return by_hd<float>(hd, q, k, v, out, qv, b, s, sk, nq, nkv, q_offset,
                        prefix_pad, st);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, q, k, v, out, qv, b, s, sk, nq, nkv,
                                q_offset, prefix_pad, st);
  return int(cudaErrorInvalidValue);
}

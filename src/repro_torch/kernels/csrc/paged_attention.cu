// paged_attention: one-query-token GQA attention per sequence over a paged
// KV pool, split-KV (flash-decoding): a split kernel computes partial
// softmax states over ranges of tokens, a merge kernel combines them.
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
// Scratch, allocated by the caller: part (B, nq, S, hd) f32 and m, l
// (B, nq, S) f32.
//
// Bound on the H100: bytes. Each live token's K and V rows are read once
// for all g = nq/nkv query heads, at two flops per element per head, far
// below the card's ~295 flops-per-byte balance point. What held the first
// version back was latency, not bandwidth: one CTA per (sequence, kv head)
// gave 32 busy CTAs at the decode step's shape, each walking its tokens one
// at a time with scalar loads and a shuffle reduction per token and head.
//
// Design. The token axis [0, MAXB*BS) is cut into S ranges of split_tokens
// tokens (a whole number of blocks, chosen by the wrapper from the shapes
// alone), and the split kernel runs one CTA per (kv head, sequence, range):
// grid (nkv, B, S). A range that starts at or past lens[b] writes an empty
// partial (m = -1e30, l = 0) and returns. Inside a CTA the range is walked
// in chunks of 16 tokens. Each chunk's K and V rows of this kv head are
// fetched with 16-byte cp.async copies into a two-stage ring in shared
// memory, so the next chunk is in flight while this one is computed; rows
// of dead tokens (past lens, or a table entry that is -1 or >= NB) are
// zero-filled by the copy itself. The 128 threads then compute all 16 x g
// scores of the chunk at once (thread = token j, head gi; float4 reads of
// K rows padded by 16 bytes, so the 16 rows fall in distinct banks), take
// one max and one rescale per chunk and head by a 16-lane shuffle, and
// accumulate P V with each thread owning a float4 column of up to two
// heads. The merge kernel combines the live ranges of each (sequence,
// query head) by the log-sum-exp rule and writes exactly 0 where no range
// saw a live token. Nothing depends on lens on the host: no sync.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;   // tokens per pipeline stage
constexpr int kMaxG = 8;     // query heads per kv head (kThreads / kChunk)
constexpr int kStages = 2;

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

// four consecutive elements of shared memory as floats
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bf16 is the high half of its f32: widen by shifts, exactly
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

// 16-byte asynchronous copy; src_bytes == 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool live_block(int blk, int nb) {
  return blk >= 0 && blk < nb;
}

// Copy the K and V rows of tokens [c0, c0 + kChunk) of one kv head into a
// ring stage laid out [2][kChunk][HD + 16 bytes]; rows of dead tokens
// (at or past t1, or whose table entry is -1 or >= nb) are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void issue_chunk(T* dst, const T* kv_base,
                                            const int32_t* row_bt, int c0,
                                            int t1, int nb, int bs,
                                            int64_t width, int64_t kvd) {
  constexpr int kV16 = 16 / sizeof(T);
  constexpr int kRS = HD + kV16;
  constexpr int kPieces = HD / kV16;
  constexpr int kPer = kChunk * 2 * kPieces / kThreads;  // copies a thread
  static_assert(kPer * kThreads == kChunk * 2 * kPieces, "copy split");
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / (2 * kPieces);
    const int kv = (i / kPieces) % 2;
    const int pc = i % kPieces;
    const int t = c0 + r;
    const T* src = kv_base;
    int bytes = 0;
    if (t < t1) {
      const int blk = row_bt[t / bs];
      if (live_block(blk, nb)) {
        src = kv_base + (int64_t(blk) * bs + t % bs) * width + kv * kvd +
              pc * kV16;
        bytes = 16;
      }
    }
    cp_async16(dst + (kv * kChunk + r) * kRS + pc * kV16, src, bytes);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 4)
paged_attention_split_kernel(const T* __restrict__ q,
                             const T* __restrict__ pages,
                             const int32_t* __restrict__ bt,
                             const int32_t* __restrict__ lens,
                             float* __restrict__ part,
                             float* __restrict__ pm, float* __restrict__ pl,
                             int nq, int nkv, int nb, int bs, int maxb,
                             int split, int S, float scale) {
  constexpr int kV16 = 16 / sizeof(T);     // elements per 16-byte copy
  constexpr int kRS = HD + kV16;           // padded row stride (elements)
  constexpr int kC4 = HD / 4;              // float4 columns of a row
  constexpr int kHG = kThreads / kC4;      // heads covered at once in P V
  constexpr int kNH = (kMaxG + kHG - 1) / kHG;  // heads per thread in P V

  __shared__ __align__(16) T ring[kStages][2][kChunk][kRS];
  __shared__ __align__(16) float sq[kMaxG][HD];
  __shared__ float sp[kMaxG][kChunk];
  __shared__ float salpha[kMaxG];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int sidx = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = nq / nkv;
  const int64_t kvd = int64_t(nkv) * HD;
  const int64_t width = 2 * kvd;
  const int32_t* row_bt = bt + int64_t(b) * maxb;

  int len = lens[b];
  len = max(0, min(len, maxb * bs));
  const int t0 = sidx * split;
  const int t1 = min(t0 + split, len);
  const int64_t stat0 = (int64_t(b) * nq + kh * g) * S + sidx;
  if (t0 >= t1) {  // range past the sequence: an empty partial
    if (tid < g) {
      pm[stat0 + int64_t(tid) * S] = -1e30f;
      pl[stat0 + int64_t(tid) * S] = 0.f;
    }
    return;
  }

  const T* q_base = q + (int64_t(b) * nq + kh * g) * HD;
  for (int i = tid; i < g * HD; i += kThreads)
    sq[i / HD][i % HD] = to_f(q_base[i]);

  const int nch = (t1 - t0 + kChunk - 1) / kChunk;
  // score phase: thread = (token j of the chunk, query head gi)
  const int j = tid % kChunk;
  const int gi = tid / kChunk;
  float m_run = -1e30f, l_run = 0.f;
  // P V phase: thread = (float4 column col, heads hg, hg + kHG, ...)
  const int col = tid % kC4;
  const int hg = tid / kC4;
  float acc[kNH][4];
#pragma unroll
  for (int k = 0; k < kNH; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;

  const T* kv_base = pages + int64_t(kh) * HD;
  issue_chunk<T, HD>(&ring[0][0][0][0], kv_base, row_bt, t0, t1, nb, bs,
                     width, kvd);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    const int st = c % kStages;
    if (c + 1 < nch)      // in flight while chunk c lands and is computed
      issue_chunk<T, HD>(&ring[(c + 1) % kStages][0][0][0], kv_base, row_bt,
                         t0 + (c + 1) * kChunk, t1, nb, bs, width, kvd);
    cp_async_commit();
    cp_async_wait<1>();   // chunk c has landed (c + 1 may be in flight)
    __syncthreads();

    const int t = t0 + c * kChunk + j;
    const bool live = gi < g && t < t1 && live_block(row_bt[t / bs], nb);
    float x = -1e30f;
    if (live) {
      const T* krow = &ring[st][0][j][0];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 8) {
        const float4 ka = load4(krow + d);
        const float4 qa = *reinterpret_cast<const float4*>(&sq[gi][d]);
        const float4 kb = load4(krow + d + 4);
        const float4 qb = *reinterpret_cast<const float4*>(&sq[gi][d + 4]);
        s0 = fmaf(qa.x, ka.x, fmaf(qa.y, ka.y, fmaf(qa.z, ka.z,
                 fmaf(qa.w, ka.w, s0))));
        s1 = fmaf(qb.x, kb.x, fmaf(qb.y, kb.y, fmaf(qb.z, kb.z,
                 fmaf(qb.w, kb.w, s1))));
      }
      x = (s0 + s1) * scale;
    }
    float cm = x;  // one max per chunk and head, over the 16 lanes of gi
#pragma unroll
    for (int o = kChunk / 2; o > 0; o >>= 1)
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
    const float m_new = fmaxf(m_run, cm);
    const float p = live ? expf(x - m_new) : 0.f;
    float ps = p;
#pragma unroll
    for (int o = kChunk / 2; o > 0; o >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, o);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + ps;
    m_run = m_new;
    sp[gi][j] = p;
    if (j == 0) salpha[gi] = alpha;
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kNH; ++k) {
      const int h = hg + k * kHG;
      const float a = h < g ? salpha[h] : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][e] *= a;
    }
#pragma unroll 4
    for (int jj = 0; jj < kChunk; ++jj) {
      const float4 v = load4(&ring[st][1][jj][4 * col]);
#pragma unroll
      for (int k = 0; k < kNH; ++k) {
        const int h = hg + k * kHG;
        if (h < g) {
          const float pj = sp[h][jj];
          acc[k][0] += pj * v.x;
          acc[k][1] += pj * v.y;
          acc[k][2] += pj * v.z;
          acc[k][3] += pj * v.w;
        }
      }
    }
    __syncthreads();  // stage st and sp are rewritten next
  }

#pragma unroll
  for (int k = 0; k < kNH; ++k) {
    const int h = hg + k * kHG;
    if (h < g) {
      float* dst = part + ((stat0 + int64_t(h) * S) * HD) + 4 * col;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    }
  }
  if (j == 0 && gi < g) {
    pm[stat0 + int64_t(gi) * S] = m_run;
    pl[stat0 + int64_t(gi) * S] = l_run;
  }
}

// One CTA per (query head, sequence), one thread per head dim: the live
// ranges' partial states merged by the log-sum-exp rule.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
paged_attention_merge_kernel(const float* __restrict__ part,
                             const float* __restrict__ pm,
                             const float* __restrict__ pl,
                             const int32_t* __restrict__ lens,
                             T* __restrict__ out, int nq, int bs, int maxb,
                             int split, int S) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  int len = lens[b];
  len = max(0, min(len, maxb * bs));
  const int nsp = min(S, (len + split - 1) / split);
  const int64_t base = (int64_t(b) * nq + h) * S;
  float mx = -1e30f;
  for (int s = 0; s < nsp; ++s) mx = fmaxf(mx, pm[base + s]);
  float den = 0.f, num = 0.f;
  for (int s = 0; s < nsp; ++s) {
    const float w = expf(pm[base + s] - mx);
    den += pl[base + s] * w;
    num += part[(base + s) * HD + d] * w;
  }
  out[(int64_t(b) * nq + h) * HD + d] =
      from_f<T>(den > 0.f ? num / den : 0.f);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pages, const int32_t* bt,
                   const int32_t* lens, void* out, float* part, float* pm,
                   float* pl, int B, int nq, int nkv, int nb, int bs,
                   int maxb, int split, int S, cudaStream_t stream) {
  paged_attention_split_kernel<T, HD><<<dim3(nkv, B, S), kThreads, 0,
                                        stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages), bt, lens, part,
      pm, pl, nq, nkv, nb, bs, maxb, split, S, 1.0f / sqrtf(float(HD)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_attention_merge_kernel<T, HD><<<dim3(nq, B), HD, 0, stream>>>(
      part, pm, pl, lens, static_cast<T*>(out), nq, bs, maxb, split, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const void* q, const void* pages,
                  const int32_t* bt, const int32_t* lens, void* out,
                  float* part, float* pm, float* pl, int B, int nq, int nkv,
                  int nb, int bs, int maxb, int split, int S,
                  cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, pages, bt, lens, out, part, pm, pl, B, nq, nkv,
                           nb, bs, maxb, split, S, st);
    case 64:
      return launch<T, 64>(q, pages, bt, lens, out, part, pm, pl, B, nq, nkv,
                           nb, bs, maxb, split, S, st);
    case 128:
      return launch<T, 128>(q, pages, bt, lens, out, part, pm, pl, B, nq,
                            nkv, nb, bs, maxb, split, S, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it). part, m
// and l are f32 scratch of (B, nq, S, hd) and (B, nq, S); split_tokens is
// a multiple of bs and S * split_tokens >= maxb * bs. Two launches on the
// stream; returns cudaGetLastError() after each (0 == both launched).
extern "C" int paged_attention(const void* q, const void* pages,
                               const void* block_table, const void* lens,
                               void* out, void* part, void* m, void* l,
                               int B, int nq, int nkv, int hd, int nb, int bs,
                               int maxb, int split_tokens, int S, int dtype,
                               void* stream) {
  if (B == 0) return 0;
  if (nkv <= 0 || nq % nkv != 0 || nq / nkv > kMaxG || B > 65535 ||
      bs <= 0 || split_tokens <= 0 ||
      split_tokens % bs != 0 || S <= 0 || S > 65535 ||
      int64_t(S) * split_tokens < int64_t(maxb) * bs)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto btp = static_cast<const int32_t*>(block_table);
  auto lp = static_cast<const int32_t*>(lens);
  auto pp = static_cast<float*>(part);
  auto mp = static_cast<float*>(m);
  auto lsp = static_cast<float*>(l);
  if (dtype == 0)
    return by_hd<float>(hd, q, pages, btp, lp, out, pp, mp, lsp, B, nq, nkv,
                        nb, bs, maxb, split_tokens, S, st);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, q, pages, btp, lp, out, pp, mp, lsp, B,
                                nq, nkv, nb, bs, maxb, split_tokens, S, st);
  return int(cudaErrorInvalidValue);
}

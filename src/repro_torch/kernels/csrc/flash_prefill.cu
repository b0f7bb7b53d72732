// flash_prefill: flash attention for prefill, GQA in the kernel, causal
// or not.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py:
// flash_prefill_pallas (pl.pallas_call at flash_prefill.py:126). The JAX
// package computes the same contract in jnp inside attention_seq
// (modeling.py:80) and names this kernel as its lowering. The non-causal
// mode (causal == 0) is the function attention_seq(causal=False) computes
// in jnp for the whisper encoder and for cross-attention: every key row
// < sk is live for every real query row, there is no prefix region
// (q_offset = prefix_pad = 0) and sk is independent of s.
//
// Shapes: q (b, s, nq, hd); k, v (b, sk, nkv, hd) with sk = P + s, where P
// (prefix_pad) >= q_offset rows of reused prefix come first and only the
// first q_offset of them are real. Query row i sits at absolute position
// q_offset + i; key row r sits at r when r < P (real iff r < q_offset) and
// at q_offset + r - P otherwise. q_valid (b,) int32 (nullable) marks how
// many leading query rows of each batch row are real; the others output
// exactly 0. f32 or bf16 in, f32 accumulation, out in q's dtype. In the
// non-causal mode k, v are (b, sk, nkv, hd) for any sk >= 1.
//
// Bound on the H100: operations for long prompts (4*s*sk*hd flops per
// head, halved by causality, against s+sk rows of bytes), bytes for the
// 16-token buckets. The main path runs f32, and f32 stays f32: TF32 would
// keep about three decimal digits where the port holds f32 outputs to its
// plain version within 1e-5, so the kernel runs on the CUDA cores and its
// roof is their 67 TFLOP/s f32 rate. A bf16 tensor-core variant (wgmma) is
// later work; bf16 inputs take the same f32 path here, converted after the
// shared-memory load. What held the first version back was shared-memory
// traffic: one shared load per FMA in QK^T, scalar K/V fills with no copy
// in flight, and 16-row query tiles that re-fetched every K/V tile.
//
// Design. One CTA of 128 threads per (query head, batch row, 64-row query
// tile), the tile index in grid z and reversed, so the heavy tiles (late
// in the causal order) start first. Query head h reads kv head h / (nq /
// nkv): K/V are never repeated in memory, and the g heads of a group
// re-read a K/V tile from L2. The Q tile sits in shared memory as f32 rows
// padded by 16 bytes, pre-multiplied by log2(e)/sqrt(hd) so that the
// softmax runs in base 2 (exp2f). K/V stream through 32-row tiles in a
// two-stage ring in dynamic shared memory (110 KB at hd 128 in f32, two
// CTAs per SM): the 16-byte cp.async copies of tile n + 1 are issued right
// after the barrier that opens tile n, and land while tile n is computed.
// Two barriers per tile. Register tiling on both products:
//  * S = Q K^T: each thread owns a 4x4 micro-tile (rows rg + 16i, keys
//    kg + 8j) and reads float4 runs of Q and K rows (K rows padded so the
//    8 key groups of a warp hit distinct banks): 64 FMAs per 8 loads,
//    written as explicit fmaf chains.
//  * Online softmax per row, reduced across the 8 lanes that hold it by
//    shuffles: one max and one rescale per row and tile. P goes to shared
//    memory transposed (P^T[key][row]), alpha beside it.
//  * O += P V: each thread owns RPT rows x DPT dims (8x8 at hd 128) and
//    reads float4 runs of P^T and V rows: 64 FMAs per 4 loads.
// Key tiles that are fully masked for the whole query tile (past the
// causal frontier, or padded prefix) are skipped, and a tile with no valid
// query row writes zeros and exits. Any s and sk are handled: tail rows
// are zero-filled by the copies and masked, not asserted away. The mode
// is a template parameter, so the causal instantiation is the code it was
// before the non-causal one existed; a non-causal CTA walks every key
// tile (its cost is even across query tiles, and a short decoder bucket
// against 1500 encoder frames gives few CTAs: later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;   // query rows per CTA
constexpr int kBK = 32;   // key rows per K/V tile

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  // a bf16 is the high half of its f32: widen by shifts, exactly
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

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

// Shared-memory layout of one CTA, in bytes from the dynamic base.
template <typename T, int HD>
struct Smem {
  static constexpr int kQRow = HD + 4;                  // f32, +16 B
  static constexpr int kKRow = HD + 16 / int(sizeof(T));  // T, +16 B
  static constexpr int kPRow = kBQ + 4;                 // f32, +16 B
  static constexpr int q = 0;
  static constexpr int k = q + kBQ * kQRow * 4;
  static constexpr int v = k + 2 * kBK * kKRow * int(sizeof(T));
  static constexpr int p = v + 2 * kBK * HD * int(sizeof(T));
  static constexpr int alpha = p + kBK * kPRow * 4;
  static constexpr int l = alpha + kBQ * 4;
  static constexpr int bytes = l + kBQ * 4;
};

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     const int32_t* __restrict__ q_valid, int s, int sk,
                     int nq, int nkv, int q_offset, int pfx, float scale2) {
  using L = Smem<T, HD>;
  // S = Q K^T register tile: rows rg + 16i (i < 4), keys kg + KG j (j < SC)
  constexpr int SC = 4;
  constexpr int KG = kBK / SC;          // key groups: lanes of a row
  static_assert(kThreads / KG * 4 == kBQ, "S tile");
  // O = P V register tile: RPT rows x DPT dims per thread
  constexpr int PVE = kBQ * HD / kThreads;
  constexpr int RPT = PVE >= 32 ? 8 : 4;
  constexpr int DPT = PVE / RPT;
  constexpr int DG = HD / DPT;          // dim groups
  constexpr int RG = kThreads / DG;     // row groups
  constexpr int NU = DPT / 4;           // float4 runs per thread row
  constexpr int kV16 = 16 / int(sizeof(T));
  constexpr int kPieces = HD / kV16;    // 16-byte copies per K or V row
  static_assert(RG * RPT == kBQ && DPT % 4 == 0, "O tile");

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sP = reinterpret_cast<float*>(smem + L::p);
  float* sAlpha = reinterpret_cast<float*>(smem + L::alpha);
  float* sL = reinterpret_cast<float*>(smem + L::l);

  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heavy tiles first
  const int kh = h / (nq / nkv);
  const int tid = threadIdx.x;

  int qv = q_valid ? q_valid[bi] : s;
  qv = max(0, min(qv, s));
  const int last_q = min(q0 + kBQ, qv) - 1;  // last real query row here

  const int64_t q_row = int64_t(nq) * HD;
  const int64_t kv_row = int64_t(nkv) * HD;
  T* o_base = out + int64_t(bi) * s * q_row + int64_t(h) * HD;

  if (last_q < q0) {  // no real query row in this tile: exact zeros
    for (int i = tid; i < kBQ * HD / 4; i += kThreads) {
      const int r = q0 + i / (HD / 4);
      if (r < s)
        st4(o_base + r * q_row + 4 * (i % (HD / 4)),
            make_float4(0.f, 0.f, 0.f, 0.f));
    }
    return;
  }

  // the key tiles that do work: [0, A) hold a real prefix key; [lo, be]
  // hold a suffix key at or before the tile's last real query row
  // (non-causal: every tile, A = lo = 0)
  const int nkt = (sk + kBK - 1) / kBK;
  const int A = CAUSAL ? min((q_offset + kBK - 1) / kBK, nkt) : 0;
  const int lo = CAUSAL ? max(A, pfx / kBK) : 0;
  const int be = CAUSAL ? min((pfx + last_q) / kBK, nkt - 1) : nkt - 1;
  const int ntiles = A + max(0, be - lo + 1);
  auto tile_start = [&](int n) { return (n < A ? n : lo + (n - A)) * kBK; };

  const T* k_base = k + int64_t(bi) * sk * kv_row + int64_t(kh) * HD;
  const T* v_base = v + int64_t(bi) * sk * kv_row + int64_t(kh) * HD;
  auto issue = [&](int n, int buf) {
    const int ts = tile_start(n);
    T* dk = sK + buf * kBK * L::kKRow;
    T* dv = sV + buf * kBK * HD;
    for (int i = tid; i < 2 * kBK * kPieces; i += kThreads) {
      const int isv = i / (kBK * kPieces);
      const int r = (i / kPieces) % kBK;
      const int pc = i % kPieces;
      const bool in = ts + r < sk;
      const T* src = (isv ? v_base : k_base) +
                     (in ? (ts + r) * kv_row + pc * kV16 : 0);
      T* dst = isv ? dv + r * HD + pc * kV16 : dk + r * L::kKRow + pc * kV16;
      cp_async16(dst, src, in ? 16 : 0);
    }
  };

  if (ntiles > 0) issue(0, 0);
  cp_async_commit();

  // Q tile -> f32 shared rows (overlaps the first K/V copies), scaled by
  // scale * log2(e): scores come out in base 2, for exp2f
  const T* q_base = q + int64_t(bi) * s * q_row + int64_t(h) * HD;
  for (int i = tid; i < kBQ * HD / 4; i += kThreads) {
    const int r = i / (HD / 4);
    const int d = 4 * (i % (HD / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < s) {
      x = ld4(q_base + (q0 + r) * q_row + d);
      x = make_float4(x.x * scale2, x.y * scale2, x.z * scale2,
                      x.w * scale2);
    }
    st4(sQ + r * L::kQRow + d, x);
  }

  const int kg = tid % KG;
  const int rg = tid / KG;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
  }
  // P V ownership: rows prg * RPT + i, dims 4 * dg + 4 * DG * u + e
  const int dg = tid % DG;
  const int prg = tid / DG;
  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    const int buf = n & 1;
    const int ts = tile_start(n);
    cp_async_wait<0>();   // tile n has landed ...
    __syncthreads();      // ... for every thread, and tile n - 1 is done
    if (n + 1 < ntiles) issue(n + 1, buf ^ 1);   // in flight meanwhile
    cp_async_commit();

    // ---- S = Q K^T, 4 x SC per thread
    const T* kt = sK + buf * kBK * L::kKRow;
    float sc[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qf[4], kf[SC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = ld4(sQ + (rg + 16 * i) * L::kQRow + d);
#pragma unroll
      for (int j = 0; j < SC; ++j)
        kf[j] = ld4(kt + (kg + KG * j) * L::kKRow + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          float a = sc[i][j];
          a = fmaf(qf[i].x, kf[j].x, a);
          a = fmaf(qf[i].y, kf[j].y, a);
          a = fmaf(qf[i].z, kf[j].z, a);
          sc[i][j] = fmaf(qf[i].w, kf[j].w, a);
        }
    }

    // ---- mask and online softmax, one max and rescale per row
    bool kvalid[SC];
    int kpos[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int kr = ts + kg + KG * j;
      const bool is_pfx = kr < pfx;
      kpos[j] = is_pfx ? kr : q_offset + (kr - pfx);
      kvalid[j] = kr < sk && (!is_pfx || kr < q_offset);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrel = q0 + rg + 16 * i;
      const bool rvalid = qrel < qv;
      float mt = -1e30f;
      bool live[SC];
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        live[j] = rvalid && kvalid[j] &&
                  (!CAUSAL || kpos[j] <= q_offset + qrel);
        if (live[j]) mt = fmaxf(mt, sc[i][j]);
      }
#pragma unroll
      for (int o = 1; o < KG; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float p = live[j] ? exp2f(sc[i][j] - m_new) : 0.f;
        sP[(kg + KG * j) * L::kPRow + rg + 16 * i] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 1; o < KG; o <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
      if (kg == 0) sAlpha[rg + 16 * i] = alpha;
    }
    __syncthreads();

    // ---- O = O * alpha + P V, RPT x DPT per thread
    const T* vt = sV + buf * kBK * HD;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = sAlpha[prg * RPT + i];
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= a;
    }
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float pr[RPT];
#pragma unroll
      for (int i = 0; i < RPT; i += 4) {
        const float4 x = ld4(sP + c * L::kPRow + prg * RPT + i);
        pr[i] = x.x;
        pr[i + 1] = x.y;
        pr[i + 2] = x.z;
        pr[i + 3] = x.w;
      }
      float vr[DPT];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 x = ld4(vt + c * HD + 4 * dg + 4 * DG * u);
        vr[4 * u] = x.x;
        vr[4 * u + 1] = x.y;
        vr[4 * u + 2] = x.z;
        vr[4 * u + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e)
          acc[i][e] = fmaf(pr[i], vr[e], acc[i][e]);
    }
  }

  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sL[rg + 16 * i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + prg * RPT + i;
    if (r >= s) continue;
    const float inv = 1.f / fmaxf(sL[prg * RPT + i], 1e-30f);
#pragma unroll
    for (int u = 0; u < NU; ++u)
      st4(o_base + r * q_row + 4 * dg + 4 * DG * u,
          make_float4(acc[i][4 * u] * inv, acc[i][4 * u + 1] * inv,
                      acc[i][4 * u + 2] * inv, acc[i][4 * u + 3] * inv));
  }
}

template <typename T, int HD, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int32_t* q_valid, int b, int s, int sk, int nq,
                   int nkv, int q_offset, int pfx, cudaStream_t stream) {
  constexpr int bytes = Smem<T, HD>::bytes;
  constexpr int kMaxDevices = 64;
  auto kernel = flash_prefill_kernel<T, HD, CAUSAL>;
  // above 48 KB the kernel must be allowed its dynamic shared memory,
  // once per device (not again inside a CUDA graph capture)
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && !allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  dim3 grid(nq, b, (s + kBQ - 1) / kBQ);
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), q_valid, s, sk, nq, nkv,
      q_offset, pfx, log2e / sqrtf(float(HD)));
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t by_hd(int hd, const void* q, const void* k, const void* v,
                  void* out, const int32_t* q_valid, int b, int s, int sk,
                  int nq, int nkv, int q_offset, int pfx, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32, CAUSAL>(q, k, v, out, q_valid, b, s, sk, nq, nkv,
                                   q_offset, pfx, st);
    case 64:
      return launch<T, 64, CAUSAL>(q, k, v, out, q_valid, b, s, sk, nq, nkv,
                                   q_offset, pfx, st);
    case 128:
      return launch<T, 128, CAUSAL>(q, k, v, out, q_valid, b, s, sk, nq,
                                    nkv, q_offset, pfx, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_mode(int causal, int hd, const void* q, const void* k,
                    const void* v, void* out, const int32_t* q_valid, int b,
                    int s, int sk, int nq, int nkv, int q_offset, int pfx,
                    cudaStream_t st) {
  if (causal)
    return by_hd<T, true>(hd, q, k, v, out, q_valid, b, s, sk, nq, nkv,
                          q_offset, pfx, st);
  return by_hd<T, false>(hd, q, k, v, out, q_valid, b, s, sk, nq, nkv,
                         q_offset, pfx, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). q_valid may
// be null (every query row is real). q, k, v and out start on 16-byte
// boundaries. causal: 1 = causal with the prefix contract above (sk ==
// prefix_pad + s), 0 = non-causal (q_offset == prefix_pad == 0, any sk >=
// 1). Returns cudaGetLastError() after the launch (0 == launched).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, const void* q_valid, int b, int s,
                             int sk, int nq, int nkv, int hd, int q_offset,
                             int prefix_pad, int causal, int dtype,
                             void* stream) {
  if (b == 0 || s == 0) return 0;
  const bool geometry =
      causal ? prefix_pad >= q_offset && sk == prefix_pad + s
             : q_offset == 0 && prefix_pad == 0 && sk >= 1;
  if (nkv <= 0 || nq % nkv != 0 || b > 65535 ||
      (s + kBQ - 1) / kBQ > 65535 || !geometry)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto qv = static_cast<const int32_t*>(q_valid);
  if (dtype == 0)
    return by_mode<float>(causal, hd, q, k, v, out, qv, b, s, sk, nq, nkv,
                          q_offset, prefix_pad, st);
  if (dtype == 1)
    return by_mode<__nv_bfloat16>(causal, hd, q, k, v, out, qv, b, s, sk,
                                  nq, nkv, q_offset, prefix_pad, st);
  return int(cudaErrorInvalidValue);
}


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
// The window mode (WINDOW, causal only) is the mask attention_seq(window=W)
// adds in jnp (modeling.py:151-152) for the long-context decode shape: a
// query at absolute position qpos sees a live key at kpos iff kpos <= qpos
// and qpos - kpos < W. JAX's Pallas kernel has no window; this one does,
// because the port's attention_seq always runs it.
//
// Shapes: q (b, s, nq, hd); k, v (b, sk, nkv, hd) with sk = P + s, where P
// (prefix_pad) >= q_offset rows of reused prefix come first and only the
// first q_offset of them are real. Query row i sits at absolute position
// q_offset + i; key row r sits at r when r < P (real iff r < q_offset) and
// at q_offset + r - P otherwise. q_valid (b,) int32 (nullable) marks how
// many leading query rows of each batch row are real; the others output
// exactly 0. f32 or bf16 in, f32 accumulation, out in q's dtype. In the
// non-causal mode k, v are (b, sk, nkv, hd) for any sk >= 1. q_offset may
// also come as a device int32 (q_offset_dev), which every thread reads
// once at its CTA's start: JAX traces prefix_len, and so the port's
// prefill graphs capture one launch per (prefix bucket, suffix bucket)
// and replay it for every prefix length inside it. The grid depends on
// shapes only, and the tile ranges below are computed from the value read.
//
// Bound on the H100: operations for long prompts (4*s*sk*hd flops per
// head, halved by causality, against s+sk rows of bytes), bytes for the
// 16-token buckets and for a short query block against many keys. The
// main path runs f32, and f32 stays f32: one TF32 product keeps about
// three decimal digits where the port holds f32 outputs to its plain
// version within 1e-5.
//
// Causal and window modes (flash_prefill_kernel). They run on the CUDA
// cores, whose roof is 67 TFLOP/s f32. What held the first version back
// was shared-memory traffic: one shared load per FMA in QK^T, scalar K/V
// fills with no copy in flight, and 16-row query tiles that re-fetched
// every K/V tile. One CTA of 128 threads per (query head, batch row,
// 64-row query tile), the tile index in grid z and reversed, so the heavy
// tiles (late in the causal order) start first. Query head h reads kv head
// h / (nq / nkv): K/V are never repeated in memory, and the g heads of a
// group re-read a K/V tile from L2. The Q tile sits in shared memory as
// f32 rows padded by 16 bytes, pre-multiplied by log2(e)/sqrt(hd) so that
// the softmax runs in base 2 (exp2f). K/V stream through 32-row tiles in
// a two-stage ring in dynamic shared memory (110 KB at hd 128 in f32, two
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
// causal frontier, padded prefix, or, in the window mode, at or below the
// first real query's position - W) are skipped, so windowed prefill walks
// about (W + kBQ) / kBK key tiles per CTA whatever the prompt length, and
// a tile with no valid query row writes zeros and exits. Any s and sk are
// handled: tail rows are zero-filled by the copies and masked, not
// asserted away. The window is a template parameter, not a large W of the
// causal mode: with no window the causal code is unchanged, and a W >=
// q_offset + s skips no tile and masks no key, so it computes the causal
// output bit for bit.
//
// Non-causal mode (flash_prefill_nc_kernel, then
// flash_prefill_combine_kernel). Every key is live, so the work is even
// across query tiles and the products dominate:
// they run on the tensor cores in 3xTF32 (tf32x3.cuh), hi rounded to
// nearest, f32-level accuracy at the 495 TFLOP/s TF32 rate's third: S =
// Q K^T with each k-step's product summed from zero and added in f32, O +=
// P V a key tile at a time from zero (add_product), P never leaving
// registers (the S accumulator is the A fragment of P V). mma.sync, not
// wgmma: TF32 operands come from registers, split by each thread, where
// wgmma would need hi and lo copies of every shared tile
// (flash_prefill_bwd.cu says more). One CTA of 4 warps per (query head,
// batch row, 64-row query tile, key range), each warp 16 query rows, K/V
// in 32-row tiles of a two-stage cp.async ring (rows padded by 16 bytes,
// so every fragment load hits distinct banks; 99 KB at hd 128 in f32).
// Few query tiles against many keys (prefill cross-attention: 4 prompts
// of 64 tokens against 1500 frames is 32 CTAs on 132 SMs) leave the card
// idle, so the wrapper cuts the keys into ranges (flash-decoding,
// kernels/flash_prefill.py:split_plan, from the shapes and the SM count
// alone): each range's CTA writes its normalised output and base-2 LSE
// into scratch, and flash_prefill_combine_kernel merges the ranges in a
// fixed order, so
// two calls give the same bits and a captured graph replays the same
// launches. A grid that fills the card (the encoder) is not cut and
// writes out and the LSE itself.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;   // query rows per CTA
constexpr int kBK = 32;   // key rows per K/V tile
constexpr float kLn2 = 0.6931471805599453f;

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

template <typename T, int HD, bool WINDOW>
__global__ void __launch_bounds__(kThreads, 2)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse,
                     const int32_t* __restrict__ q_valid,
                     const int32_t* __restrict__ q_offset_dev, int s, int sk,
                     int nq, int nkv, int q_offset_arg, int pfx, int window,
                     float scale2) {
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
  float* lse_base = lse ? lse + (int64_t(bi) * nq + h) * s : nullptr;

  if (last_q < q0) {  // no real query row in this tile: exact zeros
    for (int i = tid; i < kBQ * HD / 4; i += kThreads) {
      const int r = q0 + i / (HD / 4);
      if (r < s)
        st4(o_base + r * q_row + 4 * (i % (HD / 4)),
            make_float4(0.f, 0.f, 0.f, 0.f));
    }
    if (lse_base && tid < kBQ && q0 + tid < s)
      lse_base[q0 + tid] = INFINITY;
    return;
  }

  // the real prefix length: a device int32 when given (a captured graph
  // replays with whatever it holds then; clamped into [0, P], where the
  // host checks the int form), else the launch argument
  const int q_offset = q_offset_dev
                           ? min(max(__ldg(q_offset_dev), 0), pfx)
                           : q_offset_arg;

  // the key tiles that do work: [a0, A) hold a real prefix key; [lo, be]
  // hold a suffix key at or before the tile's last real query row. In the
  // window mode the
  // first real query row (q0, absolute position q_offset + q0) needs the
  // keys at positions >= q_offset + q0 - W + 1, the later rows fewer: a
  // prefix tile is skipped below that position, a suffix tile below key
  // row pfx + q0 - W + 1.
  const int nkt = (sk + kBK - 1) / kBK;
  const int A = min((q_offset + kBK - 1) / kBK, nkt);
  int a0 = 0;
  int lo = max(A, pfx / kBK);
  if (WINDOW) {
    a0 = min(A, max(0, q_offset + q0 - window + 1) / kBK);
    lo = max(lo, max(0, pfx + q0 - window + 1) / kBK);
  }
  const int be = min((pfx + last_q) / kBK, nkt - 1);
  const int npre = A - a0;
  const int ntiles = npre + max(0, be - lo + 1);
  auto tile_start = [&](int n) {
    return (n < npre ? a0 + n : lo + (n - npre)) * kBK;
  };

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
        live[j] = rvalid && kvalid[j] && kpos[j] <= q_offset + qrel &&
                  (!WINDOW || q_offset + qrel - kpos[j] < window);
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
    for (int i = 0; i < 4; ++i) {
      sL[rg + 16 * i] = l[i];
      // natural-log LSE of the scaled scores: m and l are in base 2
      const int r = q0 + rg + 16 * i;
      if (lse_base && r < s)
        lse_base[r] = l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : INFINITY;
    }
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

// ------------------------------------------------------- non-causal mode

constexpr int kNcKeyTile = 32;   // keys per streamed K/V tile
// CTAs an SM holds at least: three (at most 168 registers a thread) where
// the shared memory allows it
template <int HD>
constexpr int kNcMinBlocks = HD == 128 ? 2 : 3;

// Shared-memory layout of a non-causal CTA, in bytes from the dynamic
// base: the Q tile as f32 rows padded by 16 bytes, then a two-stage ring
// of K and V tiles in T, rows padded by 16 bytes (every fragment load of
// a warp hits 32 distinct banks, or two lanes one word).
template <typename T, int HD>
struct NcSmem {
  static constexpr int kQRow = HD + 4;                      // f32
  static constexpr int kKRow = HD + 16 / int(sizeof(T));    // T
  static constexpr int q = 0;
  static constexpr int k = q + kBQ * kQRow * 4;
  static constexpr int v = k + 2 * kNcKeyTile * kKRow * int(sizeof(T));
  static constexpr int bytes = v + 2 * kNcKeyTile * kKRow * int(sizeof(T));
};

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One (query head, batch row, 64-row query tile, key range) of the
// non-causal mode: 4 warps of 16 query rows, S = Q K^T and O += P V in
// 3xTF32 with hi rounded to nearest, P kept in registers. One range
// (split_keys == 0): writes out in T and the natural-log LSE. More
// ranges: writes this range's normalised O (f32) and base-2 LSE into
// part, which the combine kernel merges.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, kNcMinBlocks<HD>)
flash_prefill_nc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ lse,
                        const int32_t* __restrict__ q_valid, int s, int sk,
                        int nq, int nkv, float scale2, int split_keys,
                        float* __restrict__ part) {
  using L = NcSmem<T, HD>;
  constexpr int BK = kNcKeyTile;
  constexpr int NT = BK / 8;              // key n-tiles of S
  constexpr int ND = HD / 8;              // dim n-tiles of O
  constexpr int kV16 = 16 / int(sizeof(T));
  constexpr int kPieces = HD / kV16;      // 16-byte copies per K or V row
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);

  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int b = gridDim.y;
  const int nsplit = split_keys ? (sk + split_keys - 1) / split_keys : 1;
  const int sp = blockIdx.z % nsplit;
  const int q0 = blockIdx.z / nsplit * kBQ;
  const int kh = h / (nq / nkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tg = lane % 4;

  int qv = q_valid ? q_valid[bi] : s;
  qv = max(0, min(qv, s));
  const int64_t q_row = int64_t(nq) * HD;
  const int64_t kv_row = int64_t(nkv) * HD;
  T* o_base = out + int64_t(bi) * s * q_row + int64_t(h) * HD;
  const int64_t lse_row0 = (int64_t(bi) * nq + h) * s;   // (b, nq, s)

  if (q0 >= qv) {   // no real query row (with several ranges the merge
    if (nsplit > 1) return;   // kernel writes these rows): exact zeros
    for (int i = tid; i < kBQ * HD / 4; i += kThreads) {
      const int r = q0 + i / (HD / 4);
      if (r < s)
        st4(o_base + r * q_row + 4 * (i % (HD / 4)),
            make_float4(0.f, 0.f, 0.f, 0.f));
    }
    if (lse && tid < kBQ && q0 + tid < s) lse[lse_row0 + q0 + tid] = INFINITY;
    return;
  }

  // this range's keys [kb, ke): whole tiles, every range non-empty
  const int kb = sp * split_keys;
  const int ke = nsplit > 1 ? min(sk, kb + split_keys) : sk;
  const int ntiles = (ke - kb + BK - 1) / BK;
  const T* k_base = k + int64_t(bi) * sk * kv_row + int64_t(kh) * HD;
  const T* v_base = v + int64_t(bi) * sk * kv_row + int64_t(kh) * HD;
  auto issue = [&](int n, int buf) {
    const int ts = kb + n * BK;
    T* dk = sK + buf * BK * L::kKRow;
    T* dv = sV + buf * BK * L::kKRow;
    for (int i = tid; i < 2 * BK * kPieces; i += kThreads) {
      const int isv = i / (BK * kPieces);
      const int r = (i / kPieces) % BK;
      const int pc = i % kPieces;
      const bool in = ts + r < ke;
      const T* src = (isv ? v_base : k_base) +
                     (in ? (ts + r) * kv_row + pc * kV16 : 0);
      cp_async16((isv ? dv : dk) + r * L::kKRow + pc * kV16, src,
                 in ? 16 : 0);
    }
  };
  issue(0, 0);
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

  const int qr = 16 * warp;   // the warp's rows of the tile
  // rows qr + gr (half 0: accumulator entries 0, 1) and qr + gr + 8
  // (half 1: entries 2, 3); l is this lane's share of the row sum
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nn = 0; nn < ND; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    const int buf = n & 1;
    cp_async_wait<0>();   // tile n has landed ...
    __syncthreads();      // ... for every thread, and tile n - 1 is done
    if (n + 1 < ntiles) issue(n + 1, buf ^ 1);   // in flight meanwhile
    cp_async_commit();
    const T* kt = sK + buf * BK * L::kKRow;
    const T* vt = sV + buf * BK * L::kKRow;

    // S = Q K^T (base 2): each k-step's product summed from zero, then
    // added in f32
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      FragA aq;
      load_a<L::kQRow, true>(aq, sQ, qr, 8 * kk, gr, tg);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        FragB bk;
        load_b_t<L::kKRow, true>(bk, kt, 8 * j, 8 * kk, gr, tg);
        mma3_add<true>(sc[j], aq, bk);
      }
    }
    // keys past the range (the last tile's zero rows) are not live
    const int k0 = kb + n * BK;
    if (k0 + BK > ke) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * tg + (e & 1) >= ke) sc[j][e] = -INFINITY;
    }
    // online softmax, one max and one rescale per row and tile; the 4
    // lanes of a row reduce by shuffles
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mt = -1e30f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mt = fmaxf(mt, fmaxf(sc[j][2 * half], sc[j][2 * half + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[half], mt);
      const float alpha = exp2f(m[half] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          const float p = exp2f(sc[j][e] - m_new);
          sc[j][e] = p;
          rs += p;
        }
      l[half] = l[half] * alpha + rs;
      m[half] = m_new;
#pragma unroll
      for (int nn = 0; nn < ND; ++nn) {
        acc[nn][2 * half] *= alpha;
        acc[nn][2 * half + 1] *= alpha;
      }
    }
    add_product<HD, NT, L::kKRow, true>(acc, sc, vt, gr, tg);   // O += P V
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }
  // every row met a live key (ke > kb), so l >= 1
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + qr + gr + 8 * half;
    if (r >= s) continue;
    const float inv = 1.f / l[half];
    const float lse2 = m[half] + log2f(l[half]);
    if (nsplit > 1) {   // range sp's slabs of part (see the merge kernel)
      const int64_t slab = int64_t(b) * s * q_row;
      float* po = part + sp * slab + (o_base - out) + r * q_row;
#pragma unroll
      for (int nn = 0; nn < ND; ++nn)
        st2(po + 8 * nn + 2 * tg, acc[nn][2 * half] * inv,
            acc[nn][2 * half + 1] * inv);
      if (tg == 0)
        part[nsplit * slab + sp * (int64_t(b) * nq * s) + lse_row0 + r] =
            lse2;
      continue;
    }
    const float mul = r < qv ? inv : 0.f;   // rows past q_valid: exact 0
#pragma unroll
    for (int nn = 0; nn < ND; ++nn)
      st2(o_base + r * q_row + 8 * nn + 2 * tg, acc[nn][2 * half] * mul,
          acc[nn][2 * half + 1] * mul);
    if (lse && tg == 0)
      lse[lse_row0 + r] = r < qv ? lse2 * kLn2 : INFINITY;
  }
}

// out = the nsplit ranges' outputs merged by the log-sum-exp rule, in
// range order; rows past q_valid exact 0 with lse +inf. One thread per 4
// elements of out.
template <typename T>
__global__ void flash_prefill_combine_kernel(
    const float* __restrict__ part, T* __restrict__ out,
    float* __restrict__ lse, const int32_t* __restrict__ q_valid, int b,
    int s, int nq, int hd, int nsplit) {
  const int64_t slab = int64_t(b) * s * nq * hd;
  const int64_t lslab = int64_t(b) * nq * s;
  const float* pl = part + nsplit * slab;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       i < slab / 4; i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t e = 4 * i;
    const int d = int(e % hd);
    const int64_t row = e / hd;              // (bi * s + r) * nq + h
    const int h = int(row % nq);
    const int r = int(row / nq % s);
    const int bi = int(row / (int64_t(nq) * s));
    int qv = q_valid ? q_valid[bi] : s;
    qv = max(0, min(qv, s));
    const int64_t at = (int64_t(bi) * nq + h) * s + r;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float row_lse = INFINITY;
    if (r < qv) {
      float mx = pl[at];
      for (int j = 1; j < nsplit; ++j) mx = fmaxf(mx, pl[j * lslab + at]);
      float wsum = 0.f;
      for (int j = 0; j < nsplit; ++j) {
        const float w = exp2f(pl[j * lslab + at] - mx);
        const float4 x = ld4(part + j * slab + e);
        wsum += w;
        o.x = fmaf(w, x.x, o.x);
        o.y = fmaf(w, x.y, o.y);
        o.z = fmaf(w, x.z, o.z);
        o.w = fmaf(w, x.w, o.w);
      }
      const float inv = 1.f / wsum;
      o = make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
      row_lse = (mx + log2f(wsum)) * kLn2;
    }
    st4(out + e, o);
    if (lse && d == 0) lse[at] = row_lse;
  }
}

// ------------------------------------------------------------- launches

// above 48 KB a kernel must be allowed its dynamic shared memory, once
// per device (not again inside a CUDA graph capture)
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* allowed) {
  constexpr int kMaxDevices = 64;
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
  return cudaSuccess;
}

template <typename T, int HD, bool WINDOW>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const int32_t* q_valid, const int32_t* q_off,
                   int b, int s, int sk, int nq, int nkv, int q_offset,
                   int pfx, int window, cudaStream_t stream) {
  constexpr int bytes = Smem<T, HD>::bytes;
  auto kernel = flash_prefill_kernel<T, HD, WINDOW>;
  static bool allowed[64] = {};
  cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(nq, b, (s + kBQ - 1) / kBQ);
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, q_valid, q_off, s,
      sk, nq, nkv, q_offset, pfx, window, log2e / sqrtf(float(HD)));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_nc(const void* q, const void* k, const void* v, void* out,
                      float* lse, const int32_t* q_valid, int b, int s,
                      int sk, int nq, int nkv, int split_keys, float* part,
                      cudaStream_t stream) {
  constexpr int bytes = NcSmem<T, HD>::bytes;
  auto kernel = flash_prefill_nc_kernel<T, HD>;
  static bool allowed[64] = {};
  cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return err;
  const int nsplit = split_keys ? (sk + split_keys - 1) / split_keys : 1;
  dim3 grid(nq, b, (s + kBQ - 1) / kBQ * nsplit);
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, q_valid, s, sk,
      nq, nkv, log2e / sqrtf(float(HD)), split_keys, part);
  if (nsplit == 1) return cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n4 = int64_t(b) * s * nq * HD / 4;
  const unsigned blocks =
      unsigned(std::min<int64_t>((n4 + 255) / 256, 132 * 16));
  flash_prefill_combine_kernel<T><<<blocks, 256, 0, stream>>>(
      part, static_cast<T*>(out), lse, q_valid, b, s, nq, HD, nsplit);
  return cudaGetLastError();
}

// causal: 1 = causal, 0 = non-causal; window > 0 (causal only) selects
// the window mode, 0 none
template <typename T, int HD>
cudaError_t by_mode(int causal, int window, const void* q, const void* k,
                    const void* v, void* out, float* lse,
                    const int32_t* q_valid, const int32_t* q_off, int b, int s,
                    int sk, int nq, int nkv, int q_offset, int pfx,
                    int split_keys, float* part, cudaStream_t st) {
  if (!causal)
    return launch_nc<T, HD>(q, k, v, out, lse, q_valid, b, s, sk, nq, nkv,
                            split_keys, part, st);
  if (window > 0)
    return launch<T, HD, true>(q, k, v, out, lse, q_valid, q_off, b, s, sk,
                               nq, nkv, q_offset, pfx, window, st);
  return launch<T, HD, false>(q, k, v, out, lse, q_valid, q_off, b, s, sk,
                              nq, nkv, q_offset, pfx, 0, st);
}

template <typename T>
cudaError_t by_hd(int hd, int causal, int window, const void* q,
                  const void* k, const void* v, void* out, float* lse,
                  const int32_t* q_valid, const int32_t* q_off, int b, int s,
                  int sk, int nq, int nkv, int q_offset, int pfx,
                  int split_keys, float* part, cudaStream_t st) {
  switch (hd) {
    case 32:
      return by_mode<T, 32>(causal, window, q, k, v, out, lse, q_valid,
                            q_off, b, s, sk, nq, nkv, q_offset, pfx,
                            split_keys, part, st);
    case 64:
      return by_mode<T, 64>(causal, window, q, k, v, out, lse, q_valid,
                            q_off, b, s, sk, nq, nkv, q_offset, pfx,
                            split_keys, part, st);
    case 128:
      return by_mode<T, 128>(causal, window, q, k, v, out, lse, q_valid,
                             q_off, b, s, sk, nq, nkv, q_offset, pfx,
                             split_keys, part, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). lse may be
// null (serving); else it receives the (b, nq, s) f32 natural-log LSE of
// each query row's scaled scores over its live keys (+inf for a row with
// none), which the backward (flash_prefill_bwd.cu) recomputes P from.
// q_valid may be null (every query row is real). q_offset_dev may be null
// (q_offset is the int); else it points at one int32 on the card that
// the kernel reads as q_offset instead (the int is then ignored), so the
// launch depends on shapes only and a CUDA graph captures it once for
// every prefix length of a bucket. q, k, v and out start on 16-byte
// boundaries. causal: 1 = causal with the prefix contract above
// (sk == prefix_pad + s), 0 = non-causal (q_offset == prefix_pad == 0, no
// q_offset_dev, any sk >= 1). window: 0 = none, W > 0 = the causal window
// mode (a query sees the keys less than W positions before it and
// itself). split_keys (non-causal only; 0 = one range): the key range is
// cut into ceil(sk / split_keys) ranges of split_keys keys (a multiple of
// 32), each range's partial output and LSE written into part (ranges x
// (b, s, nq, hd) f32, then ranges x (b, nq, s) f32) and merged by a second
// kernel; part may be null for one range. Returns cudaGetLastError()
// after the last launch (0 == launched).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, void* lse, const void* q_valid,
                             const void* q_offset_dev, void* part, int b,
                             int s, int sk, int nq, int nkv, int hd,
                             int q_offset, int prefix_pad, int causal,
                             int window, int dtype, int split_keys,
                             void* stream) {
  if (b == 0 || s == 0) return 0;
  const bool geometry =
      causal ? (q_offset_dev || prefix_pad >= q_offset) &&
                   sk == prefix_pad + s && split_keys == 0
             : q_offset == 0 && prefix_pad == 0 && sk >= 1 && window == 0 &&
                   !q_offset_dev && split_keys >= 0 &&
                   split_keys % kNcKeyTile == 0;
  const int nsplit = split_keys ? (sk + split_keys - 1) / split_keys : 1;
  if (nkv <= 0 || nq % nkv != 0 || b > 65535 || window < 0 ||
      int64_t(s + kBQ - 1) / kBQ * nsplit > 65535 || !geometry ||
      (nsplit > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto qv = static_cast<const int32_t*>(q_valid);
  auto qo = static_cast<const int32_t*>(q_offset_dev);
  auto ls = static_cast<float*>(lse);
  auto pt = static_cast<float*>(part);
  if (dtype == 0)
    return by_hd<float>(hd, causal, window, q, k, v, out, ls, qv, qo, b, s,
                        sk, nq, nkv, q_offset, prefix_pad, split_keys, pt,
                        st);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, causal, window, q, k, v, out, ls, qv, qo,
                                b, s, sk, nq, nkv, q_offset, prefix_pad,
                                split_keys, pt, st);
  return int(cudaErrorInvalidValue);
}

// flash_prefill_bwd: the gradient of flash-prefill attention (dq, dk, dv
// from do), causal or not, GQA in the kernel, f32 in and out.
//
// The JAX package has no Pallas kernel here: it trains through the jnp
// attention_seq (src/repro/models/modeling.py:80) and takes its gradient
// with jax.value_and_grad. The port's attention_seq runs the hand-written
// forward (flash_prefill.cu), so its gradient is this kernel, behind
// torch.autograd.Function (kernels/ops.py:FlashPrefillFn). The forward
// saves o and the row log-sum-exp lse; nothing of size (s, s) is kept.
//
// Math (FlashAttention-2's backward), with c = 1/sqrt(hd):
//   P = exp(c Q K^T - lse) on the live pairs (the causal ones, or
//       every real key in the non-causal mode), 0 elsewhere
//   D = rowsum(dO * O)              dP = dO V^T
//   dS = P * (dP - D)               dV = P^T dO
//   dQ = c dS K                     dK = c dS^T Q
// dK and dV of a kv head sum over the g query heads of its group.
//
// Contract: q, do, o, dq (b, s, nq, hd); k, v, dk, dv (b, sk, nkv, hd);
// lse and the scratch d (b, nq, s); for g = nq / nkv > 1 the scratch part
// (2, g, b, sk, nkv, hd); all f32, contiguous, 16-byte aligned. Every
// query row real and no prefix (q_offset = prefix_pad = 0, q_valid =
// None), no window: the masks the training forwards use. Two modes, a
// template parameter (CAUSAL) as in flash_prefill.cu:
//  * causal, sk == s: the decoder's self-attention;
//  * non-causal, any sk >= 1: every key live for every query, what
//    attention_seq(causal=False) computes for the whisper encoder (s ==
//    sk == encoder frames) and for cross-attention (s decoder tokens
//    against sk encoder frames).
// hd 32, 64 or 128; any s.
//
// Bound on the H100: operations. The five products run on the tensor
// cores in 3xTF32 (tf32x3.cuh, hi truncated): each f32 operand x is split
// into hi, x's TF32 bits, and lo = x - hi, whose TF32 bits the tensor
// core reads; a product is lo*hi + hi*lo + hi*hi accumulated in f32. What
// is dropped (lo*lo and the bits below lo's TF32) is about 2^-20 of
// |a||b| a term: f32-level accuracy. One TF32 product would keep 2^-10
// and is never taken. So the bound is 3x the five products' flops at 495
// TFLOP/s TF32, the way SDPA's f32 backward runs too (CUTLASS's
// OpMultiplyAddFastF32 on sm80 and later). The
// kernel does 7 products (dQ in its own pass recomputes S and dP:
// deterministic, no atomics), so it reaches at most 5/7 of that bound.
//
// Sums. The tensor core truncates as it adds into its accumulator, so a
// long chain of products into one register drifts toward zero: dK and
// dV, summed over every later query row, lost about 2^-24 of their size
// per product. Each streamed tile's dV, dK or dQ is therefore summed
// from zero on the tensor cores (a chain of 3 BR/8 products) and then
// added to the running sum in f32, which rounds (add_product). S and
// dP are short chains (3 hd/8) and sum in place, but for dP in the
// non-causal mode, where each k-step's product is summed from zero and
// added in f32 (mma3_add<true>). There every query meets every key, and
// where one key holds a row's whole weight dP - D cancels (at sk = 1,
// dS = 0 exactly): the chain's drift in dP (about 2^-23 of the running
// sum an add) then summed over the s g rows of a key into its dK, 1.2e-4
// in a dK of 0 (s = 257, sk = 1, g = 4, hd 128; chip_smoke.py holds the
// kernel to 1e-4), about a third of that with the fresh sums. S stays
// in place (its error moves P relatively, and nothing cancels it), and
// so do both in the causal mode, whose code is unchanged.
//
// Why mma.sync and not wgmma. wgmma reads B (and A unless it sits in
// registers) from shared memory, and for .tf32 only K-major: S and dP
// are, but dV += P^T dO, dK += dS^T Q and dQ += dS K contract over rows
// and would need transposed copies, and 3xTF32 needs every shared
// operand twice (hi and lo). In f32 that is 4x the bytes of a bf16
// tile: at hd 128 the resident K/V tiles of one 64-row warpgroup, their
// splits and a two-stage ring of Q/dO with transposes and splits exceed
// the 227 KB of an SM. mma.sync.m16n8k8.tf32 takes both operands from
// registers, so each thread splits its own fragments after loading raw
// f32 from shared memory (two ops a value, no extra tiles), and the S^T
// (S) accumulator becomes the A fragment of dV and dK (dQ) without
// leaving registers: its columns 2t, 2t+1 stand at the A fragment's k =
// t, t + 4, so the B rows are read in that order. P and dS never touch
// memory. The price: mma.sync runs TF32 below wgmma's rate.
//
// Tiles. A CTA of NW warps holds RES = 16 NW rows resident (K and V in
// the dK/dV pass, Q and dO in the dQ pass; each warp owns 16 rows) and
// streams BR-row tiles of the other pair through a two-stage ring in
// shared memory, filled by the TMA unit (cp.async.bulk, one row per
// copy, completion on an mbarrier per slot), so the next tile lands
// while this one is multiplied. Rows are padded to hd + 4 floats: every
// fragment load (A at rows g and cols t, B at rows 2t and cols g) hits
// 32 distinct banks. Rows past the end repeat the last row (finite
// values), and the masks zero them: lse = +inf for query rows past s;
// keys past sk by the causal mask (causal), or by an explicit P = 0 in
// the dQ pass (non-causal; in the dK/dV pass a key row feeds only its own
// dK, dV row, which is not stored). hd 32: NW = 4, BR = 64 (56 KB); hd
// 64: NW = 4, BR = 32 (69 KB; the smaller tile keeps fewer registers
// live and measured faster at the training shape); hd 128: NW = 8, BR =
// 32 (203 KB, one CTA of 8 warps an SM). A causal warp skips a tile where all
// its keys come after all the tile's queries; a non-causal warp skips
// only when all its own rows lie past the end (keys past sk in the dK/dV
// pass, queries past s in the dQ pass). The causal instantiation is the
// code it was before the non-causal one existed (sk is read as s there).
//
// Launches, in order on the caller's stream:
//  (a) rowdot: D, one warp per (b, row, head);
//  (b) dk/dv: one CTA per (RES-key tile of sk, query head, batch row),
//      each streaming every query tile it meets (causal: from its first
//      key on; non-causal: all of s); early key tiles (the heavy ones in
//      the causal mode) first. For g > 1 each CTA writes its
//      query head's partial dK and dV into the scratch part, so the
//      grid has nq (not nkv) CTAs per key tile and fills the card at
//      GQA shapes; at g = 1 it writes dk and dv themselves;
//  (c) sum_heads (g > 1 only): dk = the g partials summed in head
//      order, and the same for dv: a fixed order, so the result is the
//      same bits on every call;
//  (d) dq: one CTA per (RES-query tile of s, query head, batch row),
//      each streaming every key tile it meets (causal: up to its last
//      query; non-causal: all of sk); late tiles (the heavy ones in the
//      causal mode) first. In the non-causal mode a grid of few query
//      tiles (cross-attention: 448 decoder rows are 7 tiles a head, 448
//      CTAs for 396 slots) is cut into key ranges, one CTA per (query
//      tile, key range, head, batch row), each writing its partial dQ
//      into scratch (the wrapper's dq_split picks the ranges from the
//      shapes and the SM count alone);
//  (e) sum_heads over the key ranges (a split dQ only): dq = the
//      partials summed in range order, a fixed order as in (c).
// Both non-causal passes at hd 64 are held to three CTAs an SM (168
// registers; the dK/dV pass spills 24 bytes): at two, both ran slower at
// whisper's shapes (PERF.md, PR 27).
#include <cuda_runtime.h>
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kRowdotThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Geo {
  static constexpr int NW = HD == 128 ? 8 : 4;      // warps of a CTA
  static constexpr int kThreads = 32 * NW;
  static constexpr int kMinBlocks = HD == 32 ? 3 : (HD == 64 ? 2 : 1);
  // the non-causal passes at hd 64: three CTAs an SM (168 registers)
  static constexpr int kMinBlocksNc = HD == 64 ? 3 : kMinBlocks;
  static constexpr int RES = 16 * NW;               // resident rows
  static constexpr int BR = HD == 32 ? 64 : 32;     // streamed rows
  static constexpr int NT = BR / 8;                 // score n-tiles
  static constexpr int ND = HD / 8;                 // output n-tiles
  static constexpr int kRow = HD + 4;               // padded row, floats
  // shared memory, in floats from the dynamic base: two resident tiles,
  // the ring [slot][tensor][BR][kRow], the ring's lse/D [slot][2][BR],
  // then three mbarriers (ring slots 0 and 1, resident)
  static constexpr int res = 0;
  static constexpr int ring = res + 2 * RES * kRow;
  static constexpr int vec = ring + 4 * BR * kRow;
  static constexpr int bar = vec + 4 * BR;
  static constexpr int bytes = bar * 4 + 3 * 8;
  static_assert(bar % 4 == 0 && kRow % 4 == 0, "16-byte alignment");
  static_assert(bytes <= 227 * 1024, "shared memory");
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` from global to shared memory, completion
// counted on `bar`
__device__ __forceinline__ void bulk_g2s(float* dst, const float* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Warp 0 loads R rows [r0, r0 + R) of one head of two (b, s, heads, HD)
// tensors into two shared tiles of stride HD + 4, one TMA copy per row;
// rows past s repeat row s - 1. Completion lands on `bar`.
template <int HD>
__device__ __forceinline__ void load_rows2(float* d1, float* d2,
                                           const float* s1, const float* s2,
                                           int64_t row_stride, int r0, int R,
                                           int s, uint64_t* bar, int lane) {
  if (lane == 0) mbar_expect_tx(bar, uint32_t(2 * R * HD * 4));
  __syncwarp();
  for (int r = lane; r < R; r += 32) {
    const int64_t src = int64_t(min(r0 + r, s - 1)) * row_stride;
    bulk_g2s(d1 + r * Geo<HD>::kRow, s1 + src, HD * 4, bar);
    bulk_g2s(d2 + r * Geo<HD>::kRow, s2 + src, HD * 4, bar);
  }
}

// float2 stores of a warp's 16 x HD accumulator (rows r0 + g, + 8) times
// mul, rows past s skipped
template <int HD>
__device__ __forceinline__ void store_acc(float* base, int64_t row_stride,
                                          int r0, int s, int g, int t,
                                          const float (&acc)[HD / 8][4],
                                          float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= s) continue;
    float* row = base + int64_t(r) * row_stride + 2 * t;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn)
      *reinterpret_cast<float2*>(row + 8 * nn) = make_float2(
          acc[nn][2 * half] * mul, acc[nn][2 * half + 1] * mul);
  }
}

// ---------------------------------------------------------- kernels

// (a) D[b][h][i] = sum_d dO[b][i][h][d] * O[b][i][h][d], a warp per row
__global__ void rowdot_kernel(const float* __restrict__ dout,
                              const float* __restrict__ o,
                              float* __restrict__ dd, int64_t rows, int s,
                              int nq, int hd) {
  const int64_t row =
      int64_t(blockIdx.x) * (kRowdotThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;   // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int e = lane; e < hd; e += 32)
    acc = fmaf(dout[row * hd + e], o[row * hd + e], acc);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {  // row = (bi * s + i) * nq + h
    const int h = int(row % nq);
    const int i = int((row / nq) % s);
    const int64_t bi = row / (int64_t(nq) * s);
    dd[(bi * nq + h) * s + i] = acc;
  }
}

// (b) dK, dV of one RES-key tile of the kv head of query head h: its
// partial over h's queries (g > 1) or the gradient itself (g = 1)
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(Geo<HD>::kThreads,
                                  CAUSAL ? Geo<HD>::kMinBlocks
                                         : Geo<HD>::kMinBlocksNc)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dd,
            float* __restrict__ dk, float* __restrict__ dv, int b, int s,
            int sk_arg, int nq, int nkv, float scale) {
  using G = Geo<HD>;
  const int sk = CAUSAL ? s : sk_arg;   // key rows
  constexpr int R = G::kRow, BR = G::BR;
  extern __shared__ __align__(128) float sm[];
  float* sK = sm + G::res;
  float* sV = sK + G::RES * R;
  float* ring = sm + G::ring;
  float* vec = sm + G::vec;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + G::bar);

  const int nqb = nq * b;
  const int kt = blockIdx.x / nqb;   // early key tiles see the most queries
  const int h = blockIdx.x % nq;
  const int bi = (blockIdx.x / nq) % b;
  const int g = nq / nkv, kh = h / g, hh = h % g;
  const int k0 = kt * G::RES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tg = lane % 4;
  const int64_t q_row = int64_t(nq) * HD, kv_row = int64_t(nkv) * HD;
  const int64_t q_off = int64_t(bi) * s * q_row + int64_t(h) * HD;
  const int64_t kv_off = int64_t(bi) * sk * kv_row + int64_t(kh) * HD;
  const float* lse_h = lse + (int64_t(bi) * nq + h) * s;
  const float* dd_h = dd + (int64_t(bi) * nq + h) * s;
  const float scale2 = scale * kLog2e;

  // causal: from the first tile with a query >= k0; non-causal: all
  const int t0 = CAUSAL ? k0 / BR : 0;
  const int nt = (s + BR - 1) / BR - t0;     // >= 1: k0 < s, s >= 1
  auto slot_q = [&](int sl) { return ring + (2 * sl) * BR * R; };
  auto slot_do = [&](int sl) { return ring + (2 * sl + 1) * BR * R; };
  // the lse (base 2) and D of the query rows of tile i, into its slot
  auto stage_vec = [&](int i) {
    float* v2 = vec + (i & 1) * 2 * BR;
    const int q0 = (t0 + i) * BR;
    for (int r = threadIdx.x; r < BR; r += G::kThreads) {
      const bool in = q0 + r < s;
      v2[r] = in ? lse_h[q0 + r] * kLog2e : INFINITY;
      v2[BR + r] = in ? dd_h[q0 + r] : 0.f;
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == 0) {
    load_rows2<HD>(sK, sV, k + kv_off, v + kv_off, kv_row, k0, G::RES, sk,
                   bars + 2, lane);
    for (int i = 0; i < 2 && i < nt; ++i)
      load_rows2<HD>(slot_q(i), slot_do(i), q + q_off, dout + q_off, q_row,
                     (t0 + i) * BR, BR, s, bars + i, lane);
  }
  stage_vec(0);
  if (nt > 1) stage_vec(1);
  __syncthreads();

  float acc_k[G::ND][4], acc_v[G::ND][4];
#pragma unroll
  for (int nn = 0; nn < G::ND; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nn][e] = acc_v[nn][e] = 0.f;
  const int kw = k0 + 16 * warp;   // the warp's first key
  const int kr = 16 * warp;        // ... as a row of sK, sV
  mbar_wait(bars + 2, 0);

  for (int i = 0; i < nt; ++i) {
    const int sl = i & 1;
    const int q0 = (t0 + i) * BR;
    mbar_wait(bars + sl, (i >> 1) & 1);
    const float* sQ = slot_q(sl);
    const float* sDO = slot_do(sl);
    const float* sL = vec + sl * 2 * BR;
    // a live pair (warp-uniform); non-causal: a real key of the warp
    if (CAUSAL ? kw <= min(q0 + BR - 1, s - 1) : kw < sk) {
      float st[G::NT][4], dpt[G::NT][4];   // S^T, dP^T: keys x queries
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < HD / 8; ++kk) {
        FragA ak, av;
        load_a<R>(ak, sK, kr, 8 * kk, gr, tg);
        load_a<R>(av, sV, kr, 8 * kk, gr, tg);
#pragma unroll
        for (int j = 0; j < G::NT; ++j) {
          FragB bq, bo;
          load_b_t<R>(bq, sQ, 8 * j, 8 * kk, gr, tg);
          mma3(st[j], ak, bq);
          load_b_t<R>(bo, sDO, 8 * j, 8 * kk, gr, tg);
          mma3_add<!CAUSAL>(dpt[j], av, bo);
        }
      }
      // some key after some query (causal); the non-causal mode masks no
      // key here: a key past sk feeds only its own row of dK, dV, which
      // store_acc skips
      const bool diag = CAUSAL && kw + 15 > q0;
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * tg + (e & 1);
          const int key = kw + gr + 8 * (e >> 1);
          float p = exp2f(st[j][e] * scale2 - sL[qi]);
          if (diag && key > q0 + qi) p = 0.f;
          st[j][e] = p;                              // P^T
          dpt[j][e] = p * (dpt[j][e] - sL[BR + qi]); // dS^T
        }
      add_product<HD, G::NT>(acc_v, st, sDO, gr, tg);    // dV += P^T dO
      add_product<HD, G::NT>(acc_k, dpt, sQ, gr, tg);    // dK += dS^T Q
    }
    __syncthreads();   // every warp is done with slot sl
    if (i + 2 < nt) {
      if (warp == 0)
        load_rows2<HD>(slot_q(sl), slot_do(sl), q + q_off, dout + q_off,
                       q_row, (t0 + i + 2) * BR, BR, s, bars + sl, lane);
      stage_vec(i + 2);
    }
  }
  const int64_t part = int64_t(hh) * b * sk * kv_row;   // 0 at g = 1
  store_acc<HD>(dk + part + kv_off, kv_row, kw, sk, gr, tg, acc_k, scale);
  store_acc<HD>(dv + part + kv_off, kv_row, kw, sk, gr, tg, acc_v, 1.f);
}

// (c) out = the g partials summed in head order (g > 1)
__global__ void sum_heads_kernel(const float4* __restrict__ part,
                                 float4* __restrict__ out, int64_t n4,
                                 int g) {
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += int64_t(gridDim.x) * blockDim.x) {
    float4 a = part[i];
    for (int hh = 1; hh < g; ++hh) {
      const float4 x = part[hh * n4 + i];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    out[i] = a;
  }
}

// (d) dQ of one RES-row query tile of one query head; in the non-causal
// mode with split_keys > 0, its partial over one range of split_keys keys,
// written to slab sp of dq (the partials are summed by sum_heads_kernel)
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(Geo<HD>::kThreads,
                                  CAUSAL ? Geo<HD>::kMinBlocks
                                         : Geo<HD>::kMinBlocksNc)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dd,
          float* __restrict__ dq, int b, int s, int sk_arg, int nq, int nkv,
          float scale, int split_keys) {
  using G = Geo<HD>;
  const int sk = CAUSAL ? s : sk_arg;   // key rows
  constexpr int R = G::kRow, BR = G::BR;
  extern __shared__ __align__(128) float sm[];
  float* sQ = sm + G::res;
  float* sDO = sQ + G::RES * R;
  float* ring = sm + G::ring;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + G::bar);

  const int nqb = nq * b;
  const int nres = (s + G::RES - 1) / G::RES;
  const int idx = blockIdx.x / nqb;
  const int qt = nres - 1 - (CAUSAL ? idx : idx % nres);  // late tiles first
  // non-causal: the key range [kb, ke) of split sp (all of sk unsplit)
  const int sp = CAUSAL ? 0 : idx / nres;
  const int kb = CAUSAL ? 0 : sp * split_keys;
  const int ke = CAUSAL || split_keys == 0 ? sk_arg
                                           : min(sk_arg, kb + split_keys);
  const int h = blockIdx.x % nq;
  const int bi = (blockIdx.x / nq) % b;
  const int kh = h / (nq / nkv);
  const int q0 = qt * G::RES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tg = lane % 4;
  const int64_t q_row = int64_t(nq) * HD, kv_row = int64_t(nkv) * HD;
  const int64_t q_off = int64_t(bi) * s * q_row + int64_t(h) * HD;
  const int64_t kv_off = int64_t(bi) * sk * kv_row + int64_t(kh) * HD;
  const float scale2 = scale * kLog2e;

  // key tiles: causal, up to the tile's last query; non-causal, all of
  // [kb, ke)
  const int nt = CAUSAL ? min(q0 + G::RES - 1, s - 1) / BR + 1
                        : (ke - kb + BR - 1) / BR;
  auto slot_k = [&](int sl) { return ring + (2 * sl) * BR * R; };
  auto slot_v = [&](int sl) { return ring + (2 * sl + 1) * BR * R; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == 0) {
    load_rows2<HD>(sQ, sDO, q + q_off, dout + q_off, q_row, q0, G::RES, s,
                   bars + 2, lane);
    for (int i = 0; i < 2 && i < nt; ++i)
      load_rows2<HD>(slot_k(i), slot_v(i), k + kv_off, v + kv_off, kv_row,
                     kb + i * BR, BR, sk, bars + i, lane);
  }
  const int qw = q0 + 16 * warp;   // the warp's first query row
  const int qr = 16 * warp;        // ... as a row of sQ, sDO
  float lse2[2], dval[2];          // rows qw + gr and qw + gr + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = qw + gr + 8 * half;
    const int64_t at = (int64_t(bi) * nq + h) * s + r;
    lse2[half] = r < s ? lse[at] * kLog2e : INFINITY;
    dval[half] = r < s ? dd[at] : 0.f;
  }
  float acc[G::ND][4];
#pragma unroll
  for (int nn = 0; nn < G::ND; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
  mbar_wait(bars + 2, 0);

  for (int i = 0; i < nt; ++i) {
    const int sl = i & 1;
    const int k0 = kb + i * BR;
    mbar_wait(bars + sl, (i >> 1) & 1);
    const float* sK = slot_k(sl);
    const float* sV = slot_v(sl);
    // a live pair (warp-uniform); non-causal: a real query of the warp
    if (CAUSAL ? k0 <= min(qw + 15, s - 1) : qw < s) {
      float sc[G::NT][4], dp[G::NT][4];   // S, dP: queries x keys
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < HD / 8; ++kk) {
        FragA aq, ao;
        load_a<R>(aq, sQ, qr, 8 * kk, gr, tg);
        load_a<R>(ao, sDO, qr, 8 * kk, gr, tg);
#pragma unroll
        for (int j = 0; j < G::NT; ++j) {
          FragB bk, bv;
          load_b_t<R>(bk, sK, 8 * j, 8 * kk, gr, tg);
          mma3(sc[j], aq, bk);
          load_b_t<R>(bv, sV, 8 * j, 8 * kk, gr, tg);
          mma3_add<!CAUSAL>(dp[j], ao, bv);
        }
      }
      // causal: some key after some row; non-causal: keys past the range
      // (the last tile's padding, copies of key sk - 1, or the next
      // range's keys) are masked here, as they would add to every row's dQ
      const bool diag = CAUSAL ? k0 + BR - 1 > qw : k0 + BR > ke;
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tg + (e & 1);
          const int row = qw + gr + 8 * (e >> 1);
          float p = exp2f(sc[j][e] * scale2 - lse2[e >> 1]);
          if (diag && (CAUSAL ? key > row : key >= ke)) p = 0.f;
          dp[j][e] = p * (dp[j][e] - dval[e >> 1]);   // dS
        }
      add_product<HD, G::NT>(acc, dp, sK, gr, tg);       // dQ += dS K
    }
    __syncthreads();   // every warp is done with slot sl
    if (i + 2 < nt && warp == 0)
      load_rows2<HD>(slot_k(sl), slot_v(sl), k + kv_off, v + kv_off, kv_row,
                     kb + (i + 2) * BR, BR, sk, bars + sl, lane);
  }
  const int64_t slab = CAUSAL ? 0 : int64_t(sp) * b * s * q_row;
  store_acc<HD>(dq + slab + q_off, q_row, qw, s, gr, tg, acc, scale);
}

// Above 48 KB a kernel must be allowed its dynamic shared memory, once
// per device (not again inside a CUDA graph capture).
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

template <int HD, bool CAUSAL>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* lse, const float* dout,
                   float* dq, float* dk, float* dv, float* dd, float* part,
                   float* part_q, int split_keys, int b, int s, int sk,
                   int nq, int nkv, cudaStream_t st) {
  using G = Geo<HD>;
  static bool allowed_kv[64] = {}, allowed_q[64] = {};
  cudaError_t err = allow_smem(dkdv_kernel<HD, CAUSAL>, G::bytes, allowed_kv);
  if (err != cudaSuccess) return err;
  err = allow_smem(dq_kernel<HD, CAUSAL>, G::bytes, allowed_q);
  if (err != cudaSuccess) return err;
  const int g = nq / nkv;
  // the dK/dV grid tiles the keys, the dQ grid the queries
  const int64_t ctas_kv = (sk + G::RES - 1) / G::RES * int64_t(nq) * b;
  // non-causal: the dQ pass over nsplit key ranges of split_keys keys
  const int nsplit = split_keys > 0 ? (sk + split_keys - 1) / split_keys : 1;
  const int64_t ctas_q =
      (s + G::RES - 1) / G::RES * int64_t(nq) * b * nsplit;
  if (ctas_kv > 0x7fffffff || ctas_q > 0x7fffffff ||
      (g > 1 && part == nullptr) ||
      (split_keys != 0 && (CAUSAL || split_keys % G::BR != 0)) ||
      (nsplit > 1 && part_q == nullptr))
    return cudaErrorInvalidValue;
  const int64_t rows = int64_t(b) * s * nq;
  const int64_t warps = kRowdotThreads / 32;
  rowdot_kernel<<<unsigned((rows + warps - 1) / warps), kRowdotThreads, 0,
                  st>>>(dout, o, dd, rows, s, nq, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(float(HD));
  const int64_t slab = int64_t(b) * sk * nkv * HD;   // one dk-sized tensor
  float* pk = g > 1 ? part : dk;
  float* pv = g > 1 ? part + g * slab : dv;
  dkdv_kernel<HD, CAUSAL><<<unsigned(ctas_kv), G::kThreads, G::bytes, st>>>(
      q, k, v, dout, lse, dd, pk, pv, b, s, sk, nq, nkv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto sum_blocks = [](int64_t n4) {
    return unsigned(std::min<int64_t>((n4 + 255) / 256, 132 * 16));
  };
  if (g > 1) {
    const int64_t n4 = slab / 4;
    const unsigned blocks = sum_blocks(n4);
    sum_heads_kernel<<<blocks, 256, 0, st>>>(
        reinterpret_cast<const float4*>(pk), reinterpret_cast<float4*>(dk),
        n4, g);
    sum_heads_kernel<<<blocks, 256, 0, st>>>(
        reinterpret_cast<const float4*>(pv), reinterpret_cast<float4*>(dv),
        n4, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dq_kernel<HD, CAUSAL><<<unsigned(ctas_q), G::kThreads, G::bytes, st>>>(
      q, k, v, dout, lse, dd, nsplit > 1 ? part_q : dq, b, s, sk, nq, nkv,
      scale, nsplit > 1 ? split_keys : 0);
  if (nsplit == 1) return cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // (e) dq = the nsplit partials summed in key order
  const int64_t n4 = int64_t(b) * s * nq * HD / 4;
  sum_heads_kernel<<<sum_blocks(n4), 256, 0, st>>>(
      reinterpret_cast<const float4*>(part_q), reinterpret_cast<float4*>(dq),
      n4, nsplit);
  return cudaGetLastError();
}

template <bool CAUSAL>
cudaError_t by_hd(int hd, const float* q, const float* k, const float* v,
                  const float* o, const float* lse, const float* dout,
                  float* dq, float* dk, float* dv, float* dd, float* part,
                  float* part_q, int split_keys, int b, int s, int sk, int nq,
                  int nkv, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<32, CAUSAL>(q, k, v, o, lse, dout, dq, dk, dv, dd, part,
                                part_q, split_keys, b, s, sk, nq, nkv, st);
    case 64:
      return launch<64, CAUSAL>(q, k, v, o, lse, dout, dq, dk, dv, dd, part,
                                part_q, split_keys, b, s, sk, nq, nkv, st);
    case 128:
      return launch<128, CAUSAL>(q, k, v, o, lse, dout, dq, dk, dv, dd, part,
                                 part_q, split_keys, b, s, sk, nq, nkv, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// All f32, contiguous, 16-byte aligned: q, o, dout, dq (b, s, nq, hd); k,
// v, dk, dv (b, sk, nkv, hd); lse (b, nq, s) as flash_prefill writes it;
// dd (b, nq, s) scratch for D; part (2, nq / nkv, b, sk, nkv, hd) scratch
// for the per-head partial dK, dV (may be null when nq == nkv). No prefix,
// every query row real. causal: 1 = causal (sk == s), 0 = non-causal (any
// sk >= 1). split_keys (non-causal only; 0 = one range): the dQ pass runs
// over ceil(sk / split_keys) key ranges of split_keys keys (a multiple of
// the streamed tile: 64 rows at hd 32, else 32), each writing a partial dQ
// into part_q (ranges, b, s, nq, hd), which are then summed in order into
// dq; part_q may be null for one range. Returns cudaGetLastError() after
// the last launch (0 == launched).
extern "C" int flash_prefill_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* lse,
                                 const void* dout, void* dq, void* dk,
                                 void* dv, void* dd, void* part,
                                 void* part_q, int b, int s, int sk, int nq,
                                 int nkv, int hd, int causal, int split_keys,
                                 void* stream) {
  if (b < 0 || s < 0 || sk < 0 || nkv <= 0 || nq % nkv != 0 ||
      split_keys < 0 || (causal ? sk != s : sk < 1 && b > 0 && s > 0))
    return int(cudaErrorInvalidValue);
  if (b == 0 || s == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  if (causal)
    return by_hd<true>(hd, f(q), f(k), f(v), f(o), f(lse), f(dout), w(dq),
                       w(dk), w(dv), w(dd), w(part), w(part_q), split_keys,
                       b, s, s, nq, nkv, st);
  return by_hd<false>(hd, f(q), f(k), f(v), f(o), f(lse), f(dout), w(dq),
                      w(dk), w(dv), w(dd), w(part), w(part_q), split_keys, b,
                      s, sk, nq, nkv, st);
}

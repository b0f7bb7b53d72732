// flash_prefill_bwd: the gradient of causal flash-prefill attention (dq,
// dk, dv from do), GQA in the kernel, f32.
//
// The JAX package has no Pallas kernel here: it trains through the jnp
// attention_seq (src/repro/models/modeling.py:80) and takes its gradient
// with jax.value_and_grad. The port's attention_seq runs the hand-written
// forward (flash_prefill.cu), so its gradient is this kernel, behind
// torch.autograd.Function (kernels/ops.py:FlashPrefillFn). The forward
// saves o and the row log-sum-exp lse; nothing of size (s, s) is kept.
//
// Math (FlashAttention-2's backward), with c = 1/sqrt(hd):
//   P = exp(c Q K^T - lse) on the causal pairs, 0 elsewhere
//   D = rowsum(dO * O)              dP = dO V^T
//   dS = P * (dP - D)               dV = P^T dO
//   dQ = c dS K                     dK = c dS^T Q
// dK and dV of a kv head sum over the g query heads of its group.
//
// Contract: q, do, o, dq (b, s, nq, hd); k, v, dk, dv (b, s, nkv, hd);
// lse and the scratch d (b, nq, s); all f32, contiguous, 16-byte aligned.
// Causal with every query row real and no prefix (q_offset = prefix_pad
// = 0, q_valid = None): the masks the training forward uses. hd 32, 64 or
// 128; any s (tail rows of a tile are zero-filled and masked).
//
// Bound on the H100: operations. 2.5x the forward's flops (the five
// products above) at the 67 TFLOP/s f32 rate of the CUDA cores; f32 stays
// f32 (TF32 would keep three decimal digits). This first version does
// seven products, not five (the dQ pass recomputes S and dP so that no
// CTA writes another's rows: deterministic, no atomics), on the CUDA
// cores with register micro-tiles fed from shared memory; a wgmma/TMA
// version with a fused dQ is later work.
//
// Design. Three launches on the caller's stream:
//  (a) rowdot: D, one warp per (b, row, head);
//  (b) dk/dv: one CTA of 128 threads per (32-key tile, kv head, batch
//      row), early key tiles (the heavy ones) first. K and V of the tile
//      sit in shared memory; the CTA walks the g query heads of its group
//      and the 32-row query tiles from the diagonal on, recomputes S^T and
//      dP^T (4 x 2 keys x queries per thread, float4 runs of both rows),
//      forms P^T and dS^T in shared memory, and accumulates dV += P^T dO
//      and dK += dS^T Q in registers (RPT keys x DPT dims per thread).
//      GQA sums inside the CTA;
//  (c) dq: one CTA per (32-row query tile, query head, batch row), late
//      tiles (the heavy ones) first; Q and dO of the tile in shared
//      memory, the key tiles up to the diagonal streamed through, dQ +=
//      dS K in registers.
// Tiles are loaded with plain float4 loads between barriers; the two
// CTAs an SM holds (77 KB of shared memory each at hd 128) overlap one's
// loads with the other's arithmetic.
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 32;   // rows of every tile, queries and keys
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Shared-memory layout of one CTA, in floats from the dynamic base: two
// resident row tiles (a1, a2), two streamed ones (b1, b2), two 32 x 32
// score tiles stored column-major ([streamed][resident]), and the
// streamed or resident query rows' lse (base 2) and D.
template <int HD>
struct Geo {
  static constexpr int kRow = HD + 4;   // +16 B: float4 runs, no conflicts
  static constexpr int kMRow = kT + 4;
  static constexpr int a1 = 0;
  static constexpr int a2 = a1 + kT * kRow;
  static constexpr int b1 = a2 + kT * kRow;
  static constexpr int b2 = b1 + kT * kRow;
  static constexpr int m1 = b2 + kT * kRow;
  static constexpr int m2 = m1 + kT * kMRow;
  static constexpr int lse = m2 + kT * kMRow;
  static constexpr int dd = lse + kT;
  static constexpr int bytes = (dd + kT) * 4;
  // accumulator tile: RPT resident rows x DPT dims per thread, dims
  // 4 * dg + 4 * DG * u + e (u < NU, e < 4)
  static constexpr int PE = kT * HD / kThreads;
  static constexpr int RPT = PE >= 16 ? 4 : 2;
  static constexpr int DPT = PE / RPT;
  static constexpr int DG = HD / DPT;
  static constexpr int NU = DPT / 4;
  static_assert((kThreads / DG) * RPT == kT && DPT % 4 == 0, "tile");
};

// kT rows [r0, r0 + kT) of one head of a (b, s, heads, HD) tensor into a
// shared tile of stride HD + 4; rows past s are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          int64_t row_stride, int r0,
                                          int s) {
  for (int i = threadIdx.x; i < kT * HD / 4; i += kThreads) {
    const int r = i / (HD / 4);
    const int d = 4 * (i % (HD / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < s) x = ld4(base + int64_t(r0 + r) * row_stride + d);
    st4(dst + r * Geo<HD>::kRow + d, x);
  }
}

// The two score products of a tile pair: x = A1 B1^T and y = A2 B2^T at
// resident rows r0 + 16 a (a < 2) and streamed rows c0 + 8 b (b < 4).
template <int HD>
__device__ __forceinline__ void scores2(const float* A1, const float* B1,
                                        const float* A2, const float* B2,
                                        int r0, int c0, float x[2][4],
                                        float y[2][4]) {
  constexpr int R = Geo<HD>::kRow;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) x[a][b] = y[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a1[2], a2[2], b1[4], b2[4];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      a1[a] = ld4(A1 + (r0 + 16 * a) * R + d);
      a2[a] = ld4(A2 + (r0 + 16 * a) * R + d);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      b1[b] = ld4(B1 + (c0 + 8 * b) * R + d);
      b2[b] = ld4(B2 + (c0 + 8 * b) * R + d);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        x[a][b] = dot4(a1[a], b1[b], x[a][b]);
        y[a][b] = dot4(a2[a], b2[b], y[a][b]);
      }
  }
}

// acc[i][.] += sum_c M[c][prg * RPT + i] * B[c][dims]
template <int HD>
__device__ __forceinline__ void accumulate(
    const float* M, const float* B, int prg, int dg,
    float (&acc)[Geo<HD>::RPT][Geo<HD>::DPT], int c) {
  using G = Geo<HD>;
  float m[G::RPT], bv[G::DPT];
#pragma unroll
  for (int i = 0; i < G::RPT; ++i) m[i] = M[c * G::kMRow + prg * G::RPT + i];
#pragma unroll
  for (int u = 0; u < G::NU; ++u) {
    const float4 x = ld4(B + c * G::kRow + 4 * dg + 4 * G::DG * u);
    bv[4 * u] = x.x;
    bv[4 * u + 1] = x.y;
    bv[4 * u + 2] = x.z;
    bv[4 * u + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < G::RPT; ++i)
#pragma unroll
    for (int e = 0; e < G::DPT; ++e) acc[i][e] = fmaf(m[i], bv[e], acc[i][e]);
}

template <int HD>
__device__ __forceinline__ void store_rows(
    float* base, int64_t row_stride, int r0, int s, int prg, int dg,
    const float (&acc)[Geo<HD>::RPT][Geo<HD>::DPT], float mul) {
  using G = Geo<HD>;
#pragma unroll
  for (int i = 0; i < G::RPT; ++i) {
    const int r = r0 + prg * G::RPT + i;
    if (r >= s) continue;
#pragma unroll
    for (int u = 0; u < G::NU; ++u)
      st4(base + int64_t(r) * row_stride + 4 * dg + 4 * G::DG * u,
          make_float4(acc[i][4 * u] * mul, acc[i][4 * u + 1] * mul,
                      acc[i][4 * u + 2] * mul, acc[i][4 * u + 3] * mul));
  }
}

// (a) D[b][h][i] = sum_d dO[b][i][h][d] * O[b][i][h][d], a warp per row
__global__ void rowdot_kernel(const float* __restrict__ dout,
                              const float* __restrict__ o,
                              float* __restrict__ dd, int64_t rows, int s,
                              int nq, int hd) {
  const int64_t row =
      int64_t(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
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

// (b) dK, dV of one 32-key tile of one kv head
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dd,
            float* __restrict__ dk, float* __restrict__ dv, int s, int nq,
            int nkv, float scale) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) float sm[];
  float* sK = sm + G::a1;
  float* sV = sm + G::a2;
  float* sQ = sm + G::b1;
  float* sDO = sm + G::b2;
  float* sP = sm + G::m1;
  float* sDS = sm + G::m2;
  float* sLse = sm + G::lse;
  float* sD = sm + G::dd;

  const int kt = blockIdx.x;       // early key tiles see the most queries
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int k0 = kt * kT;
  const int g = nq / nkv;
  const int tid = threadIdx.x;
  const int r0 = tid / 8, c0 = tid % 8;         // score micro-tile
  const int dg = tid % G::DG, prg = tid / G::DG;  // accumulator tile
  const int64_t q_row = int64_t(nq) * HD;
  const int64_t kv_row = int64_t(nkv) * HD;
  const int64_t kv_off = int64_t(bi) * s * kv_row + int64_t(kh) * HD;
  const float scale2 = scale * kLog2e;

  load_tile<HD>(sK, k + kv_off, kv_row, k0, s);
  load_tile<HD>(sV, v + kv_off, kv_row, k0, s);
  float acc_k[G::RPT][G::DPT], acc_v[G::RPT][G::DPT];
#pragma unroll
  for (int i = 0; i < G::RPT; ++i)
#pragma unroll
    for (int e = 0; e < G::DPT; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  const int nqt = (s + kT - 1) / kT;
  for (int hh = 0; hh < g; ++hh) {
    const int h = kh * g + hh;
    const int64_t q_off = int64_t(bi) * s * q_row + int64_t(h) * HD;
    const float* lse_h = lse + (int64_t(bi) * nq + h) * s;
    const float* dd_h = dd + (int64_t(bi) * nq + h) * s;
    for (int qt = kt; qt < nqt; ++qt) {   // causal: query rows >= k0
      const int q0 = qt * kT;
      __syncthreads();   // the last tile's readers are done
      load_tile<HD>(sQ, q + q_off, q_row, q0, s);
      load_tile<HD>(sDO, dout + q_off, q_row, q0, s);
      if (tid < kT) {
        const bool in = q0 + tid < s;
        sLse[tid] = in ? lse_h[q0 + tid] * kLog2e : INFINITY;
        sD[tid] = in ? dd_h[q0 + tid] : 0.f;
      }
      __syncthreads();
      float x[2][4], y[2][4];   // S^T and dP^T: keys x queries
      scores2<HD>(sK, sQ, sV, sDO, r0, c0, x, y);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int kr = r0 + 16 * a, qc = c0 + 8 * b;
          const bool live = k0 + kr <= q0 + qc && q0 + qc < s;
          const float p = live ? exp2f(x[a][b] * scale2 - sLse[qc]) : 0.f;
          sP[qc * G::kMRow + kr] = p;
          sDS[qc * G::kMRow + kr] = p * (y[a][b] - sD[qc]);
        }
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < kT; ++c) {
        accumulate<HD>(sP, sDO, prg, dg, acc_v, c);
        accumulate<HD>(sDS, sQ, prg, dg, acc_k, c);
      }
    }
  }
  store_rows<HD>(dk + kv_off, kv_row, k0, s, prg, dg, acc_k, scale);
  store_rows<HD>(dv + kv_off, kv_row, k0, s, prg, dg, acc_v, 1.f);
}

// (c) dQ of one 32-row query tile of one query head
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dd,
          float* __restrict__ dq, int s, int nq, int nkv, float scale) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) float sm[];
  float* sQ = sm + G::a1;
  float* sDO = sm + G::a2;
  float* sK = sm + G::b1;
  float* sV = sm + G::b2;
  float* sDS = sm + G::m1;
  float* sLse = sm + G::lse;
  float* sD = sm + G::dd;

  const int qt = gridDim.x - 1 - blockIdx.x;   // late tiles first
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int q0 = qt * kT;
  const int kh = h / (nq / nkv);
  const int tid = threadIdx.x;
  const int r0 = tid / 8, c0 = tid % 8;
  const int dg = tid % G::DG, prg = tid / G::DG;
  const int64_t q_row = int64_t(nq) * HD;
  const int64_t kv_row = int64_t(nkv) * HD;
  const int64_t q_off = int64_t(bi) * s * q_row + int64_t(h) * HD;
  const int64_t kv_off = int64_t(bi) * s * kv_row + int64_t(kh) * HD;
  const float scale2 = scale * kLog2e;

  load_tile<HD>(sQ, q + q_off, q_row, q0, s);
  load_tile<HD>(sDO, dout + q_off, q_row, q0, s);
  if (tid < kT) {
    const int64_t at = (int64_t(bi) * nq + h) * s + q0 + tid;
    const bool in = q0 + tid < s;
    sLse[tid] = in ? lse[at] * kLog2e : INFINITY;
    sD[tid] = in ? dd[at] : 0.f;
  }
  float acc[G::RPT][G::DPT];
#pragma unroll
  for (int i = 0; i < G::RPT; ++i)
#pragma unroll
    for (int e = 0; e < G::DPT; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {   // causal: key rows <= the tile's
    const int k0 = kt * kT;
    __syncthreads();
    load_tile<HD>(sK, k + kv_off, kv_row, k0, s);
    load_tile<HD>(sV, v + kv_off, kv_row, k0, s);
    __syncthreads();
    float x[2][4], y[2][4];   // S and dP: queries x keys
    scores2<HD>(sQ, sK, sDO, sV, r0, c0, x, y);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int qr = r0 + 16 * a, kc = c0 + 8 * b;
        const bool live = k0 + kc <= q0 + qr && q0 + qr < s;
        const float p = live ? exp2f(x[a][b] * scale2 - sLse[qr]) : 0.f;
        sDS[kc * G::kMRow + qr] = p * (y[a][b] - sD[qr]);
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kT; ++c) accumulate<HD>(sDS, sK, prg, dg, acc, c);
  }
  store_rows<HD>(dq + q_off, q_row, q0, s, prg, dg, acc, scale);
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

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* lse, const float* dout,
                   float* dq, float* dk, float* dv, float* dd, int b, int s,
                   int nq, int nkv, cudaStream_t st) {
  constexpr int bytes = Geo<HD>::bytes;
  static bool allowed_kv[64] = {}, allowed_q[64] = {};
  cudaError_t err = allow_smem(dkdv_kernel<HD>, bytes, allowed_kv);
  if (err != cudaSuccess) return err;
  err = allow_smem(dq_kernel<HD>, bytes, allowed_q);
  if (err != cudaSuccess) return err;
  const int64_t rows = int64_t(b) * s * nq;
  const int64_t warps = kThreads / 32;
  rowdot_kernel<<<unsigned((rows + warps - 1) / warps), kThreads, 0, st>>>(
      dout, o, dd, rows, s, nq, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nt = (s + kT - 1) / kT;
  const float scale = 1.f / sqrtf(float(HD));
  dkdv_kernel<HD><<<dim3(nt, nkv, b), kThreads, bytes, st>>>(
      q, k, v, dout, lse, dd, dk, dv, s, nq, nkv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<HD><<<dim3(nt, nq, b), kThreads, bytes, st>>>(
      q, k, v, dout, lse, dd, dq, s, nq, nkv, scale);
  return cudaGetLastError();
}

}  // namespace

// All f32, contiguous, 16-byte aligned: q, o, dout, dq (b, s, nq, hd); k,
// v, dk, dv (b, s, nkv, hd); lse (b, nq, s) as flash_prefill writes it;
// dd (b, nq, s) scratch for D. Causal, no prefix, every query row real.
// Returns cudaGetLastError() after the last launch (0 == launched).
extern "C" int flash_prefill_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* lse,
                                 const void* dout, void* dq, void* dk,
                                 void* dv, void* dd, int b, int s, int nq,
                                 int nkv, int hd, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (nkv <= 0 || nq % nkv != 0 || b > 65535 || nq > 65535)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  switch (hd) {
    case 32:
      return launch<32>(f(q), f(k), f(v), f(o), f(lse), f(dout), w(dq),
                        w(dk), w(dv), w(dd), b, s, nq, nkv, st);
    case 64:
      return launch<64>(f(q), f(k), f(v), f(o), f(lse), f(dout), w(dq),
                        w(dk), w(dv), w(dd), b, s, nq, nkv, st);
    case 128:
      return launch<128>(f(q), f(k), f(v), f(o), f(lse), f(dout), w(dq),
                         w(dk), w(dv), w(dd), b, s, nq, nkv, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

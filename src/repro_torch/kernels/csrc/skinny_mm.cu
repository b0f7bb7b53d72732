// skinny_mm: y (M, N) = x (M, K) @ W for a few rows (M <= 32), f32 in
// and out, f32-accurate (3xTF32 on the tensor cores, f32 sums); one
// launch takes up to three such products of one x (the decode step's q,
// k and v, or gate and up), their column tiles one stream.
//
// W is f32 in one of two layouts, each a template instantiation:
//  * NN: row-major (K, N), row stride ldw (the decode step's projections,
//    MLP, shared experts and an untied head);
//  * T: the transpose of a row-major (N, K), row stride ldw (a tied head,
//    embed.T).
// x is row-major (M, K) with row stride ldx.
//
// It replaces no TPU kernel: the JAX package leaves its dense products to
// XLA. It was added because the decode step's products ran on cuBLAS's
// f32 GEMMs on the CUDA cores at 40-50% of the HBM rate, while at 32 rows
// a product is bound by its weight bytes, each read once: 2 M flops a
// weight element (64 at M = 32) against 4 bytes. So the design is a
// stream of W at the HBM rate:
//
//  * the work is (column tile of 128, K-stage of 32) iterations,
//    tile-major, and the grid is two CTAs an SM (one for a small product;
//    kernels/skinny_mm.py:ctas), each taking an equal contiguous run of
//    iterations, which may start and end inside a tile: no CTA waits for a
//    second wave, and the card is busy to the end;
//  * a CTA streams its run through a 4-stage cp.async ring of 16 KiB of W
//    a stage (marked evict-first in L2; with the stage's K-range of x, read
//    from L2);
//  * the products are 3xTF32 on wgmma (m64nNk8, N = 8, 16 or 32 rows of
//    x): both operands split as csrc/tf32x3.cuh's forward form splits them
//    (round to nearest), lo rounded to TF32 too, and lo*hi + hi*lo + hi*hi
//    summed. W is the A operand, 64 columns a warpgroup, split in
//    registers from the padded ring slot; x^T is B, split once a stage
//    into a hi and a lo tile in shared memory that both warpgroups read.
//    mma.sync's TF32 rate held the stream at ~2.3 TB/s (measured); wgmma
//    keeps up. A stage's 12 products are summed from zero on the tensor
//    cores and added to f32 registers;
//  * where a CTA's run leaves a tile, its 32 x 128 sums go through shared
//    memory (the ring slot just read, while the next stages' loads stay
//    in flight) out in 16-byte stores: to y where one CTA covers the tile
//    whole, else to the CTA's own slot of scratch, and the last of the
//    tile's CTAs to arrive (a per-tile counter, which it resets to zero
//    for the next launch) sums the slots in CTA order, compensated (Kahan:
//    a small product's tile may have dozens). No float atomics: the same
//    inputs give the same bits on every launch and every graph replay.
#include <cuda.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups, 64 columns each
constexpr int kMaxM = 32;
constexpr int kBN = 128;       // columns a tile
constexpr int kBK = 32;        // K a stage
constexpr int kStages = 4;
constexpr int kXLD = kBK + 4;          // raw x stage [m][k]
constexpr int kWLD_NN = kBN + 8;       // W stage [k][n]
constexpr int kWLD_T = kBK + 4;        // W stage [n][k]
constexpr int kXF = kMaxM * kXLD;      // floats
constexpr int kWF = kBN * kWLD_T > kBK * kWLD_NN ? kBN * kWLD_T
                                                  : kBK * kWLD_NN;
constexpr int kStage = kXF + kWF;      // floats a ring slot
constexpr int kPieces = kBK * kBN / 4 / kThreads;  // W pieces a thread
// x^T as wgmma's B, K-major without swizzle: 8-row x 16-byte core
// matrices, K-adjacent ones 128 bytes apart (LBO), 8-row groups kBK * 32
// bytes apart (SBO)
constexpr int kBF = kMaxM * kBK;       // floats of one of hi, lo
constexpr int kSBO = kBK * 32;
constexpr int kOutLD = kBN + 4;        // the sums' staging tile [m][n]
static_assert(kMaxM * kOutLD <= kStage, "the staging tile fits a slot");
constexpr int kMaxSeg = 3;             // products of one x a launch

// The products of a launch, which share x, K and the layout: product q's
// column tiles are the launch's tiles [tile0[q], tile0[q + 1])
struct Segs {
  const float* w[kMaxSeg];
  float* y[kMaxSeg];
  int N[kMaxSeg], ldw[kMaxSeg];
  int tile0[kMaxSeg + 1];
  int n;
};

// the product a launch's tile belongs to
__device__ __forceinline__ int seg_of(const Segs& s, int tile) {
  int q = 0;
#pragma unroll
  for (int k = 1; k < kMaxSeg; ++k) q += k < s.n && tile >= s.tile0[k];
  return q;
}
constexpr int kSmem = (kStages * kStage + 2 * kBF) * 4 + 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; n < 16 source bytes zero-fill the rest
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n)
               : "memory");
}
// the same, the line marked first to leave L2 (a weight read once)
__device__ __forceinline__ void cp_async16_once(void* smem, const void* gmem,
                                                int n, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::
          "r"(smem_u32(smem)),
      "l"(gmem), "r"(n), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x -> hi + lo, both TF32 rounded to nearest (csrc/tf32x3.cuh's split<true>
// leaves lo for the tensor core to truncate, 2^-21 of |x| at worst; this
// rounds it too, to 2^-22)
__device__ __forceinline__ void split_rn(float x, uint32_t& hi,
                                         uint32_t& lo) {
  split<true>(x, hi, lo);
  lo = (lo + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint64_t desc_b(const float* tile) {
  return uint64_t((smem_u32(tile) & 0x3ffff) >> 4) |
         (uint64_t(128 >> 4) << 16) | (uint64_t(kSBO >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d (64 x 8 NB) (+)= A (64 x 8, registers) B (8 x 8 NB, shared), TF32;
// ACC 0 writes d, 1 adds to it
template <int NB>
struct Wgmma;
template <>
struct Wgmma<1> {
  template <int ACC>
  __device__ static void run(float (&d)[4], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %9, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(ACC)
        : "memory");
  }
};
template <>
struct Wgmma<2> {
  template <int ACC>
  __device__ static void run(float (&d)[8], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %13, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(ACC)
        : "memory");
  }
};
template <>
struct Wgmma<4> {
  template <int ACC>
  __device__ static void run(float (&d)[16], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %21, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(ACC)
        : "memory");
  }
};

// a tile's sums, staged in shared memory as [m][n] (kOutLD apart), out to
// y (four columns a thread) from
template <typename Load>
__device__ __forceinline__ void put(float* y, int M, int N, int n0,
                                    Load load) {
  for (int e = 4 * threadIdx.x; e < M * kBN; e += 4 * kThreads) {
    const int r = e / kBN, nl = e % kBN;
    const float4 v = load(e);
    float* dst = y + int64_t(r) * N + n0 + nl;
    if (N % 4 == 0 && n0 + nl + 4 <= N) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float v4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (n0 + nl + q < N) dst[q] = v4[q];
    }
  }
}

// The end of CTA c's part of the launch's column tile `tile` (columns n0..
// of y), its sums staged at `out`: y itself if no other CTA shares the
// tile, else the CTA's slot, and the last of the tile's CTAs to arrive
// sums their slots in CTA order.
__device__ __forceinline__ void finish(const float* out, float* y, float* part,
                                    int* counters, int* last, int M, int N,
                                    int n0, int c, int tile, int first,
                                    int nc) {
  auto staged = [&](int e) {
    return *reinterpret_cast<const float4*>(out + (e / kBN) * kOutLD +
                                            e % kBN);
  };
  if (nc == 1) {
    put(y, M, N, n0, staged);
    return;
  }
  float* slot = part + int64_t(c + tile) * kMaxM * kBN;
  for (int e = 4 * threadIdx.x; e < M * kBN; e += 4 * kThreads)
    *reinterpret_cast<float4*>(slot + e) = staged(e);
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(prev)
                 : "l"(counters + tile)
                 : "memory");
    *last = prev == nc - 1;
  }
  __syncthreads();
  if (!*last) return;
  const float* src = part + int64_t(first + tile) * kMaxM * kBN;
  // Kahan sums: a tile may have dozens of slots
  auto add1 = [](float& s, float& comp, float v) {
    const float a = v - comp, b = s + a;
    comp = (b - s) - a;
    s = b;
  };
  put(y, M, N, n0, [&](int e) {
    const float4* p = reinterpret_cast<const float4*>(src + e);
    constexpr int kSlot = kMaxM * kBN / 4;  // float4s a slot
    float4 s = __ldcg(p), comp = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](const float4& v) {
      add1(s.x, comp.x, v.x), add1(s.y, comp.y, v.y);
      add1(s.z, comp.z, v.z), add1(s.w, comp.w, v.w);
    };
    int q = 1;
    for (; q + 4 <= nc; q += 4) {  // four loads in flight, added in order
      const float4 a = __ldcg(p + q * kSlot), b = __ldcg(p + (q + 1) * kSlot),
                   d = __ldcg(p + (q + 2) * kSlot),
                   f = __ldcg(p + (q + 3) * kSlot);
      add(a), add(b), add(d), add(f);
    }
    for (; q < nc; ++q) add(__ldcg(p + q * kSlot));
    return s;
  });
  if (threadIdx.x == 0) counters[tile] = 0;  // clean for the next launch
}

// Grid (G). Iteration i is K-stage i % spt of the launch's column tile
// i / spt; CTA c runs iterations [c I / G, (c + 1) I / G) of the I =
// tiles * spt.
template <int NB, bool TRANS>
__global__ void __launch_bounds__(kThreads, 2)
    skinny_kernel(const float* __restrict__ x, const __grid_constant__ Segs
                  segs, float* __restrict__ part, int* __restrict__ counters,
                  int M, int K, int ldx, int spt) {
  constexpr int D = 4 * NB;  // accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* bhi = smem + kStages * kStage;
  float* blo = bhi + kBF;
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nw = 16 * warp;  // this warp's first column of the tile
  const int G = gridDim.x, c = blockIdx.x;
  const int64_t I = int64_t(segs.tile0[segs.n]) * spt;
  const int64_t it0 = int64_t(c) * I / G, it1 = int64_t(c + 1) * I / G;
  const int n = int(it1 - it0);
  // the CTA whose run holds iteration i
  auto owner = [&](int64_t i) { return int(((i + 1) * G - 1) / I); };
  uint64_t once;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(once));

  // iteration j of the run: x (rows < 8 NB) and W into ring slot j % kStages
  auto load = [&](int j) {
    if (j < n) {
      float* xs = smem + (j % kStages) * kStage;
      float* ws = xs + kXF;
      const int64_t i = it0 + j;
      const int tile = int(i / spt), q = seg_of(segs, tile);
      const float* w = segs.w[q];
      const int N = segs.N[q], ldw = segs.ldw[q];
      const int n0 = (tile - segs.tile0[q]) * kBN, k0 = int(i % spt) * kBK;
      for (int p = tid; p < 8 * NB * (kBK / 4); p += kThreads) {
        const int r = p / (kBK / 4), cc = 4 * (p % (kBK / 4));
        const bool ok = r < M && k0 + cc < K;
        cp_async16(xs + r * kXLD + cc,
                   ok ? x + int64_t(r) * ldx + k0 + cc : x, ok ? 16 : 0);
      }
#pragma unroll
      for (int q = 0; q < kPieces; ++q) {
        const int p = tid + q * kThreads;
        if constexpr (TRANS) {  // W^T rows: [n][k], kBK / 4 pieces a row
          const int r = p / (kBK / 4), cc = 4 * (p % (kBK / 4));
          const bool ok = n0 + r < N && k0 + cc < K;
          cp_async16_once(ws + r * kWLD_T + cc,
                          ok ? w + int64_t(n0 + r) * ldw + k0 + cc : w,
                          ok ? 16 : 0, once);
        } else {  // W rows: [k][n], kBN / 4 pieces a row
          const int r = p / (kBN / 4), cc = 4 * (p % (kBN / 4));
          const bool ok = k0 + r < K && n0 + cc < N;
          cp_async16_once(ws + r * kWLD_NN + cc,
                          ok ? w + int64_t(k0 + r) * ldw + n0 + cc : w,
                          ok ? 16 : 0, once);
        }
      }
    }
    cp_async_commit();
  };

  float acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) acc[e] = 0.f;

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load(j);
  // the run tile by tile: the stream loop of a tile's iterations, then
  // the tile's end
  for (int j = 0; j < n;) {
    const int tile = int((it0 + j) / spt);
    const int stop = min(n, j + int(spt - (it0 + j) % spt));
    float* xs;
    for (; j < stop; ++j) {
      cp_async_wait<kStages - 2>();  // iteration j has landed
      __syncthreads();               // for every thread; j - 1 is read
      load(j + kStages - 1);         // into the slot read at j - 1
      xs = smem + (j % kStages) * kStage;
      const float* ws = xs + kXF;
      // x^T split into the hi and lo B tiles: a 16-byte piece a thread
      if (tid < 8 * NB * (kBK / 4)) {
        const int r = tid % (8 * NB), cc = 4 * (tid / (8 * NB));
        const float4 v = *reinterpret_cast<const float4*>(xs + r * kXLD + cc);
        const float f[4] = {v.x, v.y, v.z, v.w};
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_rn(f[e], h[e], l[e]);
        const int o = (r / 8) * (kSBO / 4) + (cc / 4) * 32 + (r % 8) * 4;
        *reinterpret_cast<uint4*>(bhi + o) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(blo + o) = make_uint4(l[0], l[1], l[2], l[3]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      // A (64 columns x 8 K of W^T) of each of the stage's four K-steps
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int kk = 8 * s;
        if constexpr (TRANS) {
          const float* p = ws + (nw + g) * kWLD_T + kk + t;
          split_rn(p[0], ahi[s][0], alo[s][0]);
          split_rn(p[8 * kWLD_T], ahi[s][1], alo[s][1]);
          split_rn(p[4], ahi[s][2], alo[s][2]);
          split_rn(p[8 * kWLD_T + 4], ahi[s][3], alo[s][3]);
        } else {
          const float* p = ws + (kk + t) * kWLD_NN + nw + g;
          split_rn(p[0], ahi[s][0], alo[s][0]);
          split_rn(p[8], ahi[s][1], alo[s][1]);
          split_rn(p[4 * kWLD_NN], ahi[s][2], alo[s][2]);
          split_rn(p[4 * kWLD_NN + 8], ahi[s][3], alo[s][3]);
        }
      }
      float fresh[D];
#pragma unroll
      for (int e = 0; e < D; ++e) fresh[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint64_t dh = desc_b(bhi + s * 64), dl = desc_b(blo + s * 64);
        if (s == 0)
          Wgmma<NB>::template run<0>(fresh, alo[s], dh);
        else
          Wgmma<NB>::template run<1>(fresh, alo[s], dh);
        Wgmma<NB>::template run<1>(fresh, ahi[s], dl);
        Wgmma<NB>::template run<1>(fresh, ahi[s], dh);
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int e = 0; e < D; ++e) {
        asm volatile("" : "+f"(fresh[e])::"memory");
        acc[e] += fresh[e];
      }
    }
    // the run leaves the tile: its sums, staged as [m][n] in the slot just
    // read (its next load comes after the next barrier), go out in
    // 16-byte pieces. acc[4 b + e] is D[n][m] at n = nw + g + 8 (e / 2),
    // m = 8 b + 2 t + e % 2
    __syncthreads();
    float* out = xs;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(8 * b + 2 * t + (e & 1)) * kOutLD + nw + g + 8 * (e >> 1)] =
            acc[4 * b + e];
#pragma unroll
    for (int e = 0; e < D; ++e) acc[e] = 0.f;
    __syncthreads();
    const int first = owner(int64_t(tile) * spt), q = seg_of(segs, tile);
    finish(out, segs.y[q], part, counters, &last, M, segs.N[q],
           (tile - segs.tile0[q]) * kBN, c, tile, first,
           owner(int64_t(tile + 1) * spt - 1) - first + 1);
  }
  cp_async_wait<0>();
}

// cudaFuncSetAttribute once per (kernel, device)
cudaError_t allow_smem(const void* kernel, int bytes) {
  constexpr int kMax = 16;
  static const void* done_kernel[kMax];
  static int done_dev[kMax];
  static int done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < done; ++i)
    if (done_kernel[i] == kernel && done_dev[i] == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  if (done < kMax) {
    done_kernel[done] = kernel;
    done_dev[done] = dev;
    ++done;
  }
  return cudaSuccess;
}

template <int NB, bool TRANS>
cudaError_t launch(const float* x, const Segs& segs, float* part,
                   int* counters, int M, int K, int ldx, int ctas,
                   cudaStream_t st) {
  auto kernel = skinny_kernel<NB, TRANS>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kThreads, kSmem, st>>>(x, segs, part, counters, M, K, ldx,
                                        (K + kBK - 1) / kBK);
  return cudaGetLastError();
}

template <bool TRANS>
cudaError_t launch_m(const float* x, const Segs& segs, float* part,
                     int* counters, int M, int K, int ldx, int ctas,
                     cudaStream_t st) {
  if (M <= 8)
    return launch<1, TRANS>(x, segs, part, counters, M, K, ldx, ctas, st);
  if (M <= 16)
    return launch<2, TRANS>(x, segs, part, counters, M, K, ldx, ctas, st);
  return launch<4, TRANS>(x, segs, part, counters, M, K, ldx, ctas, st);
}

}  // namespace

// y[q] (M, N[q]) = x (M, K) @ W[q] for the nseg (1 to 3) products of one
// x, all f32 on the card: x rows ldx apart; W[q] (K, N[q]) rows ldw[q]
// apart, or with trans W[q]^T (N[q], K) rows ldw[q] apart; y[q]
// contiguous. w, y, N and ldw are host arrays of nseg. Every pointer
// 16-byte aligned, K, ldx and ldw[q] multiples of 4 (and N[q] too without
// trans), 1 <= M <= 32. ctas CTAs, at most the iterations (the products'
// 128-column tiles x 32-deep K-stages); part holds (ctas + tiles) * 32 *
// 128 floats, and counters (tiles,) ints, all zero, which the launch
// leaves zero.
// Returns cudaGetLastError() after the launch (0 == launched).
extern "C" int skinny_mm(const void* x, const void* const* w,
                         void* const* y, const int* N, const int* ldw,
                         int nseg, void* part, void* counters, int M, int K,
                         int ldx, int trans, int ctas, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (nseg < 1 || nseg > kMaxSeg || M < 1 || M > kMaxM || K < 1 ||
      K % 4 != 0 || ldx < K || ldx % 4 != 0 || !aligned(x) ||
      !aligned(part) || part == nullptr || counters == nullptr)
    return int(cudaErrorInvalidValue);
  Segs segs{};
  segs.n = nseg;
  int64_t tiles = 0;
  for (int q = 0; q < nseg; ++q) {
    if (N[q] < 1 || ldw[q] % 4 != 0 || (trans ? ldw[q] < K : ldw[q] < N[q]) ||
        (!trans && N[q] % 4 != 0) || !aligned(w[q]) || !aligned(y[q]))
      return int(cudaErrorInvalidValue);
    segs.w[q] = static_cast<const float*>(w[q]);
    segs.y[q] = static_cast<float*>(y[q]);
    segs.N[q] = N[q];
    segs.ldw[q] = ldw[q];
    segs.tile0[q] = int(std::min<int64_t>(tiles, INT32_MAX));
    tiles += (int64_t(N[q]) + kBN - 1) / kBN;
  }
  segs.tile0[nseg] = int(std::min<int64_t>(tiles, INT32_MAX));
  const int64_t iters = tiles * ((K + kBK - 1) / kBK);
  if (ctas < 1 || ctas > iters || iters > INT32_MAX)
    return int(cudaErrorInvalidValue);
  auto xp = static_cast<const float*>(x);
  auto pp = static_cast<float*>(part);
  auto cp = static_cast<int*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
  if (trans)
    return int(launch_m<true>(xp, segs, pp, cp, M, K, ldx, ctas, st));
  return int(launch_m<false>(xp, segs, pp, cp, M, K, ldx, ctas, st));
}

// grouped_mm: the grouped (ragged) matrix product of sorted MoE dispatch.
// x (M, K) holds the token-expert assignments sorted by expert; offsets
// (E+1,) int32 on the card is the exclusive cumsum of the group sizes, so
// rows offsets[e] <= r < offsets[e+1] form expert e's group, and
//
//   y[r] = x[r] @ w[e]        w (E, K, N)   (the forward)
//   y[r] = x[r] @ w[e]^T      w (E, N, K)   (TRANS: the input gradient)
//
// with rows outside every group written as zeros. grouped_mm_dw is the
// weight gradient dw[e] = x_e^T @ dy_e over the group's rows (zeros for an
// empty group). f32 or bf16 in and out, f32 accumulation.
//
// Replaces lax.ragged_dot in the JAX package's sorted dispatch
// (src/repro/models/modeling.py:_moe_dispatch_sorted, three calls, and
// their gradients under jax.value_and_grad): XLA computes it outside any
// Pallas kernel.
//
// What bounds it on the H100, and the two paths of the forward and TRANS
// product. The wrapper (kernels/grouped_mm.py:plan) picks the path and
// the grid from (M, K, N, E, dtype) alone; no launch reads the group
// sizes on the host, an empty group's weights are never read, and every
// grid and scratch buffer is fixed by the shapes, so a sorted step can be
// captured in a CUDA graph. No float atomics: every sum is taken in one
// fixed order, so two calls agree bit for bit.
//
// * Rows path (decode: a few rows an expert, GEMV-shaped). Bound by the
//   bytes of the touched experts' weights, each read once: the path is a
//   stream at the HBM rate. A CTA takes one expert and one contiguous
//   piece of its weights (forward: a K-slab of whole rows of the (K, N)
//   matrix, up to 2048 columns; TRANS: a block of output rows of the
//   (N, K) matrix, each a dot product along the whole K when it fits),
//   stages the group's x rows in shared memory once a pass (8 rows, 4
//   with TRANS; longer groups take more passes; a pass is compiled for 1,
//   2, 4 or 8 rows and takes the fewest that hold the group's, so a
//   one-row group does one row's multiplies), and streams the weights
//   through a private cp.async ring: each thread copies 16-byte pieces
//   and later reads back only its own, so the ring needs no barrier; 4
//   stages of 4 pieces a thread, counted in bytes, so bf16 keeps as many
//   bytes in flight as f32. Forward threads own 8 columns each; TRANS
//   lanes own strided 16-byte vectors of a row and a warp sums each dot
//   product with a fixed shuffle tree. The plan cuts each expert into a
//   few pieces (about 6.5 CTAs an SM in all, as min(E, M) experts would
//   need, so the last of about three waves of two resident CTAs an SM is
//   nearly full; neighbouring CTAs stream neighbouring pieces of one
//   expert). Each forward K-slab writes an f32
//   partial (splits, M, N), and a second pass sums the slabs in order and
//   writes the zeros outside every group; TRANS with one K-range writes
//   y itself, and one extra CTA the zeros.
// * Tiles path (a prefill chunk: groups of ~100+ rows). Bound by the
//   operations in f32 and by the bytes in bf16. A CTA takes one row tile
//   of one expert's group (tiles start at the group's first row and may
//   run past its end into the next group's rows, which are computed and
//   dropped at the store) and one 128-column tile; the grid holds
//   ceil(M / tile) + min(E, M) tile slots and each CTA finds its
//   (expert, tile) from the offsets. bf16 (16-byte aligned operands):
//   the tensor cores, wgmma m64n128k16 fed by TMA through a 3-stage
//   mbarrier ring, one producer warp and two consumer warpgroups, each
//   on a 64-row half of a 128-row tile (a half past the group's end
//   idle; the weight stage serves both halves); x is
//   K-major, w is MN-major (forward) or K-major (TRANS), all 128-byte
//   swizzled, so neither layout needs a transpose pass. f32 (and
//   unaligned bf16): the CUDA cores, no TF32, 128 threads each 4 rows x
//   8 columns of a 32-row half, a cp.async ring; the forward's tile has
//   two halves (64 rows) sharing each weight stage, a half past the
//   group's end skipped.
//
//
// The weight gradient dw[e] = x_e^T dy_e (E, K, N) takes one of two paths
// as well, picked by kernels/grouped_mm.py:plan_dw from (M, K, N, E,
// dtype) alone at the forward's threshold; every entry of dw is written
// once (an empty group's as zeros), so dw needs no memset:
// * Rows path (decode). The work is writing every expert's K x N
//   gradient: bound by that write stream at the HBM rate. A CTA owns a
//   slab of whole dw rows of one expert; each thread one 16-byte piece of
//   every row, written with one streaming vector store; a group of up to
//   8 rows is a single pass (compiled for 1, 2, 4 or 8 rows) with the
//   thread's dy piece in registers and x staged once; an empty group's
//   slab is a zero fill.
// * Tiles path (a prefill chunk or a training step: ~100+ rows an expert).
//   bf16 (16-byte aligned): wgmma m64n256k16 with both operands MN-major
//   (A = x_e^T, B = dy_e) fed by TMA, persistent CTAs walking 128 x 256
//   tiles, the rows past a group's end zeroed in shared memory, a TMA
//   store epilogue overlapping the next tile's loads. f32 (and unaligned
//   bf16): the CUDA cores, no TF32, 128 x 128 tiles of 8 x 8 outputs a
//   thread.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

// rows path
constexpr int kR = 8;        // forward: group rows a pass
constexpr int kRT = 4;       // TRANS: group rows a pass
constexpr int kD = 4;        // 16-byte pieces a thread a stage
constexpr int kS = 4;        // ring stages
constexpr int kNT = 2048;    // forward: output columns a CTA
constexpr int kXBytes = 16384;   // forward: a pass's rows of x, f32
constexpr int kXTBytes = 32768;  // TRANS: a pass's rows of x, as given
constexpr int kRingBytes = kS * kD * kThreads * 16;

// tiles path, CUDA cores
constexpr int kTM = 32, kTNc = 128, kTThreads = 128;

// tiles path, tensor cores
// two consumer warpgroups, each on a 64-row half of a 128 x 128 tile,
// 64-deep stages, kWS in flight, and a producer warp
constexpr int kWM = 64, kWN = 128, kWK = 64, kWS = 3;
constexpr int kWA = 2 * kWM * kWK * 2;   // bytes of an x stage
constexpr int kWB = kWN * kWK * 2;       // bytes of a w stage
constexpr int kWStage = kWA + kWB;
constexpr int kWThreads = 2 * 128 + 32;
constexpr int kWSmem = kWS * kWStage + 1024 + 2 * kWS * 8;

// weight gradient, rows path
constexpr int kDwChunk = 512;  // threads a CTA at most (a 16-byte piece each)
constexpr int kDwMaxKc = 256;  // dw rows a slab at most
constexpr int kDwKB = 8;       // dw rows a sweep of a group over kR rows

// weight gradient, tiles path, CUDA cores: kDwT x kDwT tiles, kDwR group
// rows a stage, kDwS stages in flight
constexpr int kDwT = 128, kDwR = 32, kDwS = 3, kDwThreads = 256;
constexpr int kDwSmemF32 = kDwS * 2 * kDwR * kDwT * 4;

// weight gradient, tiles path, tensor cores: two consumer warpgroups,
// each 64 dw rows of a kGK x kGN tile, kGR group rows a stage, kGS stages
constexpr int kGK = 128, kGN = 256, kGR = 32, kGS = 6;
constexpr int kGBox = 64 * kGR * 2;       // a 64-column bf16 box of a stage
constexpr int kGX = 2 * kGBox;            // x: two boxes (64 dw rows each)
constexpr int kGStage = kGX + 4 * kGBox;  // + dy: four boxes (256 columns)
constexpr int kGOut = kGK * kGN * 2;      // the bf16 staging tile
constexpr int kGThreads = 2 * 128 + 32;
constexpr int kGSmem = kGS * kGStage + kGOut + 1024 + 2 * kGS * 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T as floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// four consecutive elements as floats (8- or 16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cnt (< 16 bytes' worth) elements of an unaligned run, zero-padded
template <typename T>
__device__ __forceinline__ void copy_short(uint4* dst, const T* src,
                                           int cnt) {
  constexpr int V = Vec<T>::V;
  __align__(16) T t[V];
#pragma unroll
  for (int v = 0; v < V; ++v) t[v] = v < cnt ? src[v] : from_f<T>(0.f);
  *dst = *reinterpret_cast<const uint4*>(t);
}

// Stage a ROWS x COLS tile of a row-major matrix (leading dim ld) whose
// first element is (r0, c0) into shared memory (leading dim SLD). Rows at
// or past r_end and columns at or past c_end read as zero. With vec (the
// matrix base 16-byte aligned and ld a multiple of 16 bytes) every whole
// 16-byte run goes by cp.async; the rest is loaded element by element.
template <typename T, int ROWS, int COLS, int SLD, int NT = kThreads>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int64_t ld, int r0, int r_end, int c0,
                                      int c_end, bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int RUNS = COLS / V;
  static_assert(COLS % V == 0 && SLD % V == 0, "16-byte runs");
  for (int i = threadIdx.x; i < ROWS * RUNS; i += NT) {
    const int r = i / RUNS, c = (i % RUNS) * V;
    T* d = dst + r * SLD + c;
    const int gr = r0 + r, gc = c0 + c;
    const T* s = src + int64_t(gr) * ld + gc;
    if (gr < r_end && vec && gc + V <= c_end) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        d[j] = (gr < r_end && gc + j < c_end) ? s[j] : from_f<T>(0.f);
    }
  }
}

__device__ __forceinline__ void group_bounds(const int32_t* offsets, int e,
                                             int M, int* lo, int* hi) {
  const int a = min(max(offsets[e], 0), M);
  *lo = a;
  *hi = max(a, min(offsets[e + 1], M));
}

// zeros in the rows before the first group and past the last, columns
// [n0, n0 + nt) (the last CTA row of a tiles grid, a direct TRANS grid's
// extra CTA)
template <typename T>
__device__ __forceinline__ void zero_rows(const int32_t* offsets, T* y, int M,
                                          int N, int E, int n0, int nt) {
  const int first = min(max(offsets[0], 0), M);
  const int last = max(first, min(offsets[E], M));
  for (int r = 0; r < M; ++r) {
    if (r == first) r = last;
    if (r >= M) break;
    for (int c = n0 + threadIdx.x; c < min(n0 + nt, N); c += blockDim.x)
      y[int64_t(r) * N + c] = from_f<T>(0.f);
  }
}

// ------------------------------------------------------------ rows path

// A thread's private ring: stage st of kD pieces in slot st % kS, the
// thread's piece j of slot s at ring[(s * kD + j) * blockDim.x + tid].
// issue(c, j, slot) copies piece c (j = c % kD, known at compile time)
// into its slot; use(c, j, value) consumes it. The thread reads back only
// what it copied, so no barrier is needed: cp.async.wait_group makes the
// thread's own copies visible to it. prep() runs (on every thread) while
// the first stages are in flight.
template <typename Prep, typename Issue, typename Use>
__device__ __forceinline__ void stream(int n, uint4* ring, Prep prep,
                                       Issue issue, Use use) {
  const int nst = (n + kD - 1) / kD, nth = blockDim.x;
  uint4* mine = ring + threadIdx.x;
  auto fill = [&](int st) {
    if (st < nst) {
      uint4* slot = mine + (st % kS) * kD * nth;
#pragma unroll
      for (int j = 0; j < kD; ++j)
        if (st * kD + j < n) issue(st * kD + j, j, slot + j * nth);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kS - 1; ++st) fill(st);
  prep();
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kS - 2>();  // stage st has landed
    fill(st + kS - 1);        // into the slot read at st - 1
    const uint4* slot = mine + (st % kS) * kD * nth;
#pragma unroll
    for (int j = 0; j < kD; ++j)
      if (st * kD + j < n) use(st * kD + j, j, slot[j * nth]);
  }
  cp_async_wait<0>();
}

// Forward, rows path: grid (ceil(N / kNT), splits, E). CTA (c, s, e)
// multiplies expert e's rows by the K-slab [s*kc, s*kc + kc) of w[e] and
// columns [c*kNT, c*kNT + kNT): part[s, r, n] for r in the group.
// Neighbouring CTAs stream neighbouring slabs of one expert (measured
// faster than interleaving the experts).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    rows_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int32_t* __restrict__ offsets,
                    float* __restrict__ part, int M, int K, int N, int kc,
                    bool vec) {
  constexpr int V = Vec<T>::V;
  constexpr int CV = 8 / V;  // 16-byte pieces of a thread's 8 columns
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  float* xs = reinterpret_cast<float*>(smem + kS * kD * blockDim.x * 16);
  const int e = blockIdx.z, s = blockIdx.y;
  int lo, hi;
  group_bounds(offsets, e, M, &lo, &hi);
  if (hi == lo) return;  // an untouched expert: its weights are not read
  const int n0 = blockIdx.x * kNT;
  const int k0 = s * kc, nk = max(0, min(K, k0 + kc) - k0);
  const T* we = w + (int64_t(e) * K + k0) * N;
  float* ps = part + int64_t(s) * M * N;
  int col[CV], cnt[CV];
#pragma unroll
  for (int j = 0; j < CV; ++j) {
    col[j] = n0 + V * (threadIdx.x + blockDim.x * j);
    cnt[j] = min(max(N - col[j], 0), V);
  }
  // one pass of up to NR rows (NR >= nr, known at compile time, so a
  // group of one row does one row's multiplies, not kR's)
  auto pass = [&](int m0, int nr, auto rows) {
    constexpr int NR = decltype(rows)::value;
    float acc[NR][8] = {};
    stream(
        nk * CV, ring,
        [&] {  // xs[r][kk] = x[m0 + r, k0 + kk] (rows past nr unread)
          __syncthreads();  // the previous pass's xs is read
          for (int i = threadIdx.x; i < nr * kc; i += blockDim.x) {
            const int r = i / kc, kk = i - r * kc;
            xs[i] = kk < nk ? to_f(x[int64_t(m0 + r) * K + k0 + kk]) : 0.f;
          }
          __syncthreads();
        },
        [&](int c, int j, uint4* slot) {
          const int jj = j % CV;
          if (cnt[jj] == 0) return;
          const T* src = we + int64_t(c / CV) * N + col[jj];
          if (vec)
            cp_async16(slot, src);
          else
            copy_short<T>(slot, src, cnt[jj]);
        },
        [&](int c, int j, const uint4& u) {
          const int jj = j % CV;
          if (cnt[jj] == 0) return;
          float wv[V];
          Vec<T>::unpack(u, wv);
          const float* xr = xs + c / CV;
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            if (r < nr) {
              const float a = xr[r * kc];
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[r][jj * V + v] = fmaf(a, wv[v], acc[r][jj * V + v]);
            }
          }
        });
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r >= nr) continue;
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        float* dst = ps + int64_t(m0 + r) * N + col[j];
        if (vec && cnt[j] == V) {
#pragma unroll
          for (int v = 0; v < V; v += 4)
            *reinterpret_cast<float4*>(dst + v) =
                make_float4(acc[r][j * V + v], acc[r][j * V + v + 1],
                            acc[r][j * V + v + 2], acc[r][j * V + v + 3]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (v < cnt[j]) dst[v] = acc[r][j * V + v];
        }
      }
    }
  };
  for (int m0 = lo; m0 < hi; m0 += kR) {
    const int nr = min(kR, hi - m0);
    if (nr == 1)
      pass(m0, nr, std::integral_constant<int, 1>());
    else if (nr == 2)
      pass(m0, nr, std::integral_constant<int, 2>());
    else if (nr <= 4)
      pass(m0, nr, std::integral_constant<int, 4>());
    else
      pass(m0, nr, std::integral_constant<int, kR>());
  }
}

// TRANS, rows path: grid (ceil(N / nt), splits, E + 1). CTA (c, s, e)
// takes output columns [c*nt, c*nt + nt), each a row of w[e] (N, K) read
// along the K-range [s*kc, s*kc + kc): warp q of 8 takes rows q, q + 8,
// ...; a lane takes the row's 16-byte vectors lane, lane + 32, ... and
// the warp sums each dot product with a fixed shuffle tree. With one
// K-range (direct) the sums go to y, and CTA (0, 0, E) writes the zeros
// outside every group; else to part for the reduce pass.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    rows_trans_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int32_t* __restrict__ offsets,
                      float* __restrict__ part, T* __restrict__ y, int M,
                      int K, int N, int E, int kc, int nt, bool vec) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  T* xs = reinterpret_cast<T*>(smem + kRingBytes);  // [kRT][kc]
  const int e = blockIdx.z, s = blockIdx.y;
  const bool direct = gridDim.y == 1;
  if (e == E) {
    if (direct && blockIdx.x == 0) zero_rows(offsets, y, M, N, E, 0, N);
    return;
  }
  int lo, hi;
  group_bounds(offsets, e, M, &lo, &hi);
  if (hi == lo) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * nt + warp, n1 = min(N, blockIdx.x * nt + nt);
  const int k0 = s * kc, nk = max(0, min(K, k0 + kc) - k0);
  const int nv = (nk + V - 1) / V;  // 16-byte vectors of a row's K-range
  const int J = (nv + 31) / 32;     // pieces a lane a row
  const int rows = n1 > n0 ? (n1 - n0 + 7) / 8 : 0;  // this warp's rows
  const T* we = w + int64_t(e) * N * K + k0;
  float* ps = part + int64_t(s) * M * N;
  // one pass of up to NR rows (as the forward's)
  auto pass = [&](int m0, int nr, auto nrows) {
    constexpr int NR = decltype(nrows)::value;
    float acc[NR] = {};
    int iq = 0, ij = 0, uq = 0, uj = 0;  // row and piece to issue, to use
    stream(
        rows * J, ring,
        [&] {  // xs[r][kk] = x[m0 + r, k0 + kk], zeros past nk
          __syncthreads();  // the previous pass's xs is read
          const int vr = kc / V;
          for (int i = threadIdx.x; i < nr * vr; i += kThreads) {
            const int r = i / vr, kv = i - r * vr;
            const T* src = x + int64_t(m0 + r) * K + k0 + V * kv;
            uint4* dst = reinterpret_cast<uint4*>(xs + r * kc + V * kv);
            if (vec && V * kv + V <= nk)
              *dst = *reinterpret_cast<const uint4*>(src);
            else
              copy_short<T>(dst, src, max(0, min(V, nk - V * kv)));
          }
          __syncthreads();
        },
        [&](int, int, uint4* slot) {  // pieces come in order
          const int kv = lane + 32 * ij;
          if (kv < nv) {
            const T* src = we + int64_t(n0 + 8 * iq) * K + V * kv;
            if (vec)
              cp_async16(slot, src);
            else
              copy_short<T>(slot, src, min(V, nk - V * kv));
          }
          if (++ij == J) ij = 0, ++iq;
        },
        [&](int, int, const uint4& u) {
          const int kv = lane + 32 * uj;
          if (kv < nv) {
            float wv[V];
            Vec<T>::unpack(u, wv);
#pragma unroll
            for (int r = 0; r < NR; ++r) {
              if (r < nr) {
                float xv[V];
                Vec<T>::unpack(
                    *reinterpret_cast<const uint4*>(xs + r * kc + V * kv), xv);
#pragma unroll
                for (int v = 0; v < V; ++v) acc[r] = fmaf(xv[v], wv[v], acc[r]);
              }
            }
          }
          if (++uj == J) {  // the row's last piece: sum over the warp
#pragma unroll
            for (int r = 0; r < NR; ++r) {
              if (r < nr) {
                float t = acc[r];
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                  t += __shfl_xor_sync(0xffffffffu, t, o);
                if (lane == 0) {
                  const int64_t o = int64_t(m0 + r) * N + n0 + 8 * uq;
                  if (direct)
                    y[o] = from_f<T>(t);
                  else
                    ps[o] = t;
                }
                acc[r] = 0.f;
              }
            }
            uj = 0, ++uq;
          }
        });
  };
  for (int m0 = lo; m0 < hi; m0 += kRT) {
    const int nr = min(kRT, hi - m0);
    if (nr == 1)
      pass(m0, nr, std::integral_constant<int, 1>());
    else if (nr == 2)
      pass(m0, nr, std::integral_constant<int, 2>());
    else
      pass(m0, nr, std::integral_constant<int, kRT>());
  }
}

// y = the sum of the splits' partials in order, zeros outside every group
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rows_reduce_kernel(const float* __restrict__ part,
                       const int32_t* __restrict__ offsets, T* __restrict__ y,
                       int M, int N, int E, int splits) {
  const int first = min(max(offsets[0], 0), M);
  const int last = max(first, min(offsets[E], M));
  const int64_t MN = int64_t(M) * N;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < MN;
       i += int64_t(gridDim.x) * kThreads) {
    const int r = int(i / N);
    float t = 0.f;
    if (r >= first && r < last)
      for (int s = 0; s < splits; ++s) t += part[s * MN + i];
    y[i] = from_f<T>(t);
  }
}

// ----------------------------------------------------------- tiles path

// Warp 0 finds CTA row y's tile: expert e's group [lo, hi) holds
// ceil((hi - lo) / BM) tiles, numbered in expert order; out = (e, first
// row, hi), e = -1 past the last tile.
__device__ __forceinline__ void find_tile(const int32_t* offsets, int E,
                                          int M, int BM, int y, int* out) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) out[0] = -1;
  __syncwarp();
  int base = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    int lo = 0, hi = 0, cnt = 0;
    if (e < E) {
      group_bounds(offsets, e, M, &lo, &hi);
      cnt = (hi - lo + BM - 1) / BM;
    }
    int inc = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += v;
    }
    const int start = base + inc - cnt;
    if (cnt > 0 && y >= start && y < start + cnt) {
      out[0] = e;
      out[1] = lo + (y - start) * BM;
      out[2] = hi;
    }
    base += __shfl_sync(0xffffffffu, inc, 31);
  }
}

// CUDA cores: grid (ceil(N / 128), ceil(M / BM) + min(E, M) + 1); a CTA
// of 128 threads computes a BM x 128 tile of one expert, BM = 32 H (each
// thread 4 rows x 8 columns of each 32-row half; a half past the group's
// end is skipped, so a tile wastes at most 31 rows there) over kTK-deep
// stages, kTS in flight. Forward columns: a thread's four
// neighbours at tx*4 and at 64 + tx*4 (16-byte reads of the (k, n) tile);
// TRANS: eight 16 apart (the (n, k) tile's rows in distinct banks).
template <typename T, bool TRANS, int H, int kTK, int kTS>
__global__ void __launch_bounds__(kTThreads)
    tiles_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int32_t* __restrict__ offsets, T* __restrict__ y,
                      int M, int K, int N, int E, bool vec) {
  constexpr int BM = kTM * H;
  constexpr int P = 16 / sizeof(T);
  constexpr int ALD = kTK + P;
  constexpr int BROWS = TRANS ? kTNc : kTK;
  constexpr int BLD = (TRANS ? kTK : kTNc) + P;
  constexpr int ASZ = BM * ALD, BSZ = BROWS * BLD;
  extern __shared__ __align__(16) uint8_t smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kTS * ASZ;
  __shared__ int tile[3];
  const int n0 = blockIdx.x * kTNc;
  if (blockIdx.y == gridDim.y - 1) {
    zero_rows(offsets, y, M, N, E, n0, kTNc);
    return;
  }
  if (threadIdx.x < 32) find_tile(offsets, E, M, BM, blockIdx.y, tile);
  __syncthreads();
  const int e = tile[0];
  if (e < 0) return;
  const int m0 = tile[1], hi = tile[2];
  const int halves = min(H, (hi - m0 + kTM - 1) / kTM);  // with rows
  const T* we = w + int64_t(e) * K * N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nk = (K + kTK - 1) / kTK;
  auto load = [&](int slot, int k0) {
    stage<T, BM, kTK, ALD, kTThreads>(As + slot * ASZ, x, K, m0, M, k0, K,
                                      vec);
    if constexpr (TRANS)
      stage<T, kTNc, kTK, BLD, kTThreads>(Bs + slot * BSZ, we, K, n0, N, k0,
                                          K, vec);
    else
      stage<T, kTK, kTNc, BLD, kTThreads>(Bs + slot * BSZ, we, N, k0, K, n0,
                                          N, vec);
  };
#pragma unroll
  for (int st = 0; st < kTS - 1; ++st) {
    if (st < nk) load(st, st * kTK);
    cp_async_commit();
  }
  float acc[H][4][8] = {};
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTS - 2>();
    __syncthreads();  // stage kt landed; every thread is done with kt - 1
    if (kt + kTS - 1 < nk) load((kt + kTS - 1) % kTS, (kt + kTS - 1) * kTK);
    cp_async_commit();
    const T* a = As + (kt % kTS) * ASZ;
    const T* b = Bs + (kt % kTS) * BSZ;
#pragma unroll
    for (int kq = 0; kq < kTK; kq += 4) {
      float bv[4][8];
      if constexpr (TRANS) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float t[4];
          load4(b + (j * 16 + tx) * BLD + kq, t);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) bv[kk][j] = t[kk];
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float t[4], u[4];
          load4(b + (kq + kk) * BLD + tx * 4, t);
          load4(b + (kq + kk) * BLD + 64 + tx * 4, u);
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[kk][j] = t[j], bv[kk][4 + j] = u[j];
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (h >= halves) break;  // a half past the group's end: skipped
        float av[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load4(a + (h * kTM + ty * 4 + i) * ALD + kq, av[i]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[h][i][j] = fmaf(av[i][kk], bv[kk][j], acc[h][i][j]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + h * kTM + ty * 4 + i;
      if (r >= hi) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c =
            n0 + (TRANS ? j * 16 + tx : (j & 4) * 16 + tx * 4 + (j & 3));
        if (c < N) y[int64_t(r) * N + c] = from_f<T>(acc[h][i][j]);
      }
    }
}

// ---------------------------------------------------- tensor-core tiles

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// a wait that never ends (a stage that never lands) traps, so the launch
// fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}
__device__ __forceinline__ void tma2d(void* dst, const CUtensorMap* map,
                                      int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma3d(void* dst, const CUtensorMap* map,
                                      int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptors of a 128-byte-swizzled tile (layout
// type 1 in bits 62-63): K-major, 8-row groups 1024 bytes apart (SBO); or
// MN-major, 8-row groups of K 1024 bytes apart (SBO) and 64-column blocks
// lbo bytes apart (LBO)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return uint64_t((addr & 0x3ffff) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return uint64_t((addr & 0x3ffff) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from reading the accumulators before wgmma_wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B for one 64 x 128 x 16 step; A K-major, B K-major (TB 0) or
// MN-major (TB 1), both 128-byte swizzled in shared memory
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB)
      : "memory");
}

// Tensor cores (bf16): grid (ceil(N / 128), ceil(M / 128) + min(E, M) +
// 1). The producer warp (one thread) streams the tile's x (128 x 64,
// K-major) and w (forward: two 64 x 64 boxes of the (k, n) slab,
// MN-major; TRANS: one 128 x 64 box of (n, k), K-major) by TMA into a
// kWS-stage ring, each stage's arrival counted on its full barrier; each
// consumer warpgroup runs four m64n128k16 steps a stage on its 64-row
// half (a half past the group's end runs none: the w stage is read once
// for both halves, which measured faster than one 64-row warpgroup a
// CTA) and frees the stage on its empty barrier once the next stage's
// steps are issued. TMA zero-fills past M, K and N (the tensors' edges);
// rows past the group's end are computed and dropped.
template <bool TRANS>
__global__ void __launch_bounds__(kWThreads, 2)
    tiles_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       const int32_t* __restrict__ offsets,
                       __nv_bfloat16* __restrict__ y, int M, int K, int N,
                       int E) {
  extern __shared__ uint8_t wsmem[];
  __shared__ int tile[3];
  const int n0 = blockIdx.x * kWN;
  if (blockIdx.y == gridDim.y - 1) {
    zero_rows(offsets, y, M, N, E, n0, kWN);
    return;
  }
  // swizzled tiles need 1024-byte alignment
  uint8_t* base = wsmem + ((1024 - (smem_u32(wsmem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kWS * kWStage);
  uint64_t* empty = full + kWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) find_tile(offsets, E, M, 2 * kWM, blockIdx.y, tile);
  if (threadIdx.x == 32) {
    for (int s = 0; s < kWS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int e = tile[0];
  if (e < 0) return;
  const int m0 = tile[1], hi = tile[2];
  const int nk = (K + kWK - 1) / kWK;
  if (warp == 8) {  // the producer
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kWS;
        if (kt >= kWS) mbar_wait(empty + s, ((kt / kWS) - 1) & 1);
        uint8_t* a = base + s * kWStage;
        uint8_t* b = a + kWA;
        mbar_expect_tx(full + s, kWStage);
        tma2d(a, &ta, kt * kWK, m0, full + s);
        if constexpr (TRANS) {
          tma3d(b, &tb, kt * kWK, n0, e, full + s);
        } else {
          tma3d(b, &tb, n0, kt * kWK, e, full + s);
          tma3d(b + kWB / 2, &tb, n0 + 64, kt * kWK, e, full + s);
        }
      }
    }
    return;
  }
  const int g = warp / 4;                 // this warpgroup's half
  const bool live = m0 + kWM * g < hi;   // the same for its 128 threads
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t sbase = smem_u32(base);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kWS;
    mbar_wait(full + s, (kt / kWS) & 1);
    if (live) {
      // the half's 64 rows start 8 KB into the x stage
      const uint32_t a = sbase + s * kWStage + g * kWM * 128,
                     b = sbase + s * kWStage + kWA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        // 16 K-columns are 32 bytes into a K-major 128-byte row, or 16
        // 128-byte rows of an MN-major box
        if constexpr (TRANS)
          wgmma_m64n128k16<0>(acc, desc_k(a + kk * 32), desc_k(b + kk * 32));
        else
          wgmma_m64n128k16<1>(acc, desc_k(a + kk * 32),
                              desc_mn(b + kk * 2048, kWB / 2));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's steps are done
    }
    if (kt > 0) mbar_arrive(empty + (kt - 1) % kWS);
  }
  if (!live) return;
  wgmma_wait<0>();
  fence_acc(acc);
  // the accumulator fragment: warp w of the group holds rows
  // 16w..16w+15; register 4j + i is row l/4 (+8 for i >= 2), column
  // 8j + 2(l%4) + (i & 1)
  const int r0 = m0 + kWM * g + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < kWN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane % 4);
    if (c >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < hi)
        *reinterpret_cast<__nv_bfloat162*>(y + int64_t(r) * N + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ----------------------------------------------------- weight gradient
//
// dw[e] = x_e^T @ dy_e over expert e's rows, every entry of dw written
// exactly once (an empty group's slab or tile as zeros), in one fixed
// order: no atomics, no partials.

// 16 bytes to global memory with the streaming hint (the output is
// written once and never read here: kept out of L2's way)
__device__ __forceinline__ void st_cs16(void* p, uint32_t a, uint32_t b,
                                        uint32_t c, uint32_t d) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void st_cs8(void* p, uint32_t a, uint32_t b) {
  asm volatile("st.global.cs.v2.b32 [%0], {%1, %2};" ::"l"(p), "r"(a), "r"(b)
               : "memory");
}
__device__ __forceinline__ uint32_t bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// a piece: V (16 bytes' worth) consecutive elements of a row, cnt of
// them inside it (the rest read as zero, never written); with vec the
// piece is 16-byte aligned and moves as one vector
template <typename T>
__device__ __forceinline__ void load_piece(const T* p, int cnt, bool vec,
                                           float* f) {
  constexpr int V = Vec<T>::V;
  if (vec && cnt == V) {
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(p), f);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = v < cnt ? to_f(p[v]) : 0.f;
  }
}
template <typename T>
__device__ __forceinline__ void store_piece(T* p, int cnt, bool vec,
                                            const float* f) {
  constexpr int V = Vec<T>::V;
  if (vec && cnt == V) {
    if constexpr (std::is_same<T, float>::value)
      st_cs16(p, __float_as_uint(f[0]), __float_as_uint(f[1]),
              __float_as_uint(f[2]), __float_as_uint(f[3]));
    else
      st_cs16(p, bf2(f[0], f[1]), bf2(f[2], f[3]), bf2(f[4], f[5]),
              bf2(f[6], f[7]));
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < cnt) p[v] = from_f<T>(f[v]);
  }
}

// Rows path, a group of at most kR rows (NR >= nr, known at compile
// time): xs[kk][r] = x[lo + r, k0 + kk] staged once (zeros past nr), the
// thread's piece of the nr dy rows held in registers, then every row of
// the slab computed and written.
template <typename T, int NR>
__device__ __forceinline__ void dw_rows_pass(const T* __restrict__ x,
                                             const T* __restrict__ dy,
                                             T* __restrict__ out, float* xs,
                                             int lo, int nr, int K, int N,
                                             int k0, int nk, int n, int cnt,
                                             bool vec) {
  constexpr int V = Vec<T>::V;
  for (int i = threadIdx.x; i < kR * nk; i += blockDim.x) {
    const int r = i / nk, kk = i - r * nk;
    xs[kk * kR + r] = r < nr ? to_f(x[int64_t(lo + r) * K + k0 + kk]) : 0.f;
  }
  __syncthreads();
  if (cnt == 0) return;
  float d[NR][V];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r < nr)
      load_piece(dy + int64_t(lo + r) * N + n, cnt, vec, d[r]);
    else
#pragma unroll
      for (int v = 0; v < V; ++v) d[r][v] = 0.f;
  }
#pragma unroll 4
  for (int kk = 0; kk < nk; ++kk) {
    float a[NR];
    if constexpr (NR >= 4) {
#pragma unroll
      for (int q = 0; q < NR; q += 4) {
        const float4 t = *reinterpret_cast<const float4*>(xs + kk * kR + q);
        a[q] = t.x, a[q + 1] = t.y, a[q + 2] = t.z, a[q + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < NR; ++r) a[r] = xs[kk * kR + r];
    }
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc[v] = a[0] * d[0][v];
#pragma unroll
      for (int r = 1; r < NR; ++r) acc[v] = fmaf(a[r], d[r][v], acc[v]);
    }
    store_piece(out + int64_t(kk) * N, cnt, vec, acc);
  }
}

// Weight gradient, rows path (decode: a few rows an expert; the work is
// writing every expert's K x N gradient, so the bound is the write stream
// at the HBM rate): grid (ceil(P / blockDim), ceil(K / kc), E) for the
// P 16-byte pieces of a dw row; blockDim a multiple of 32, at most
// kDwChunk. Thread t of CTA (c, s, e) owns piece c * blockDim + t of the
// rows [s*kc, s*kc + kc) of dw[e] and writes each with one streaming
// vector store: zeros for an empty group; a group of up to kR rows in one
// pass (its dy piece in registers); a longer group kDwKB rows at a time,
// each summing the group's rows in order.
template <typename T>
__global__ void __launch_bounds__(kDwChunk)
    dw_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const int32_t* __restrict__ offsets, T* __restrict__ dw,
                   int M, int K, int N, int kc, bool vec) {
  constexpr int V = Vec<T>::V;
  __shared__ __align__(16) float xs[kDwMaxKc * kR];
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * kc, nk = min(K, k0 + kc) - k0;
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int cnt = max(0, min(V, N - n));
  int lo, hi;
  group_bounds(offsets, e, M, &lo, &hi);
  T* out = dw + (int64_t(e) * K + k0) * N + n;
  const int nr = hi - lo;
  if (nr == 0) {
    if (cnt == 0) return;
    float z[V] = {};
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk)
      store_piece(out + int64_t(kk) * N, cnt, vec, z);
    return;
  }
  if (nr <= kR) {
    if (nr == 1)
      dw_rows_pass<T, 1>(x, dy, out, xs, lo, nr, K, N, k0, nk, n, cnt, vec);
    else if (nr == 2)
      dw_rows_pass<T, 2>(x, dy, out, xs, lo, nr, K, N, k0, nk, n, cnt, vec);
    else if (nr <= 4)
      dw_rows_pass<T, 4>(x, dy, out, xs, lo, nr, K, N, k0, nk, n, cnt, vec);
    else
      dw_rows_pass<T, kR>(x, dy, out, xs, lo, nr, K, N, k0, nk, n, cnt,
                          vec);
    return;
  }
  if (cnt == 0) return;
  for (int kq = 0; kq < nk; kq += kDwKB) {
    float acc[kDwKB][V] = {};
    for (int m = lo; m < hi; ++m) {
      float d[V], a[kDwKB];
      load_piece(dy + int64_t(m) * N + n, cnt, vec, d);
      const T* xr = x + int64_t(m) * K + k0 + kq;
#pragma unroll
      for (int q = 0; q < kDwKB; ++q) a[q] = kq + q < nk ? to_f(xr[q]) : 0.f;
#pragma unroll
      for (int q = 0; q < kDwKB; ++q)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[q][v] = fmaf(a[q], d[v], acc[q][v]);
    }
#pragma unroll
    for (int q = 0; q < kDwKB; ++q)
      if (kq + q < nk) store_piece(out + int64_t(kq + q) * N, cnt, vec, acc[q]);
  }
}

// Weight gradient, tiles path on the CUDA cores (f32, and bf16 whose
// operands are not 16-byte aligned; no TF32): grid (ceil(N / kDwT),
// ceil(K / kDwT), E), each CTA one kDwT x kDwT tile of dw[e]; 256
// threads, each 8 x 8 outputs (rows ty*4 + {0..3} and 64 + ty*4 + ...,
// columns tx*4 + ... and 64 + tx*4 + ...: four 16-byte shared loads
// for 64 FMAs); the group's rows stream through a kDwS-stage cp.async
// ring kDwR at a time, rows past the group's end zero-filled and never
// multiplied. Bound by the operations (2MKN at the f32 rate).
template <typename T>
__global__ void __launch_bounds__(kDwThreads, 2)
    dw_tiles_simt_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const int32_t* __restrict__ offsets,
                         T* __restrict__ dw, int M, int K, int N, bool vec) {
  constexpr int SZ = kDwR * kDwT;
  extern __shared__ __align__(16) uint8_t smem[];
  T* Xs = reinterpret_cast<T*>(smem);
  T* Ds = Xs + kDwS * SZ;
  const int n0 = blockIdx.x * kDwT, k0 = blockIdx.y * kDwT, e = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int lo, hi;
  group_bounds(offsets, e, M, &lo, &hi);
  const int nst = (hi - lo + kDwR - 1) / kDwR;
  auto load = [&](int slot, int r0) {
    stage<T, kDwR, kDwT, kDwT, kDwThreads>(Xs + slot * SZ, x, K, r0, hi, k0,
                                          K, vec);
    stage<T, kDwR, kDwT, kDwT, kDwThreads>(Ds + slot * SZ, dy, N, r0, hi, n0,
                                          N, vec);
  };
#pragma unroll
  for (int st = 0; st < kDwS - 1; ++st) {
    if (st < nst) load(st, lo + st * kDwR);
    cp_async_commit();
  }
  float acc[8][8] = {};
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kDwS - 2>();
    __syncthreads();  // stage s landed; every thread is done with s - 1
    if (s + kDwS - 1 < nst)
      load((s + kDwS - 1) % kDwS, lo + (s + kDwS - 1) * kDwR);
    cp_async_commit();
    const T* a = Xs + (s % kDwS) * SZ;
    const T* b = Ds + (s % kDwS) * SZ;
    const int rows = min(kDwR, hi - lo - s * kDwR);
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      float av[2][4], bv[2][4];
      load4(a + r * kDwT + ty * 4, av[0]);
      load4(a + r * kDwT + 64 + ty * 4, av[1]);
      load4(b + r * kDwT + tx * 4, bv[0]);
      load4(b + r * kDwT + 64 + tx * 4, bv[1]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(av[i / 4][i % 4], bv[j / 4][j % 4], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  T* de = dw + int64_t(e) * K * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (k >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * 64 + tx * 4;
      T* p = de + int64_t(k) * N + c;
      const float f0 = acc[i][4 * h], f1 = acc[i][4 * h + 1],
                  f2 = acc[i][4 * h + 2], f3 = acc[i][4 * h + 3];
      if (vec && c + 4 <= N) {
        if constexpr (std::is_same<T, float>::value)
          st_cs16(p, __float_as_uint(f0), __float_as_uint(f1),
                  __float_as_uint(f2), __float_as_uint(f3));
        else
          st_cs8(p, bf2(f0, f1), bf2(f2, f3));
      } else {
        if (c < N) p[0] = from_f<T>(f0);
        if (c + 1 < N) p[1] = from_f<T>(f1);
        if (c + 2 < N) p[2] = from_f<T>(f2);
        if (c + 3 < N) p[3] = from_f<T>(f3);
      }
    }
  }
}

// d += A B for one 64 x 256 x 16 step; A and B both MN-major (the
// transpose bits set), 128-byte swizzled in shared memory
__device__ __forceinline__ void wgmma_m64n256k16_tt(float (&d)[128],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// a barrier among one warpgroup's 128 threads (ids 1, 2; 0 is
// __syncthreads)
__device__ __forceinline__ void bar_wg(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}
// a barrier among both warpgroups' 256 threads (id 3)
__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}
__device__ __forceinline__ void tma_store3d(const CUtensorMap* map,
                                            const void* src, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// the bulk stores issued so far have read their shared memory (.read) or
// are complete
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Weight gradient, tiles path on the tensor cores (bf16, 16-byte aligned
// operands): persistent CTAs, one an SM, walk the tiles t = blockIdx.x,
// + gridDim.x, ... of the fixed list (expert, 128 dw rows, 256 dw
// columns), expert-major so that the CTAs in flight share an expert's
// rows in L2. The producer warp (one thread) streams each tile's group
// rows kGR at a time by TMA into a kGS-stage ring: two 64-column boxes of
// x (A = x_e^T, MN-major: its M is x's contiguous K) and four of dy (B =
// dy_e, MN-major), a box past K or N not issued (only rows and columns
// that are never stored would read it). Each consumer warpgroup runs two
// m64n256k16 steps a stage on its 64 dw rows. A group's last stage runs
// past its end into the next group's rows: the consumers zero those rows
// of the x and dy boxes in shared memory (a 128-byte-swizzled row of a
// 64-column box is 128 contiguous bytes; both operands, so that an Inf or
// NaN of the next group stays out of this one's sum) and fence them to
// the async proxy before wgmma reads them; TMA zero-fills only past M.
// The epilogue writes the tile as bf16 into a 128-byte-swizzled staging
// tile (no bank conflicts) and TMA stores it (clipped at K and N), while
// the producer already loads the next tile: its stages fit the ring. An
// empty group's tiles are stored as zeros.
__global__ void __launch_bounds__(kGThreads, 1)
    dw_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tdy,
                    const __grid_constant__ CUtensorMap tdw,
                    const int32_t* __restrict__ offsets, int M, int K, int N,
                    int E) {
  extern __shared__ uint8_t wsmem[];
  uint8_t* base = wsmem + ((1024 - (smem_u32(wsmem) & 1023)) & 1023);
  uint8_t* outs = base + kGS * kGStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + kGOut);
  uint64_t* empty = full + kGS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tk = (K + kGK - 1) / kGK, tn = (N + kGN - 1) / kGN;
  const int ntiles = E * tk * tn;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 8) {  // the producer
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int e = t / (tk * tn), k0 = (t / tn) % tk * kGK,
                  n0 = t % tn * kGN;
        int lo, hi;
        group_bounds(offsets, e, M, &lo, &hi);
        const int nx = min(2, (K - k0 + 63) / 64),
                  nd = min(4, (N - n0 + 63) / 64);
        for (int r0 = lo; r0 < hi; r0 += kGR, ++it) {
          const int s = it % kGS;
          if (it >= kGS) mbar_wait(empty + s, ((it / kGS) - 1) & 1);
          uint8_t* st = base + s * kGStage;
          mbar_expect_tx(full + s, (nx + nd) * kGBox);
          for (int j = 0; j < nx; ++j)
            tma2d(st + j * kGBox, &tx, k0 + 64 * j, r0, full + s);
          for (int j = 0; j < nd; ++j)
            tma2d(st + kGX + j * kGBox, &tdy, n0 + 64 * j, r0, full + s);
        }
      }
    }
    return;
  }
  const int g = warp / 4, wt = threadIdx.x % 128;  // warpgroup, its thread
  uint8_t* og = outs + g * (kGOut / 2);
  const uint32_t sbase = smem_u32(base);
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int e = t / (tk * tn), k0 = (t / tn) % tk * kGK, n0 = t % tn * kGN;
    int lo, hi;
    group_bounds(offsets, e, M, &lo, &hi);
    const bool live = k0 + 64 * g < K;  // the same for the warpgroup
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int r0 = lo; r0 < hi; r0 += kGR, ++it) {
      const int s = it % kGS;
      mbar_wait(full + s, (it / kGS) & 1);
      const int nv = hi - r0;  // rows of this group in the stage
      if (nv < kGR) {
        // zero the next group's rows: of this warpgroup's x box, and,
        // split between the two warpgroups, of the four dy boxes both read
        uint8_t* st = base + s * kGStage + nv * 128;
        const int pieces = (kGR - nv) * 8;  // 16-byte pieces a box
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        if (live)
          for (int i = wt; i < pieces; i += 128)
            reinterpret_cast<uint4*>(st + g * kGBox)[i] = zero;
        for (int i = threadIdx.x; i < 4 * pieces; i += 256)
          reinterpret_cast<uint4*>(st + kGX + i / pieces * kGBox)[i % pieces] =
              zero;
        fence_async_smem();
        bar_consumers();
      }
      if (live) {
        const uint32_t a = sbase + s * kGStage + g * kGBox,
                       b = sbase + s * kGStage + kGX;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kGR / 16; ++kk)
          // 16 group rows are 16 128-byte rows of each box
          wgmma_m64n256k16_tt(acc, desc_mn(a + kk * 2048, kGBox),
                              desc_mn(b + kk * 2048, kGBox));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's steps are done
      }
      if (r0 > lo) mbar_arrive(empty + (it - 1) % kGS);
    }
    if (hi > lo) {
      if (live) wgmma_wait<0>();
      mbar_arrive(empty + (it - 1) % kGS);
    }
    if (!live) continue;
    fence_acc(acc);
    if (wt == 0) bulk_wait_read();  // the last tile's store has read og
    bar_wg(1 + g);
    // the accumulator fragment: warp w of the group holds rows
    // 16w..16w+15; register 4j + i is row l/4 (+8 for i >= 2), column
    // 8j + 2(l%4) + (i & 1); staged as four 64-column boxes of 64 rows,
    // 16-byte chunk c of row r at chunk c ^ (r % 8)
    const int w4 = warp % 4;
#pragma unroll
    for (int j = 0; j < kGN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * w4 + lane / 4 + 8 * h;
        uint8_t* p = og + (j / 8) * 8192 + r * 128 +
                     (((j % 8) ^ (lane / 4)) * 16) + (lane % 4) * 4;
        *reinterpret_cast<uint32_t*>(p) =
            bf2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    fence_async_smem();
    bar_wg(1 + g);
    if (wt == 0) {
      for (int bx = 0; bx < 4; ++bx)
        if (n0 + 64 * bx < N)
          tma_store3d(&tdw, og + bx * 8192, n0 + 64 * bx, k0 + 64 * g, e);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait();
}

// ---------------------------------------------------------------- host

// above 48 KB a kernel must be allowed its dynamic shared memory, once per
// kernel and device (not again inside a CUDA graph capture)
cudaError_t allow_smem(const void* kernel, int bytes) {
  constexpr int kMax = 64;
  static const void* done_kernel[kMax];
  static int done_dev[kMax];
  static int done = 0;
  if (bytes <= 48 * 1024) return cudaSuccess;
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

template <typename T>
cudaError_t launch_rows(const void* x, const void* w, const int32_t* offsets,
                        void* y, float* part, int M, int K, int N, int E,
                        bool trans, bool vec, int splits, int kc, int nt,
                        cudaStream_t st) {
  auto xp = static_cast<const T*>(x);
  auto wp = static_cast<const T*>(w);
  auto yp = static_cast<T*>(y);
  cudaError_t err;
  if (trans) {
    constexpr int bytes = kRingBytes + kXTBytes;
    auto kernel = rows_trans_kernel<T>;
    err = allow_smem(reinterpret_cast<const void*>(kernel), bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((N + nt - 1) / nt, splits, E + 1), kThreads, bytes, st>>>(
        xp, wp, offsets, part, yp, M, K, N, E, kc, nt, vec);
  } else {
    // 8 columns a thread: no more threads than a tile's columns need
    const int nth = std::min(kThreads, (std::min(N, kNT) + 255) / 256 * 32);
    auto kernel = rows_fwd_kernel<T>;
    err = allow_smem(reinterpret_cast<const void*>(kernel),
                     kRingBytes + kXBytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((N + kNT - 1) / kNT, splits, E), nth,
             kS * kD * nth * 16 + kXBytes, st>>>(xp, wp, offsets, part, M, K,
                                                 N, kc, vec);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (trans && splits == 1) return cudaSuccess;  // written directly
  const int64_t MN = int64_t(M) * N;
  const int blocks = int(std::min<int64_t>((MN + kThreads - 1) / kThreads,
                                           4 * 132));
  rows_reduce_kernel<T><<<blocks, kThreads, 0, st>>>(part, offsets, yp, M, N,
                                                     E, splits);
  return cudaGetLastError();
}

template <typename T, int H, int kTK, int kTS>
cudaError_t launch_simt_h(const void* x, const void* w, const int32_t* offsets,
                          void* y, int M, int K, int N, int E, bool trans,
                          bool vec, cudaStream_t st) {
  constexpr int P = 16 / sizeof(T);
  constexpr int BM = kTM * H;
  constexpr int bytes_f = kTS * (BM * (kTK + P) + kTK * (kTNc + P)) *
                          int(sizeof(T));
  constexpr int bytes_t = kTS * (BM * (kTK + P) + kTNc * (kTK + P)) *
                          int(sizeof(T));
  const dim3 grid((N + kTNc - 1) / kTNc,
                  (M + BM - 1) / BM + std::min(E, M) + 1);
  auto xp = static_cast<const T*>(x);
  auto wp = static_cast<const T*>(w);
  auto yp = static_cast<T*>(y);
  cudaError_t err;
  if (trans) {
    auto kernel = tiles_simt_kernel<T, true, H, kTK, kTS>;
    err = allow_smem(reinterpret_cast<const void*>(kernel), bytes_t);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kTThreads, bytes_t, st>>>(xp, wp, offsets, yp, M, K, N, E,
                                             vec);
  } else {
    auto kernel = tiles_simt_kernel<T, false, H, kTK, kTS>;
    err = allow_smem(reinterpret_cast<const void*>(kernel), bytes_f);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kTThreads, bytes_f, st>>>(xp, wp, offsets, yp, M, K, N, E,
                                             vec);
  }
  return cudaGetLastError();
}

// the forward computes 64-row tiles, skipping a 32-row half past the
// group's end (the weight tile is read once for both halves), 16-deep
// stages, 4 in flight; TRANS 32-row tiles, 32-deep stages, 2 in flight
// (each measured faster for its layout in a prefill chunk)
template <typename T>
cudaError_t launch_simt(const void* x, const void* w, const int32_t* offsets,
                        void* y, int M, int K, int N, int E, bool trans,
                        bool vec, cudaStream_t st) {
  if (trans)
    return launch_simt_h<T, 1, 32, 2>(x, w, offsets, y, M, K, N, E, true, vec,
                                      st);
  return launch_simt_h<T, 2, 16, 4>(x, w, offsets, y, M, K, N, E, false, vec,
                                    st);
}

// cuTensorMapEncodeTiled of the CUDA driver API, found through the
// runtime (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map with a 128-byte-swizzled box (dims innermost first)
bool tensor_map(CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint32_t* box) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t strides[2];
  strides[0] = dims[0] * 2;
  if (rank == 3) strides[1] = dims[0] * dims[1] * 2;
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank),
             const_cast<void*>(base), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_wgmma(const void* x, const void* w, const int32_t* offsets,
                         void* y, int M, int K, int N, int E, bool trans,
                         cudaStream_t st) {
  CUtensorMap ta, tb;
  const cuuint64_t adims[2] = {cuuint64_t(K), cuuint64_t(M)};
  const cuuint32_t abox[2] = {kWK, 2 * kWM};
  if (!tensor_map(&ta, x, 2, adims, abox)) return cudaErrorInvalidValue;
  if (trans) {
    const cuuint64_t dims[3] = {cuuint64_t(K), cuuint64_t(N), cuuint64_t(E)};
    const cuuint32_t box[3] = {kWK, kWN, 1};
    if (!tensor_map(&tb, w, 3, dims, box)) return cudaErrorInvalidValue;
  } else {
    const cuuint64_t dims[3] = {cuuint64_t(N), cuuint64_t(K), cuuint64_t(E)};
    const cuuint32_t box[3] = {64, kWK, 1};
    if (!tensor_map(&tb, w, 3, dims, box)) return cudaErrorInvalidValue;
  }
  const dim3 grid((N + kWN - 1) / kWN,
                  (M + 2 * kWM - 1) / (2 * kWM) + std::min(E, M) + 1);
  auto yp = static_cast<__nv_bfloat16*>(y);
  cudaError_t err;
  if (trans) {
    auto kernel = tiles_wgmma_kernel<true>;
    err = allow_smem(reinterpret_cast<const void*>(kernel), kWSmem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kWThreads, kWSmem, st>>>(ta, tb, offsets, yp, M, K, N, E);
  } else {
    auto kernel = tiles_wgmma_kernel<false>;
    err = allow_smem(reinterpret_cast<const void*>(kernel), kWSmem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kWThreads, kWSmem, st>>>(ta, tb, offsets, yp, M, K, N, E);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* dy, const int32_t* offsets,
                      void* dw, int M, int K, int N, int E, bool vec, int path,
                      int kc, int nth, cudaStream_t st) {
  auto xp = static_cast<const T*>(x);
  auto dp = static_cast<const T*>(dy);
  auto wp = static_cast<T*>(dw);
  if (path == 0) {
    // one thread a 16-byte piece of a row, nth a CTA
    const int P = (N + Vec<T>::V - 1) / Vec<T>::V;
    dw_rows_kernel<T><<<dim3((P + nth - 1) / nth, (K + kc - 1) / kc, E), nth,
                        0, st>>>(xp, dp, offsets, wp, M, K, N, kc, vec);
    return cudaGetLastError();
  }
  constexpr int bytes = kDwSmemF32 / 4 * int(sizeof(T));
  auto kernel = dw_tiles_simt_kernel<T>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N + kDwT - 1) / kDwT, (K + kDwT - 1) / kDwT, E), kDwThreads,
           bytes, st>>>(xp, dp, offsets, wp, M, K, N, vec);
  return cudaGetLastError();
}

// the tensor-core tiles path: tensor maps of x (K, M), dy (N, M) and dw
// (N, K, E), one persistent CTA an SM (or a tile, if fewer)
cudaError_t launch_dw_wgmma(const void* x, const void* dy,
                            const int32_t* offsets, void* dw, int M, int K,
                            int N, int E, cudaStream_t st) {
  CUtensorMap tx, tdy, tdw;
  const cuuint64_t xdims[2] = {cuuint64_t(K), cuuint64_t(M)};
  const cuuint64_t ddims[2] = {cuuint64_t(N), cuuint64_t(M)};
  const cuuint64_t wdims[3] = {cuuint64_t(N), cuuint64_t(K), cuuint64_t(E)};
  const cuuint32_t box[2] = {64, kGR};
  const cuuint32_t obox[3] = {64, 64, 1};
  if (!tensor_map(&tx, x, 2, xdims, box) ||
      !tensor_map(&tdy, dy, 2, ddims, box) ||
      !tensor_map(&tdw, dw, 3, wdims, obox))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t tiles = int64_t(E) * ((K + kGK - 1) / kGK) *
                        ((N + kGN - 1) / kGN);
  err = allow_smem(reinterpret_cast<const void*>(dw_wgmma_kernel), kGSmem);
  if (err != cudaSuccess) return err;
  dw_wgmma_kernel<<<int(std::min<int64_t>(sms, tiles)), kGThreads, kGSmem,
                    st>>>(tx, tdy, tdw, offsets, M, K, N, E);
  return cudaGetLastError();
}

}  // namespace

// x (M, K), w (E, K, N) or with trans (E, N, K), y (M, N), offsets (E+1,)
// int32, all contiguous on the card. vec: every pointer 16-byte aligned
// and K, N multiples of 16 bytes' worth of elements. dtype 0 f32, 1 bf16.
// path 0 (rows): splits K-ranges of kc, TRANS output tiles of nt columns
// (the forward's are kNT), part an f32 scratch of splits * M * N (unused
// by TRANS with one K-range); path 1 (tiles): part unused.
// Returns cudaGetLastError() after the launches (0 == launched).
extern "C" int grouped_mm(const void* x, const void* w, const void* offsets,
                          void* y, void* part, int M, int K, int N, int E,
                          int trans, int vec, int dtype, int path, int splits,
                          int kc, int nt, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || K < 0 || N < 0 || E < 0 || E >= 65535 || dtype < 0 ||
      dtype > 1)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto off = static_cast<const int32_t*>(offsets);
  const size_t es = dtype == 0 ? 4 : 2;
  if (K == 0 || E == 0)  // every product is empty: y is all zeros
    return int(cudaMemsetAsync(y, 0, size_t(M) * N * es, st));
  if (path == 0) {
    // splits K-ranges of kc rows, none empty, a pass's x rows within the
    // staging buffer; TRANS: output tiles of nt columns; forward: kNT
    if (splits < 1 || splits > 65535 || kc < 8 || kc % 8 != 0 ||
        int64_t(splits) * kc < K || int64_t(splits - 1) * kc >= K ||
        (trans ? int64_t(kRT) * kc * es > kXTBytes
               : int64_t(kR) * kc * 4 > kXBytes) ||
        nt < 1 || (N + nt - 1) / nt > 65535 || (!trans && nt != kNT))
      return int(cudaErrorInvalidValue);
    auto part_f = static_cast<float*>(part);
    if (dtype == 0)
      return launch_rows<float>(x, w, off, y, part_f, M, K, N, E, trans != 0,
                                vec != 0, splits, kc, nt, st);
    return launch_rows<__nv_bfloat16>(x, w, off, y, part_f, M, K, N, E,
                                      trans != 0, vec != 0, splits, kc, nt,
                                      st);
  }
  if (path != 1 || (M + 31) / 32 + std::min(E, M) + 1 > 65535 ||
      (N + 127) / 128 > 65535)
    return int(cudaErrorInvalidValue);
  if (dtype == 1 && vec) return int(launch_wgmma(x, w, off, y, M, K, N, E,
                                                 trans != 0, st));
  if (dtype == 0)
    return launch_simt<float>(x, w, off, y, M, K, N, E, trans != 0, vec != 0,
                              st);
  return launch_simt<__nv_bfloat16>(x, w, off, y, M, K, N, E, trans != 0,
                                    vec != 0, st);
}

// x (M, K), dy (M, N), dw (E, K, N), offsets (E+1,) int32, all
// contiguous on the card. vec: every pointer 16-byte aligned and K, N
// multiples of 16 bytes' worth of elements. dtype 0 f32, 1 bf16. path 0
// (rows): slabs of kc dw rows (a multiple of 4, at most kDwMaxKc), nth
// threads a CTA (a multiple of 32, at most kDwChunk); path 1 (tiles): kc
// and nth unused. Every entry of dw is written.
// Returns cudaGetLastError() after the launch (0 == launched).
extern "C" int grouped_mm_dw(const void* x, const void* dy,
                             const void* offsets, void* dw, int M, int K,
                             int N, int E, int vec, int dtype, int path,
                             int kc, int nth, void* stream) {
  if (E == 0 || K == 0 || N == 0) return 0;
  if (M < 0 || K < 0 || N < 0 || E < 0 || E > 65535 || dtype < 0 ||
      dtype > 1)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto off = static_cast<const int32_t*>(offsets);
  if (path == 0) {
    const int64_t P = (int64_t(N) + (dtype == 0 ? 3 : 7)) / (dtype == 0 ? 4 : 8);
    if (kc < 4 || kc > kDwMaxKc || kc % 4 != 0 || nth < 32 ||
        nth > kDwChunk || nth % 32 != 0 || (P + nth - 1) / nth > 65535 ||
        (K + kc - 1) / kc > 65535)
      return int(cudaErrorInvalidValue);
  } else if (path != 1 || (K + kDwT - 1) / kDwT > 65535 ||
             int64_t(E) * ((K + kGK - 1) / kGK) * ((N + kGN - 1) / kGN) >
                 INT32_MAX) {
    return int(cudaErrorInvalidValue);
  }
  if (path == 1 && dtype == 1 && vec && M > 0)
    return int(launch_dw_wgmma(x, dy, off, dw, M, K, N, E, st));
  if (dtype == 0)
    return int(launch_dw<float>(x, dy, off, dw, M, K, N, E, vec != 0, path,
                                kc, nth, st));
  return int(launch_dw<__nv_bfloat16>(x, dy, off, dw, M, K, N, E, vec != 0,
                                      path, kc, nth, st));
}

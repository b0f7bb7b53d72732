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
// Bound on the H100: at decode (M = tokens x top_k, a few dozen rows) the
// bytes of the touched experts' weights, which the routing picks; in a
// prefill chunk, the f32 product (2*M*K*N flops on the CUDA cores).
// Design (simple and right first; wgmma/TMA is later work): grid
// (ceil(N/64), E+1), one CTA per (column tile, expert). The CTA reads its
// group's bounds from offsets on the card and returns at once when the
// group is empty, so an untouched expert's weights are never read and the
// grid does not depend on the routing (the launch can be captured in a
// CUDA graph). It walks its rows in BM-row tiles (BM 16 when groups are
// small, 64 otherwise); each tile's K loop stages 32-deep slices of x and
// of the expert's weight through shared memory with cp.async, two stages
// in flight, into f32 accumulators in registers (each thread TM x 4). The
// extra CTA row e == E writes the zeros of rows outside every group.
// The weight-gradient kernel has grid (ceil(K/64), ceil(N/64), E) and
// accumulates a 64 x 64 tile over the group's rows, 32 rows a stage.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;  // output columns a CTA (forward)
constexpr int kBK = 32;  // contraction depth a stage (forward)
constexpr int kTN = 4;   // output columns a thread
constexpr int kDT = 64;  // weight-gradient tile: kDT x kDT outputs
constexpr int kBR = 32;  // rows a stage (weight gradient)

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage a ROWS x COLS tile of a row-major matrix (leading dim ld) whose
// first element is (r0, c0) into shared memory (leading dim SLD). Rows at
// or past r_end and columns at or past c_end read as zero. With vec (the
// matrix base 16-byte aligned and ld a multiple of 16 bytes) every whole
// 16-byte run goes by cp.async; the rest is loaded element by element.
template <typename T, int ROWS, int COLS, int SLD>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int64_t ld, int r0, int r_end, int c0,
                                      int c_end, bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int RUNS = COLS / V;
  static_assert(COLS % V == 0 && SLD % V == 0, "16-byte runs");
  for (int i = threadIdx.x; i < ROWS * RUNS; i += kThreads) {
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

template <typename T, int BM, bool TRANS>
__global__ void __launch_bounds__(kThreads)
    grouped_mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int32_t* __restrict__ offsets, T* __restrict__ y,
                      int M, int K, int N, int E, bool vec) {
  constexpr int TM = BM / 16;
  constexpr int V = 16 / sizeof(T);
  constexpr int ALD = kBK + V;  // padded; rows stay 16-byte aligned
  constexpr int BROWS = TRANS ? kBN : kBK;
  constexpr int BLD = (TRANS ? kBK : kBN) + V;
  __shared__ __align__(16) T As[2][BM * ALD];
  __shared__ __align__(16) T Bs[2][BROWS * BLD];
  const int e = blockIdx.y;
  const int n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // a thread's kTN columns: four neighbours (the non-transposed tile's
  // rows read as 16-byte words), or with TRANS four 16 apart, so the
  // half-warp's reads of the (n, k) tile fall in distinct banks
  auto col = [tx](int j) { return TRANS ? j * 16 + tx : tx * kTN + j; };
  if (e == E) {
    // rows before the first group and past the last: zeros
    const int first = min(max(offsets[0], 0), M);
    const int last = max(first, min(offsets[E], M));
    for (int r = 0; r < M; ++r) {
      if (r == first) r = last;
      if (r >= M) break;
      for (int c = n0 + threadIdx.x; c < min(n0 + kBN, N); c += kThreads)
        y[int64_t(r) * N + c] = from_f<T>(0.f);
    }
    return;
  }
  int lo, hi;
  group_bounds(offsets, e, M, &lo, &hi);
  if (hi == lo) return;  // an untouched expert: its weights are not read
  const T* we = w + int64_t(e) * K * N;
  const int nk = (K + kBK - 1) / kBK;
  for (int m0 = lo; m0 < hi; m0 += BM) {
    float acc[TM][kTN] = {};
    auto load = [&](int buf, int k0) {
      stage<T, BM, kBK, ALD>(As[buf], x, K, m0, hi, k0, K, vec);
      if constexpr (TRANS)
        stage<T, kBN, kBK, BLD>(Bs[buf], we, K, n0, N, k0, K, vec);
      else
        stage<T, kBK, kBN, BLD>(Bs[buf], we, N, k0, K, n0, N, vec);
      cp_async_commit();
    };
    load(0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        load((kt + 1) & 1, (kt + 1) * kBK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* a = As[kt & 1];
      const T* b = Bs[kt & 1];
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float av[TM], bv[kTN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = to_f(a[(ty * TM + i) * ALD + kk]);
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          bv[j] = to_f(TRANS ? b[col(j) * BLD + kk]
                             : b[kk * BLD + col(j)]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();  // the next load overwrites this stage
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + ty * TM + i;
      if (r >= hi) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = n0 + col(j);
        if (c < N) y[int64_t(r) * N + c] = from_f<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_mm_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const int32_t* __restrict__ offsets,
                         T* __restrict__ dw, int M, int K, int N, bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LD = kDT + V;
  __shared__ __align__(16) T Xs[2][kBR * LD];
  __shared__ __align__(16) T Ds[2][kBR * LD];
  const int k0 = blockIdx.x * kDT, n0 = blockIdx.y * kDT, e = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int lo, hi;
  group_bounds(offsets, e, M, &lo, &hi);
  float acc[4][kTN] = {};
  const int nr = (hi - lo + kBR - 1) / kBR;
  auto load = [&](int buf, int r0) {
    stage<T, kBR, kDT, LD>(Xs[buf], x, K, r0, hi, k0, K, vec);
    stage<T, kBR, kDT, LD>(Ds[buf], dy, N, r0, hi, n0, N, vec);
    cp_async_commit();
  };
  if (nr > 0) load(0, lo);
  for (int t = 0; t < nr; ++t) {
    if (t + 1 < nr) {
      load((t + 1) & 1, lo + (t + 1) * kBR);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* a = Xs[t & 1];
    const T* b = Ds[t & 1];
#pragma unroll 8
    for (int rr = 0; rr < kBR; ++rr) {
      float av[4], bv[kTN];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = to_f(a[rr * LD + ty * 4 + i]);
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = to_f(b[rr * LD + tx * kTN + j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  T* de = dw + int64_t(e) * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < N) de[int64_t(k) * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const int32_t* offsets,
                       void* y, int M, int K, int N, int E, bool trans,
                       bool vec, cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, E + 1);
  auto xp = static_cast<const T*>(x);
  auto wp = static_cast<const T*>(w);
  auto yp = static_cast<T*>(y);
  // small groups (decode: a few rows an expert) take 16-row tiles
  const bool small = int64_t(M) < int64_t(32) * E;
  if (small && trans)
    grouped_mm_kernel<T, 16, true>
        <<<grid, kThreads, 0, st>>>(xp, wp, offsets, yp, M, K, N, E, vec);
  else if (small)
    grouped_mm_kernel<T, 16, false>
        <<<grid, kThreads, 0, st>>>(xp, wp, offsets, yp, M, K, N, E, vec);
  else if (trans)
    grouped_mm_kernel<T, 64, true>
        <<<grid, kThreads, 0, st>>>(xp, wp, offsets, yp, M, K, N, E, vec);
  else
    grouped_mm_kernel<T, 64, false>
        <<<grid, kThreads, 0, st>>>(xp, wp, offsets, yp, M, K, N, E, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* dy, const int32_t* offsets,
                      void* dw, int M, int K, int N, int E, bool vec,
                      cudaStream_t st) {
  const dim3 grid((K + kDT - 1) / kDT, (N + kDT - 1) / kDT, E);
  grouped_mm_dw_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), offsets,
      static_cast<T*>(dw), M, K, N, vec);
  return cudaGetLastError();
}

}  // namespace

// x (M, K), w (E, K, N) or with trans (E, N, K), y (M, N), offsets (E+1,)
// int32, all contiguous on the card. vec: every pointer 16-byte aligned
// and K, N multiples of 16 bytes' worth of elements. dtype 0 f32, 1 bf16.
// Returns cudaGetLastError() after the launch (0 == launched).
extern "C" int grouped_mm(const void* x, const void* w, const void* offsets,
                          void* y, int M, int K, int N, int E, int trans,
                          int vec, int dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || K < 0 || N < 0 || E < 0 || E >= 65535)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto off = static_cast<const int32_t*>(offsets);
  if (dtype == 0)
    return launch_fwd<float>(x, w, off, y, M, K, N, E, trans != 0, vec != 0,
                             st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w, off, y, M, K, N, E, trans != 0,
                                     vec != 0, st);
  return int(cudaErrorInvalidValue);
}

// x (M, K), dy (M, N), dw (E, K, N), offsets (E+1,) int32.
extern "C" int grouped_mm_dw(const void* x, const void* dy,
                             const void* offsets, void* dw, int M, int K,
                             int N, int E, int vec, int dtype, void* stream) {
  if (E == 0 || K == 0 || N == 0) return 0;
  if (M < 0 || K < 0 || N < 0 || E < 0 || E > 65535 ||
      (N + kDT - 1) / kDT > 65535)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto off = static_cast<const int32_t*>(offsets);
  if (dtype == 0)
    return launch_dw<float>(x, dy, off, dw, M, K, N, E, vec != 0, st);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(x, dy, off, dw, M, K, N, E, vec != 0,
                                    st);
  return int(cudaErrorInvalidValue);
}

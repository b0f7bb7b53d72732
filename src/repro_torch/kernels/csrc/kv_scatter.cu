// kv_scatter (RecvScatter): write a contiguous (L, n*BS, W) buffer into
// blocks `idx` of paged storage (L, NB, BS, W), in place.
//
// Replaces the TPU kernel src/repro/kernels/kv_scatter.py:kv_scatter_pallas
// (pl.pallas_call at kv_scatter.py:42, pool aliased to the output at :46),
// the receiver side of block-free KV transfer and of the per-layer stripe
// scatter of the overlapped transfer scheduler.
//
// Bound on the H100: bytes, 2 * L * n * BS * W * itemsize over 3.35 TB/s.
// Design: the pool is written where it lies (no new pool allocation, the
// storage pointer never changes); one CTA per (block, layer) page streams
// the page as 16-byte words when size and alignment allow, else 4-, 2- or
// 1-byte words, coalesced across the warp. Blocks not named in idx are
// never touched; indices outside [0, NB) are dropped. Two equal indices
// race, as they do in the TPU kernel: callers pass distinct blocks.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename Word>
__global__ void kv_scatter_kernel(Word* __restrict__ dst,
                                  const Word* __restrict__ buf,
                                  const int32_t* __restrict__ idx,
                                  int64_t nb, int64_t n, int64_t page_words,
                                  int64_t layer_stride_words) {
  const int64_t i = blockIdx.x;  // position in idx
  const int64_t l = blockIdx.y;  // layer
  const int32_t b = idx[i];
  if (b < 0 || b >= nb) return;
  const Word* s = buf + (l * n + i) * page_words;
  Word* d = dst + l * layer_stride_words + int64_t(b) * page_words;
  for (int64_t w = threadIdx.x; w < page_words; w += blockDim.x) d[w] = s[w];
}

template <typename Word>
cudaError_t launch(void* dst, const void* buf, const int32_t* idx,
                   int64_t layers, int64_t nb, int64_t n, int64_t page_bytes,
                   int64_t layer_stride_bytes, cudaStream_t stream) {
  const int64_t w = sizeof(Word);
  dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(layers));
  kv_scatter_kernel<Word><<<grid, 256, 0, stream>>>(
      static_cast<Word*>(dst), static_cast<const Word*>(buf), idx, nb, n,
      page_bytes / w, layer_stride_bytes / w);
  return cudaGetLastError();
}

bool fits(int64_t w, const void* a, const void* b, int64_t x, int64_t y) {
  return reinterpret_cast<uintptr_t>(a) % w == 0 &&
         reinterpret_cast<uintptr_t>(b) % w == 0 && x % w == 0 && y % w == 0;
}

}  // namespace

// dst: layer 0 of the storage (or of a single-layer view); layer l starts
// layer_stride_bytes further on. buf: (layers, n*BS, W) contiguous.
// Returns cudaGetLastError() after the launch (0 == launched).
extern "C" int kv_scatter(void* dst, const void* buf, const void* idx,
                          int64_t layers, int64_t nb, int64_t n,
                          int64_t page_bytes, int64_t layer_stride_bytes,
                          void* stream) {
  if (n == 0 || layers == 0) return 0;
  if (n > 2147483647 || layers > 65535) return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int32_t*>(idx);
  if (fits(16, dst, buf, page_bytes, layer_stride_bytes))
    return launch<uint4>(dst, buf, ix, layers, nb, n, page_bytes,
                         layer_stride_bytes, st);
  if (fits(4, dst, buf, page_bytes, layer_stride_bytes))
    return launch<uint32_t>(dst, buf, ix, layers, nb, n, page_bytes,
                            layer_stride_bytes, st);
  if (fits(2, dst, buf, page_bytes, layer_stride_bytes))
    return launch<uint16_t>(dst, buf, ix, layers, nb, n, page_bytes,
                            layer_stride_bytes, st);
  return launch<uint8_t>(dst, buf, ix, layers, nb, n, page_bytes,
                         layer_stride_bytes, st);
}

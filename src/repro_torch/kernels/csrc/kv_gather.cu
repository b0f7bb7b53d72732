// kv_gather: copy the pool blocks named by `idx` out of paged storage
// (L, NB, BS, W) into one contiguous (L, n*BS, W) buffer.
//
// Replaces the TPU kernel src/repro/kernels/kv_gather.py:kv_gather_pallas
// (pl.pallas_call at kv_gather.py:38), the sender side of block-free KV
// transfer and the warm-prefix gather.
//
// Bound on the H100: bytes. It reads n*L pages and writes as many, with no
// arithmetic, so the least time is 2 * L * n * BS * W * itemsize over the
// 3.35 TB/s of HBM. Design: one CTA per (block, layer) page; the page is a
// contiguous run of BS*W elements at both ends, so the CTA streams it as
// 16-byte words (uint4) when the page size and pointers allow it, falling
// back to 4-, 2- or 1-byte words. Neighbouring threads touch neighbouring
// words, so every warp access is one coalesced 512-byte transaction.
// Indices outside [0, NB) produce a zero page rather than a stray read.
// The copy is bit-exact for every dtype: it never interprets the bytes.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename Word>
__global__ void kv_gather_kernel(const Word* __restrict__ src,
                                 const int32_t* __restrict__ idx,
                                 Word* __restrict__ out, int64_t nb,
                                 int64_t n, int64_t page_words,
                                 int64_t layer_stride_words) {
  const int64_t i = blockIdx.x;  // position in idx
  const int64_t l = blockIdx.y;  // layer
  const int32_t b = idx[i];
  Word* dst = out + (l * n + i) * page_words;
  if (b < 0 || b >= nb) {
    for (int64_t w = threadIdx.x; w < page_words; w += blockDim.x)
      dst[w] = Word{};
    return;
  }
  const Word* s = src + l * layer_stride_words + int64_t(b) * page_words;
  for (int64_t w = threadIdx.x; w < page_words; w += blockDim.x)
    dst[w] = s[w];
}

template <typename Word>
cudaError_t launch(const void* src, const int32_t* idx, void* out,
                   int64_t layers, int64_t nb, int64_t n, int64_t page_bytes,
                   int64_t layer_stride_bytes, cudaStream_t stream) {
  const int64_t w = sizeof(Word);
  dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(layers));
  kv_gather_kernel<Word><<<grid, 256, 0, stream>>>(
      static_cast<const Word*>(src), idx, static_cast<Word*>(out), nb, n,
      page_bytes / w, layer_stride_bytes / w);
  return cudaGetLastError();
}

bool fits(int64_t w, const void* a, const void* b, int64_t x, int64_t y) {
  return reinterpret_cast<uintptr_t>(a) % w == 0 &&
         reinterpret_cast<uintptr_t>(b) % w == 0 && x % w == 0 && y % w == 0;
}

}  // namespace

// src: layer 0 of the storage (or of a single-layer view); layer l starts
// layer_stride_bytes further on. out: (layers, n*BS, W) contiguous.
// Returns cudaGetLastError() after the launch (0 == launched).
extern "C" int kv_gather(const void* src, const void* idx, void* out,
                         int64_t layers, int64_t nb, int64_t n,
                         int64_t page_bytes, int64_t layer_stride_bytes,
                         void* stream) {
  if (n == 0 || layers == 0) return 0;
  if (n > 2147483647 || layers > 65535) return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int32_t*>(idx);
  if (fits(16, src, out, page_bytes, layer_stride_bytes))
    return launch<uint4>(src, ix, out, layers, nb, n, page_bytes,
                         layer_stride_bytes, st);
  if (fits(4, src, out, page_bytes, layer_stride_bytes))
    return launch<uint32_t>(src, ix, out, layers, nb, n, page_bytes,
                            layer_stride_bytes, st);
  if (fits(2, src, out, page_bytes, layer_stride_bytes))
    return launch<uint16_t>(src, ix, out, layers, nb, n, page_bytes,
                            layer_stride_bytes, st);
  return launch<uint8_t>(src, ix, out, layers, nb, n, page_bytes,
                         layer_stride_bytes, st);
}

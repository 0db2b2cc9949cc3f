// Kernel C: write new K/V token rows into the stacked KV cache, in place.
//
// Replaces the TPU kernel llm_inference_engine_tpu/ops/kv_cache.py
// `_write_kernel` (launched by `_write_pallas`), which DMAs each
// sequence's [T, K, D] span into cache[layer, b, starts[b]:starts[b]+T].
//
// Layout: new rows [B, T, K, D] and caches [L, B, S, K, D], all contiguous
// and token-major, so one token's K*D values are one contiguous row of
// `row_bytes` bytes. Row t of sequence b lands at cache[layer, b,
// starts[b] + t] when t < new_len[b] and starts[b] + t < S; other rows
// (padding, sequences with new_len == 0, anything past the cache end) are
// never written.
//
// Bound: pure data movement, so HBM bytes on Hopper (2 x B x T x row_bytes
// read and written). Design: one block per (token, sequence, k|v) row,
// each thread moving 16-byte vectors, neighbouring threads on
// neighbouring addresses, so every row is one coalesced stream. Blocks of
// skipped rows exit at once. The element type does not matter: the kernel
// copies bytes (bf16 and f32 caches both work).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void kv_write_kernel(const uint4* __restrict__ k_new,
                                const uint4* __restrict__ v_new,
                                uint4* __restrict__ k_cache,
                                uint4* __restrict__ v_cache,
                                const int* __restrict__ starts,
                                const int* __restrict__ new_len,
                                int layer, int B, int T, int S,
                                int row_vecs) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  if (t >= new_len[b]) return;
  const long long pos = (long long)starts[b] + t;
  if (pos < 0 || pos >= S) return;
  const uint4* src = (blockIdx.z == 0 ? k_new : v_new) +
                     ((size_t)b * T + t) * row_vecs;
  uint4* dst = (blockIdx.z == 0 ? k_cache : v_cache) +
               (((size_t)layer * B + b) * S + pos) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

extern "C" int kv_write(const void* k_new, const void* v_new, void* k_cache,
                        void* v_cache, const int* starts, const int* new_len,
                        int layer, int B, int T, int S, int row_bytes,
                        void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const int row_vecs = row_bytes / 16;
  const int threads = row_vecs >= 256 ? 256 : ((row_vecs + 31) / 32) * 32;
  dim3 grid(T, B, 2);
  kv_write_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)k_new, (const uint4*)v_new, (uint4*)k_cache,
      (uint4*)v_cache, starts, new_len, layer, B, T, S, row_vecs);
  return (int)cudaGetLastError();
}

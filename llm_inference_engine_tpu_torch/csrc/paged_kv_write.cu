// Kernel H: write new K/V token rows into the paged KV pool through the
// block table, in place.
//
// Replaces the TPU kernel llm_inference_engine_tpu/ops/paged_kv.py
// `_paged_write_kernel` (launched by `_paged_write_pallas`), which DMAs a
// chunk row's whole [T, K, D] window into one page (the chunk starts
// page-aligned) and a decode row's one token at any in-page offset.
//
// Layout: new rows [B, T, K, D] and pools [L, P, page, K, D], contiguous;
// one token's K*D values are one contiguous row of `row_bytes` bytes.
// Row t of sequence b, at position pos = starts[b] + t, lands at pool
// [layer, table[b, pos / page], pos % page] when t < new_len[b] and
// 0 <= pos < max_pages * page. Rows with new_len == 0 and padding rows are
// never written, and each row is translated through the table on its own,
// so one launch serves chunk rows and decode rows alike and no row relies
// on the engine's page-alignment invariant. The table entries read are
// those of written rows only, all below ceil((starts + new_len) / page).
//
// Bound: pure data movement, so HBM bytes (2 x rows x row_bytes read and
// written). Design, as kernel C: one block per (token, sequence, k|v)
// row, each thread moving 16-byte vectors, neighbouring threads on
// neighbouring addresses; blocks of skipped rows exit at once. The
// element type does not matter: the kernel copies bytes.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void paged_kv_write_kernel(const uint4* __restrict__ k_new,
                                      const uint4* __restrict__ v_new,
                                      uint4* __restrict__ k_pool,
                                      uint4* __restrict__ v_pool,
                                      const int* __restrict__ starts,
                                      const int* __restrict__ new_len,
                                      const int* __restrict__ table,
                                      int layer, int T, int P, int page,
                                      int max_pages, int row_vecs) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  if (t >= new_len[b]) return;
  const long long pos = (long long)starts[b] + t;
  if (pos < 0 || pos >= (long long)max_pages * page) return;
  const int pg = table[(size_t)b * max_pages + (int)(pos / page)];
  if (pg < 0 || pg >= P) return;
  const uint4* src = (blockIdx.z == 0 ? k_new : v_new) +
                     ((size_t)b * T + t) * row_vecs;
  uint4* dst = (blockIdx.z == 0 ? k_pool : v_pool) +
               (((size_t)layer * P + pg) * page + (int)(pos % page)) *
                   row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

extern "C" int paged_kv_write(const void* k_new, const void* v_new,
                              void* k_pool, void* v_pool, const int* starts,
                              const int* new_len, const int* table, int layer,
                              int B, int T, int P, int page, int max_pages,
                              int row_bytes, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (page <= 0 || max_pages <= 0 || P <= 0 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  const int threads = row_vecs >= 256 ? 256 : ((row_vecs + 31) / 32) * 32;
  dim3 grid(T, B, 2);
  paged_kv_write_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)k_new, (const uint4*)v_new, (uint4*)k_pool,
      (uint4*)v_pool, starts, new_len, table, layer, T, P, page, max_pages,
      row_vecs);
  return (int)cudaGetLastError();
}

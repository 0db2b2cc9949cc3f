// Kernel I: quantize new K/V token rows and write them into an int8 KV
// cache with their f32 scales, in place: the stacked slot cache
// (`kv_write_quant`) or, through the block table, the paged pool
// (`paged_kv_write_quant`, kernel H's int8 mode).
//
// Replaces the TPU kernel llm_inference_engine_tpu/ops/kv_cache.py
// `_write_kernel_quant` (launched by `_write_pallas(quantized=True)`), which
// DMAs int8 values [T, K, D] and f32 scales [T, K] of each sequence into
// cache[layer, b, starts[b]:starts[b]+T] and scales[layer, b, ...], and the
// int8 mode of llm_inference_engine_tpu/ops/paged_kv.py `_paged_write_kernel`
// on the JAX package's int8 pool. The JAX package quantizes in XLA ahead of
// its copy kernels; here the quantize is fused into the write
// (kv_quant.cuh), so the bf16 rows are read once and no int8 intermediate
// goes through device memory.
//
// Layout: new rows bf16 [B, T, K, D]; slot: values int8 [L, B, S, K, D],
// scales f32 [L, B, S, K]; paged (PAGED): values int8 [L, P, page, K, D],
// scales f32 [L, P, page, K]; all contiguous. Row t of sequence b, at
// position pos = starts[b] + t, is written when t < new_len[b] and
//   slot:  0 <= pos < S, at token [layer, b, pos];
//   paged: 0 <= pos < max_pages * page, at [layer, table[b, pos / page],
//          pos % page], each row translated through the table on its own
//          (kernel H's rules: only table entries of written rows are read).
// Other rows (padding, sequences with new_len == 0, anything past the end)
// are never written. SNAPPED picks the log2-snapped scale numerics (the
// pool always uses them), otherwise absmax / 127 (kv_quant.cuh).
//
// Bound: HBM bytes (2 x rows x K x D x 2 bytes read, half that plus 4 bytes
// per (token, head) written); the quantize is a few FLOPs per byte. Design:
// one warp per (token, head, k|v) row of D values, eight rows per block;
// the warp's absmax is one shuffle reduction, its loads and stores are
// contiguous across lanes; warps of skipped rows exit at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

// Where the rows go: slot (B, S) or paged (table, P, page, max_pages).
struct Dest {
  int layer, B, S;
  const int* table;
  int P, page, max_pages;
};

// The token row of [L, *, K] that position `pos` of sequence b lands at, or
// -1 when the row is not written.
template <bool PAGED>
__device__ __forceinline__ long long token_row(const Dest& d, int b,
                                               long long pos) {
  if (PAGED) {
    if (pos < 0 || pos >= (long long)d.max_pages * d.page) return -1;
    const int pg = d.table[(size_t)b * d.max_pages + (int)(pos / d.page)];
    if (pg < 0 || pg >= d.P) return -1;
    return ((long long)d.layer * d.P + pg) * d.page + pos % d.page;
  }
  if (pos < 0 || pos >= d.S) return -1;
  return ((long long)d.layer * d.B + b) * d.S + pos;
}

template <int D, bool SNAPPED, bool PAGED>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
kv_write_quant_kernel(const __nv_bfloat16* __restrict__ k_new,
                      const __nv_bfloat16* __restrict__ v_new,
                      signed char* __restrict__ k_cache,
                      signed char* __restrict__ v_cache,
                      float* __restrict__ k_scale,
                      float* __restrict__ v_scale,
                      const int* __restrict__ starts,
                      const int* __restrict__ new_len, Dest dest, int T,
                      int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (row >= T * K) return;                    // warp-uniform
  const int t = row / K;
  const int kh = row % K;
  if (t >= new_len[b]) return;
  const long long tok = token_row<PAGED>(dest, b, (long long)starts[b] + t);
  if (tok < 0) return;
  const bool is_v = blockIdx.z != 0;
  const size_t src = (((size_t)b * T + t) * K + kh) * D;
  const size_t dst = (size_t)tok * K + kh;
  kvq::quantize_row<D, SNAPPED>((is_v ? v_new : k_new) + src,
                                (is_v ? v_cache : k_cache) + dst * D,
                                (is_v ? v_scale : k_scale) + dst, lane);
}

template <int D, bool SNAPPED, bool PAGED>
int launch(const void* k_new, const void* v_new, void* k_cache,
           void* v_cache, void* k_scale, void* v_scale, const int* starts,
           const int* new_len, const Dest& dest, int B, int T, int K,
           cudaStream_t stream) {
  dim3 grid((T * K + kRowsPerBlock - 1) / kRowsPerBlock, B, 2);
  kv_write_quant_kernel<D, SNAPPED, PAGED>
      <<<grid, kRowsPerBlock * 32, 0, stream>>>(
          (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
          (signed char*)k_cache, (signed char*)v_cache, (float*)k_scale,
          (float*)v_scale, starts, new_len, dest, T, K);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, void*, void*, void*,
                         void*, const int*, const int*, const Dest&, int,
                         int, int, cudaStream_t);

template <bool PAGED>
LaunchFn pick(int D, int snapped) {
  switch (D) {
    case 64: return snapped ? &launch<64, true, PAGED> : &launch<64, false, PAGED>;
    case 80: return snapped ? &launch<80, true, PAGED> : &launch<80, false, PAGED>;
    case 96: return snapped ? &launch<96, true, PAGED> : &launch<96, false, PAGED>;
    case 128: return snapped ? &launch<128, true, PAGED> : &launch<128, false, PAGED>;
    case 256: return snapped ? &launch<256, true, PAGED> : &launch<256, false, PAGED>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" int kv_write_quant(const void* k_new, const void* v_new,
                              void* k_cache, void* v_cache, void* k_scale,
                              void* v_scale, const int* starts,
                              const int* new_len, int layer, int B, int T,
                              int K, int S, int D, int snapped,
                              void* stream) {
  if (B <= 0 || T <= 0) return 0;
  LaunchFn fn = pick<false>(D, snapped);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const Dest dest{layer, B, S, nullptr, 0, 0, 0};
  return fn(k_new, v_new, k_cache, v_cache, k_scale, v_scale, starts,
            new_len, dest, B, T, K, (cudaStream_t)stream);
}

extern "C" int paged_kv_write_quant(const void* k_new, const void* v_new,
                                    void* k_pool, void* v_pool,
                                    void* k_scale, void* v_scale,
                                    const int* starts, const int* new_len,
                                    const int* table, int layer, int B,
                                    int T, int K, int P, int page,
                                    int max_pages, int D, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  LaunchFn fn = pick<true>(D, 1);
  if (page <= 0 || max_pages <= 0 || P <= 0 || fn == nullptr)
    return (int)cudaErrorInvalidValue;
  const Dest dest{layer, B, 0, table, P, page, max_pages};
  return fn(k_new, v_new, k_pool, v_pool, k_scale, v_scale, starts,
            new_len, dest, B, T, K, (cudaStream_t)stream);
}

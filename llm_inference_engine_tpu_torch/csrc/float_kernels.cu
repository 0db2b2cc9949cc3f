// Kernel If: the float instance of kernel I, the int8 K/V write of a
// float32 or float16 model's rows, computed in f32 on the CUDA cores.
//
// The JAX package's Pallas kernels take a float32, float16 or bfloat16
// model because they compute in f32 inside. Kernel I
// (kv_write_quant.cu) quantizes bf16 rows; this instance, one template
// over the element type T (float or __half), takes the other two dtypes:
// If (kv_write_quant_float_kernel) replaces ops/kv_cache.py
// `_write_kernel_quant` and the int8 mode of ops/paged_kv.py
// `_paged_write_kernel`: T rows quantized per (token, head) into the int8
// slot cache or pool, snapped or absmax scales (kv_quant.cuh).
// The other float instances left this file: D2f and Df are kernels D2 and
// D's templates (attention_prefill_f16.cu, attention_prefill_f32.cu,
// attention_decode_f16.cu, attention_decode_f32.cu), Ef and Ff kernels E
// and F's (quant_matmul_f16.cu, quant_matmul_f32.cu).
// head_dim is a runtime argument (a multiple of 16 from 16 to 256; the
// wrappers take _native.FLOAT_HEAD_DIMS).
//
// Bound and design. If is bound by bytes: one warp a (token, k|v, head)
// row, lane l its values l + 32 i; the warp's absmax by shuffles, then
// kvq::row_scale, divide_recip and quantize (kvq::quantize_row_strided),
// the rounding of kernel I and of the plain quantize_rows. Ragged tails
// are masked: rows past new_len are neither read nor written.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

constexpr int kMaxD = 256;

bool head_dim_ok(int D) { return D >= 16 && D <= kMaxD && D % 16 == 0; }

// ---------------------------------------------------------------------------
// If: the int8 write of T rows
// ---------------------------------------------------------------------------

struct WriteParams {
  const void* k_new;    // [B, T, K, D] of T
  const void* v_new;
  signed char* k_cache; // [L, B, S, K, D] or [L, P, page, K, D]
  signed char* v_cache;
  float* k_scale;       // [L, B, S, K] or [L, P, page, K]
  float* v_scale;
  const int* starts;    // [B]
  const int* new_len;   // [B]
  const int* table;     // PAGED: [B, max_pages]
  int layer, B, T, K, S, D;   // S: slot length, or the pool's P pages
  int page, max_pages, snapped;
};

constexpr int kWriteThreads = 256;

template <typename T, bool PAGED>
__global__ void __launch_bounds__(kWriteThreads)
kv_write_quant_float_kernel(const WriteParams p) {
  const int b = blockIdx.y, lane = threadIdx.x % 32;
  // the warp's row of sequence b's flat order (t, k|v, head)
  const int r = blockIdx.x * (kWriteThreads / 32) + threadIdx.x / 32;
  const int n_tok = max(min(p.new_len[b], p.T), 0);
  if (r >= n_tok * 2 * p.K) return;            // warp-uniform from here
  const int t = r / (2 * p.K), head = r - t * 2 * p.K;
  const bool v = head >= p.K;
  const int kh = v ? head - p.K : head;
  const long long pos = (long long)p.starts[b] + t;
  long long row;
  if (PAGED) {
    if (pos < 0 || pos >= (long long)p.max_pages * p.page) return;
    const int e = p.table[(size_t)b * p.max_pages + (int)(pos / p.page)];
    if (e < 0 || e >= p.S) return;
    row = (((long long)p.layer * p.S + e) * p.page + pos % p.page) * p.K + kh;
  } else {
    if (pos < 0 || pos >= p.S) return;
    row = (((long long)p.layer * p.B + b) * p.S + pos) * p.K + kh;
  }
  const T* src = static_cast<const T*>(v ? p.v_new : p.k_new) +
                 (((size_t)b * p.T + t) * p.K + kh) * p.D;
  kvq::quantize_row_strided<T>(src, (v ? p.v_cache : p.k_cache) + row * p.D,
                               (v ? p.v_scale : p.k_scale) + row, p.D,
                               p.snapped != 0, lane);
}

template <typename T>
int launch_write(const WriteParams& p, bool paged, cudaStream_t stream) {
  constexpr int kRowsABlock = kWriteThreads / 32;
  const dim3 grid((2 * p.T * p.K + kRowsABlock - 1) / kRowsABlock, p.B);
  if (paged)
    kv_write_quant_float_kernel<T, true><<<grid, kWriteThreads, 0, stream>>>(p);
  else
    kv_write_quant_float_kernel<T, false>
        <<<grid, kWriteThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// If: T rows [B, T, K, D] quantized into the int8 slot cache (table null)
// or through the table into the pool (S is then its page count P).
extern "C" int kv_write_quant_float(const void* k_new, const void* v_new,
                                    void* k_cache, void* v_cache,
                                    void* k_scale, void* v_scale,
                                    const int* starts, const int* new_len,
                                    const int* table, int layer, int B,
                                    int T, int K, int S, int page,
                                    int max_pages, int D, int dtype,
                                    int snapped, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const bool paged = table != nullptr;
  if (!head_dim_ok(D) || K <= 0 || S <= 0 ||
      (paged && (page <= 0 || max_pages <= 0)) || (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  WriteParams p{k_new, v_new, (signed char*)k_cache, (signed char*)v_cache,
                (float*)k_scale, (float*)v_scale, starts, new_len, table,
                layer, B, T, K, S, D, page, max_pages, snapped};
  const cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_write<__half>(p, paged, s)
                    : launch_write<float>(p, paged, s);
}

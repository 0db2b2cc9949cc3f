// The float instances of kernels I, E and F: the same functions for a
// float32 or float16 model, computed in f32 on the CUDA cores.
//
// The JAX package's Pallas kernels take a float32, float16 or bfloat16
// model because they compute in f32 inside. The bf16 kernels of this port
// (kv_write_quant.cu, quant_matmul.cu) run on bf16 rows or tensor cores;
// these instances, one template over the element type T (float or
// __half) each, take the other two dtypes:
//   - If (kv_write_quant_float_kernel): replaces ops/kv_cache.py
//     `_write_kernel_quant` and the int8 mode of ops/paged_kv.py
//     `_paged_write_kernel`: T rows quantized per (token, head) into the
//     int8 slot cache or pool, snapped or absmax scales (kv_quant.cuh);
//   - Ef / Ff (quant_matmul_float_kernel, then quant_matmul_float_reduce):
//     replace ops/quant.py `_int4_matmul_kernel` and `_int8_matmul_kernel`
//     below 1024 rows: T activations times INT4 weights with grouped
//     scales (each group's f32 partial product times its scale, summed in
//     f32) or INT8 weights (exact values, the per-channel scale after the
//     f32 sum); out T or f32 (the lm_head).
// The float attention instances D2f and Df left this file: float16
// prefill runs on kernel D2's tensor-core template
// (attention_prefill_f16.cu), float32 prefill on a register-tiled kernel
// (attention_prefill_f32.cu), and both decodes on kernel D's split-KV
// template (attention_decode_f16.cu, attention_decode_f32.cu), a float
// pool's token write fused in.
// No tensor core runs here, so no TF32 and no bf16 rounding of an f32
// value: every product is an f32 FMA. head_dim is a runtime argument (a
// multiple of 16 from 16 to 256; the wrappers take
// _native.FLOAT_HEAD_DIMS).
//
// Bound and design. If and the decode-sized matmuls are bound by bytes.
// What the design does:
//   - If: one warp a (token, k|v, head) row, lane l its values l + 32 i;
//     the warp's absmax by shuffles, then kvq::row_scale, divide_recip and
//     quantize (kvq::quantize_row_strided), the rounding of kernel I and
//     of the plain quantize_rows;
//   - Ef / Ff: a block of 128 threads takes 8 rows of x and 512 output
//     columns (4 adjacent ones a thread, one 32-bit weight load a K row, 8
//     values of INT4), over one K split of whole scale groups; x is staged
//     64 K rows at a time in shared memory. The splits (enough blocks to
//     fill the card at decode sizes, ops/quant.py `float_matmul_plan`)
//     write f32 partial sums into a workspace the wrapper allocates, and
//     quant_matmul_float_reduce sums them in split order, applies the INT8
//     scale and rounds once: deterministic, no atomics.
// Ragged tails are masked: rows past m, columns past n and K rows past k
// are neither read nor written.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

constexpr int kMaxD = 256;

using kvq::to_f32;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

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

// ---------------------------------------------------------------------------
// Ef / Ff: T activations times INT4 / INT8 weights
// ---------------------------------------------------------------------------

struct MatParams {
  const void* x;          // [m, k] of T
  const signed char* q;   // INT8 [k, n], INT4 [k / 2, n] (a half each)
  const float* scale;     // INT8 [1, n], INT4 [k / group, n]
  float* work;            // [splits, m, halves * n] partial sums
  void* out;              // [m, halves * n] of T, or f32
  int m, k, n, halves;
  long long q_half, s_half;   // elements from one half to the next
  int group;              // INT4 scale group
  int chunk;              // K rows a split (whole groups)
  int out_f32;
};

constexpr int kMatThreads = 128;
constexpr int kMatCols = 4;      // adjacent output columns a thread
constexpr int kMatRows = 8;      // x rows a block
constexpr int kMatK = 64;        // K rows of x staged at a time

template <typename T, bool INT4>
__global__ void __launch_bounds__(kMatThreads)
quant_matmul_float_kernel(const MatParams p) {
  __shared__ __align__(16) float xs[kMatRows][kMatK];
  const int cols = p.halves * p.n;
  const int c0 = (blockIdx.x * kMatThreads + threadIdx.x) * kMatCols;
  const int i0 = blockIdx.y * kMatRows;
  const int k0 = blockIdx.z * p.chunk, k1 = min(p.k, k0 + p.chunk);
  const bool live = c0 < cols;
  const int half = live ? c0 / p.n : 0;
  const int col = c0 - half * p.n;
  const signed char* qh = p.q + half * p.q_half;
  const float* sh = p.scale + half * p.s_half;
  const T* x = static_cast<const T*>(p.x);
  float acc[kMatRows][kMatCols], part[kMatRows][kMatCols];
#pragma unroll
  for (int r = 0; r < kMatRows; ++r)
#pragma unroll
    for (int c = 0; c < kMatCols; ++c) acc[r][c] = part[r][c] = 0.f;

  for (int kc = k0; kc < k1; kc += kMatK) {
    const int nk = min(kMatK, k1 - kc);
    __syncthreads();
    for (int e = threadIdx.x; e < kMatRows * kMatK; e += kMatThreads) {
      const int r = e / kMatK, kk = e % kMatK;
      xs[r][kk] = i0 + r < p.m && kk < nk
                      ? to_f32(x[(size_t)(i0 + r) * p.k + kc + kk]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    if (INT4) {
      // byte row kr holds K row 2 kr in its low nibble, 2 kr + 1 in its high
#pragma unroll 4
      for (int kk = 0; kk < nk; kk += 2) {
        const char4 w4 = *reinterpret_cast<const char4*>(
            qh + (size_t)((kc + kk) / 2) * p.n + col);
        const signed char wb[kMatCols] = {w4.x, w4.y, w4.z, w4.w};
        float lo[kMatCols], hi[kMatCols];
#pragma unroll
        for (int c = 0; c < kMatCols; ++c) {
          lo[c] = (float)((signed char)((unsigned char)wb[c] << 4) >> 4);
          hi[c] = (float)(wb[c] >> 4);
        }
#pragma unroll
        for (int r = 0; r < kMatRows; ++r) {
          const float x0 = xs[r][kk], x1 = xs[r][kk + 1];
#pragma unroll
          for (int c = 0; c < kMatCols; ++c) {
            part[r][c] = fmaf(x0, lo[c], part[r][c]);
            part[r][c] = fmaf(x1, hi[c], part[r][c]);
          }
        }
      }
      if ((kc + nk - k0) % p.group == 0) {   // a scale group ends here
        const int g = (kc + nk - 1) / p.group;
        const float4 s4 =
            *reinterpret_cast<const float4*>(sh + (size_t)g * p.n + col);
        const float s[kMatCols] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int r = 0; r < kMatRows; ++r)
#pragma unroll
          for (int c = 0; c < kMatCols; ++c) {
            acc[r][c] = fmaf(part[r][c], s[c], acc[r][c]);
            part[r][c] = 0.f;
          }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const char4 w4 = *reinterpret_cast<const char4*>(
            qh + (size_t)(kc + kk) * p.n + col);
        const float w[kMatCols] = {(float)w4.x, (float)w4.y, (float)w4.z,
                                   (float)w4.w};
#pragma unroll
        for (int r = 0; r < kMatRows; ++r) {
          const float xv = xs[r][kk];
#pragma unroll
          for (int c = 0; c < kMatCols; ++c)
            acc[r][c] = fmaf(xv, w[c], acc[r][c]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kMatRows; ++r) {
    if (i0 + r >= p.m) break;
    float* dst = p.work + ((size_t)blockIdx.z * p.m + i0 + r) * cols + c0;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// out = the splits' sum in split order (times the INT8 channel scale),
// rounded once.
template <typename T, bool INT4>
__global__ void __launch_bounds__(256)
quant_matmul_float_reduce(const MatParams p, int splits) {
  const int cols = p.halves * p.n;
  const long long total = (long long)p.m * cols;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += p.work[sp * total + i];
  if (!INT4) {
    const int c = (int)(i % cols), half = c / p.n;
    s *= p.scale[half * p.s_half + (c - half * p.n)];
  }
  if (p.out_f32)
    static_cast<float*>(p.out)[i] = s;
  else
    static_cast<T*>(p.out)[i] = from_f32<T>(s);
}

template <typename T, bool INT4>
int launch_matmul(const MatParams& p, int splits, cudaStream_t stream) {
  const int cols = p.halves * p.n;
  constexpr int kBlockCols = kMatThreads * kMatCols;
  const dim3 grid((cols + kBlockCols - 1) / kBlockCols,
                  (p.m + kMatRows - 1) / kMatRows, splits);
  quant_matmul_float_kernel<T, INT4><<<grid, kMatThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)p.m * cols;
  quant_matmul_float_reduce<T, INT4>
      <<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(p, splits);
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

// Ef (group > 0) and Ff (group 0): x [m, k] times the weight (the [2, k', n]
// gate|up stack: halves 2, flat [m, 2n] out) over `splits` K splits of
// `chunk` rows (whole groups), partial sums in `work`, then the reduce.
extern "C" int quant_matmul_float(const void* x, const void* q,
                                  const void* scale, void* work, void* out,
                                  int m, int k, int n, int halves,
                                  long long q_half, long long s_half,
                                  int group, int chunk, int splits,
                                  int dtype, int out_f32, void* stream) {
  if (m <= 0) return 0;
  const bool int4 = group > 0;
  if (k <= 0 || n <= 0 || n % kMatCols || (halves != 1 && halves != 2) ||
      chunk <= 0 || splits <= 0 || (long long)chunk * (splits - 1) >= k ||
      (int4 && (group % kMatK || k % group || chunk % group)) ||
      (!int4 && chunk % kMatK) || (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  MatParams p{x, (const signed char*)q, (const float*)scale, (float*)work,
              out, m, k, n, halves, q_half, s_half, group, chunk, out_f32};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return int4 ? launch_matmul<__half, true>(p, splits, s)
                : launch_matmul<__half, false>(p, splits, s);
  return int4 ? launch_matmul<float, true>(p, splits, s)
              : launch_matmul<float, false>(p, splits, s);
}

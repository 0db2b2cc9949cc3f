// The float instances of kernels D2, D, I, E and F: the same functions
// for a float32 or float16 model, computed in f32 on the CUDA cores.
//
// The JAX package's Pallas kernels take a float32, float16 or bfloat16
// model because they compute in f32 inside. The bf16 kernels of this port
// (attention_prefill.cu, attention_decode.cu, kv_write_quant.cu,
// quant_matmul.cu) run on bf16 tensor cores; these instances, one
// template over the element type T (float or __half) each, take the other
// two dtypes:
//   - D2f (attend_float_kernel, no new row): replaces
//     llm_inference_engine_tpu/ops/attention.py `_attn_kernel` in its four
//     modes: prefill, chunked prefill and mixed steps over the slot cache
//     [L, B, S, K, D] or the pool [L, P, page, K, D] through the block
//     table, a T cache or an int8 cache with f32 scale planes [.., K];
//   - Df (attend_float_kernel at T = 1): the slot decode with WRITE_NEW
//     replaces `_decode_fused_mxu_kernel`: it writes the token's K/V row
//     first (into an int8 cache quantized with kv_quant.cuh's kvq::
//     helpers, bit for bit as kernel If writes it), then attends; the
//     paged attend-only decode replaces `_decode_mxu_kernel` (a float
//     pool's token is written by kernel H first, an int8 pool's by If);
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
// No tensor core runs here, so no TF32 and no bf16 rounding of an f32
// value: every product is an f32 FMA. head_dim is a runtime argument (a
// multiple of 16 from 16 to 256; the wrappers take 16 and
// _native.HEAD_DIMS).
//
// Semantics of the attention (every mode, as kernel D2's): query row
// (t, h) at position p = q_start[b] + t attends key j iff j < kv_len[b],
// j <= p and (window > 0) j > p - window, through kv head h / G. A row
// with no visible key gives 0, not NaN. Key j of sequence b sits at page
// table[b, j / page], row j % page; an entry outside [0, P), or a key past
// the table's reach, reads as zeros. Only keys below kv_len[b] are read,
// so no table entry at or past ceil(kv_len[b] / page) is.
//
// Bound and design. These are the simple instances that are right first;
// making them fast is later work (ROADMAP.md). Prefill attention is bound
// by its f32 operations (4 D a visible key and query row, against 67
// TFLOP/s of f32 FMA), decode attention, If and the decode-sized matmuls
// by bytes. What the design does:
//   - attention: one block per (row tile, kv head, sequence); its query
//     rows are the flattened (t, g) rows of the kv head, 4 a warp, so
//     every 32-key K/V tile a block stages in shared memory (as f32, by
//     16-byte loads, zero-filled past kv_len and for an invalid entry:
//     0 * NaN would be NaN) serves all G query heads. Lane j scores key j
//     of the tile against the warp's 4 rows (float4 reads; K rows padded
//     by 4 floats, so the lanes' reads fall in distinct banks), the online
//     softmax keeps (m, l) a row in registers with warp shuffles for the
//     tile's max and sum, and lane l owns output columns l + 32 i. A
//     warp computes its 4 rows whether they are live or not (per-row
//     branches in the loops ran slower than the dead rows' work); a
//     decode block (T = 1) holds G query rows, so at G = 1 one warp
//     computes while all four load the tiles. The int8 k scale
//     multiplies the score, the v scale the softmax weight (the JAX
//     kernel's placement);
//   - If: one warp a (token, k|v, head) row, lane l its values l + 32 i;
//     the warp's absmax by shuffles, then kvq::row_scale, divide_recip and
//     quantize, the rounding of kernel I and of the plain quantize_rows;
//   - Ef / Ff: a block of 128 threads takes 8 rows of x and 512 output
//     columns (4 adjacent ones a thread, one 32-bit weight load a K row, 8
//     values of INT4), over one K split of whole scale groups; x is staged
//     64 K rows at a time in shared memory. The splits (enough blocks to
//     fill the card at decode sizes, ops/quant.py `float_matmul_plan`)
//     write f32 partial sums into a workspace the wrapper allocates, and
//     quant_matmul_float_reduce sums them in split order, applies the INT8
//     scale and rounds once: deterministic, no atomics.
// Ragged tails are masked: rows past m or T * G, columns past n and K rows
// past k are neither read nor written.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "kv_quant.cuh"

namespace {

constexpr int kMaxD = 256;
constexpr int kDimsPerLane = kMaxD / 32;   // output columns a lane owns
constexpr int kRowsPerWarp = 4;            // query rows a warp holds
constexpr int kMaxRows = 16;               // query rows a block
constexpr int kThreads = kMaxRows / kRowsPerWarp * 32;
constexpr int kTileKeys = 32;              // keys a K/V tile (a lane each)
constexpr int kMaxDevices = 16;            // launch attributes per device
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(signed char x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// 16 bytes of values of type V, as f32, to dst.
template <typename V>
__device__ __forceinline__ void unpack16(const uint4& raw, float* dst) {
  const V* v = reinterpret_cast<const V*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(V); ++i) dst[i] = to_f32(v[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One warp quantizes one row of D values of T at `src` into D int8 values
// at `dst` and its scale at `*scale_dst` (kv_quant.cuh's numerics; lane l
// holds values l + 32 i). All 32 lanes call it.
template <typename T>
__device__ __forceinline__ void quantize_row(const T* src, signed char* dst,
                                             float* scale_dst, int D,
                                             bool snapped, int lane) {
  float x[kDimsPerLane];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) {
    const int d = lane + 32 * i;
    x[i] = d < D ? to_f32(src[d]) : 0.f;
    amax = fmaxf(amax, fabsf(x[i]));
  }
  amax = warp_max(amax);
  const float scale = snapped ? kvq::row_scale<true>(amax)
                              : kvq::row_scale<false>(amax);
  const float recip = kvq::divide_recip(scale);
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) dst[d] = kvq::quantize(x[i], scale, recip);
  }
  if (lane == 0) *scale_dst = scale;
}

// ---------------------------------------------------------------------------
// D2f / Df: attention
// ---------------------------------------------------------------------------

struct AttnParams {
  const void* q;        // [B, T, H, D] of T
  void* k_cache;        // [L, B, S, K, D] or [L, P, page, K, D]: T or int8
  void* v_cache;
  float* k_scale;       // INT8: [L, B, S, K] or [L, P, page, K]
  float* v_scale;
  const void* k_new;    // WRITE_NEW: [B, 1, K, D] of T
  const void* v_new;
  void* out;            // [B, T, H, D] of T
  const int* q_start;   // [B]
  const int* kv_len;    // [B]
  const int* table;     // PAGED: [B, max_pages]
  int layer, B, T, H, K, S, D, G;   // S: slot length, or the pool's P pages
  int page, max_pages;
  float sm_scale;
  int window, snapped;
};

// The token row ([.., K] index) of key j of sequence b and kv head kh, or
// -1 where it reads as zeros. The cache is read with ordinary loads, never
// through the read-only path: a WRITE_NEW block reads back its own row.
template <bool PAGED>
__device__ __forceinline__ long long kv_row(const AttnParams& p, int b,
                                            int kh, int j) {
  if (PAGED) {
    if (j >= p.max_pages * p.page) return -1;
    const int e = p.table[(size_t)b * p.max_pages + j / p.page];
    if (e < 0 || e >= p.S) return -1;
    return (((long long)p.layer * p.S + e) * p.page + j % p.page) * p.K + kh;
  }
  if (j >= p.S) return -1;
  return (((long long)p.layer * p.B + b) * p.S + j) * p.K + kh;
}

__host__ __device__ constexpr size_t attend_smem(int rows, int D) {
  // q [rows][D], K tile [32][D + 4], V tile [32][D], 2 x 32 scales (f32),
  // then 32 token rows (long long)
  return (size_t)(rows * D + kTileKeys * (D + 4) + kTileKeys * D +
                  2 * kTileKeys) * 4 + kTileKeys * 8;
}

template <typename T, bool INT8, bool PAGED, bool WRITE_NEW>
__global__ void __launch_bounds__(kThreads)
attend_float_kernel(const AttnParams p) {
  static_assert(!(PAGED && WRITE_NEW), "the paged decode attends only");
  using V = typename std::conditional<INT8, signed char, T>::type;
  extern __shared__ float4 smem4[];
  const int D = p.D;
  constexpr int rows = kMaxRows;
  float* q_s = reinterpret_cast<float*>(smem4);   // [rows][D]
  float* k_s = q_s + rows * D;                      // [32][D + 4]
  float* v_s = k_s + kTileKeys * (D + 4);           // [32][D]
  float* ks_s = v_s + kTileKeys * D;                // [32]
  float* vs_s = ks_s + kTileKeys;                   // [32]
  long long* row_s = reinterpret_cast<long long*>(vs_s + kTileKeys);

  const int b = blockIdx.z, kh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_rows = p.T * p.G;
  const int r0 = blockIdx.x * rows;
  const int qs = p.q_start[b], kl = p.kv_len[b];

  if (WRITE_NEW) {
    // the token's row at q_start, for an active sequence inside the cache
    if (warp == 0 && kl > qs && qs >= 0 && qs < p.S) {
      const long long row =
          (((long long)p.layer * p.B + b) * p.S + qs) * p.K + kh;
      const T* kn = static_cast<const T*>(p.k_new) + ((size_t)b * p.K + kh) * D;
      const T* vn = static_cast<const T*>(p.v_new) + ((size_t)b * p.K + kh) * D;
      if (INT8) {
        quantize_row<T>(kn, static_cast<signed char*>(p.k_cache) + row * D,
                        p.k_scale + row, D, p.snapped, lane);
        quantize_row<T>(vn, static_cast<signed char*>(p.v_cache) + row * D,
                        p.v_scale + row, D, p.snapped, lane);
      } else {
        T* kd = static_cast<T*>(p.k_cache) + row * D;
        T* vd = static_cast<T*>(p.v_cache) + row * D;
        for (int d = lane; d < D; d += 32) {
          kd[d] = kn[d];
          vd[d] = vn[d];
        }
      }
    }
    __syncthreads();   // the row is visible to every thread of the block
  }

  // the block's query rows, as f32 (rows past T * G as zeros)
  const T* q = static_cast<const T*>(p.q);
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D, gr = r0 + r;
    float v = 0.f;
    if (gr < n_rows) {
      const int t = gr / p.G, h = kh * p.G + gr % p.G;
      v = to_f32(q[(((size_t)b * p.T + t) * p.H + h) * D + d]);
    }
    q_s[i] = v;
  }

  // the keys any row of the block sees: [lo, hi)
  const int last = min(r0 + rows, n_rows) - 1;
  const int hi = min(kl, qs + last / p.G + 1);
  const int lo = p.window > 0 ? max(0, qs + r0 / p.G - p.window + 1) : 0;

  bool live[kRowsPerWarp];
  int pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int gr = r0 + warp * kRowsPerWarp + r;
    live[r] = gr < n_rows;
    pos[r] = qs + gr / p.G;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  const int vecs = D * (int)sizeof(V) / 16;   // 16-byte pieces a key row
  constexpr int kPer = 16 / (int)sizeof(V);    // values a piece
  for (int j0 = lo; j0 < hi; j0 += kTileKeys) {
    const int nk = min(kTileKeys, hi - j0);
    __syncthreads();                 // the last tile (and q_s) is consumed
    if (threadIdx.x < kTileKeys) {
      const int kk = threadIdx.x;
      const long long row = kk < nk ? kv_row<PAGED>(p, b, kh, j0 + kk) : -1;
      row_s[kk] = row;
      if (INT8) {
        ks_s[kk] = row >= 0 ? p.k_scale[row] : 0.f;
        vs_s[kk] = row >= 0 ? p.v_scale[row] : 0.f;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kTileKeys * vecs; e += kThreads) {
      const int kk = e / vecs, c = e - kk * vecs;
      const long long row = row_s[kk];
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
      if (row >= 0) {
        kr = reinterpret_cast<const uint4*>(
            static_cast<const V*>(p.k_cache) + row * D)[c];
        vr = reinterpret_cast<const uint4*>(
            static_cast<const V*>(p.v_cache) + row * D)[c];
      }
      unpack16<V>(kr, k_s + kk * (D + 4) + c * kPer);
      unpack16<V>(vr, v_s + kk * D + c * kPer);
    }
    __syncthreads();
    if (!live[0]) continue;          // warp-uniform: the warp has no rows

    // scores: lane kk against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * (D + 4);
    const float* qrow = q_s + warp * kRowsPerWarp * D;
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + r * D + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    // online softmax over the tile; pw: the weight of the lane's key
    const int j = j0 + lane;
    float pw[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool vis = live[r] && lane < nk && j <= pos[r] &&
                       (p.window <= 0 || j > pos[r] - p.window);
      float sc = s[r] * p.sm_scale;
      if (INT8) sc *= ks_s[lane];
      sc = vis ? sc : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      float w = 0.f;
      if (m_new != -INFINITY) {      // warp-uniform
        const float alpha = expf(m[r] - m_new);
        w = vis ? expf(sc - m_new) : 0.f;
        l[r] = l[r] * alpha + warp_sum(w);
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] *= alpha;
        m[r] = m_new;
      }
      pw[r] = INT8 ? w * vs_s[lane] : w;
    }
    // P V: lane l adds every key's weighted V to its columns l + 32 i
    for (int kk = 0; kk < nk; ++kk) {
      const float* vrow = v_s + kk * D;
      float w[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        w[r] = __shfl_sync(kFull, pw[r], kk);
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float v = vrow[d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r][i] = fmaf(w[r], v, acc[r][i]);
        }
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!live[r]) continue;
    const int gr = r0 + warp * kRowsPerWarp + r;
    const int t = gr / p.G, h = kh * p.G + gr % p.G;
    T* o = out + (((size_t)b * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[d] = from_f32<T>(l[r] > 0.f ? acc[r][i] / l[r] : 0.f);
    }
  }
}

template <typename T, bool INT8, bool PAGED, bool WRITE_NEW>
int launch_attend(const AttnParams& p, cudaStream_t stream) {
  auto kernel = attend_float_kernel<T, INT8, PAGED, WRITE_NEW>;
  const size_t smem = attend_smem(kMaxRows, p.D);
  if (smem > 48 * 1024) {
    static bool attr_set[kMaxDevices] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
      return (int)cudaErrorInvalidDevice;
    if (!attr_set[dev]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)attend_smem(kMaxRows, kMaxD));
      if (err != cudaSuccess) return (int)err;
      attr_set[dev] = true;
    }
  }
  const dim3 grid((p.T * p.G + kMaxRows - 1) / kMaxRows, p.K, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_attend(const AttnParams& p, bool int8, bool paged,
                    bool write_new, cudaStream_t s) {
  if (write_new)
    return int8 ? launch_attend<T, true, false, true>(p, s)
                : launch_attend<T, false, false, true>(p, s);
  if (paged)
    return int8 ? launch_attend<T, true, true, false>(p, s)
                : launch_attend<T, false, true, false>(p, s);
  return int8 ? launch_attend<T, true, false, false>(p, s)
              : launch_attend<T, false, false, false>(p, s);
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
  quantize_row<T>(src, (v ? p.v_cache : p.k_cache) + row * p.D,
                  (v ? p.v_scale : p.k_scale) + row, p.D, p.snapped, lane);
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

// D2f and Df. dtype: 1 float16, 2 float32 (the codes of norm_act.cu). The
// mode follows from the pointers: k_scale given, an int8 cache; table
// given, the pool (S is then its page count P); k_new given, the slot
// decode that writes the token first (T must be 1).
extern "C" int attention_float(const void* q, void* k_cache, void* v_cache,
                               float* k_scale, float* v_scale,
                               const void* k_new, const void* v_new,
                               void* out, const int* q_start,
                               const int* kv_len, const int* table,
                               int layer, int B, int T, int H, int K, int S,
                               int page, int max_pages, int D, int dtype,
                               float sm_scale, int window, int snapped,
                               void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const bool int8 = k_scale != nullptr, paged = table != nullptr;
  const bool write_new = k_new != nullptr;
  if (!head_dim_ok(D) || K <= 0 || H % K || S <= 0 ||
      (paged && (page <= 0 || max_pages <= 0)) ||
      (write_new && (paged || T != 1)) || (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  AttnParams p{q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, out,
               q_start, kv_len, table, layer, B, T, H, K, S, D, H / K,
               page, max_pages, sm_scale, window, snapped};
  const cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? dispatch_attend<__half>(p, int8, paged, write_new, s)
                    : dispatch_attend<float>(p, int8, paged, write_new, s);
}

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

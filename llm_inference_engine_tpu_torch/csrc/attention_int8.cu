// Kernel D, int8 decode modes: single-token attention of bf16 queries
// against the int8 KV cache (slot [L, B, S, K, D] or pool
// [L, P, page, K, D]) with f32 scale planes [.., K] beside the values,
// online softmax in f32. The int8 prefill modes (`_attn_kernel`) are
// kernel D2, attention_prefill.cu.
//
// Replaces the int8 modes of two TPU kernels of the JAX package
// (llm_inference_engine_tpu/ops/attention.py): the embedded-scale mode of
// `_decode_fused_mxu_kernel` (single-token decode that writes the new row
// and attends, slot cache) and the int8 mode of `_decode_mxu_kernel`
// (attend-only decode through the block table).
//
// The design, addressing, row semantics and launch shape are kernel D's
// bf16 decode ones (attention.cu): one block per (sequence, kv head), K/V
// tiles staged once per block in shared memory, softmax state in
// registers, the 8 warps of a block splitting each 256-key tile. The bf16
// modes keep their own source: nvcc's code for them proved sensitive to
// small changes of a shared template (the fused bf16 decode ran ~50%
// slower), so the int8 modes are a template of their own. What differs:
//   - A tile's int8 values are converted to bf16 (exact, |v| <= 127) as
//     they are staged into shared memory, with the tile's k and v scales
//     beside them. The plane holds the final f32 scale, so the absmax and
//     the log2-snapped numerics read alike.
//   - The scale is constant along D, so it goes where the JAX kernels put
//     it: the k scale on each score, the v scale on each softmax weight
//     before it weighs V (the running sum l takes the unscaled weight):
//     bk multiplies per tile and head instead of bk * D.
//   - The fused decode quantizes the token's bf16 K/V rows in the kernel
//     with kernel I's row quantizer (kv_quant.cuh; SNAPPED picks the
//     numerics), writes values and scales into the cache, synchronises and
//     attends the token in its dequantized form, as the JAX fused kernel
//     attends its packed row.
//   - RPW, the query rows a warp holds: 8, or 1 where the launch shape
//     gives each warp one row (G = 1, MHA), which shrinks the per-row
//     loops to one iteration without changing a row's sums.
// The paged and slot modes share launch shape and summation order, so a
// paged int8 engine reproduces a slot int8 engine (snapped) bit for bit.
// (The template keeps the general row-block shape of the former prefill
// mode, left byte for byte.)
//
// Bound: HBM bytes (int8 values plus 4 bytes per (token, head) of scale,
// about half the bf16 bytes), on scalar f32 FMAs here (no wgmma, no TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowsPerWarp = 8;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dims {
  static constexpr int kDPL = D / 32;     // output dims per lane
  static constexpr int kStride = D + 8;   // smem tile row, in bf16 (16 B pad)
  static constexpr int kChunks = D / 8;   // 16-byte bf16 chunks per q row
  static constexpr int kChunks8 = D / 16; // 16-byte int8 chunks per kv row
};

struct Params {
  const __nv_bfloat16* q;      // [B, T, H, D]
  const __nv_bfloat16* k_new;  // [B, 1, K, D] (fused decode)
  const __nv_bfloat16* v_new;
  signed char* k_cache;        // [L, B, S, K, D] or pool [L, P, page, K, D]
  signed char* v_cache;
  float* k_scale;              // [L, B, S, K] or [L, P, page, K]
  float* v_scale;
  __nv_bfloat16* out;          // [B, T, H, D]
  const int* q_start;          // [B]
  const int* kv_len;           // [B]
  const int* table;            // [B, max_pages] (paged)
  int layer, B, T, H, K, S, G;
  int P, page, max_pages;      // paged pool geometry
  int rows_per_block;          // R: query rows (t, g) of one kv head
  int ksplit;                  // warps sharing a row, one 32-key slice each
  float scale_log2;            // sm_scale * log2(e)
  int window;                  // 0 = no sliding window
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

size_t smem_bytes(int D, int rows, int ksplit) {
  const size_t bk = 32ull * ksplit;
  const size_t q = (size_t)rows * D * sizeof(float);
  const size_t tiles = 2 * bk * ((D + 8) * sizeof(__nv_bfloat16) +
                                 sizeof(float));
  const size_t comb = (size_t)ksplit * rows * (D + 2) * sizeof(float);
  return q + (tiles > comb ? tiles : comb);
}

template <int D, bool WRITE_NEW, bool PAGED, bool SNAPPED, int RPW>
__global__ void __launch_bounds__(kThreads)
attention_int8_kernel(const Params p) {
  static_assert(!(WRITE_NEW && PAGED), "the fused write is slot-only");
  using Dm = Dims<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = p.rows_per_block;
  const int ks = p.ksplit;
  const int BK = 32 * ks;
  float* q_s = reinterpret_cast<float*>(smem);                    // [R][D]
  __nv_bfloat16* k_s =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)R * D * 4);  // [BK][stride]
  __nv_bfloat16* v_s = k_s + (size_t)BK * Dm::kStride;
  float* ks_s = reinterpret_cast<float*>(v_s + (size_t)BK * Dm::kStride);
  float* vs_s = ks_s + BK;                                        // [BK]
  float* comb = reinterpret_cast<float*>(smem + (size_t)R * D * 4);

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const int nrows = p.T * p.G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kw = warp % ks;          // this warp's 32-key slice of a tile
  const int rg = warp / ks;          // this warp's row group
  const int nrg = kWarps / ks;

  const int qs = p.q_start[b];
  const int kl = p.kv_len[b];
  // (token, head) row of key `key` of this (sequence, kv head): its values
  // start at element row * D, its scale at row
  const size_t base = PAGED ? (size_t)p.layer * p.P * p.page * p.K + kh
                            : ((size_t)p.layer * p.B + b) * p.S * p.K + kh;
  auto kv_row = [&](int key) -> size_t {
    if constexpr (PAGED) {
      const int pg = p.table[(size_t)b * p.max_pages + key / p.page];
      return base + ((size_t)pg * p.page + key % p.page) * p.K;
    } else {
      return base + (size_t)key * p.K;
    }
  };

  if (WRITE_NEW) {
    // warp 0 quantizes and writes the token's k row, warp 1 its v row
    if (kl > qs && qs >= 0 && qs < p.S && warp < 2) {
      const size_t src = ((size_t)b * p.K + kh) * D;
      const size_t dst = kv_row(qs);
      kvq::quantize_row<D, SNAPPED>(
          (warp ? p.v_new : p.k_new) + src,
          (warp ? p.v_cache : p.k_cache) + dst * D,
          (warp ? p.v_scale : p.k_scale) + dst, lane);
    }
    // the writes above are visible to the whole block after the barrier
    __syncthreads();
  }

  // queries of this block, pre-scaled into the log2 domain
  for (int idx = threadIdx.x; idx < R * Dm::kChunks; idx += kThreads) {
    const int r = idx / Dm::kChunks;
    const int c = idx % Dm::kChunks;
    const int row = row0 + r;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row < nrows) {
      const int t = row / p.G;
      const int h = kh * p.G + row % p.G;
      const uint4 raw = reinterpret_cast<const uint4*>(
          p.q + (((size_t)b * p.T + t) * p.H + h) * D)[c];
      unpack8(raw, f);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) q_s[r * D + c * 8 + i] = f[i] * p.scale_log2;
  }

  // keys any row of this block can see: [lo, hi)
  const int last_row = min(row0 + R, nrows) - 1;
  const int hi = min(kl, qs + last_row / p.G + 1);
  const int lo = p.window > 0 ? max(0, qs + row0 / p.G - p.window + 1) : 0;

  float m[RPW], l[RPW];
  float acc[RPW][Dm::kDPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Dm::kDPL; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = lo; j0 < hi; j0 += BK) {
    __syncthreads();   // the previous tile (and q_s, first time) is settled
    // 16 int8 values per load, converted to bf16 on the way to smem; the
    // thread of a row's first chunk also stages the row's two scales, so a
    // tile costs one round trip to memory, not two
    for (int idx = threadIdx.x; idx < BK * Dm::kChunks8; idx += kThreads) {
      const int jr = idx / Dm::kChunks8;
      const int c = idx % Dm::kChunks8;
      const int key = j0 + jr;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      float ksc = 0.f, vsc = 0.f;
      if (key < hi) {   // rows past hi are zero-filled, never stale
        const size_t row = kv_row(key);
        kv = reinterpret_cast<const uint4*>(p.k_cache + row * D)[c];
        vv = reinterpret_cast<const uint4*>(p.v_cache + row * D)[c];
        if (c == 0) {
          ksc = p.k_scale[row];
          vsc = p.v_scale[row];
        }
      }
      kvq::int8x16_to_bf16(kv, k_s + (size_t)jr * Dm::kStride + c * 16);
      kvq::int8x16_to_bf16(vv, v_s + (size_t)jr * Dm::kStride + c * 16);
      if (c == 0) {
        ks_s[jr] = ksc;
        vs_s[jr] = vsc;
      }
    }
    __syncthreads();

    // scores of this lane's key against each of the warp's rows
    const int jr = kw * 32 + lane;
    const int key = j0 + jr;
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const __nv_bfloat16* krow = k_s + (size_t)jr * Dm::kStride;
#pragma unroll
    for (int c = 0; c < Dm::kChunks; ++c) {
      float kf[8];
      unpack8(reinterpret_cast<const uint4*>(krow)[c], kf);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = rg + nrg * i;
        if (r < R) {
          const float4* qv = reinterpret_cast<const float4*>(q_s + r * D + c * 8);
          const float4 a = qv[0], z = qv[1];
          s[i] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] +
                  z.x * kf[4] + z.y * kf[5] + z.z * kf[6] + z.w * kf[7];
        }
      }
    }
    // this lane's key's scales: k on the score, v on the weight
    const float ksc = ks_s[jr];
    const float vsc = vs_s[jr];

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = rg + nrg * i;
      const int row = row0 + r;
      if (r >= R || row >= nrows) continue;           // warp-uniform
      const int pos = qs + row / p.G;
      const bool valid = key < kl && key <= pos &&
                         (p.window <= 0 || key > pos - p.window);
      const float sc = valid ? s[i] * ksc : -INFINITY;
      const float mt = warp_max(sc);
      if (mt == -INFINITY) continue;                  // warp-uniform
      const float mn = fmaxf(m[i], mt);
      const float alpha = exp2f(m[i] - mn);           // 0 while m = -inf
      const float pr = valid ? exp2f(sc - mn) : 0.f;
      l[i] = l[i] * alpha + warp_sum(pr);
      const float pw = pr * vsc;
#pragma unroll
      for (int c = 0; c < Dm::kDPL; ++c) acc[i][c] *= alpha;
      for (int jj = 0; jj < 32; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pw, jj);
        if (pj == 0.f) continue;                      // warp-uniform
        const __nv_bfloat162* vrow = reinterpret_cast<const __nv_bfloat162*>(
            v_s + (size_t)(kw * 32 + jj) * Dm::kStride + lane * Dm::kDPL);
#pragma unroll
        for (int c = 0; c < Dm::kDPL / 2; ++c) {
          const float2 vf = __bfloat1622float2(vrow[c]);
          acc[i][2 * c] += pj * vf.x;
          acc[i][2 * c + 1] += pj * vf.y;
        }
      }
      m[i] = mn;
    }
  }

  // merge the ks partial softmax states of each row
  __syncthreads();   // tiles are dead; comb reuses their space
  const int cs = D + 2;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = rg + nrg * i;
    if (r >= R) continue;
    float* dst = comb + ((size_t)kw * R + r) * cs;
#pragma unroll
    for (int c = 0; c < Dm::kDPL; ++c) dst[lane * Dm::kDPL + c] = acc[i][c];
    if (lane == 0) {
      dst[D] = m[i];
      dst[D + 1] = l[i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int row = row0 + r;
    if (row >= nrows) continue;
    float mx = -INFINITY;
    for (int w = 0; w < ks; ++w) mx = fmaxf(mx, comb[((size_t)w * R + r) * cs + D]);
    float o = 0.f;
    if (mx != -INFINITY) {
      float lsum = 0.f, a = 0.f;
      for (int w = 0; w < ks; ++w) {
        const float* src = comb + ((size_t)w * R + r) * cs;
        const float e = exp2f(src[D] - mx);
        lsum += src[D + 1] * e;
        a += src[d] * e;
      }
      o = lsum > 0.f ? a / lsum : 0.f;
    }
    const int t = row / p.G;
    const int h = kh * p.G + row % p.G;
    p.out[(((size_t)b * p.T + t) * p.H + h) * D + d] = __float2bfloat16(o);
  }
}

template <int D, bool WRITE_NEW, bool PAGED, bool SNAPPED, int RPW>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, p.rows_per_block, p.ksplit);
  auto kernel = attention_int8_kernel<D, WRITE_NEW, PAGED, SNAPPED, RPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.T * p.G + p.rows_per_block - 1) / p.rows_per_block, p.K, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool WRITE_NEW, bool PAGED, bool SNAPPED>
int dispatch(const Params& p, int D, cudaStream_t stream) {
  // one row per warp (the decode shape at G = 1); the slot prefill never
  // launches so and keeps the one variant
  const bool one_row = (WRITE_NEW || PAGED) &&
                       p.rows_per_block <= kWarps / p.ksplit;
  switch (D * 2 + one_row) {
    case 128: return launch<64, WRITE_NEW, PAGED, SNAPPED, kMaxRowsPerWarp>(p, stream);
    case 129: return launch<64, WRITE_NEW, PAGED, SNAPPED, 1>(p, stream);
    case 256: return launch<128, WRITE_NEW, PAGED, SNAPPED, kMaxRowsPerWarp>(p, stream);
    case 257: return launch<128, WRITE_NEW, PAGED, SNAPPED, 1>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Decode launch shape, as the bf16 decode: one block per (sequence, kv
// head) holding its G query heads. Returns false if G is too large.
bool decode_shape(Params& p) {
  p.T = 1;
  p.G = p.H / p.K;
  p.ksplit = p.G <= 8 ? 8 : p.G <= 16 ? 4 : p.G <= 32 ? 2 : 1;
  p.rows_per_block = p.G;
  return p.G <= (kWarps / p.ksplit) * kMaxRowsPerWarp;
}

Params make_params(const void* q, const void* k_cache, const void* v_cache,
                   void* k_scale, void* v_scale, void* out,
                   const int* q_start, const int* kv_len, int layer, int B,
                   int T, int H, int K, int S, float sm_scale, int window) {
  Params p{};
  p.q = (const __nv_bfloat16*)q;
  p.k_cache = (signed char*)k_cache;
  p.v_cache = (signed char*)v_cache;
  p.k_scale = (float*)k_scale;
  p.v_scale = (float*)v_scale;
  p.out = (__nv_bfloat16*)out;
  p.q_start = q_start;
  p.kv_len = kv_len;
  p.layer = layer; p.B = B; p.T = T; p.H = H; p.K = K; p.S = S;
  p.scale_log2 = sm_scale * kLog2e;
  p.window = window;
  return p;
}

Params paged(Params p, const int* table, int P, int page, int max_pages) {
  p.table = table;
  p.P = P; p.page = page; p.max_pages = max_pages;
  return p;
}

}  // namespace

// Decode (T == 1) over the int8 slot cache: the new token's K/V rows are
// quantized (snapped != 0: log2-snapped scales, else absmax / 127) and
// written with their scales, then attended.
extern "C" int attention_decode_int8(const void* q, const void* k_new,
                                     const void* v_new, void* k_cache,
                                     void* v_cache, void* k_scale,
                                     void* v_scale, void* out,
                                     const int* q_start, const int* kv_len,
                                     int layer, int B, int H, int K, int S,
                                     int D, float sm_scale, int window,
                                     int snapped, void* stream) {
  Params p = make_params(q, k_cache, v_cache, k_scale, v_scale, out,
                         q_start, kv_len, layer, B, 1, H, K, S, sm_scale,
                         window);
  p.k_new = (const __nv_bfloat16*)k_new;
  p.v_new = (const __nv_bfloat16*)v_new;
  if (!decode_shape(p)) return (int)cudaErrorInvalidValue;
  return snapped ? dispatch<true, false, true>(p, D, (cudaStream_t)stream)
                 : dispatch<true, false, false>(p, D, (cudaStream_t)stream);
}

// Attend-only decode (T == 1) over the int8 paged pool, after kernel H's
// int8 mode has written the token.
extern "C" int attention_decode_paged_int8(
    const void* q, const void* k_pool, const void* v_pool, void* k_scale,
    void* v_scale, void* out, const int* q_start, const int* kv_len,
    const int* table, int layer, int B, int H, int K, int P, int page,
    int max_pages, int D, float sm_scale, int window, void* stream) {
  Params p = paged(make_params(q, k_pool, v_pool, k_scale, v_scale, out,
                               q_start, kv_len, layer, B, 1, H, K,
                               page * max_pages, sm_scale, window),
                   table, P, page, max_pages);
  if (!decode_shape(p)) return (int)cudaErrorInvalidValue;
  return dispatch<false, true, false>(p, D, (cudaStream_t)stream);
}

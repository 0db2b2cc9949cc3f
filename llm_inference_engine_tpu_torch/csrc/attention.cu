// Kernel D: causal attention of bf16 queries against the stacked,
// token-major bf16 KV cache, with online softmax in f32.
//
// Replaces two TPU kernels of the JAX package:
//   - llm_inference_engine_tpu/ops/attention.py `_attn_kernel` (launched
//     by `_attention_pallas`): flash attention for prefill and chunked
//     prefill (WRITE_NEW = false, after kernel C has written the chunk);
//   - llm_inference_engine_tpu/ops/attention.py `_decode_fused_mxu_kernel`
//     (launched by `_attention_decode_fused_mxu`): single-token decode
//     that writes the new K/V row and attends in one kernel
//     (WRITE_NEW = true).
//
// Semantics (both modes). q [B, T, H, D]; caches [L, B, S, K, D]; out
// [B, T, H, D]. Query row (t, h) sits at position p = q_start[b] + t and
// attends key j iff j < kv_len[b], j <= p, and (window > 0) j > p - window,
// using kv head h / G (G = H / K, GQA). Rows with no visible key give 0.
// In decode mode the block of (b, kv head) first copies that head's new
// K/V row into the cache at q_start[b] when kv_len[b] > q_start[b]
// (inactive rows write nothing), synchronises, and then attends; the
// block that writes a row is its only reader, so there is no race.
//
// Bound: at decode the kernel streams the whole valid cache once per
// step, so it is bound by HBM bytes; at long prefill it is bound by the
// QK^T and PV FLOPs. This first design is simple and right rather than
// fast: scalar f32 FMAs (no wgmma, no TMA). What it does about the
// bounds: K/V tiles are staged once per block in shared memory with
// coalesced 16-byte loads and reused by every query row of the block (all
// G query heads of a kv head and up to 32 query rows at prefill); the
// scale and log2(e) are folded into q once; a row's softmax state stays
// in registers; key tiles outside [lo, hi) of the block (causal end,
// kv_len, window start) are never read. At decode, the 8 warps of a block
// split each 256-key tile between them and merge their partial softmax
// states at the end, so one block per (sequence, kv head) keeps 256
// threads loading.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowsPerWarp = 8;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dims {
  static constexpr int kDPL = D / 32;     // output dims per lane
  static constexpr int kStride = D + 8;   // smem tile row, in bf16 (16 B pad)
  static constexpr int kChunks = D / 8;   // 16-byte chunks per row
};

struct Params {
  const __nv_bfloat16* q;      // [B, T, H, D]
  const __nv_bfloat16* k_new;  // [B, 1, K, D] (decode)
  const __nv_bfloat16* v_new;
  __nv_bfloat16* k_cache;      // [L, B, S, K, D]
  __nv_bfloat16* v_cache;
  __nv_bfloat16* out;          // [B, T, H, D]
  const int* q_start;          // [B]
  const int* kv_len;           // [B]
  int layer, B, T, H, K, S, G;
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
  const size_t q = (size_t)rows * D * sizeof(float);
  const size_t tiles = 2ull * 32 * ksplit * (D + 8) * sizeof(__nv_bfloat16);
  const size_t comb = (size_t)ksplit * rows * (D + 2) * sizeof(float);
  return q + (tiles > comb ? tiles : comb);
}

template <int D, bool WRITE_NEW>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const Params p) {
  using Dm = Dims<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = p.rows_per_block;
  const int ks = p.ksplit;
  const int BK = 32 * ks;
  float* q_s = reinterpret_cast<float*>(smem);                    // [R][D]
  __nv_bfloat16* k_s =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)R * D * 4);  // [BK][stride]
  __nv_bfloat16* v_s = k_s + (size_t)BK * Dm::kStride;
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
  const size_t tok_stride = (size_t)p.K * D;   // between cache tokens
  const size_t base =
      ((size_t)p.layer * p.B + b) * p.S * tok_stride + (size_t)kh * D;

  if (WRITE_NEW) {
    if (kl > qs && qs >= 0 && qs < p.S) {
      const size_t src = ((size_t)b * p.K + kh) * D;
      const size_t dst = base + (size_t)qs * tok_stride;
      for (int c = threadIdx.x; c < Dm::kChunks; c += kThreads) {
        reinterpret_cast<uint4*>(p.k_cache + dst)[c] =
            reinterpret_cast<const uint4*>(p.k_new + src)[c];
        reinterpret_cast<uint4*>(p.v_cache + dst)[c] =
            reinterpret_cast<const uint4*>(p.v_new + src)[c];
      }
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

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp];
  float acc[kMaxRowsPerWarp][Dm::kDPL];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Dm::kDPL; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = lo; j0 < hi; j0 += BK) {
    __syncthreads();   // the previous tile (and q_s, first time) is settled
    for (int idx = threadIdx.x; idx < BK * Dm::kChunks; idx += kThreads) {
      const int jr = idx / Dm::kChunks;
      const int c = idx % Dm::kChunks;
      const int key = j0 + jr;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < hi) {   // rows past hi are zero-filled, never stale
        const size_t off = base + (size_t)key * tok_stride;
        kv = reinterpret_cast<const uint4*>(p.k_cache + off)[c];
        vv = reinterpret_cast<const uint4*>(p.v_cache + off)[c];
      }
      reinterpret_cast<uint4*>(k_s + (size_t)jr * Dm::kStride)[c] = kv;
      reinterpret_cast<uint4*>(v_s + (size_t)jr * Dm::kStride)[c] = vv;
    }
    __syncthreads();

    // scores of this lane's key against each of the warp's rows
    const int jr = kw * 32 + lane;
    const int key = j0 + jr;
    float s[kMaxRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) s[i] = 0.f;
    const __nv_bfloat16* krow = k_s + (size_t)jr * Dm::kStride;
#pragma unroll
    for (int c = 0; c < Dm::kChunks; ++c) {
      float kf[8];
      unpack8(reinterpret_cast<const uint4*>(krow)[c], kf);
#pragma unroll
      for (int i = 0; i < kMaxRowsPerWarp; ++i) {
        const int r = rg + nrg * i;
        if (r < R) {
          const float4* qv = reinterpret_cast<const float4*>(q_s + r * D + c * 8);
          const float4 a = qv[0], z = qv[1];
          s[i] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] +
                  z.x * kf[4] + z.y * kf[5] + z.z * kf[6] + z.w * kf[7];
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int r = rg + nrg * i;
      const int row = row0 + r;
      if (r >= R || row >= nrows) continue;           // warp-uniform
      const int pos = qs + row / p.G;
      const bool valid = key < kl && key <= pos &&
                         (p.window <= 0 || key > pos - p.window);
      const float sc = valid ? s[i] : -INFINITY;
      const float mt = warp_max(sc);
      if (mt == -INFINITY) continue;                  // warp-uniform
      const float mn = fmaxf(m[i], mt);
      const float alpha = exp2f(m[i] - mn);           // 0 while m = -inf
      const float pr = valid ? exp2f(sc - mn) : 0.f;
      l[i] = l[i] * alpha + warp_sum(pr);
#pragma unroll
      for (int c = 0; c < Dm::kDPL; ++c) acc[i][c] *= alpha;
      for (int jj = 0; jj < 32; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pr, jj);
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
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
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

template <int D, bool WRITE_NEW>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, p.rows_per_block, p.ksplit);
  auto kernel = attention_kernel<D, WRITE_NEW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.T * p.G + p.rows_per_block - 1) / p.rows_per_block, p.K, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool WRITE_NEW>
int dispatch(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<64, WRITE_NEW>(p, stream);
    case 128: return launch<128, WRITE_NEW>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Prefill / chunked prefill: 32 query rows per block, two warps per row
// (64-key tiles).
extern "C" int attention_prefill(const void* q, const void* k_cache,
                                 const void* v_cache, void* out,
                                 const int* q_start, const int* kv_len,
                                 int layer, int B, int T, int H, int K, int S,
                                 int D, float sm_scale, int window,
                                 void* stream) {
  Params p{};
  p.q = (const __nv_bfloat16*)q;
  p.k_cache = (__nv_bfloat16*)k_cache;
  p.v_cache = (__nv_bfloat16*)v_cache;
  p.out = (__nv_bfloat16*)out;
  p.q_start = q_start;
  p.kv_len = kv_len;
  p.layer = layer; p.B = B; p.T = T; p.H = H; p.K = K; p.S = S;
  p.G = H / K;
  p.ksplit = 2;
  p.rows_per_block = (kWarps / p.ksplit) * kMaxRowsPerWarp;   // 32
  p.scale_log2 = sm_scale * kLog2e;
  p.window = window;
  return dispatch<false>(p, D, (cudaStream_t)stream);
}

// Decode (T == 1) with the new token's K/V write: one block per
// (sequence, kv head) holding the G query heads of that kv head.
extern "C" int attention_decode(const void* q, const void* k_new,
                                const void* v_new, void* k_cache,
                                void* v_cache, void* out, const int* q_start,
                                const int* kv_len, int layer, int B, int H,
                                int K, int S, int D, float sm_scale,
                                int window, void* stream) {
  Params p{};
  p.q = (const __nv_bfloat16*)q;
  p.k_new = (const __nv_bfloat16*)k_new;
  p.v_new = (const __nv_bfloat16*)v_new;
  p.k_cache = (__nv_bfloat16*)k_cache;
  p.v_cache = (__nv_bfloat16*)v_cache;
  p.out = (__nv_bfloat16*)out;
  p.q_start = q_start;
  p.kv_len = kv_len;
  p.layer = layer; p.B = B; p.T = 1; p.H = H; p.K = K; p.S = S;
  p.G = H / K;
  // as many warps per row as the group leaves free (8 rows per warp max)
  p.ksplit = p.G <= 8 ? 8 : p.G <= 16 ? 4 : p.G <= 32 ? 2 : 1;
  if (p.G > (kWarps / p.ksplit) * kMaxRowsPerWarp)
    return (int)cudaErrorInvalidValue;
  p.rows_per_block = p.G;
  p.scale_log2 = sm_scale * kLog2e;
  p.window = window;
  return dispatch<true>(p, D, (cudaStream_t)stream);
}

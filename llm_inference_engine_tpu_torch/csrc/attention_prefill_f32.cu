// Kernel D2f's float32 instances: prefill, chunked prefill and mixed steps
// over a float32 or int8 slot cache or pool, register-tiled on the CUDA
// cores. The semantics, modes, parameters and entry points are kernel
// D2's (attention_prefill.cuh); the TPU kernel replaced is the same
// `_attn_kernel`.
//
// Bound. f32 stays off the tensor cores (TF32 keeps 10 mantissa bits, far
// above the 1e-5 the f32 instances are held to), so QK^T and PV are f32
// FMAs at 67 TFLOP/s: at the engine's prefill shapes the operations bound
// the work, 4 D a visible (row, key) pair. The design feeds the FMA units
// from registers and keeps shared memory reads below them:
//   - D2's block: 64 query rows (t, g) of one kv head, kv head, sequence,
//     128 threads; K/V tiles of 32 keys (16 at D = 256, so that the Q
//     tile, the ring and the P tile fit one block) in a two-stage cp.async
//     ring, rows padded by 16 bytes, keys past hi zero-filled; the mask
//     runs only on tiles that cross kv_len, the diagonal or the window
//     start. Tile boundaries do not depend on the page size;
//   - thread (ty, tx) = (tid / 8, tid % 8) owns query rows ty + 16 k
//     (k < 4) and, for QK^T, keys tx + 8 j of the tile: a 4 x 4 micro-tile
//     of S (4 x 2 at 16 keys), each step reading 4 Q and 4 K float4 for 64
//     FMAs. The 4 rows of a warp's ty and the 8 keys of its tx fall in
//     distinct banks (pitch D + 4), so every read is one wavefront;
//   - online softmax in the log2 domain: a row's 8 lanes (tx) share its
//     max by shuffles; each lane keeps its own share of the row sum until
//     the end. p (f32, never rounded) goes to the warp's own rows of a P
//     tile in shared memory (pitch kKeys + 8: the stores and the float4
//     reads are conflict-free), read back after __syncwarp;
//   - PV: the thread owns output columns tx * V + 8 V c (V = 4, or 2 at
//     D = 16 and 80) of its 4 rows: per key, D / 8 values of V read once
//     and weighed by 4 p values, so a row's 8 lanes read 8 contiguous
//     vectors;
//   - INT8: the tile's int8 values and scales are staged raw, converted to
//     f32 in shared memory (exact); the k scale multiplies the score, the
//     v scale p after the row sum took it (the JAX kernel's placement).
// Every multiply-add is an f32 FMA; sums run in a fixed order, so a paged
// instance equals the slot instance bit for bit.

#include "attention_prefill.cuh"

namespace {

// The f32 tiling at head_dim D.
template <int D>
struct F32Tile {
  static constexpr int kKeys = D > 128 ? 16 : 32;     // keys of a tile
  static constexpr int kKpt = kKeys / 8;              // keys a thread scores
  static constexpr int kStride = D + 4;               // f32 row pitch (+16 B)
  static constexpr int kPStride = kKeys + 8;          // P row pitch
  static constexpr int kVec = (D / 8) % 4 == 0 ? 4 : 2;   // columns a load
  static constexpr int kCols = D / 8 / kVec;          // vectors a thread owns
  static constexpr int kTile = kKeys * kStride;       // floats of a tile
};

// Shared memory of one block, in bytes: the Q tile, the ring, (INT8) the
// converted f32 tiles with their scales, and the P tile.
template <int D, bool INT8>
struct F32Layout {
  using Tl = F32Tile<D>;
  static constexpr int kQBytes = kRows * Tl::kStride * 4;
  static constexpr int kStageBytes =
      INT8 ? 2 * Tl::kKeys * D + 2 * Tl::kKeys * 4 : 2 * Tl::kTile * 4;
  static constexpr int kConvBytes =
      INT8 ? 2 * Tl::kTile * 4 + 2 * Tl::kKeys * 4 : 0;
  static constexpr int kPBytes = kRows * Tl::kPStride * 4;
  static constexpr int kBytes =
      kQBytes + kStages * kStageBytes + kConvBytes + kPBytes;
};

constexpr int kRowsPerThread = kRows / (kThreads / 8);   // 4

template <int V>
struct Vec;
template <>
struct Vec<4> { using T = float4; };
template <>
struct Vec<2> { using T = float2; };

template <int D, bool PAGED, bool INT8>
__global__ void __launch_bounds__(kThreads, D > 128 ? 1 : 2)
attention_prefill_f32_kernel(const Params<float> p) {
  using Tl = F32Tile<D>;
  using Ly = F32Layout<D, INT8>;
  constexpr int kKeys = Tl::kKeys;
  constexpr int kKpt = Tl::kKpt;
  constexpr int kStride = Tl::kStride;
  constexpr int kPStride = Tl::kPStride;
  constexpr int kVec = Tl::kVec;
  constexpr int kCols = Tl::kCols;
  constexpr int kR = kRowsPerThread;
  using VecT = typename Vec<kVec>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + Ly::kQBytes;
  // INT8: the current tile converted to f32, and its scales
  float* kc_s = reinterpret_cast<float*>(ring + kStages * Ly::kStageBytes);
  float* vc_s = kc_s + Tl::kTile;
  float* ksc_s = vc_s + Tl::kTile;   // k scale * log2e * sm_scale
  float* vsc_s = ksc_s + kKeys;
  float* p_s = reinterpret_cast<float*>(ring + kStages * Ly::kStageBytes +
                                        Ly::kConvBytes);

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int nrows = p.T * p.G;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;

  const int qs = p.q_start[b];
  const int kl = p.kv_len[b];
  // keys any row of this block can see: [lo, hi)
  const int last_row = min(row0 + kRows, nrows) - 1;
  const int pos_first = qs + row0 / p.G;
  const int pos_last = qs + last_row / p.G;
  const int hi = min(kl, pos_last + 1);
  const int lo = p.window > 0 ? max(0, pos_first - p.window + 1) : 0;
  const int n_tiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;

  // (token, head) row of key `key` of this (sequence, kv head)
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

  // tile i (keys lo + kKeys i ..) into its ring stage, keys >= hi
  // zero-filled: f32 rows at a pitch of kStride floats, or int8 rows
  // packed and then the tile's scales
  auto load_tile = [&](int i) {
    const int j0 = lo + i * kKeys;
    unsigned char* st = ring + (i % kStages) * Ly::kStageBytes;
    constexpr int kCopies = INT8 ? D / 16 : D / 4;    // 16-byte copies a row
    constexpr int kPasses = (kKeys * kCopies + kThreads - 1) / kThreads;
    constexpr int kPitch = INT8 ? D : 4 * kStride;
    constexpr int kVOffset = INT8 ? kKeys * D : 4 * Tl::kTile;
    const unsigned char* kg = static_cast<const unsigned char*>(p.k_cache);
    const unsigned char* vg = static_cast<const unsigned char*>(p.v_cache);
    float* ksr = reinterpret_cast<float*>(st + 2 * kKeys * D);   // INT8
    float* vsr = ksr + kKeys;
#pragma unroll
    for (int it = 0; it < kPasses; ++it) {
      const int x = tid + it * kThreads;
      if (kKeys * kCopies % kThreads != 0 && x >= kKeys * kCopies) break;
      const int r = x / kCopies;
      const int c = x % kCopies;
      const bool ok = j0 + r < hi;
      const size_t row = ok ? kv_row(j0 + r) : 0;
      const size_t off = row * (INT8 ? D : 4 * D) + c * 16;
      cp_async16(st + r * kPitch + c * 16, kg + off, ok);
      cp_async16(st + kVOffset + r * kPitch + c * 16, vg + off, ok);
      if constexpr (INT8) {
        if (c == 0) {
          cp_async4(ksr + r, p.k_scale + row, ok);
          cp_async4(vsr + r, p.v_scale + row, ok);
        }
      }
    }
  };

  // Q rows of this block (rows past T * G zero-filled), with tile 0
  if (n_tiles > 0) {
    constexpr int kQCopies = D / 4;
    for (int i = tid; i < kRows * kQCopies; i += kThreads) {
      const int r = i / kQCopies;
      const int c = i % kQCopies;
      const int row = row0 + r;
      const bool ok = row < nrows;
      const size_t off =
          ok ? (((size_t)b * p.T + row / p.G) * p.H + kh * p.G + row % p.G) *
                       D + c * 4
             : 0;
      cp_async16(q_s + r * kStride + c * 4, p.q + off, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // this thread's rows ty + 16 k: positions, softmax state, output
  int pos[kR];
  float m[kR], l[kR], o[kR][kCols * kVec];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    pos[k] = qs + (row0 + ty + 16 * k) / p.G;
    m[k] = -INFINITY;
    l[k] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols * kVec; ++e) o[k][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile i landed for all; every warp is done with i - 1
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();

    const float* k_t;
    const float* v_t;
    if constexpr (INT8) {
      constexpr int kChunks8 = D / 16;
      const unsigned char* st = ring + (i % kStages) * Ly::kStageBytes;
      const signed char* kr = reinterpret_cast<const signed char*>(st);
      const signed char* vr = kr + kKeys * D;
      const float* ksr = reinterpret_cast<const float*>(vr + kKeys * D);
      const float* vsr = ksr + kKeys;
      for (int x = tid; x < 2 * kKeys * kChunks8; x += kThreads) {
        const bool is_v = x >= kKeys * kChunks8;
        const int y = is_v ? x - kKeys * kChunks8 : x;
        const int r = y / kChunks8;
        const int c = y % kChunks8;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            (is_v ? vr : kr) + r * D + c * 16);
        const signed char* v8 = reinterpret_cast<const signed char*>(&raw);
        float4* dst = reinterpret_cast<float4*>((is_v ? vc_s : kc_s) +
                                                r * kStride + c * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[e] = make_float4((float)v8[4 * e], (float)v8[4 * e + 1],
                               (float)v8[4 * e + 2], (float)v8[4 * e + 3]);
      }
      if (tid < kKeys) {
        ksc_s[tid] = ksr[tid] * p.scale_log2;
        vsc_s[tid] = vsr[tid];
      }
      __syncthreads();
      k_t = kc_s;
      v_t = vc_s;
    } else {
      k_t = reinterpret_cast<const float*>(ring +
                                           (i % kStages) * Ly::kStageBytes);
      v_t = k_t + Tl::kTile;
    }

    // S = Q K^T: rows ty + 16 k, keys tx + 8 j
    float s[kR][kKpt];
#pragma unroll
    for (int k = 0; k < kR; ++k)
#pragma unroll
      for (int j = 0; j < kKpt; ++j) s[k][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kR];
#pragma unroll
      for (int k = 0; k < kR; ++k)
        qv[k] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * k) * kStride +
                                                 d);
#pragma unroll
      for (int j = 0; j < kKpt; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(k_t + (tx + 8 * j) * kStride + d);
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          s[k][j] = fmaf(qv[k].x, kv.x, s[k][j]);
          s[k][j] = fmaf(qv[k].y, kv.y, s[k][j]);
          s[k][j] = fmaf(qv[k].z, kv.z, s[k][j]);
          s[k][j] = fmaf(qv[k].w, kv.w, s[k][j]);
        }
      }
    }

    // scores into the log2 domain; the mask only where the tile crosses
    // kv_len, the diagonal or the window start of some row of the block
    const int j0 = lo + i * kKeys;
    const bool full = j0 + kKeys <= min(kl, pos_first + 1) &&
                      (p.window <= 0 || j0 > pos_last - p.window);
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKpt; ++j) {
        const int col = tx + 8 * j;
        float x = s[k][j] * (INT8 ? ksc_s[col] : p.scale_log2);
        if (!full) {
          const int key = j0 + col;
          if (key >= kl || key > pos[k] ||
              (p.window > 0 && key <= pos[k] - p.window))
            x = -INFINITY;
        }
        s[k][j] = x;
        mx = fmaxf(mx, x);
      }
      // online softmax of row k over its 8 lanes; a row that has seen no
      // visible key yet keeps alpha = 1, p = 0
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[k], mx);
      const float alpha = mn == -INFINITY ? 1.f : exp2f(m[k] - mn);
      const float base_k = mn == -INFINITY ? 0.f : mn;
      m[k] = mn;
      l[k] *= alpha;
#pragma unroll
      for (int e = 0; e < kCols * kVec; ++e) o[k][e] *= alpha;
#pragma unroll
      for (int j = 0; j < kKpt; ++j) {
        const int col = tx + 8 * j;
        float pr = exp2f(s[k][j] - base_k);
        l[k] += pr;
        if constexpr (INT8) pr *= vsc_s[col];
        p_s[(ty + 16 * k) * kPStride + col] = pr;
      }
    }
    __syncwarp();   // the warp's P rows are written

    // O += P V: per key, this thread's D / 8 columns of V, 4 rows
#pragma unroll 2
    for (int k0 = 0; k0 < kKeys; k0 += 4) {
      float4 pv[kR];
#pragma unroll
      for (int k = 0; k < kR; ++k)
        pv[k] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * k) * kPStride +
                                                 k0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vrow = v_t + (k0 + kk) * kStride + tx * kVec;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const VecT vv = *reinterpret_cast<const VecT*>(vrow + c * 8 * kVec);
          const float* v = reinterpret_cast<const float*>(&vv);
#pragma unroll
          for (int k = 0; k < kR; ++k) {
            const float w = reinterpret_cast<const float*>(&pv[k])[kk];
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              o[k][c * kVec + e] = fmaf(w, v[e], o[k][c * kVec + e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // O / l, out in vector stores; rows with no visible key give 0, rows
  // past T * G are not stored
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    float lk = l[k];
    lk += __shfl_xor_sync(0xffffffffu, lk, 1);
    lk += __shfl_xor_sync(0xffffffffu, lk, 2);
    lk += __shfl_xor_sync(0xffffffffu, lk, 4);
    const float inv = lk > 0.f ? 1.f / lk : 0.f;
    const int row = row0 + ty + 16 * k;
    if (row >= nrows) continue;
    float* dst = p.out +
                 (((size_t)b * p.T + row / p.G) * p.H + kh * p.G + row % p.G) *
                     D + tx * kVec;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      VecT vv;
      float* v = reinterpret_cast<float*>(&vv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = o[k][c * kVec + e] * inv;
      *reinterpret_cast<VecT*>(dst + c * 8 * kVec) = vv;
    }
  }
}

// Launch one f32 instance; with `report`, launch nothing and report
// instead {tile keys, ring stages, dynamic shared memory a block}.
template <int D, bool PAGED, bool INT8>
int launch_f32(const Params<float>& p, cudaStream_t stream, int* report) {
  constexpr int smem = F32Layout<D, INT8>::kBytes;
  if (report) {
    report[0] = F32Tile<D>::kKeys;
    report[1] = kStages;
    report[2] = smem;
    return 0;
  }
  auto kernel = attention_prefill_f32_kernel<D, PAGED, INT8>;
  static bool attr_set[kMaxDevices] = {};
  const int err = allow_smem(kernel, smem, attr_set);
  if (err != 0) return err;
  const dim3 grid((p.T * p.G + kRows - 1) / kRows, p.K, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename E, bool PAGED, bool INT8>
int dispatch(const Params<E>& p, int D, cudaStream_t stream, int* report) {
  switch (D) {
    case 16: return launch_f32<16, PAGED, INT8>(p, stream, report);
    case 64: return launch_f32<64, PAGED, INT8>(p, stream, report);
    case 80: return launch_f32<80, PAGED, INT8>(p, stream, report);
    case 96: return launch_f32<96, PAGED, INT8>(p, stream, report);
    case 128: return launch_f32<128, PAGED, INT8>(p, stream, report);
    case 256: return launch_f32<256, PAGED, INT8>(p, stream, report);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Prefill / chunked prefill over the float32 slot cache.
extern "C" int attention_prefill_f32(const void* q, const void* k_cache,
                                 const void* v_cache, void* out,
                                 const int* q_start, const int* kv_len,
                                 int layer, int B, int T, int H, int K, int S,
                                 int D, float sm_scale, int window,
                                 void* stream) {
  return run_entry<float, false, false>(
      q, k_cache, v_cache, nullptr, nullptr, out, q_start, kv_len, nullptr,
      layer, B, T, H, K, S, 0, 0, 0, D, sm_scale, window, stream);
}

// Prefill / chunked prefill / mixed steps over the float32 paged pool.
extern "C" int attention_prefill_paged_f32(const void* q, const void* k_pool,
                                       const void* v_pool, void* out,
                                       const int* q_start, const int* kv_len,
                                       const int* table, int layer, int B,
                                       int T, int H, int K, int P, int page,
                                       int max_pages, int D, float sm_scale,
                                       int window, void* stream) {
  return run_entry<float, true, false>(
      q, k_pool, v_pool, nullptr, nullptr, out, q_start, kv_len, table, layer,
      B, T, H, K, 0, P, page, max_pages, D, sm_scale, window, stream);
}

// Prefill / chunked prefill over the int8 slot cache.
extern "C" int attention_prefill_int8_f32(const void* q, const void* k_cache,
                                      const void* v_cache, void* k_scale,
                                      void* v_scale, void* out,
                                      const int* q_start, const int* kv_len,
                                      int layer, int B, int T, int H, int K,
                                      int S, int D, float sm_scale,
                                      int window, void* stream) {
  return run_entry<float, false, true>(
      q, k_cache, v_cache, k_scale, v_scale, out, q_start, kv_len, nullptr,
      layer, B, T, H, K, S, 0, 0, 0, D, sm_scale, window, stream);
}

// Prefill / chunked prefill / mixed steps over the int8 paged pool.
extern "C" int attention_prefill_paged_int8_f32(
    const void* q, const void* k_pool, const void* v_pool, void* k_scale,
    void* v_scale, void* out, const int* q_start, const int* kv_len,
    const int* table, int layer, int B, int T, int H, int K, int P, int page,
    int max_pages, int D, float sm_scale, int window, void* stream) {
  return run_entry<float, true, true>(
      q, k_pool, v_pool, k_scale, v_scale, out, q_start, kv_len, table, layer,
      B, T, H, K, 0, P, page, max_pages, D, sm_scale, window, stream);
}

// The tiling of a prefill launch at head_dim D (int8 != 0: an int8 cache;
// the paged modes tile alike), for reports: out = {tile keys, ring
// stages, dynamic shared memory bytes a block}.
extern "C" int attention_prefill_plan_f32(int D, int int8, int* out) {
  return plan_entry<float>(D, int8, out);
}

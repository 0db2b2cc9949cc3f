// Kernel D2: causal GQA flash attention of 16-bit queries against the KV
// cache, on Hopper's tensor cores: prefill, chunked prefill and mixed
// steps, over the slot cache or the paged pool, a cache of q's dtype or
// int8. One template over the element type E: __nv_bfloat16
// (attention_prefill.cu, kernel D2) or __half (attention_prefill_f16.cu,
// kernel D2f's float16 instance); float32 takes a kernel of its own on the
// CUDA cores (attention_prefill_f32.cu), which shares this header's
// parameters, copies and entry points.
//
// Replaces the TPU kernel llm_inference_engine_tpu/ops/attention.py
// `_attn_kernel` (launched by `_attention_pallas`, slot or paged index
// map, float cache or int8 cache) in all four of its modes, one template
// <E, D, PAGED, INT8>; each source's `switch (D)` names its head dims
// (bf16: 64, 80, 96, 128, 256; f16 and f32 also 16). Kernel D's decode
// modes are attention_decode.cuh.
//
// Semantics (all modes). q [B, T, H, D]; out [B, T, H, D]. Query row
// (t, h) sits at position p = q_start[b] + t and attends key j iff
// j < kv_len[b], j <= p, and (window > 0) j > p - window, using kv head
// h / G (G = H / K, GQA). A row with no visible key gives 0, not NaN.
// The cache is the slot cache [L, B, S, K, D] or the pool
// [L, P, page, K, D] with a block table [B, max_pages] (key row j of
// sequence b at page table[b, j / page], row j % page); E, or int8 with
// f32 scale planes [.., K] holding each (token, head) row's final scale.
// Every key row is translated through the table on its own, so a tile may
// straddle pages and any page size works; only keys below
// hi <= kv_len[b] are read, so no table entry at or past
// ceil(kv_len[b] / page) is. Tile boundaries do not depend on the page
// size: a paged instance sums in the slot instance's order, and a paged
// engine reproduces a slot engine bit for bit.
//
// Bound. At the engine's prefill shapes (Llama2-7B, 512-row chunks
// against up to 2048 keys) the bytes (q, out, each key row once) and the
// QK^T + PV operations bound the work about equally, so the kernel must
// feed the tensor cores and keep copies off the critical path:
//   - one block per (64 query rows r = (t, g) of one kv head, kv head,
//     sequence): every K/V tile loaded serves 64 rows (all G query heads
//     of the kv head), 4 warps of 16 rows each;
//   - QK^T and PV as mma.sync m16n8k16 E -> f32 (the .bf16 or .f16
//     variant: Elem<E>). Q is read once into
//     A fragments (ldmatrix); K fragments come from the tile by ldmatrix,
//     V fragments by ldmatrix.trans. The S accumulator's layout is the A
//     fragment layout of the next mma, so P (rounded to E, the JAX
//     kernel's rounding of p to q's dtype) never goes
//     through shared memory. sm_scale * log2(e) multiplies the f32 scores;
//   - online softmax on the accumulator fragments: a row's max and sum
//     over the four lanes that hold it (__shfl_xor_sync), exp2f. A row
//     whose running max is still -inf keeps alpha = 1 and p = 0;
//   - 64-key K/V tiles in a two-stage ring of dynamic shared memory filled
//     by 16-byte cp.async.cg: tile i + 1 is in flight while tile i
//     computes. At D = 256 the output accumulator alone takes 128
//     registers a lane, so that instance takes 32-key tiles and reads its
//     Q fragments from shared memory for each tile instead of holding
//     them (ptxas reports no spills). Rows are padded by 16 bytes, so
//     ldmatrix is free of bank conflicts (at D = 16 too: a 48-byte pitch
//     puts 8 rows on 8 distinct 16-byte bank groups). Keys at or past hi are zero-filled (src-size 0), never
//     left stale: the mma multiplies p = 0 by whatever V holds, and
//     0 * NaN is NaN. Tiles outside the block's key range [lo, hi) are
//     never loaded, and the mask (kv_len, causal, window) runs only on
//     tiles that cross kv_len, the diagonal or the window start;
//   - INT8: the tile's int8 values (16 per copy) and its scales are
//     staged raw, then converted to E in shared memory (exact for
//     |v| <= 127 in bf16 and f16). The k scale multiplies each score column in f32; the
//     v scale multiplies p before p rounds to E, and the row sum l
//     takes the unscaled p (the placement of the JAX kernel);
//   - the output goes through the warp's own rows of the Q tile, so it
//     leaves in 16-byte stores; rows past T * G are not stored.
// Not yet done: wgmma on 64-row warpgroup tiles, TMA tile loads with
// mbarriers, warp specialisation (ROADMAP.md, speed work).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;   // query rows (t, g) of one block
constexpr int kStages = 2;           // tiles in the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 16;      // launch attributes are set per device

template <typename E>
struct Params {
  const E* q;               // [B, T, H, D]
  const void* k_cache;      // [L, B, S, K, D] or pool [L, P, page, K, D]
  const void* v_cache;      // E, or int8 (INT8)
  const float* k_scale;     // INT8: [L, B, S, K] or [L, P, page, K]
  const float* v_scale;
  E* out;                   // [B, T, H, D]
  const int* q_start;       // [B]
  const int* kv_len;        // [B]
  const int* table;         // [B, max_pages] (PAGED)
  int layer, B, T, H, K, S, G;
  int P, page, max_pages;   // paged pool geometry
  float scale_log2;         // sm_scale * log2(e)
  int window;               // 0 = no sliding window
};

// Keys of one tile, and whether a lane holds its Q fragments in registers
// for the whole loop (else it reads them from the Q tile each tile).
template <int D>
struct Tile {
  static constexpr int kKeys = D > 128 ? 32 : 64;
  static constexpr bool kQInRegs = D <= 128;
};

// Shared memory of one block, in bytes: the Q tile (reused for the
// output), the ring, and (INT8) the converted 16-bit tiles with their
// scales.
template <int D, bool INT8>
struct Layout {
  static constexpr int kKeys = Tile<D>::kKeys;
  static constexpr int kStride = D + 8;          // 16-bit row pitch (+16 B)
  static constexpr int kTile = kKeys * kStride;  // 16-bit elements of a tile
  static constexpr int kQBytes = kRows * kStride * 2;
  static constexpr int kStageBytes =
      INT8 ? 2 * kKeys * D + 2 * kKeys * 4 : 2 * kTile * 2;
  static constexpr int kConvBytes = INT8 ? 2 * kTile * 2 + 2 * kKeys * 4 : 0;
  static constexpr int kBytes = kQBytes + kStages * kStageBytes + kConvBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; !valid zero-fills it and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// What the element type changes: the mma variant, the pack of p, and the
// int8 tile's conversion in shared memory.
template <typename E>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two f32 -> a bf16 pair, `lo` in the low half (the lower column)
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ void int8x16(const uint4& raw,
                                                 __nv_bfloat16* dst) {
    kvq::int8x16_to_bf16(raw, dst);
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two f32 -> an f16 pair, `lo` in the low half (the lower column)
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  // 16 int8 values -> 16 f16 values (exact: |v| <= 127 < 2^11)
  static __device__ __forceinline__ void int8x16(const uint4& raw,
                                                 __half* dst) {
    const signed char* v = reinterpret_cast<const signed char*>(&raw);
    __half2 out[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = __floats2half2_rn((float)v[2 * i], (float)v[2 * i + 1]);
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(out)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(out)[1];
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragment layouts of m16n8k16 (lane = 4 * g + t): A holds rows g and
// g + 8, columns 2t, 2t + 1 (+ 8); B columns g, rows 2t, 2t + 1 (+ 8); the
// f32 accumulator rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1.
template <typename E, int D, bool PAGED, bool INT8>
__global__ void __launch_bounds__(kThreads, 2)
attention_prefill_kernel(const Params<E> p) {
  using Ly = Layout<D, INT8>;
  constexpr int kKeys = Tile<D>::kKeys;
  constexpr bool kQInRegs = Tile<D>::kQInRegs;
  constexpr int kStride = Ly::kStride;
  constexpr int kChunks = D / 8;     // 16-byte chunks of a 16-bit row
  constexpr int kDB = D / 8;         // 8-wide output column blocks
  extern __shared__ __align__(16) unsigned char smem[];
  E* q_s = reinterpret_cast<E*>(smem);
  unsigned char* ring = smem + Ly::kQBytes;
  // INT8: the current tile converted to E, and its scales
  E* kc_s = reinterpret_cast<E*>(ring + kStages * Ly::kStageBytes);
  E* vc_s = kc_s + Ly::kTile;
  float* ksc_s = reinterpret_cast<float*>(vc_s + Ly::kTile);  // k * log2e
  float* vsc_s = ksc_s + kKeys;

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int nrows = p.T * p.G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const int qs = p.q_start[b];
  const int kl = p.kv_len[b];
  // keys any row of this block can see: [lo, hi)
  const int last_row = min(row0 + kRows, nrows) - 1;
  const int pos_first = qs + row0 / p.G;
  const int pos_last = qs + last_row / p.G;
  const int hi = min(kl, pos_last + 1);
  const int lo = p.window > 0 ? max(0, pos_first - p.window + 1) : 0;
  const int n_tiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;

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

  // tile i (keys lo + kKeys i ..) into its ring stage; keys >= hi
  // zero-filled. Copy x of a tile is 16 bytes of key row x / kCopies; a
  // thread takes copies tid, tid + kThreads, .. (at D = 80 and 96 a row's
  // copies do not divide the threads, and the last pass is partial)
  auto load_tile = [&](int i) {
    const int j0 = lo + i * kKeys;
    unsigned char* st = ring + (i % kStages) * Ly::kStageBytes;
    constexpr int kCopies = INT8 ? D / 16 : D / 8;   // 16-byte copies a row
    constexpr int kPasses = (kKeys * kCopies + kThreads - 1) / kThreads;
    const unsigned char* kg = static_cast<const unsigned char*>(p.k_cache);
    const unsigned char* vg = static_cast<const unsigned char*>(p.v_cache);
    // 16-bit rows at a pitch of kStride elements; int8 rows packed, then
    // the tile's scales
    constexpr int kPitch = INT8 ? D : 2 * kStride;
    constexpr int kVOffset = INT8 ? kKeys * D : 2 * Ly::kTile;
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
      const size_t off = row * (INT8 ? D : 2 * D) + c * 16;
      cp_async16(st + r * kPitch + c * 16, kg + off, ok);
      cp_async16(st + kVOffset + r * kPitch + c * 16, vg + off, ok);
      if constexpr (INT8) {
        if (c == 0) {   // the row's scales ride with its first copy
          cp_async4(ksr + r, p.k_scale + row, ok);
          cp_async4(vsr + r, p.v_scale + row, ok);
        }
      }
    }
  };

  // Q rows of this block (rows past T * G zero-filled), with tile 0
  if (n_tiles > 0) {
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const int row = row0 + r;
      const bool ok = row < nrows;
      const size_t off =
          ok ? (((size_t)b * p.T + row / p.G) * p.H + kh * p.G + row % p.G) *
                       D + c * 8
             : 0;
      cp_async16(q_s + r * kStride + c * 8, p.q + off, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // this lane's two rows: positions, softmax state, output accumulator
  const int r_lo = row0 + warp * 16 + g;
  const int pos_lo = qs + r_lo / p.G;
  const int pos_hi = qs + (r_lo + 8) / p.G;
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.f, l_hi = 0.f;   // this lane's share of the row sums
  float o[kDB][4];
#pragma unroll
  for (int d = 0; d < kDB; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  uint32_t qa[kQInRegs ? D / 16 : 1][4];

  // per-lane ldmatrix offsets (elements): K tiles as B of QK^T (keys as
  // rows), V tiles as B of PV (.trans), the warp's Q rows as A
  const int k_off = (((lane >> 4) << 3) + (lane & 7)) * kStride +
                    (((lane >> 3) & 1) << 3);
  const int v_off = ((((lane >> 3) & 1) << 3) + (lane & 7)) * kStride +
                    ((lane >> 4) << 3);
  const int q_off = (warp * 16 + (lane & 15)) * kStride + ((lane >> 4) << 3);

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile i landed for all; every warp is done with i - 1
    if (kQInRegs && i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qa[kk], q_s + q_off + kk * 16);
    }
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();

    const E* k_t;
    const E* v_t;
    if constexpr (INT8) {
      constexpr int kChunks8 = D / 16;
      const unsigned char* st = ring + (i % kStages) * Ly::kStageBytes;
      const signed char* kr = reinterpret_cast<const signed char*>(st);
      const signed char* vr = kr + kKeys * D;
      const float* ksr = reinterpret_cast<const float*>(vr + kKeys * D);
      const float* vsr = ksr + kKeys;
      for (int x = tid; x < kKeys * kChunks8; x += kThreads) {
        const int r = x / kChunks8;
        const int c = x % kChunks8;
        Elem<E>::int8x16(
            *reinterpret_cast<const uint4*>(kr + r * D + c * 16),
            kc_s + r * kStride + c * 16);
        Elem<E>::int8x16(
            *reinterpret_cast<const uint4*>(vr + r * D + c * 16),
            vc_s + r * kStride + c * 16);
      }
      if (tid < kKeys) {
        ksc_s[tid] = ksr[tid] * p.scale_log2;
        vsc_s[tid] = vsr[tid];
      }
      __syncthreads();
      k_t = kc_s;
      v_t = vc_s;
    } else {
      k_t = reinterpret_cast<const E*>(ring + (i % kStages) * Ly::kStageBytes);
      v_t = k_t + Ly::kTile;
    }

    // S = Q K^T over the tile's 8 blocks of 8 keys
    float s[kKeys / 8][4];
#pragma unroll
    for (int nb = 0; nb < kKeys / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qk[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qk[e] = qa[kk][e];
      } else {
        ldmatrix_x4(qk, q_s + q_off + kk * 16);
      }
#pragma unroll
      for (int nb = 0; nb < kKeys / 16; ++nb) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_t + k_off + nb * 16 * kStride + kk * 16);
        Elem<E>::mma(s[2 * nb], qk, kb[0], kb[1]);
        Elem<E>::mma(s[2 * nb + 1], qk, kb[2], kb[3]);
      }
    }

    // scores into the log2 domain; the mask only where the tile crosses
    // kv_len, the diagonal or the window start of some row of the block
    const int j0 = lo + i * kKeys;
    const bool full = j0 + kKeys <= min(kl, pos_first + 1) &&
                      (p.window <= 0 || j0 > pos_last - p.window);
#pragma unroll
    for (int nb = 0; nb < kKeys / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + 2 * t4 + (e & 1);
        float x = s[nb][e] * (INT8 ? ksc_s[col] : p.scale_log2);
        if (!full) {
          const int key = j0 + col;
          const int pos = e < 2 ? pos_lo : pos_hi;
          if (key >= kl || key > pos || (p.window > 0 && key <= pos - p.window))
            x = -INFINITY;
        }
        s[nb][e] = x;
      }

    // online softmax of the two rows
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kKeys / 8; ++nb) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nb][0], s[nb][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nb][2], s[nb][3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    // a row that has seen no visible key yet: alpha = 1, p = 0
    const float alpha_lo = mn_lo == -INFINITY ? 1.f : exp2f(m_lo - mn_lo);
    const float alpha_hi = mn_hi == -INFINITY ? 1.f : exp2f(m_hi - mn_hi);
    const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= alpha_lo;
    l_hi *= alpha_hi;
#pragma unroll
    for (int d = 0; d < kDB; ++d) {
      o[d][0] *= alpha_lo;
      o[d][1] *= alpha_lo;
      o[d][2] *= alpha_hi;
      o[d][3] *= alpha_hi;
    }
    // P in E as the A fragments of PV: keys 16 kk .. 16 kk + 15 are key
    // blocks 2 kk (a0, a1) and 2 kk + 1 (a2, a3)
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int nb = 0; nb < kKeys / 8; ++nb) {
      float p0 = exp2f(s[nb][0] - base_lo);
      float p1 = exp2f(s[nb][1] - base_lo);
      float p2 = exp2f(s[nb][2] - base_hi);
      float p3 = exp2f(s[nb][3] - base_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      if constexpr (INT8) {
        const float v0 = vsc_s[nb * 8 + 2 * t4];
        const float v1 = vsc_s[nb * 8 + 2 * t4 + 1];
        p0 *= v0;
        p1 *= v1;
        p2 *= v0;
        p3 *= v1;
      }
      pa[nb >> 1][(nb & 1) * 2] = Elem<E>::pack(p0, p1);
      pa[nb >> 1][(nb & 1) * 2 + 1] = Elem<E>::pack(p2, p3);
    }

    // O += P V over the tile's 4 steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_t + v_off + kk * 16 * kStride + nd * 16);
        Elem<E>::mma(o[2 * nd], pa[kk], vb[0], vb[1]);
        Elem<E>::mma(o[2 * nd + 1], pa[kk], vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // O / l in E through the warp's own Q rows (read only by this warp),
  // then out in 16-byte stores; rows with no visible key give 0
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  E* o_s = q_s + warp * 16 * kStride;
#pragma unroll
  for (int d = 0; d < kDB; ++d) {
    *reinterpret_cast<uint32_t*>(o_s + g * kStride + d * 8 + 2 * t4) =
        Elem<E>::pack(o[d][0] * inv_lo, o[d][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(o_s + (g + 8) * kStride + d * 8 + 2 * t4) =
        Elem<E>::pack(o[d][2] * inv_hi, o[d][3] * inv_hi);
  }
  __syncwarp();
  for (int x = lane; x < 16 * kChunks; x += 32) {
    const int r = x / kChunks;
    const int c = x % kChunks;
    const int row = row0 + warp * 16 + r;
    if (row >= nrows) continue;
    const size_t off =
        (((size_t)b * p.T + row / p.G) * p.H + kh * p.G + row % p.G) * D;
    reinterpret_cast<uint4*>(p.out + off)[c] =
        reinterpret_cast<const uint4*>(o_s + r * kStride)[c];
  }
}

// Let `kernel` take `smem` bytes of dynamic shared memory on this device
// (once a device: an attribute set on one device does not reach another).
template <typename Kernel>
int allow_smem(Kernel kernel, int smem, bool (&attr_set)[kMaxDevices]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  return 0;
}

// Launch one tensor-core instance; with `report`, launch nothing and
// report instead {tile keys, ring stages, dynamic shared memory a block}.
template <typename E, int D, bool PAGED, bool INT8>
int launch(const Params<E>& p, cudaStream_t stream, int* report) {
  constexpr int smem = Layout<D, INT8>::kBytes;
  if (report) {
    report[0] = Tile<D>::kKeys;
    report[1] = kStages;
    report[2] = smem;
    return 0;
  }
  auto kernel = attention_prefill_kernel<E, D, PAGED, INT8>;
  static bool attr_set[kMaxDevices] = {};
  const int err = allow_smem(kernel, smem, attr_set);
  if (err != 0) return err;
  const dim3 grid((p.T * p.G + kRows - 1) / kRows, p.K, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Each source defines it over its own head dims (its `switch (D)`).
template <typename E, bool PAGED, bool INT8>
int dispatch(const Params<E>& p, int D, cudaStream_t stream, int* report);

// One entry point: the slot cache [L, B, S, K, D], or (PAGED) the pool
// [L, P, page, K, D] through the table; INT8 with the scale planes.
template <typename E, bool PAGED, bool INT8>
int run_entry(const void* q, const void* k_cache, const void* v_cache,
              const void* k_scale, const void* v_scale, void* out,
              const int* q_start, const int* kv_len, const int* table,
              int layer, int B, int T, int H, int K, int S, int P, int page,
              int max_pages, int D, float sm_scale, int window,
              void* stream) {
  Params<E> p{};
  p.q = (const E*)q;
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scale = (const float*)k_scale;
  p.v_scale = (const float*)v_scale;
  p.out = (E*)out;
  p.q_start = q_start;
  p.kv_len = kv_len;
  p.layer = layer; p.B = B; p.T = T; p.H = H; p.K = K;
  p.S = PAGED ? page * max_pages : S;
  p.G = H / K;
  p.scale_log2 = sm_scale * kLog2e;
  p.window = window;
  if (PAGED) {
    p.table = table;
    p.P = P; p.page = page; p.max_pages = max_pages;
  }
  return dispatch<E, PAGED, INT8>(p, D, (cudaStream_t)stream, nullptr);
}

// The tiling of a launch at head_dim D (int8 != 0: an int8 cache; the
// paged modes tile alike): out = {tile keys, ring stages, dynamic shared
// memory bytes a block}.
template <typename E>
int plan_entry(int D, int int8, int* out) {
  const Params<E> p{};
  return int8 ? dispatch<E, false, true>(p, D, nullptr, out)
              : dispatch<E, false, false>(p, D, nullptr, out);
}

}  // namespace

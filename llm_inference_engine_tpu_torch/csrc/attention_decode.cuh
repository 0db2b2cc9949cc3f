// Kernel D: single-token decode attention against the stacked KV cache,
// split along the keys over a thread-block cluster (flash-decoding), in
// four decode modes: the fused write + attend over the slot cache and over
// a paged pool, each of q's dtype or int8 (a pool given no new rows
// attends only). One template over the element type E
// of q, the new rows and out: __nv_bfloat16 (attention_decode.cu, kernel
// D), __half and float (attention_decode_f16.cu, attention_decode_f32.cu:
// kernel Df, the float instances). The prefill modes are kernel D2
// (attention_prefill.cuh).
//
// Replaces two TPU kernels of the JAX package
// (llm_inference_engine_tpu/ops/attention.py):
//   - `_decode_fused_mxu_kernel` (launched by `_attention_decode_fused_mxu`):
//     write the token's K/V row into the slot cache, then attend
//     (WRITE_NEW; an int8 cache gets the row quantized with kernel I's row
//     quantizer, kv_quant.cuh, in the numerics `snapped` picks; a float
//     row with the row quantizer of kernel If, bit for bit as If writes
//     it);
//   - `_decode_mxu_kernel` (launched by `_attention_decode_mxu` with a block
//     table): decode over the paged pool (PAGED). The token's row is
//     written through the table by the kernel itself (PAGED && WRITE_NEW,
//     with the rules of kernel H's write, kv_write.cu: the JAX package's
//     `_paged_write_kernel` runs before its attend-only decode), which
//     saves a launch of H a layer in every decode step; an int8 pool gets
//     the row quantized as over the slot cache, always in the snapped
//     numerics (the pool's), bit for bit as kernel H's int8 mode (or If)
//     writes it. `attention_decode_paged` and `attention_decode_paged_int8`
//     run the same instances with no new rows, after kernel H (or its int8
//     mode, or If) wrote the token: the JAX package's order, kept to hold
//     the fused write against.
//
// Semantics. q [B, 1, H, D]; out [B, 1, H, D]. Query head h sits at position
// p = q_start[b] and attends key j iff j < kv_len[b], j <= p and, with a
// window W > 0, j > p - W, using kv head h / G (G = H / K). All heads of a
// sequence share p, so they see the same keys [lo, hi): lo = max(0, p - W +
// 1) (0 without a window), hi = min(kv_len[b], p + 1). A head with no
// visible key gives 0. The fused modes first write the token at p when
// kv_len[b] > p and 0 <= p < S (inactive rows write nothing; over a pool S
// is max_pages * page, and a table entry e = table[b, p / page] outside
// [0, P) writes nothing either, the row landing at [layer, e, p % page]).
// The cache is
// the slot cache [L, B, S, K, D] or the pool [L, P, page, K, D] with a block
// table [B, max_pages] (key j of sequence b at page table[b, j / page], row
// j % page); E, or int8 with f32 scale planes [.., K] holding each
// (token, head) row's final scale.
//
// Bound: HBM bytes. A decode step reads each sequence's visible keys once
// (2 K/V rows of D values per key and kv head) and does 4 D operations per
// key and query head, far below the card's ratio of operations to bytes.
// The design keeps enough bytes in flight on every SM:
//   - Split-KV over a cluster. Each (sequence, kv head, block of up to R
//     query heads) is a cluster of `nsplit` blocks along the keys. Block r
//     takes a contiguous, tile-aligned slice of [lo, hi), computed on the
//     card from kv_len, q_start and the window, and keeps a softmax state
//     (m, l, acc) per query head. The blocks' states meet through
//     distributed shared memory, every rank merging a share of the outputs
//     in rank order (each row's maximum and weights computed once), so the
//     merge is one launch, needs no workspace and no atomics, and is
//     deterministic. The split plan (R, nsplit: make_plan) depends on B, K,
//     G, D, the element size, the SM count and the instance's residency
//     only, never on S, the page size or kv_len: tiles start at the slice's
//     lo, never at a page boundary, so a paged instance sums in the slot
//     instance's order and a paged engine reproduces a slot engine bit for
//     bit. At G > 1 the plan keeps the grid's clusters in one wave.
//   - A cp.async ring of kStages tiles of kKeys keys: the next tile's K/V
//     (and an int8 tile's scales, in the same group as its values) is in
//     flight while a tile is consumed. Two stages of 32 keys, with about
//     kTargetBlocksPerSm = 8 blocks an SM in the grid at G = 1, timed
//     fastest on the H100 of the plans tried (PERF.md; G > 1:
//     tools/plan_sweep.py):
//     small blocks keep 6 (bf16, f16) or 10 (int8) of them resident an
//     SM; an f32 tile holds twice the bytes and 3 blocks fit an SM at
//     D = 128, so f32 aims at half as many blocks an SM.
//     Keys at or past the slice's end are zero-filled (src-size 0), never
//     left stale. In the paged modes the
//     slice's table entries are staged in shared memory once, before the
//     ring starts, so no K/V copy waits on a table load.
//   - The fused write comes before any tile is loaded: the block whose
//     slice holds the token writes its row (with G > R, the block of each
//     row block of the kv head writes the same bytes). Over a pool that
//     block reads the token's table entry straight from global memory, its
//     load in flight beside the query loads, before the slice's entries
//     are staged.
//   - Parallel P V on the CUDA cores. A warp takes kKeys / kWarps keys of
//     each tile, a few at a time: lane (group, c) holds query values
//     [8c, 8c + 8) of each head in registers and owns output columns
//     [8c, 8c + 8) for the keys of its lane group. A score is one 8-wide
//     product per lane and a shuffle sum over the group; every lane weighs
//     its own V columns, with no serial loop over keys. Values are
//     converted to f32 in registers as they are consumed (exactly: bf16,
//     f16 and int8 all fit f32), and p is never rounded; the k scale multiplies
//     the score, the v scale the softmax weight before it weighs V (the row
//     sum l takes the unscaled weight), the placement of the JAX kernels.
//   - One warp's state is merged over its lane groups with shuffles, a
//     block's warps through shared memory, then the cluster as above.
// The kernel allocates nothing, does not synchronise with the host and
// never reads kv_len on the host, so a CUDA graph can capture it.

#include <cooperative_groups.h>
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "kv_quant.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;            // keys of one tile
constexpr int kStages = 2;           // tiles in the cp.async ring
constexpr int kKeysPerWarp = kKeys / kWarps;
constexpr int kMaxSplit = 8;         // the portable cluster size
constexpr int kTargetBlocksPerSm = 8;
constexpr int kMaxDevices = 16;      // launch attributes are set per device
constexpr float kLog2e = 1.4426950408889634f;

template <typename E>
struct Params {
  const E* q;                    // [B, 1, H, D]
  const E* k_new;                // [B, 1, K, D] (WRITE_NEW)
  const E* v_new;
  void* k_cache;                 // [L, B, S, K, D] or pool [L, P, page, K, D]
  void* v_cache;                 // E, or int8 (INT8)
  float* k_scale;                // INT8: [L, B, S, K] or [L, P, page, K]
  float* v_scale;
  E* out;                        // [B, 1, H, D]
  const int* q_start;            // [B]
  const int* kv_len;             // [B]
  const int* table;              // [B, max_pages] (PAGED)
  int layer, B, H, K, S, G;
  int P, page, max_pages;        // paged pool geometry
  int nsplit;                    // blocks of a cluster along the keys
  int rows;                      // R: query heads a block (1, 4 or 8)
  int row_blocks;                // blocks of R query heads per kv head
  int table_max;                 // table entries a slice can span (PAGED)
                                 // (these four: the plan, set by run)
  float scale_log2;              // sm_scale * log2(e)
  int window;                    // 0 = no sliding window
  int snapped;                   // INT8 && WRITE_NEW: snapped scale numerics
                                 // (always over a pool)
};

// Lanes of a warp: lane = group * kLanes + c. Lane c < kChunks of a group
// holds 8 consecutive values [8c, 8c + 8) of the D-wide rows; a group
// handles one key at a time, kGroups keys side by side (at D = 16, groups
// of 4 lanes, 2 of them live, so that the 8 groups fill a warp's keys).
template <int D>
struct Lanes {
  static constexpr int kChunks = D / 8;
  static constexpr int kLanes =
      kChunks <= 4 ? 4 : kChunks <= 8 ? 8 : kChunks <= 16 ? 16 : 32;
  static constexpr int kGroups = 32 / kLanes;
  static_assert(D % 8 == 0 && kChunks <= 32, "head_dim a multiple of 8, <= 256");
  static_assert(kKeysPerWarp % kGroups == 0, "a warp's keys fill its groups");
};

// Shared memory of one block (bytes): the ring (K and V tiles, int8 scales
// beside them), then the slice's table entries; after the loop the ring
// holds the warps' states and the block's merged state.
template <typename E, int D, int R, bool INT8>
struct Layout {
  static constexpr int kRowBytes = INT8 ? D : (int)sizeof(E) * D;
  static constexpr int kTileBytes = kKeys * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes + (INT8 ? 2 * kKeys * 4 : 0);
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kState = R * (D + 2);           // floats: acc, m, l
  static constexpr int kMerge = (kWarps + 1) * kState * 4;
  static constexpr int kBytes = kRing > kMerge ? kRing : kMerge;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- or 4-byte copy into shared memory; !valid zero-fills it and reads
// nothing
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

// 8 bf16 values -> f32 (exact)
__device__ __forceinline__ void bf16x8_to_f32(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 8 f16 values -> f32 (exact)
__device__ __forceinline__ void f16x8_to_f32(const uint4& raw, float* f) {
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Values [8c, 8c + 8) of a row of E at `row` (16-byte aligned), as f32:
// one 16-byte load of bf16 or f16, two of f32.
template <typename E>
__device__ __forceinline__ void load8(const E* row, int c, float* f) {
  if constexpr (sizeof(E) == 4) {
    const float4* v = reinterpret_cast<const float4*>(row) + 2 * c;
    const float4 a = v[0], b = v[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    const uint4 raw = reinterpret_cast<const uint4*>(row)[c];
    if constexpr (std::is_same<E, __half>::value)
      f16x8_to_f32(raw, f);
    else
      bf16x8_to_f32(raw, f);
  }
}

template <typename E>
__device__ __forceinline__ E from_f32(float x) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value)
    return __float2bfloat16(x);
  else if constexpr (std::is_same<E, __half>::value)
    return __float2half_rn(x);
  else
    return x;
}

// 8 int8 values -> f32 (exact): byte b ^ 0x80 as the low mantissa byte of
// 2^23, minus 2^23 + 128
__device__ __forceinline__ void int8x8_to_f32(const uint2& raw, float* f) {
  const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = __uint_as_float(__byte_perm(w[i >> 2], 0x4b000000u,
                                       0x7540u | (i & 3))) - 8388736.f;
}

template <typename E, int D, int R, bool PAGED, bool INT8, bool WRITE_NEW>
__global__ void __launch_bounds__(kThreads)
attention_decode_kernel(const Params<E> p) {
  using Ln = Lanes<D>;
  using Ly = Layout<E, D, R, INT8>;
  constexpr int kChunks = Ln::kChunks;
  constexpr int kLanes = Ln::kLanes;
  constexpr int kGroups = Ln::kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl_s = reinterpret_cast<int*>(smem + Ly::kBytes);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.z;
  const int kh = blockIdx.y / p.row_blocks;
  const int r0 = (blockIdx.y % p.row_blocks) * R;   // first query head of kh
  const int nrows = min(R, p.G - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane / kLanes;
  const int c = lane % kLanes;
  const bool live = c < kChunks;

  // this block's slice [k0, k1) of the visible keys [lo, hi): whole tiles
  // from lo, split evenly over the cluster
  const int qs = p.q_start[b];
  const int kl = p.kv_len[b];
  const int hi = min(min(kl, qs + 1), p.S);
  const int lo = p.window > 0 ? max(0, qs - p.window + 1) : 0;
  const int n_all = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;
  const int per = (n_all + p.nsplit - 1) / p.nsplit;
  const int t0 = min(rank * per, n_all);
  const int n_tiles = min(t0 + per, n_all) - t0;
  const int k0 = lo + t0 * kKeys;
  const int k1 = min(k0 + n_tiles * kKeys, hi);

  // (token, head) row of key `key`: values at element row * D, scale at row
  const size_t base = PAGED ? (size_t)p.layer * p.P * p.page * p.K + kh
                            : ((size_t)p.layer * p.B + b) * p.S * p.K + kh;
  const int pg0 = PAGED && n_tiles > 0 ? k0 / p.page : 0;
  auto kv_row = [&](int key) -> size_t {
    if constexpr (PAGED) {
      return base + ((size_t)tbl_s[key / p.page - pg0] * p.page +
                     key % p.page) * p.K;
    } else {
      return base + (size_t)key * p.K;
    }
  };

  // the fused write's block: the one whose slice holds the token (k1 <= S);
  // a pool launched with no new rows writes nothing
  [[maybe_unused]] const bool writes =
      WRITE_NEW && (!PAGED || p.k_new != nullptr) && kl > qs && qs >= 0 &&
      qs >= k0 && qs < k1;
  // over a pool, the token's table entry, loaded beside the queries
  int w_entry = -1;
  if constexpr (WRITE_NEW && PAGED) {
    if (writes) w_entry = p.table[(size_t)b * p.max_pages + qs / p.page];
  }

  // queries of this lane's chunk, pre-scaled into the log2 domain
  float qf[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if constexpr (std::is_same<E, __nv_bfloat16>::value) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (live && r < nrows)
        raw = reinterpret_cast<const uint4*>(
            p.q + ((size_t)b * p.H + kh * p.G + r0 + r) * D)[c];
      bf16x8_to_f32(raw, qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[r][e] = 0.f;
      if (live && r < nrows)
        load8(p.q + ((size_t)b * p.H + kh * p.G + r0 + r) * D, c, qf[r]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[r][e] *= p.scale_log2;
  }

  // the fused write: the block whose slice holds the token writes it before
  // any tile of the slice is loaded (with G > R, the block of each row
  // block of kh writes the same bytes)
  if constexpr (WRITE_NEW) {
    if (writes && (!PAGED || (w_entry >= 0 && w_entry < p.P))) {
      const size_t src = ((size_t)b * p.K + kh) * D;
      const size_t row =
          PAGED ? base + ((size_t)w_entry * p.page + qs % p.page) * p.K
                : kv_row(qs);
      if constexpr (INT8) {
        // warp 0 quantizes and writes the k row, warp 1 the v row
        if (warp < 2) {
          const E* from = (warp ? p.v_new : p.k_new) + src;
          signed char* to = static_cast<signed char*>(
              warp ? p.v_cache : p.k_cache) + row * D;
          float* sc = (warp ? p.v_scale : p.k_scale) + row;
          if constexpr (std::is_same<E, __nv_bfloat16>::value) {
            if (p.snapped)
              kvq::quantize_row<D, true>(from, to, sc, lane);
            else
              kvq::quantize_row<D, false>(from, to, sc, lane);
          } else {
            kvq::quantize_row_strided(from, to, sc, D, p.snapped != 0, lane);
          }
        }
      } else {
        constexpr int kCopies = Ly::kRowBytes / 16;   // 16-byte copies a row
        for (int x = tid; x < 2 * kCopies; x += kThreads) {
          const bool is_v = x >= kCopies;
          const int cc = x % kCopies;
          reinterpret_cast<uint4*>(static_cast<E*>(
              is_v ? p.v_cache : p.k_cache) + row * D)[cc] =
              reinterpret_cast<const uint4*>((is_v ? p.v_new : p.k_new) +
                                             src)[cc];
        }
      }
    }
  }
  // the slice's table entries, once
  if constexpr (PAGED) {
    const int n_pg = n_tiles > 0 ? (k1 - 1) / p.page - pg0 + 1 : 0;
    for (int x = tid; x < n_pg; x += kThreads)
      tbl_s[x] = p.table[(size_t)b * p.max_pages + pg0 + x];
  }
  __syncthreads();   // the written row and the table entries are visible

  // tile i of the slice (keys k0 + kKeys i ..) into its ring stage; keys at
  // or past k1 zero-filled
  auto load_tile = [&](int i) {
    const int j0 = k0 + i * kKeys;
    unsigned char* st = smem + (i % kStages) * Ly::kStageBytes;
    constexpr int kCopies = Ly::kRowBytes / 16;      // 16-byte copies a row
    constexpr int kPasses = (kKeys * kCopies + kThreads - 1) / kThreads;
    const unsigned char* kg = static_cast<const unsigned char*>(p.k_cache);
    const unsigned char* vg = static_cast<const unsigned char*>(p.v_cache);
#pragma unroll
    for (int it = 0; it < kPasses; ++it) {
      const int x = tid + it * kThreads;
      if (kKeys * kCopies % kThreads != 0 && x >= kKeys * kCopies) break;
      const int r = x / kCopies;
      const int cc = x % kCopies;
      const bool ok = j0 + r < k1;
      const size_t off = (ok ? kv_row(j0 + r) : 0) * Ly::kRowBytes + cc * 16;
      cp_async16(st + r * Ly::kRowBytes + cc * 16, kg + off, ok);
      cp_async16(st + Ly::kTileBytes + r * Ly::kRowBytes + cc * 16, vg + off,
                 ok);
    }
    if constexpr (INT8) {
      // the tile's scales ride in the group of its values
      float* ks = reinterpret_cast<float*>(st + 2 * Ly::kTileBytes);
      if (tid < kKeys) {
        const bool ok = j0 + tid < k1;
        const size_t row = ok ? kv_row(j0 + tid) : 0;
        cp_async4(ks + tid, p.k_scale + row, ok);
        cp_async4(ks + kKeys + tid, p.v_scale + row, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // softmax state of each query head: m (warp-uniform), l (this lane
  // group's keys), acc (this lane's 8 columns, this group's keys)
  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile i landed for all; every warp is done with i - 1
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();

    const unsigned char* st = smem + (i % kStages) * Ly::kStageBytes;
    const int j0 = k0 + i * kKeys;
#pragma unroll
    for (int s = 0; s < kKeysPerWarp / kGroups; ++s) {
      const int kk = warp * kKeysPerWarp + s * kGroups + grp;   // tile key
      const bool valid = j0 + kk < k1;
      float kf[8], vf[8];
      if constexpr (INT8) {
        uint2 kr = make_uint2(0, 0), vr = make_uint2(0, 0);
        if (live) {
          kr = *reinterpret_cast<const uint2*>(st + kk * D + c * 8);
          vr = *reinterpret_cast<const uint2*>(st + Ly::kTileBytes + kk * D +
                                                c * 8);
        }
        int8x8_to_f32(kr, kf);
        int8x8_to_f32(vr, vf);
      } else if constexpr (std::is_same<E, __nv_bfloat16>::value) {
        uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
        if (live) {
          kr = *reinterpret_cast<const uint4*>(st + kk * 2 * D + c * 16);
          vr = *reinterpret_cast<const uint4*>(st + Ly::kTileBytes +
                                                kk * 2 * D + c * 16);
        }
        bf16x8_to_f32(kr, kf);
        bf16x8_to_f32(vr, vf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
        if (live) {
          load8(reinterpret_cast<const E*>(st + kk * Ly::kRowBytes), c, kf);
          load8(reinterpret_cast<const E*>(st + Ly::kTileBytes +
                                           kk * Ly::kRowBytes), c, vf);
        }
      }
      float ksc = 1.f, vsc = 1.f;
      if constexpr (INT8) {
        const float* sc = reinterpret_cast<const float*>(st + 2 * Ly::kTileBytes);
        ksc = sc[kk];
        vsc = sc[kKeys + kk];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nrows) break;                          // block-uniform
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part += qf[r][e] * kf[e];
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        const float sc = valid ? part * ksc : -INFINITY;
        float mx = sc;
#pragma unroll
        for (int o = kLanes; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m[r], mx);
        if (mn == -INFINITY) continue;                  // warp-uniform
        if (mn > m[r]) {                                // warp-uniform
          const float alpha = exp2f(m[r] - mn);         // 0 while m = -inf
          l[r] *= alpha;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
          m[r] = mn;
        }
        const float pr = valid ? exp2f(sc - mn) : 0.f;
        l[r] += pr;
        const float pw = pr * vsc;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] += pw * vf[e];
      }
    }
  }
  cp_async_wait<0>();

  // merge the warp's lane groups (m is warp-uniform)
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
  }
  // the warps' states, then the block's, in the ring's space: state s of
  // head r is acc at [s][r][0, D), m at [s][r][D], l at [s][r][D + 1]
  __syncthreads();   // every warp is done with the ring
  float* st_w = reinterpret_cast<float*>(smem);
  constexpr int kSt = D + 2;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* dst = st_w + (warp * R + r) * kSt;
    if (grp == 0 && live) {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[c * 8 + e] = acc[r][e];
    }
    if (lane == 0) {
      dst[D] = m[r];
      dst[D + 1] = l[r];
    }
  }
  __syncthreads();
  float* blk = st_w + kWarps * R * kSt;
  for (int x = tid; x < R * kSt; x += kThreads) {
    const int r = x / kSt;
    const int d = x % kSt;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, st_w[(w * R + r) * kSt + D]);
    float v;
    if (d == D) {
      v = mx;
    } else if (mx == -INFINITY) {
      v = 0.f;
    } else {
      v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* src = st_w + (w * R + r) * kSt;
        v += src[d] * exp2f(src[D] - mx);
      }
    }
    blk[r * kSt + d] = v;
  }

  // the cluster's merge, spread over its ranks: rank r writes a share of
  // the nrows x D outputs (row-major); each row it touches gets its maximum,
  // its ranks' weights e_s = exp2(m_s - max) and its sum l = sum_s l_s e_s
  // once, in rank order, in the space of the warps' states (no rank reads
  // it remotely); then every output sums a_s e_s over ranks 0, 1, ... in
  // order, the arithmetic of a merge by one rank, so the bits do not
  // depend on which rank writes
  cluster.sync();
  {
    const int n_out = nrows * D;
    const int share = (n_out + p.nsplit - 1) / p.nsplit;
    const int x0 = min(rank * share, n_out);
    const int x1 = min(x0 + share, n_out);
    if (x1 > x0) {                                      // block-uniform
      const int ra = x0 / D;
      const int nr = (x1 - 1) / D - ra + 1;             // rows touched
      float* wts = st_w;                                // [nr][kMaxSplit]
      float* ls = wts + R * kMaxSplit;                  // [nr][kMaxSplit]
      float* row_m = ls + R * kMaxSplit;                // [nr]
      float* row_l = row_m + R;                         // [nr]
      for (int y = tid; y < nr * p.nsplit; y += kThreads) {
        const int rr = y / p.nsplit;
        const int s = y % p.nsplit;
        const float* src = cluster.map_shared_rank(blk, s) + (ra + rr) * kSt;
        wts[rr * kMaxSplit + s] = src[D];
        ls[rr * kMaxSplit + s] = src[D + 1];
      }
      __syncthreads();
      for (int rr = tid; rr < nr; rr += kThreads) {
        float mx = -INFINITY;
        for (int s = 0; s < p.nsplit; ++s)
          mx = fmaxf(mx, wts[rr * kMaxSplit + s]);
        float lsum = 0.f;
        if (mx != -INFINITY) {
          for (int s = 0; s < p.nsplit; ++s) {
            const float e = exp2f(wts[rr * kMaxSplit + s] - mx);
            wts[rr * kMaxSplit + s] = e;
            lsum += ls[rr * kMaxSplit + s] * e;
          }
        }
        row_m[rr] = mx;
        row_l[rr] = lsum;
      }
      __syncthreads();
      for (int x = x0 + tid; x < x1; x += kThreads) {
        const int r = x / D;
        const int d = x % D;
        const int rr = r - ra;
        float o = 0.f;
        if (row_m[rr] != -INFINITY) {
          float a = 0.f;
#pragma unroll
          for (int s = 0; s < kMaxSplit; ++s) {
            if (s < p.nsplit) {
              const float e = wts[rr * kMaxSplit + s];
              a += cluster.map_shared_rank(blk, s)[r * kSt + d] * e;
            }
          }
          const float lsum = row_l[rr];
          o = lsum > 0.f ? a / lsum : 0.f;
        }
        p.out[((size_t)b * p.H + kh * p.G + r0 + r) * D + d] = from_f32<E>(o);
      }
    }
  }
  cluster.sync();    // every block's state stays until every rank has read it
}

// The split plan: blocks of R query heads per kv head and nsplit blocks
// along the keys. A function of B, K, G, the element size, the SM count
// and the compiled instance (its residency) only, never of S, the page
// size or kv_len.
//   - G = 1 (R = 1): nsplit so that the grid holds about
//     kTargetBlocksPerSm blocks an SM (half as many for f32, whose tiles
//     take twice the shared memory).
//   - G > 1: each candidate R (4 up to G = 4; else 8, then 4: a block's
//     registers grow with R, so a smaller R keeps more blocks resident)
//     takes the largest nsplit, up to that target, whose grid of
//     B * K * ceil(G / R) clusters the card holds in one wave
//     (`clusters[R][n]`, cudaOccupancyMaxActiveClusters of R's slot
//     instance; nsplit 1 where no split fits one wave); the candidate
//     with the most blocks wins, the first on a tie. A short context
//     split over a second wave waits for it: at B 8, K 4, G 8, D 64 the
//     old plan's 32 clusters of 8 met 30 resident ones.
// The paged instances take their slot instance's residency, so a paged
// launch splits as the slot one and a paged engine reproduces a slot
// engine bit for bit.
struct Plan {
  int rows, row_blocks, nsplit;
};

// clusters[0][n]: clusters of n blocks of the R = 4 slot instance the card
// holds at once; clusters[1][n]: of the R = 8 one (n = 1 .. kMaxSplit)
typedef int Residency[2][kMaxSplit + 1];
constexpr int kReport = 5 + 2 * kMaxSplit;

#ifdef PLAN_SWEEP
// tools/plan_sweep.py: a forced plan (rows 0: none)
int g_force_rows = 0, g_force_nsplit = 0;
#endif

Plan make_plan(int B, int K, int G, int esize, int sms,
               const Residency& clusters) {
  Plan pl{};
  const long long want = (long long)kTargetBlocksPerSm * 2 / esize * sms;
  auto target = [&](long long c) {
    return (int)max(1ll, min((long long)kMaxSplit,
                             (want + c / 2) / max(c, 1ll)));
  };
  if (G == 1) {
    pl.rows = 1;
    pl.row_blocks = 1;
    pl.nsplit = target((long long)B * K);
  } else {
    long long best = -1;
    const int cands[2] = {G <= 4 ? 4 : 8, 4};
    for (int i = 0; i < (G <= 4 ? 1 : 2); ++i) {
      const int R = cands[i];
      const int rb = (G + R - 1) / R;
      const long long c = (long long)B * K * rb;
      int n = target(c);
      while (n > 1 && c > clusters[R == 8][n]) --n;
      if (c * n > best) {
        best = c * n;
        pl.rows = R;
        pl.row_blocks = rb;
        pl.nsplit = n;
      }
    }
  }
#ifdef PLAN_SWEEP
  if (g_force_rows > 0 && G > 1) {
    pl.rows = g_force_rows;
    pl.row_blocks = (G + g_force_rows - 1) / g_force_rows;
    pl.nsplit = g_force_nsplit;
  }
#endif
  return pl;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// Allow an instance `smem` bytes of dynamic shared memory on the current
// device: the largest size allowed yet is kept per device (an attribute
// set on one device does not reach another).
template <typename E, int D, int R, bool PAGED, bool INT8, bool WRITE_NEW>
cudaError_t allow_smem(int smem) {
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (smem <= smem_set[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      attention_decode_kernel<E, D, R, PAGED, INT8, WRITE_NEW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) smem_set[dev] = smem;
  return err;
}

// Clusters of n = 1 .. kMaxSplit blocks of R's slot instance (fused
// write, no table) that the card holds at once, asked once a device.
template <typename E, int D, int R, bool INT8>
cudaError_t slot_clusters(int* out) {
  static int cache[kMaxDevices][kMaxSplit + 1] = {};   // value + 1
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (cache[dev][1] == 0) {
    const int smem = Layout<E, D, R, INT8>::kBytes;
    cudaError_t err = allow_smem<E, D, R, false, INT8, true>(smem);
    if (err != cudaSuccess) return err;
    for (int n = 1; n <= kMaxSplit; ++n) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(n, 1, 1);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = n;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int c = 0;
      err = cudaOccupancyMaxActiveClusters(
          &c, attention_decode_kernel<E, D, R, false, INT8, true>, &cfg);
      if (err != cudaSuccess) return err;
      cache[dev][n] = c + 1;
    }
  }
  for (int n = 1; n <= kMaxSplit; ++n) out[n] = cache[dev][n] - 1;
  out[0] = 0;
  return cudaSuccess;
}

template <typename E, int D, bool INT8>
cudaError_t residency(Residency& r) {
  cudaError_t err = slot_clusters<E, D, 4, INT8>(r[0]);
  if (err == cudaSuccess) err = slot_clusters<E, D, 8, INT8>(r[1]);
  return err;
}

// Launch one instance with a cluster of nsplit blocks along x; with
// `report`, launch nothing and report instead {blocks an SM holds,
// clusters the card holds at once, dynamic shared memory a block}.
template <typename E, int D, int R, bool PAGED, bool INT8, bool WRITE_NEW>
int launch(const Params<E>& p, cudaStream_t stream, int* report) {
  auto kernel = attention_decode_kernel<E, D, R, PAGED, INT8, WRITE_NEW>;
  const int smem =
      Layout<E, D, R, INT8>::kBytes + (PAGED ? 4 * p.table_max : 0);
  cudaError_t err = allow_smem<E, D, R, PAGED, INT8, WRITE_NEW>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nsplit, p.K * p.row_blocks, p.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (report) {
    report[2] = smem;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&report[0], kernel,
                                                        kThreads, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&report[1], kernel, &cfg);
    return (int)err;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// One head_dim: the plan (from the slot instances' residency), then the
// instance of its query heads a block. With `report` (kReport ints),
// launch nothing and report {blocks an SM holds, clusters the card holds,
// dynamic shared memory a block, nsplit, query heads a block, then the
// residency: clusters of n = 1 .. 8 blocks of R = 4's slot instance, then
// of R = 8's}.
template <typename E, int D, bool PAGED, bool INT8, bool WRITE_NEW>
int run(Params<E> p, cudaStream_t stream, int* report) {
  Residency res = {};
  if (p.G > 1 || report) {   // G = 1 reads no residency
    const cudaError_t err = residency<E, D, INT8>(res);
    if (err != cudaSuccess) return (int)err;
  }
  const Plan pl = make_plan(p.B, p.K, p.G, (int)sizeof(E), sm_count(), res);
  p.nsplit = pl.nsplit;
  p.rows = pl.rows;
  p.row_blocks = pl.row_blocks;
  if constexpr (PAGED) {
    // the most table entries one slice can span
    const int tiles = (p.page * p.max_pages + kKeys - 1) / kKeys;
    const int slice = (tiles + p.nsplit - 1) / p.nsplit * kKeys;
    p.table_max = p.page > 0 ? (slice + p.page - 2) / p.page + 1 : 0;
  }
  if (report) {
    report[3] = p.nsplit;
    report[4] = p.rows;
    for (int n = 1; n <= kMaxSplit; ++n) {
      report[4 + n] = res[0][n];
      report[4 + kMaxSplit + n] = res[1][n];
    }
  }
  switch (p.rows) {
    case 1: return launch<E, D, 1, PAGED, INT8, WRITE_NEW>(p, stream, report);
    case 4: return launch<E, D, 4, PAGED, INT8, WRITE_NEW>(p, stream, report);
    default: return launch<E, D, 8, PAGED, INT8, WRITE_NEW>(p, stream, report);
  }
}

// Each source defines it over its own head dims (its `switch (D)`).
template <typename E, bool PAGED, bool INT8, bool WRITE_NEW>
int dispatch(const Params<E>& p, int D, cudaStream_t stream, int* report);

template <typename E>
Params<E> make_params(const void* q, void* k_cache, void* v_cache,
                      void* k_scale, void* v_scale, void* out,
                      const int* q_start, const int* kv_len, int layer, int B,
                      int H, int K, int S, float sm_scale, int window) {
  Params<E> p{};
  p.q = (const E*)q;
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scale = (float*)k_scale;
  p.v_scale = (float*)v_scale;
  p.out = (E*)out;
  p.q_start = q_start;
  p.kv_len = kv_len;
  p.layer = layer; p.B = B; p.H = H; p.K = K; p.S = S;
  p.G = K > 0 ? H / K : 0;
  p.scale_log2 = sm_scale * kLog2e;
  p.window = window;
  return p;
}

// The paged geometry (the table's span a slice, after the plan: run).
template <typename E>
Params<E> paged(Params<E> p, const int* table, int P, int page,
                int max_pages) {
  p.table = table;
  p.P = P; p.page = page; p.max_pages = max_pages;
  return p;
}

template <typename E>
bool valid_shape(const Params<E>& p) {
  return p.B > 0 && p.K > 0 && p.H % p.K == 0 && p.G > 0;
}

// Decode over the slot cache (E, or int8 with its scales: the row
// quantized in the numerics `snapped` picks) with the new token's K/V
// write.
template <typename E, bool INT8>
int slot_entry(const void* q, const void* k_new, const void* v_new,
               void* k_cache, void* v_cache, void* k_scale, void* v_scale,
               void* out, const int* q_start, const int* kv_len, int layer,
               int B, int H, int K, int S, int D, float sm_scale, int window,
               int snapped, void* stream) {
  Params<E> p = make_params<E>(q, k_cache, v_cache, k_scale, v_scale, out,
                               q_start, kv_len, layer, B, H, K, S, sm_scale,
                               window);
  p.k_new = (const E*)k_new;
  p.v_new = (const E*)v_new;
  p.snapped = snapped;
  if (!valid_shape(p)) return (int)cudaErrorInvalidValue;
  return dispatch<E, false, INT8, true>(p, D, (cudaStream_t)stream, nullptr);
}

// Decode over a pool of E, or int8 (INT8: the row quantized with snapped
// scales, the pool's numerics), with the new token's K/V write through
// the table (kernel H's rules; k_new null: attend only).
template <typename E, bool INT8>
int paged_entry(const void* q, const void* k_new, const void* v_new,
                void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                void* out, const int* q_start, const int* kv_len,
                const int* table, int layer, int B, int H, int K, int P,
                int page, int max_pages, int D, float sm_scale, int window,
                void* stream) {
  Params<E> p = paged(make_params<E>(q, k_pool, v_pool, k_scale, v_scale,
                                     out, q_start, kv_len, layer, B, H, K,
                                     page * max_pages, sm_scale, window),
                      table, P, page, max_pages);
  p.k_new = (const E*)k_new;
  p.v_new = (const E*)v_new;
  p.snapped = 1;
  if (!valid_shape(p) || page <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<E, true, INT8, true>(p, D, (cudaStream_t)stream, nullptr);
}

// The split plan of a decode launch at these shapes (paged: page and
// max_pages > 0), for reports: out = {nsplit, query heads a block, tile
// keys, ring stages, dynamic shared memory bytes, blocks an SM holds,
// clusters the card holds}.
template <typename E>
int plan_entry(int B, int H, int K, int D, int int8, int page, int max_pages,
               int* out) {
  Params<E> p = make_params<E>(nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, 0, B, H, K,
                               page * max_pages, 1.f, 0);
  if (!valid_shape(p)) return (int)cudaErrorInvalidValue;
  const bool is_paged = page > 0 && max_pages > 0;
  if (is_paged) p = paged(p, nullptr, 1, page, max_pages);
  int occ[kReport] = {};
  const int err =
      is_paged ? (int8 ? dispatch<E, true, true, true>(p, D, nullptr, occ)
                       : dispatch<E, true, false, true>(p, D, nullptr, occ))
               : (int8 ? dispatch<E, false, true, true>(p, D, nullptr, occ)
                       : dispatch<E, false, false, true>(p, D, nullptr, occ));
  out[0] = occ[3];
  out[1] = occ[4];
  out[2] = kKeys;
  out[3] = kStages;
  out[4] = occ[2];
  out[5] = occ[0];
  out[6] = occ[1];
  return err;
}

// The residency the plan reads at head_dim D: out[8 i + n - 1] = clusters
// of n blocks (n = 1 .. 8) of the slot instance of R = 4 (i = 0) or 8
// (i = 1) that the card holds at once. A head_dim with no instance
// reports cudaErrorInvalidValue.
template <typename E>
int clusters_entry(int D, int int8, int* out) {
  Params<E> p = make_params<E>(nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, 0, 1, 8, 1, 0, 1.f,
                               0);
  int occ[kReport] = {};
  const int err = int8 ? dispatch<E, false, true, true>(p, D, nullptr, occ)
                       : dispatch<E, false, false, true>(p, D, nullptr, occ);
  for (int i = 0; i < 2 * kMaxSplit; ++i) out[i] = occ[5 + i];
  return err;
}

}  // namespace

// Kernel I: quantize new K/V token rows and write them into an int8 KV
// cache with their f32 scales, in place: the stacked slot cache
// (`kv_write_quant`) or, through the block table, the paged pool
// (`paged_kv_write_quant`, kernel H's int8 mode). One template over the
// rows' element type E: bf16 (kernel I), and __half and float (kernel If,
// the int8 write of a float16 or float32 model's rows: the entry points
// suffixed `_f16` and `_f32`).
//
// Replaces the TPU kernel llm_inference_engine_tpu/ops/kv_cache.py
// `_write_kernel_quant` (launched by `_write_pallas(quantized=True)`), which
// DMAs int8 values [T, K, D] and f32 scales [T, K] of each sequence into
// cache[layer, b, starts[b]:starts[b]+T] and scales[layer, b, ...], and the
// int8 mode of llm_inference_engine_tpu/ops/paged_kv.py `_paged_write_kernel`
// on the JAX package's int8 pool. The JAX package quantizes in XLA ahead of
// its copy kernels; here the quantize is fused into the write
// (kv_quant.cuh), so the rows are read once and no int8 intermediate goes
// through device memory.
//
// Layout: new rows E [B, T, K, D]; slot: values int8 [L, B, S, K, D],
// scales f32 [L, B, S, K]; paged (PAGED): values int8 [L, P, page, K, D],
// scales f32 [L, P, page, K]; all contiguous. Row t of sequence b, at
// position pos = starts[b] + t, is written when t < new_len[b] and
//   slot:  0 <= pos < S, at token [layer, b, pos];
//   paged: 0 <= pos < max_pages * page, at [layer, table[b, pos / page],
//          pos % page], each row translated through the table on its own
//          (kernel H's rules: only table entries of written rows are read).
// Other rows (padding, sequences with new_len == 0, anything past the end)
// are never written. SNAPPED picks the log2-snapped scale numerics (the
// pool always uses them), otherwise absmax / 127 (kv_quant.cuh). Every
// element type rounds alike: a value is converted to f32 exactly and
// quantized by the same instructions, so an f16 or f32 row is written bit
// for bit as the plain version and kvq::quantize_row_strided (kernel D's
// fused float write) write it.
//
// Bound: HBM bytes (2 x rows x K x D x sizeof(E) bytes read, a byte a value
// plus 4 bytes per (token, head) written). The quantize is the next cost:
// the card's issue slots nearly match its memory here, so every value
// takes a handful of full-rate instructions (kv_quant.cuh), and what a
// thread pays once (its row, addresses, the scale) is spread over the
// values it holds. Design:
//   - a group of W lanes holds a row, each lane two 16-byte pieces (32
//     contiguous bytes: 16 values of a 2-byte E, 8 of f32): W is the
//     smallest power of two whose lanes cover D (bf16 / f16: 1, 4, 8, 8,
//     8, 16 at D = 16, 64, 80, 96, 128, 256; f32 twice that), so a warp
//     holds 32 / W rows at once; D = 80 and 96 leave the group's lanes past
//     the row idle; a lane stores its int8 values at once (16 bytes of a
//     2-byte E, 8 of f32);
//   - a block's rows are a run of the flat order (t, k|v, head) of one
//     sequence: neighbouring groups take neighbouring heads of one token,
//     so a warp reads and writes contiguous spans;
//   - a row's source does not depend on the table, so its two loads and
//     its table entry's are in flight together;
//   - a warp computes the scales of its G = 32 / W rows at once, each lane
//     one row's, and shuffles them back: the log2, exp2 and divides of a
//     scale are paid once a row, not once a lane;
//   - the first lane of each group stores its row's scale, so a warp
//     stores its G rows' scales, G neighbouring heads, as one contiguous
//     run; staging a block's scales in shared memory to store each
//     (token, k|v)'s K floats at once measured slower on the H100 (it put
//     a barrier and a second table read on every block's path);
//   - the grid runs over the padded rows of each sequence (the host does not
//     know new_len), and a block past min(new_len, T) rows exits at once.
// make_plan sets the grid; ops/kv_cache.py `write_quant_plan` mirrors it,
// and a CPU test holds that the blocks take every row once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "kv_quant.cuh"

namespace {

constexpr int kThreads = 256;

// Where the rows go: slot (B, S) or paged (table, P, page, max_pages).
struct Dest {
  int layer, B, S;
  const int* table;
  int P, page, max_pages;
};

// The table entry of position pos of sequence b, -1 past the table's reach
// (slot: 0 inside the cache, else -1). It is checked against [0, P) only
// where it is used, so that its load stays in flight meanwhile.
template <bool PAGED>
__device__ __forceinline__ int entry_of(const Dest& d, int b, long long pos) {
  if (PAGED) {
    if (pos < 0 || pos >= (long long)d.max_pages * d.page ||
        pos > 0x7fffffff)
      return -1;
    return d.table[(size_t)b * d.max_pages + (int)pos / d.page];
  }
  return pos >= 0 && pos < d.S ? 0 : -1;
}

// The token row of [L, *, K] that position pos of sequence b lands at, or
// -1 when the row is not written (entry from entry_of).
template <bool PAGED>
__device__ __forceinline__ long long token_row(const Dest& d, int b,
                                               long long pos, int entry) {
  if (PAGED) {
    if (entry < 0 || entry >= d.P) return -1;
    // entry_of checked that pos fits an int
    return ((long long)d.layer * d.P + entry) * d.page + (int)pos % d.page;
  }
  if (entry < 0) return -1;
  return ((long long)d.layer * d.B + b) * d.S + pos;
}

// Lanes a row of D values of esize bytes: the smallest power of two whose
// lanes, 32 bytes each, cover the row.
__host__ __device__ constexpr int lanes_a_row(int D, int esize) {
  return D * esize <= 32 ? 1 : D * esize <= 64 ? 2 : D * esize <= 128 ? 4
       : D * esize <= 256 ? 8 : D * esize <= 512 ? 16 : 32;
}

// The launch: kThreads / lanes rows of the flat (t, k|v, head) order a
// block, grid (blocks_x, B).
struct Plan {
  int lanes, rows_per_block, blocks_x;
};

Plan make_plan(int T, int K, int D, int esize) {
  const int lanes = lanes_a_row(D, esize);
  const int rb = kThreads / lanes;
  return {lanes, rb, (int)((2LL * T * K + rb - 1) / rb)};
}

// The largest |x| of a lane's two 16-byte pieces, unpacked to f32 into x
// and y (f32 rows: all 8 values into x).
template <typename E>
__device__ __forceinline__ float lane_absmax(const uint4 (&raw)[2],
                                             float x[8], float y[8]) {
  if constexpr (sizeof(E) == 4)
    return fmaxf(kvq::piece_absmax4(raw[0], x),
                 kvq::piece_absmax4(raw[1], x + 4));
  else if constexpr (std::is_same<E, __half>::value)
    return fmaxf(kvq::piece_absmax_f16(raw[0], x),
                 kvq::piece_absmax_f16(raw[1], y));
  else
    return fmaxf(kvq::piece_absmax(raw[0], x), kvq::piece_absmax(raw[1], y));
}

template <typename E, int D, bool SNAPPED, bool PAGED>
__global__ void __launch_bounds__(kThreads)
kv_write_quant_kernel(const E* __restrict__ k_new,
                      const E* __restrict__ v_new,
                      signed char* __restrict__ k_cache,
                      signed char* __restrict__ v_cache,
                      float* __restrict__ k_scale,
                      float* __restrict__ v_scale,
                      const int* __restrict__ starts,
                      const int* __restrict__ new_len, Dest dest, int T,
                      int K) {
  constexpr int W = lanes_a_row(D, (int)sizeof(E));
  constexpr int G = 32 / W;                  // rows a warp holds
  constexpr int kRows = kThreads / W;        // rows a block holds
  constexpr int kLaneVals = 32 / (int)sizeof(E);  // values a lane holds
  const int b = blockIdx.y;
  const long long start = starts[b];
  const int n_tok = max(min(new_len[b], T), 0);
  const int rows_a_token = 2 * K;            // K k rows, then K v rows
  const int r = blockIdx.x * kRows + threadIdx.x / W;  // the thread's row
  if (blockIdx.x * kRows >= n_tok * rows_a_token) return;  // block-uniform
  const int lane = threadIdx.x % 32;
  // the lane's two pieces: values [kLaneVals p, kLaneVals (p + 1)) of its
  // row
  const int p = lane % W;
  const bool has = kLaneVals * p < D;
  const int t = r / rows_a_token;
  const int head = r - t * rows_a_token;
  const bool v = head >= K;
  const int kh = v ? head - K : head;
  uint4 raw[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  int entry = -1;
  if (t < n_tok) {
    const uint4* src = reinterpret_cast<const uint4*>(
        (v ? v_new : k_new) + (((size_t)b * T + t) * K + kh) * D);
    if (has) {
      raw[0] = __ldg(src + 2 * p);
      raw[1] = __ldg(src + 2 * p + 1);
    }
    entry = entry_of<PAGED>(dest, b, start + t);
  }
  // the row's absmax, reduced over its group; lane l computes the scale
  // (and its reciprocal) of the warp's row l % G, then each lane takes its
  // own row's; x and y keep the lane's values for the quantize (f32: all 8
  // in x)
  float x[8], y[8];
  const float amax = kvq::group_max<W>(lane_absmax<E>(raw, x, y));
  const float mine = kvq::row_scale<SNAPPED>(
      __shfl_sync(0xffffffffu, amax, lane % G * W));
  const float mine_recip = kvq::divide_recip(mine);
  const float scale = __shfl_sync(0xffffffffu, mine, lane / W);
  const float recip = __shfl_sync(0xffffffffu, mine_recip, lane / W);
  const long long row = token_row<PAGED>(dest, b, start + t, entry);
  if (row >= 0 && has) {
    if constexpr (sizeof(E) == 4) {
      reinterpret_cast<uint2*>((v ? v_cache : k_cache) + (row * K + kh) * D)[p] =
          kvq::quantize_piece(x, scale, recip);
    } else {
      const uint2 lo = kvq::quantize_piece(x, scale, recip);
      const uint2 hi = kvq::quantize_piece(y, scale, recip);
      reinterpret_cast<uint4*>((v ? v_cache : k_cache) + (row * K + kh) * D)[p] =
          make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    if (p == 0) (v ? v_scale : k_scale)[row * K + kh] = scale;
  }
}

template <typename E, int D, bool SNAPPED, bool PAGED>
int launch(const void* k_new, const void* v_new, void* k_cache,
           void* v_cache, void* k_scale, void* v_scale, const int* starts,
           const int* new_len, const Dest& dest, int B, int T, int K,
           cudaStream_t stream) {
  const Plan pl = make_plan(T, K, D, (int)sizeof(E));
  kv_write_quant_kernel<E, D, SNAPPED, PAGED>
      <<<dim3(pl.blocks_x, B), kThreads, 0, stream>>>(
          (const E*)k_new, (const E*)v_new, (signed char*)k_cache,
          (signed char*)v_cache, (float*)k_scale, (float*)v_scale, starts,
          new_len, dest, T, K);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, void*, void*, void*,
                         void*, const int*, const int*, const Dest&, int,
                         int, int, cudaStream_t);

template <typename E, int D, bool PAGED>
LaunchFn pick_numerics(int snapped) {
  return snapped ? &launch<E, D, true, PAGED> : &launch<E, D, false, PAGED>;
}

// The instance of bf16 rows (kernel I) at head_dim D, null for none.
template <typename E, bool PAGED>
LaunchFn pick_bf16(int D, int snapped) {
  switch (D) {
    case 64: return pick_numerics<E, 64, PAGED>(snapped);
    case 80: return pick_numerics<E, 80, PAGED>(snapped);
    case 96: return pick_numerics<E, 96, PAGED>(snapped);
    case 128: return pick_numerics<E, 128, PAGED>(snapped);
    case 256: return pick_numerics<E, 256, PAGED>(snapped);
    default: return nullptr;
  }
}

// The instance of f16 or f32 rows (kernel If) at head_dim D, null for none.
template <typename E, bool PAGED>
LaunchFn pick_float(int D, int snapped) {
  switch (D) {
    case 16: return pick_numerics<E, 16, PAGED>(snapped);
    case 64: return pick_numerics<E, 64, PAGED>(snapped);
    case 80: return pick_numerics<E, 80, PAGED>(snapped);
    case 96: return pick_numerics<E, 96, PAGED>(snapped);
    case 128: return pick_numerics<E, 128, PAGED>(snapped);
    case 256: return pick_numerics<E, 256, PAGED>(snapped);
    default: return nullptr;
  }
}

template <typename E, bool PAGED>
LaunchFn pick(int D, int snapped) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value)
    return pick_bf16<E, PAGED>(D, snapped);
  else
    return pick_float<E, PAGED>(D, snapped);
}

template <typename E>
int slot_entry(const void* k_new, const void* v_new, void* k_cache,
               void* v_cache, void* k_scale, void* v_scale,
               const int* starts, const int* new_len, int layer, int B,
               int T, int K, int S, int D, int snapped, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  LaunchFn fn = pick<E, false>(D, snapped);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const Dest dest{layer, B, S, nullptr, 0, 0, 0};
  return fn(k_new, v_new, k_cache, v_cache, k_scale, v_scale, starts,
            new_len, dest, B, T, K, (cudaStream_t)stream);
}

template <typename E>
int paged_entry(const void* k_new, const void* v_new, void* k_pool,
                void* v_pool, void* k_scale, void* v_scale,
                const int* starts, const int* new_len, const int* table,
                int layer, int B, int T, int K, int P, int page,
                int max_pages, int D, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  LaunchFn fn = pick<E, true>(D, 1);
  if (page <= 0 || max_pages <= 0 || P <= 0 || fn == nullptr)
    return (int)cudaErrorInvalidValue;
  const Dest dest{layer, B, 0, table, P, page, max_pages};
  return fn(k_new, v_new, k_pool, v_pool, k_scale, v_scale, starts,
            new_len, dest, B, T, K, (cudaStream_t)stream);
}

template <typename E>
int plan_entry(int B, int T, int K, int D, int* out) {
  if (B <= 0 || T <= 0 || K <= 0 || pick<E, false>(D, 0) == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(T, K, D, (int)sizeof(E));
  const int vals[5] = {kThreads, pl.lanes, pl.rows_per_block, pl.blocks_x,
                       B};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace

// The slot cache, bf16 rows (kernel I): rows [B, T, K, D] quantized (snapped != 0:
// log2-snapped scales, else absmax / 127) into [layer, b, starts[b] + t].
extern "C" int kv_write_quant(const void* k_new, const void* v_new,
                              void* k_cache, void* v_cache, void* k_scale,
                              void* v_scale, const int* starts,
                              const int* new_len, int layer, int B, int T,
                              int K, int S, int D, int snapped,
                              void* stream) {
  return slot_entry<__nv_bfloat16>(k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                         starts, new_len, layer, B, T, K, S, D, snapped,
                         stream);
}

// The pool, bf16 rows (kernel I): through the block table, snapped scales.
extern "C" int paged_kv_write_quant(const void* k_new,
                                    const void* v_new, void* k_pool,
                                    void* v_pool, void* k_scale,
                                    void* v_scale, const int* starts,
                                    const int* new_len, const int* table,
                                    int layer, int B, int T, int K, int P,
                                    int page, int max_pages, int D,
                                    void* stream) {
  return paged_entry<__nv_bfloat16>(k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                          starts, new_len, table, layer, B, T, K, P, page,
                          max_pages, D, stream);
}

// The launch of the two above at these shapes: out = {threads, lanes a
// row, rows a block, blocks_x, blocks_y}.
extern "C" int kv_write_quant_plan(int B, int T, int K, int D,
                                   int* out) {
  return plan_entry<__nv_bfloat16>(B, T, K, D, out);
}

// The slot cache, float16 rows (kernel If): rows [B, T, K, D] quantized (snapped != 0:
// log2-snapped scales, else absmax / 127) into [layer, b, starts[b] + t].
extern "C" int kv_write_quant_f16(const void* k_new, const void* v_new,
                              void* k_cache, void* v_cache, void* k_scale,
                              void* v_scale, const int* starts,
                              const int* new_len, int layer, int B, int T,
                              int K, int S, int D, int snapped,
                              void* stream) {
  return slot_entry<__half>(k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                         starts, new_len, layer, B, T, K, S, D, snapped,
                         stream);
}

// The pool, float16 rows (kernel If): through the block table, snapped scales.
extern "C" int paged_kv_write_quant_f16(const void* k_new,
                                    const void* v_new, void* k_pool,
                                    void* v_pool, void* k_scale,
                                    void* v_scale, const int* starts,
                                    const int* new_len, const int* table,
                                    int layer, int B, int T, int K, int P,
                                    int page, int max_pages, int D,
                                    void* stream) {
  return paged_entry<__half>(k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                          starts, new_len, table, layer, B, T, K, P, page,
                          max_pages, D, stream);
}

// The launch of the two above at these shapes: out = {threads, lanes a
// row, rows a block, blocks_x, blocks_y}.
extern "C" int kv_write_quant_plan_f16(int B, int T, int K, int D,
                                   int* out) {
  return plan_entry<__half>(B, T, K, D, out);
}

// The slot cache, float32 rows (kernel If): rows [B, T, K, D] quantized (snapped != 0:
// log2-snapped scales, else absmax / 127) into [layer, b, starts[b] + t].
extern "C" int kv_write_quant_f32(const void* k_new, const void* v_new,
                              void* k_cache, void* v_cache, void* k_scale,
                              void* v_scale, const int* starts,
                              const int* new_len, int layer, int B, int T,
                              int K, int S, int D, int snapped,
                              void* stream) {
  return slot_entry<float>(k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                         starts, new_len, layer, B, T, K, S, D, snapped,
                         stream);
}

// The pool, float32 rows (kernel If): through the block table, snapped scales.
extern "C" int paged_kv_write_quant_f32(const void* k_new,
                                    const void* v_new, void* k_pool,
                                    void* v_pool, void* k_scale,
                                    void* v_scale, const int* starts,
                                    const int* new_len, const int* table,
                                    int layer, int B, int T, int K, int P,
                                    int page, int max_pages, int D,
                                    void* stream) {
  return paged_entry<float>(k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                          starts, new_len, table, layer, B, T, K, P, page,
                          max_pages, D, stream);
}

// The launch of the two above at these shapes: out = {threads, lanes a
// row, rows a block, blocks_x, blocks_y}.
extern "C" int kv_write_quant_plan_f32(int B, int T, int K, int D,
                                   int* out) {
  return plan_entry<float>(B, T, K, D, out);
}

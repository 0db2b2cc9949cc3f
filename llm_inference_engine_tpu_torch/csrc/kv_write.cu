// Kernels C and H (bf16): write new K/V token rows into the stacked slot
// cache (`kv_write`, kernel C) or, through the block table, into the paged
// pool (`paged_kv_write`, kernel H), in place. One template, PAGED.
//
// Replaces two TPU kernels of the JAX package:
//   - llm_inference_engine_tpu/ops/kv_cache.py `_write_kernel` (launched by
//     `_write_pallas`), which DMAs each sequence's [T, K, D] span into
//     cache[layer, b, starts[b]:starts[b]+T];
//   - llm_inference_engine_tpu/ops/paged_kv.py `_paged_write_kernel`
//     (launched by `_paged_write_pallas`) on a bf16 pool, which DMAs a
//     chunk row's [T, K, D] window into one page (the chunk starts
//     page-aligned) and a decode row's one token at any in-page offset.
//     The engine's pure-decode steps write through kernel D's fused paged
//     decode (attention_decode.cu) instead; this kernel serves prefill
//     chunks and mixed steps.
//
// Layout: new rows [B, T, K, D]; slot cache [L, B, S, K, D], pool
// [L, P, page, K, D]; all contiguous and token-major, so one token's K*D
// values are one contiguous row of `row_bytes` bytes. Row t of sequence b,
// at position pos = starts[b] + t, is written when t < new_len[b] and
//   slot:  0 <= pos < S, at [layer, b, pos];
//   paged: 0 <= pos < max_pages * page and 0 <= e < P for the table entry
//          e = table[b, pos / page], at [layer, e, pos % page]; each row is
//          translated through the table on its own, so one launch serves
//          chunk rows and decode rows alike and no row relies on the
//          engine's page-alignment invariant; only the entries of rows
//          t < new_len inside the table's reach are read.
// Other rows (padding, sequences with new_len == 0, anything past the end)
// are never written. The kernel copies bytes: the element type does not
// matter (bf16 and f32 caches both work).
//
// Bound: HBM bytes (2 x rows x row_bytes read and written). A block a row
// would leave narrow rows bound by block scheduling and latency, not bytes
// (a 256-byte row is 16 vectors: a block of a few threads), and a small
// launch (a decode step's rows, a short chunk) by its dependent loads.
// Design:
//   - a block of kThreads takes a run of whole rows of one sequence in the
//     flat order r = 2 t + (k|v): as many rows as fit kBlockVecs 16-byte
//     vectors (8 KB), so a block moves about 8 KB at any K x D; a row of 4
//     KB or more takes a block of its own (at 7B widths a row is 8 KB; at
//     a tp = 2 rank's 4 KB rows two rows a block left a short chunk on
//     half as many SMs and timed slower); a row wider than 8 KB takes
//     passes of 8 KB;
//   - a thread holds up to kVecs vectors of a pass, neighbouring threads on
//     neighbouring addresses; it issues all of its 16-byte loads, and in
//     the paged mode its rows' table entries beside them, before any of
//     its stores, so neither the source nor the table waits on the other;
//     the sequence's start is loaded beside its new_len, so a store waits
//     on two loads in turn (new_len, then the row or its table entry), and
//     a power-of-two row width or page size costs no integer division;
//   - the grid runs over the padded rows of each sequence (the host does
//     not know new_len), and a block past 2 x min(new_len, T) rows exits at
//     once.
// make_plan sets the grid; ops/kv_cache.py `write_plan` mirrors it, and a
// CPU test holds that the blocks take every row once.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVecs = 4;                          // vectors a thread a pass
constexpr int kBlockVecs = kThreads * kVecs;      // 512 vectors, 8 KB

// x / d and x % d for x >= 0, by a shift and a mask where d is a power of
// two (the usual row widths and page sizes): the index arithmetic sits on
// a small launch's critical path, and an integer division by a value known
// only at run time costs dozens of instructions.
struct Div {
  int d, shift;                                   // shift < 0: no power of 2
  __device__ __forceinline__ int quot(int x) const {
    return shift >= 0 ? x >> shift : x / d;
  }
  __device__ __forceinline__ int rem(int x) const {
    return shift >= 0 ? x & (d - 1) : x % d;
  }
};

Div make_div(int d) {
  int s = 0;
  while (s < 30 && (1 << s) < d) ++s;
  return {d, (1 << s) == d ? s : -1};
}

// Where the rows go: slot (B, S) or paged (table, P, page, max_pages).
struct Dest {
  int layer, B, S;
  const int* table;
  int P;
  Div page;
  int max_pages;
};

// The table entry of position pos of sequence b, -1 past the table's reach
// (slot: 0 inside the cache, else -1). It is checked against [0, P) only
// where it is used, so that its load stays in flight meanwhile.
template <bool PAGED>
__device__ __forceinline__ int entry_of(const Dest& d, int b, long long pos) {
  if (PAGED) {
    if (pos < 0 || pos >= (long long)d.max_pages * d.page.d ||
        pos > 0x7fffffff)
      return -1;
    return d.table[(size_t)b * d.max_pages + d.page.quot((int)pos)];
  }
  return pos >= 0 && pos < d.S ? 0 : -1;
}

// The token row of [L, *] that position pos of sequence b lands at, or -1
// when the row is not written (entry from entry_of).
template <bool PAGED>
__device__ __forceinline__ long long token_row(const Dest& d, int b,
                                               long long pos, int entry) {
  if (PAGED) {
    if (entry < 0 || entry >= d.P) return -1;
    // entry_of checked that pos fits an int
    return ((long long)d.layer * d.P + entry) * d.page.d +
           d.page.rem((int)pos);
  }
  if (entry < 0) return -1;
  return ((long long)d.layer * d.B + b) * d.S + pos;
}

// The launch: rows_per_block rows of the flat (t, k|v) order a block, grid
// (blocks_x, B), each block in `passes` passes of kBlockVecs vectors.
struct Plan {
  int rows_per_block, blocks_x, passes;
};

Plan make_plan(int T, int row_vecs) {
  const int rb = 2 * row_vecs >= kBlockVecs ? 1 : kBlockVecs / row_vecs;
  return {rb, (int)((2LL * T + rb - 1) / rb),
          (rb * row_vecs + kBlockVecs - 1) / kBlockVecs};
}

template <bool PAGED>
__global__ void __launch_bounds__(kThreads)
kv_write_kernel(const uint4* __restrict__ k_new,
                const uint4* __restrict__ v_new, uint4* __restrict__ k_cache,
                uint4* __restrict__ v_cache, const int* __restrict__ starts,
                const int* __restrict__ new_len, Dest dest, int T,
                Div row_vecs, int rows_per_block) {
  const int b = blockIdx.y;
  const int start = starts[b];
  const int n_rows = 2 * max(min(new_len[b], T), 0);
  const int r0 = blockIdx.x * rows_per_block;
  // block-uniform; a start of INT_MIN puts every row at a negative
  // position, which is never written, and testing it keeps the start's
  // load beside new_len's (a load used only past the exit is sunk past it)
  if (r0 >= n_rows || start == INT_MIN) return;
  const int n_vecs = (min(r0 + rows_per_block, n_rows) - r0) * row_vecs.d;
  // vector i of the run is column i % row_vecs of row r0 + i / row_vecs; a
  // thread's next vector, kThreads on, is step_r rows and step_c columns
  // on (Div above: a pass splits one index, not one a vector)
  const int step_r = row_vecs.quot(kThreads);
  const int step_c = row_vecs.rem(kThreads);
  for (int pass = 0; pass < n_vecs; pass += kBlockVecs) {
    uint4 val[kVecs];
    int col[kVecs], tok[kVecs], entry[kVecs];
    bool is_v[kVecs];
    int r = row_vecs.quot(pass + (int)threadIdx.x);
    int c = row_vecs.rem(pass + (int)threadIdx.x);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      entry[j] = -1;
      if (pass + j * kThreads + (int)threadIdx.x < n_vecs) {
        col[j] = c;
        tok[j] = (r0 + r) >> 1;
        is_v[j] = (r0 + r) & 1;
        val[j] = __ldg((is_v[j] ? v_new : k_new) +
                       ((size_t)b * T + tok[j]) * row_vecs.d + col[j]);
        // a token's table entry (and below its row) once: at 7B widths a
        // thread's 4 vectors are one row's
        entry[j] = j > 0 && tok[j] == tok[j - 1]
                       ? entry[j - 1]
                       : entry_of<PAGED>(dest, b, (long long)start + tok[j]);
      }
      r += step_r;
      c += step_c;
      if (c >= row_vecs.d) {
        c -= row_vecs.d;
        ++r;
      }
    }
    long long row = -1;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (pass + j * kThreads + (int)threadIdx.x >= n_vecs) break;
      if (j == 0 || tok[j] != tok[j - 1])
        row = token_row<PAGED>(dest, b, (long long)start + tok[j], entry[j]);
      if (row >= 0)
        (is_v[j] ? v_cache : k_cache)[row * row_vecs.d + col[j]] = val[j];
    }
  }
}

template <bool PAGED>
int launch(const void* k_new, const void* v_new, void* k_cache,
           void* v_cache, const int* starts, const int* new_len,
           const Dest& dest, int B, int T, int row_vecs,
           cudaStream_t stream) {
  const Plan pl = make_plan(T, row_vecs);
  kv_write_kernel<PAGED><<<dim3(pl.blocks_x, B), kThreads, 0, stream>>>(
      (const uint4*)k_new, (const uint4*)v_new, (uint4*)k_cache,
      (uint4*)v_cache, starts, new_len, dest, T, make_div(row_vecs),
      pl.rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kv_write(const void* k_new, const void* v_new, void* k_cache,
                        void* v_cache, const int* starts, const int* new_len,
                        int layer, int B, int T, int S, int row_bytes,
                        void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16) return (int)cudaErrorInvalidValue;
  const Dest dest{layer, B, S, nullptr, 0, make_div(1), 0};
  return launch<false>(k_new, v_new, k_cache, v_cache, starts, new_len, dest,
                       B, T, row_bytes / 16, (cudaStream_t)stream);
}

extern "C" int paged_kv_write(const void* k_new, const void* v_new,
                              void* k_pool, void* v_pool, const int* starts,
                              const int* new_len, const int* table, int layer,
                              int B, int T, int P, int page, int max_pages,
                              int row_bytes, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (page <= 0 || max_pages <= 0 || P <= 0 || row_bytes <= 0 ||
      row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const Dest dest{layer, B, 0, table, P, make_div(page), max_pages};
  return launch<true>(k_new, v_new, k_pool, v_pool, starts, new_len, dest, B,
                      T, row_bytes / 16, (cudaStream_t)stream);
}

// The launch of kv_write / paged_kv_write at these shapes: out = {threads,
// vectors a thread a pass, rows a block, blocks_x, blocks_y, passes}.
extern "C" int kv_write_plan(int B, int T, int row_bytes, int* out) {
  if (B <= 0 || T <= 0 || row_bytes <= 0 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(T, row_bytes / 16);
  const int vals[6] = {kThreads, kVecs, pl.rows_per_block, pl.blocks_x, B,
                       pl.passes};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

// Kernel D's bfloat16 instances (attention_decode.cuh): the fused slot and
// paged decodes over a bf16 or int8 cache or pool (a pool given no new
// rows attends only).

#include "attention_decode.cuh"

namespace {

template <typename E, bool PAGED, bool INT8, bool WRITE_NEW>
int dispatch(const Params<E>& p, int D, cudaStream_t stream, int* report) {
  switch (D) {
    case 64: return run<E, 64, PAGED, INT8, WRITE_NEW>(p, stream, report);
    case 80: return run<E, 80, PAGED, INT8, WRITE_NEW>(p, stream, report);
    case 96: return run<E, 96, PAGED, INT8, WRITE_NEW>(p, stream, report);
    case 128: return run<E, 128, PAGED, INT8, WRITE_NEW>(p, stream, report);
    case 256: return run<E, 256, PAGED, INT8, WRITE_NEW>(p, stream, report);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Decode over the bf16 slot cache with the new token's K/V write.
extern "C" int attention_decode(const void* q, const void* k_new,
                                const void* v_new, void* k_cache,
                                void* v_cache, void* out, const int* q_start,
                                const int* kv_len, int layer, int B, int H,
                                int K, int S, int D, float sm_scale,
                                int window, void* stream) {
  return slot_entry<__nv_bfloat16, false>(q, k_new, v_new, k_cache, v_cache, nullptr,
                               nullptr, out, q_start, kv_len, layer, B, H, K,
                               S, D, sm_scale, window, 0, stream);
}

// Decode over the bf16 paged pool with the new token's K/V write through
// the table (kernel H's rules).
extern "C" int attention_decode_paged_fused(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, void* out, const int* q_start, const int* kv_len,
    const int* table, int layer, int B, int H, int K, int P, int page,
    int max_pages, int D, float sm_scale, int window, void* stream) {
  return paged_entry<__nv_bfloat16, false>(q, k_new, v_new, k_pool, v_pool, nullptr,
                                nullptr, out, q_start, kv_len, table, layer,
                                B, H, K, P, page, max_pages, D, sm_scale,
                                window, stream);
}

// Attend-only decode over the bf16 paged pool, after kernel H wrote the
// token: the fused instance with no new rows.
extern "C" int attention_decode_paged(const void* q, const void* k_pool,
                                      const void* v_pool, void* out,
                                      const int* q_start, const int* kv_len,
                                      const int* table, int layer, int B,
                                      int H, int K, int P, int page,
                                      int max_pages, int D, float sm_scale,
                                      int window, void* stream) {
  return paged_entry<__nv_bfloat16, false>(q, nullptr, nullptr, (void*)k_pool,
                                (void*)v_pool, nullptr, nullptr, out, q_start,
                                kv_len, table, layer, B, H, K, P, page,
                                max_pages, D, sm_scale, window, stream);
}

// Decode over the int8 slot cache: the new token's K/V rows are quantized
// (snapped != 0: log2-snapped scales, else absmax / 127) and written with
// their scales, then attended.
extern "C" int attention_decode_int8(const void* q, const void* k_new,
                                     const void* v_new, void* k_cache,
                                     void* v_cache, void* k_scale,
                                     void* v_scale, void* out,
                                     const int* q_start, const int* kv_len,
                                     int layer, int B, int H, int K, int S,
                                     int D, float sm_scale, int window,
                                     int snapped, void* stream) {
  return slot_entry<__nv_bfloat16, true>(q, k_new, v_new, k_cache, v_cache, k_scale,
                              v_scale, out, q_start, kv_len, layer, B, H, K,
                              S, D, sm_scale, window, snapped, stream);
}

// Decode over the int8 paged pool with the new token's K/V write: the
// rows quantized with snapped scales (kernel H's int8 mode's bits) and
// written with their scales through the table (kernel H's rules), then
// attended.
extern "C" int attention_decode_paged_fused_int8(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, void* out,
    const int* q_start, const int* kv_len, const int* table, int layer,
    int B, int H, int K, int P, int page, int max_pages, int D,
    float sm_scale, int window, void* stream) {
  return paged_entry<__nv_bfloat16, true>(q, k_new, v_new, k_pool, v_pool, k_scale,
                               v_scale, out, q_start, kv_len, table, layer,
                               B, H, K, P, page, max_pages, D, sm_scale,
                               window, stream);
}

// Attend-only decode over the int8 paged pool, after kernel H's int8 mode
// (or If) wrote the token: the fused int8 instance with no new rows.
extern "C" int attention_decode_paged_int8(
    const void* q, const void* k_pool, const void* v_pool, void* k_scale,
    void* v_scale, void* out, const int* q_start, const int* kv_len,
    const int* table, int layer, int B, int H, int K, int P, int page,
    int max_pages, int D, float sm_scale, int window, void* stream) {
  return paged_entry<__nv_bfloat16, true>(q, nullptr, nullptr, (void*)k_pool,
                               (void*)v_pool, k_scale, v_scale, out, q_start,
                               kv_len, table, layer, B, H, K, P, page,
                               max_pages, D, sm_scale, window, stream);
}

// The split plan of a decode launch at these shapes (paged: page and
// max_pages > 0), for reports: out = {nsplit, query heads a block, tile
// keys, ring stages, dynamic shared memory bytes, blocks an SM holds,
// clusters the card holds}.
extern "C" int attention_decode_plan(int B, int H, int K, int D,
                                     int int8, int page, int max_pages,
                                     int* out) {
  return plan_entry<__nv_bfloat16>(B, H, K, D, int8, page, max_pages, out);
}

// The residency kernel D's plan reads at head_dim D (clusters_entry):
// out[8 i + n - 1] = clusters of n blocks of the R = 4 (i = 0) or R = 8
// (i = 1) slot instance the card holds at once.
extern "C" int attention_decode_clusters(int D, int int8, int* out) {
  return clusters_entry<__nv_bfloat16>(D, int8, out);
}

#ifdef PLAN_SWEEP
// tools/plan_sweep.py only: force the plan at G > 1 (rows 0: the plan's)
extern "C" void attention_decode_force_plan(int rows, int nsplit) {
  g_force_rows = rows;
  g_force_nsplit = nsplit;
}
#endif

// Kernel D2f's float16 instances: kernel D2's tensor-core template
// (attention_prefill.cuh) over __half, mma.sync m16n8k16 f16 -> f32, p
// rounded to f16 before PV; a float16 or int8 slot cache or pool.

#include "attention_prefill.cuh"

namespace {

template <typename E, bool PAGED, bool INT8>
int dispatch(const Params<E>& p, int D, cudaStream_t stream, int* report) {
  switch (D) {
    case 16: return launch<E, 16, PAGED, INT8>(p, stream, report);
    case 64: return launch<E, 64, PAGED, INT8>(p, stream, report);
    case 80: return launch<E, 80, PAGED, INT8>(p, stream, report);
    case 96: return launch<E, 96, PAGED, INT8>(p, stream, report);
    case 128: return launch<E, 128, PAGED, INT8>(p, stream, report);
    case 256: return launch<E, 256, PAGED, INT8>(p, stream, report);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Prefill / chunked prefill over the float16 slot cache.
extern "C" int attention_prefill_f16(const void* q, const void* k_cache,
                                 const void* v_cache, void* out,
                                 const int* q_start, const int* kv_len,
                                 int layer, int B, int T, int H, int K, int S,
                                 int D, float sm_scale, int window,
                                 void* stream) {
  return run_entry<__half, false, false>(
      q, k_cache, v_cache, nullptr, nullptr, out, q_start, kv_len, nullptr,
      layer, B, T, H, K, S, 0, 0, 0, D, sm_scale, window, stream);
}

// Prefill / chunked prefill / mixed steps over the float16 paged pool.
extern "C" int attention_prefill_paged_f16(const void* q, const void* k_pool,
                                       const void* v_pool, void* out,
                                       const int* q_start, const int* kv_len,
                                       const int* table, int layer, int B,
                                       int T, int H, int K, int P, int page,
                                       int max_pages, int D, float sm_scale,
                                       int window, void* stream) {
  return run_entry<__half, true, false>(
      q, k_pool, v_pool, nullptr, nullptr, out, q_start, kv_len, table, layer,
      B, T, H, K, 0, P, page, max_pages, D, sm_scale, window, stream);
}

// Prefill / chunked prefill over the int8 slot cache.
extern "C" int attention_prefill_int8_f16(const void* q, const void* k_cache,
                                      const void* v_cache, void* k_scale,
                                      void* v_scale, void* out,
                                      const int* q_start, const int* kv_len,
                                      int layer, int B, int T, int H, int K,
                                      int S, int D, float sm_scale,
                                      int window, void* stream) {
  return run_entry<__half, false, true>(
      q, k_cache, v_cache, k_scale, v_scale, out, q_start, kv_len, nullptr,
      layer, B, T, H, K, S, 0, 0, 0, D, sm_scale, window, stream);
}

// Prefill / chunked prefill / mixed steps over the int8 paged pool.
extern "C" int attention_prefill_paged_int8_f16(
    const void* q, const void* k_pool, const void* v_pool, void* k_scale,
    void* v_scale, void* out, const int* q_start, const int* kv_len,
    const int* table, int layer, int B, int T, int H, int K, int P, int page,
    int max_pages, int D, float sm_scale, int window, void* stream) {
  return run_entry<__half, true, true>(
      q, k_pool, v_pool, k_scale, v_scale, out, q_start, kv_len, table, layer,
      B, T, H, K, 0, P, page, max_pages, D, sm_scale, window, stream);
}

// The tiling of a prefill launch at head_dim D (int8 != 0: an int8 cache;
// the paged modes tile alike), for reports: out = {tile keys, ring
// stages, dynamic shared memory bytes a block}.
extern "C" int attention_prefill_plan_f16(int D, int int8, int* out) {
  return plan_entry<__half>(D, int8, out);
}

// Kernels Ef and Ff, float16 instances: float16 activations times INT4 /
// INT8 weights, kernels E and F's template (quant_matmul.cuh) over __half,
// on the same tensor cores (mma.sync and wgmma .f16 with f32 sums; the
// weights dequantized exactly into f16 pairs). Replace the JAX package's
// ops/quant.py `_int4_matmul_kernel` and `_int8_matmul_kernel` for a
// float16 model: each f16 x times an int value is exact in f32, so only
// the order of summation differs from the JAX kernels' f32 dot.

#include "quant_matmul.cuh"

// Ef: x f16 [m, k] times the packed INT4 weight; out f16 or f32. qd: the
// same weight in fragment order (the fragment mode, m <= 16).
extern "C" int int4_matmul_f16(const void* x, const void* q, const void* qd,
                               const void* scale, void* out, int m, int k,
                               int n, int halves, long long q_half,
                               long long s_half, int group, int out_f32,
                               void* stream) {
  return int4_entry<__half, dispatch<__half, true>>(
      x, q, qd, scale, out, m, k, n, halves, q_half, s_half, group, out_f32,
      stream);
}

// Ff: x f16 [m, k] times the INT8 weight; out f16 or f32.
extern "C" int int8_matmul_f16(const void* x, const void* q,
                               const void* scale, void* out, int m, int k,
                               int n, int halves, long long q_half,
                               long long s_half, int out_f32, void* stream) {
  return int8_entry<__half, dispatch<__half, false>>(
      x, q, scale, out, m, k, n, halves, q_half, s_half, out_f32, stream);
}

// The plan of Ef (int4 != 0) or Ff's float16 instance (plan_entry).
extern "C" int quant_matmul_plan_f16(int m, int k, int n, int halves,
                                     int int4, int group, int* out) {
  return plan_entry<__half, dispatch<__half, true>, dispatch<__half, false>>(
      m, k, n, halves, int4, group, out);
}

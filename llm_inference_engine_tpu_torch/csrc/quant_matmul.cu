// Kernels E and F: bf16 activations times INT4 / INT8 weights, the
// dequantization fused into the matmul (the template and its design:
// quant_matmul.cuh). Replace the JAX package's ops/quant.py
// `_int4_matmul_kernel` and `_int8_matmul_kernel` for a bf16 model.

#include "quant_matmul.cuh"

using BF16 = __nv_bfloat16;

// Kernel E: x bf16 [m, k] times the packed INT4 weight [halves][k/2, n]
// with grouped scales; out bf16 or f32. qd: the same weight in fragment
// order, which the fragment mode (m <= 16) reads.
extern "C" int int4_matmul(const void* x, const void* q, const void* qd,
                           const void* scale, void* out, int m, int k, int n,
                           int halves, long long q_half, long long s_half,
                           int group, int out_f32, void* stream) {
  return int4_entry<BF16, dispatch<BF16, true>>(
      x, q, qd, scale, out, m, k, n, halves, q_half, s_half, group, out_f32,
      stream);
}

// Kernel F: x bf16 [m, k] times the INT8 weight [halves][k, n], the
// per-channel scale after the f32 sum.
extern "C" int int8_matmul(const void* x, const void* q, const void* scale,
                           void* out, int m, int k, int n, int halves,
                           long long q_half, long long s_half, int out_f32,
                           void* stream) {
  return int8_entry<BF16, dispatch<BF16, false>>(
      x, q, scale, out, m, k, n, halves, q_half, s_half, out_f32, stream);
}

// The plan of kernel E (int4 != 0) or F at these shapes (plan_entry).
extern "C" int quant_matmul_plan(int m, int k, int n, int halves, int int4,
                                 int group, int* out) {
  return plan_entry<BF16, dispatch<BF16, true>, dispatch<BF16, false>>(
      m, k, n, halves, int4, group, out);
}

#ifdef PLAN_SWEEP
// tools/plan_sweep.py only: force the decode mode's cluster (0: the
// plan's) and the mode (0: the plan's, 1: prefill, 2: decode)
extern "C" void quant_matmul_force_plan(int cluster, int mode) {
  g_force_cluster = cluster;
  g_force_mode = mode;
}

// tools/plan_sweep.py only: force the fragment mode's column groups a
// block and blocks a cluster (0, 0: the plan's)
extern "C" void quant_matmul_force_fragment(int wc, int cs) {
  g_force_frag_wc = wc;
  g_force_frag_cs = cs;
}
#endif

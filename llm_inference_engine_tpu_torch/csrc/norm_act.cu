// Kernels A (RMSNorm, with or without a residual add), B (SiLU-and-mul)
// and J (the QKV split with RoPE).
//
// Replaces three TPU kernels of the JAX package:
//   - A: llm_inference_engine_tpu/ops/rmsnorm.py `_rmsnorm_kernel`, and
//     (RES) `_add_residual_rmsnorm_kernel`: h = x + r added in f32 and
//     stored in the storage dtype, y = h * rsqrt(mean(h^2) + eps) * w,
//     the sum of squares taken over the stored h in f32;
//   - B: llm_inference_engine_tpu/ops/activations.py `_silu_mul_kernel`:
//     silu(gate) * up of the packed [N, 2I] gate|up rows, in f32, rounded
//     once.
// Both are memory-bound on Hopper (a few operations a byte). At the
// decode step's shapes ([8, 4096] and [8, 22016]) they move 140-530 KB,
// which the card's HBM rate moves in 0.04-0.16 us: what a call costs there
// is its launch, one dependent global load, the reduction and the drain
// of the stores. The design removes what it can of that:
//   - A runs one block a row and keeps the row in registers: each thread
//     takes up to V 16-byte vectors (8 bf16 / f16 or 4 f32 values; one
//     value a load where a row is not 16-byte aligned), reduces the sum
//     of squares with warp shuffles (the warps' sums meet in warp 0, not
//     in a loop of shared-memory reads in every thread), and writes y
//     from its registers: one read of x (and r), one write of y (and h);
//   - B runs one thread per 8 (f32: 4) output columns of a row, 16-byte
//     loads of gate and up;
//   - both are launched as programmatic dependents
//     (cudaLaunchAttributeProgrammaticStreamSerialization): a block
//     becomes resident while the kernel before it runs, loads what is
//     constant (A: its norm weight), then waits in `griddepcontrol.wait`
//     for the previous kernel's results. Each calls
//     `griddepcontrol.launch_dependents` right after that wait, so the
//     kernel after it (kernel E's decode mode, which is launched the same
//     way) starts its weight ring while A or B runs, and never before the
//     kernel before A or B has finished: two weight-streaming E launches
//     never share the card, and each E finds the SMs as free as without
//     the attribute when its blocks are placed;
//   - A at one vector a thread keeps 4 blocks of 512 threads an SM (at
//     most 32 registers a thread), the occupancy of the kernel it
//     replaced, for the prefill's thousands of rows.
//
// J replaces no TPU kernel. The JAX package splits the packed qkv and
// rotates q and k in XLA, which fuses the rotation into the split
// (llm_inference_engine_tpu/ops/rope.py `split_qkv_rope_xla`; its Pallas
// rotation kernel was deleted there because the TPU's tiling forced two
// head-major transposes around it). Eager torch runs the same math as
// ten ops a rotation plus a copy of v, about twenty launches a layer; J
// is the fused pass: it reads the group-major qkv row once and writes q,
// k and v contiguous once. It is bound by its bytes (a few operations a
// value) and, at the decode step's 8 tokens, by its launch, so:
//   - a unit of work is one 16-byte vector of a head's first half and the
//     vector D/2 values on (the rotation's pair), with E f32 values of cos
//     and sin where the head is rotated (q and k; v is copied as read);
//     neighbouring threads take neighbouring vectors of a head, then the
//     next head, in the packed row's order;
//   - the units of all tokens are one flat range, one unit a thread, 256
//     threads a block: one round of loads a launch and few registers a
//     thread, so a prefill keeps 8 blocks an SM in flight and a decode
//     step's 8 tokens spread over 24 blocks at llama2-7b's widths (2, 4
//     or 8 units a thread, their loads batched before their products,
//     were slower at both shapes on an H100: registers cut the blocks an
//     SM holds, and each launch waits for more of them);
//   - torch's rounding, operation for operation: each product rounded to
//     f32, then the difference or the sum, then one rounding to the
//     element type (__fmul_rn, __fsub_rn, __fadd_rn: no FMA contraction),
//     so J's q, k and v equal the plain version's bit for bit;
//   - it is a programmatic dependent and reads nothing before the wait.
// The PDL rule of this repository, for every kernel launched with the
// attribute: before `griddepcontrol.wait` a kernel reads only constants
// (weights, scales, norm weights), prefetches tensor maps and initializes
// barriers and shared memory. Every read of an activation and every
// global store comes after the wait: with launches allowed to overlap,
// the caching allocator may hand a kernel an output buffer that the
// kernel before it is still reading. Without the attribute (or after a
// kernel that never triggers) the wait returns at once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes of the C entry points (ops/rmsnorm.py, ops/activations.py)
enum Dtype { kBF16 = 0, kF16 = 1, kF32 = 2 };

// A's instances: V vectors a thread, at most MAXT threads (a power of
// two) a block. A block of at most 512 threads may keep 128 registers a
// thread, so rows up to 4096 vectors stay in registers with no spill;
// wider rows (bf16 beyond 32768 values) take 16 vectors a thread in up to
// 1024 threads.
constexpr int kMaxThreads = 1024;
constexpr int kMaxRowVecs = 16384;
constexpr int kActThreads = 128;
// J: threads a block, one unit (a vector pair) each
constexpr int kRopeThreads = 256;

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// The rounding of the kernels these replace, instruction for instruction
// (the PTX that Triton emitted for them on this card): an approximate
// divide (`div.full.f32`, within 2 ulp), `sqrt.approx.ftz.f32` and
// `ex2.approx.f32`. With them, and the sums below taken in the same order,
// A and B give the previous kernels' bits, so a model's tokens do not
// move when the kernels are swapped.
__device__ __forceinline__ float div_full(float a, float b) {
  float q;
  asm("div.full.f32 %0, %1, %2;\n" : "=f"(q) : "f"(a), "f"(b));
  return q;
}

__device__ __forceinline__ float sqrt_approx(float a) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ float ex2_approx(float a) {
  float r;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(r) : "f"(a));
  return r;
}

// E values of T in one load: 16 bytes, or one value (E = 1)
template <typename T, int E>
struct alignas(E * sizeof(T)) Pack {
  T v[E];
};

// A: one block a row of [n, hidden]; thread t takes vectors t, t +
// blockDim, ... (at most V). RES: h = x + r is stored and normed. The sum
// of squares: a thread's values in order, the first vector's second value
// squared first, each next one by an FMA; a butterfly over the warp's
// lanes (xor 16 .. 1); then a butterfly over the warps' sums (a power of
// two) in warp 0, and one more shared-memory round to hand out the total.
template <typename T, int E, bool RES, int V, int MAXT>
__global__ void __launch_bounds__(MAXT, V == 1 ? 2048 / MAXT : 1)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const T* __restrict__ w, T* __restrict__ y,
                   T* __restrict__ h, int hidden, float eps) {
  using P = Pack<T, E>;
  __shared__ float warp_sums[MAXT / 32];
  const int nv = hidden / E;
  const long long base = (long long)blockIdx.x * hidden;
  const int tid = threadIdx.x;

  // before the wait: the norm weight only
  P wv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = tid + j * blockDim.x;
    if (i < nv) wv[j] = reinterpret_cast<const P*>(w)[i];
  }
  pdl_wait();
  pdl_launch_dependents();

  P hv[V], rv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = tid + j * blockDim.x;
    if (i < nv) {
      hv[j] = reinterpret_cast<const P*>(x + base)[i];
      if constexpr (RES) rv[j] = reinterpret_cast<const P*>(r + base)[i];
    }
  }
  if constexpr (RES) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = tid + j * blockDim.x;
      if (i < nv) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          hv[j].v[e] = from_f32<T>(__fadd_rn(to_f32(hv[j].v[e]),
                                             to_f32(rv[j].v[e])));
        reinterpret_cast<P*>(h + base)[i] = hv[j];
      }
    }
  }
  float ss = 0.f;
  if (tid < nv) {
    const float f0 = to_f32(hv[0].v[0]);
    if constexpr (E > 1) {
      const float f1 = to_f32(hv[0].v[1]);
      ss = __fmaf_rn(f0, f0, __fmul_rn(f1, f1));
#pragma unroll
      for (int e = 2; e < E; ++e) {
        const float f = to_f32(hv[0].v[e]);
        ss = __fmaf_rn(f, f, ss);
      }
    } else {
      ss = __fmul_rn(f0, f0);
    }
  }
#pragma unroll
  for (int j = 1; j < V; ++j) {
    if (tid + j * (int)blockDim.x < nv) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float f = to_f32(hv[j].v[e]);
        ss = __fmaf_rn(f, f, ss);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  if ((tid & 31) == 0) warp_sums[tid >> 5] = ss;
  __syncthreads();
  // warp 0 adds the warps' sums by the same butterfly, then hands the
  // total to the block through shared memory
  const int warps = blockDim.x >> 5;
  if (tid < 32) {
    float v = tid < warps ? warp_sums[tid] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < warps) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (tid == 0) warp_sums[0] = v;
  }
  __syncthreads();
  const float rstd =
      div_full(1.f, sqrt_approx(__fadd_rn(eps, div_full(warp_sums[0],
                                                        (float)hidden))));

#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = tid + j * blockDim.x;
    if (i < nv) {
      P out;
#pragma unroll
      for (int e = 0; e < E; ++e)
        out.v[e] = from_f32<T>(__fmul_rn(__fmul_rn(rstd, to_f32(hv[j].v[e])),
                                         to_f32(wv[j].v[e])));
      reinterpret_cast<P*>(y + base)[i] = out;
    }
  }
}

// B: thread (row, c) of the packed [n, 2 * inter] rows writes out[row,
// c * E .. c * E + E - 1] = silu(gate) * up; grid (rows, column blocks).
template <typename T, int E>
__global__ void __launch_bounds__(kActThreads)
    silu_mul_kernel(const T* __restrict__ gate_up, T* __restrict__ out,
                    int inter) {
  using P = Pack<T, E>;
  const int c = blockIdx.y * kActThreads + threadIdx.x;
  pdl_wait();
  pdl_launch_dependents();
  if (c >= inter / E) return;
  const long long row = blockIdx.x;
  const P g = reinterpret_cast<const P*>(gate_up + row * 2 * inter)[c];
  const P u = reinterpret_cast<const P*>(gate_up + row * 2 * inter + inter)[c];
  P o;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    // silu(g) = g / (1 + 2^(-g * log2(e))), then times up
    const float gf = to_f32(g.v[e]);
    const float ex = ex2_approx(__fmul_rn(__fsub_rn(0.f, gf),
                                          __int_as_float(0x3FB8AA3B)));
    o.v[e] = from_f32<T>(
        __fmul_rn(div_full(gf, __fadd_rn(ex, 1.f)), to_f32(u.v[e])));
  }
  reinterpret_cast<P*>(out + row * inter)[c] = o;
}

// J: unit w of the flat range [0, n * units) is unit u = w % units of
// token w / units: its head slot hs = u / (D / 2 / E) at column hs * D +
// (u % (D / 2 / E)) * E, and its pair D / 2 on; slot i = hs % (G + 2) of
// group g = hs / (G + 2) is q head g * G + i (i < G), k head g (i == G)
// or v head g (i == G + 1). cos and sin: [n, D / 2] f32. With a bias
// (Qwen2's packed qkv bias, [K * (G + 2) * D] of qkv's dtype), each value
// is first x + b rounded once to the element type, as torch's
// `qkv + bqkv` rounds it; the bias is a weight, read before the wait.
template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&o)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      const float4 f = reinterpret_cast<const float4*>(p)[j];
      o[4 * j] = f.x;
      o[4 * j + 1] = f.y;
      o[4 * j + 2] = f.z;
      o[4 * j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = p[e];
  }
}

template <typename T, int E>
__device__ __forceinline__ void add_bias(Pack<T, E>& x, const Pack<T, E>& b) {
#pragma unroll
  for (int e = 0; e < E; ++e)
    x.v[e] = from_f32<T>(__fadd_rn(to_f32(x.v[e]), to_f32(b.v[e])));
}

template <typename T, int E, bool BIAS>
__global__ void __launch_bounds__(kRopeThreads)
    split_qkv_rope_kernel(const T* __restrict__ qkv,
                          const T* __restrict__ bias,
                          const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t, T* __restrict__ q,
                          T* __restrict__ k, T* __restrict__ v, int n,
                          int kv_heads, int group, int head_dim) {
  using P = Pack<T, E>;
  const unsigned half = head_dim >> 1;
  const unsigned vecs = half / E;
  const unsigned slots = group + 2;
  const unsigned units = kv_heads * slots * vecs;
  const unsigned w = blockIdx.x * kRopeThreads + threadIdx.x;
  const bool live = w < (unsigned)n * units;
  const unsigned tok = w / units;
  const unsigned u = w - tok * units;
  const unsigned hs = u / vecs;
  const unsigned col = (u - hs * vecs) * E;
  P b1, b2;
  if constexpr (BIAS) {
    if (live) {
      const T* b = bias + hs * head_dim + col;
      b1 = *reinterpret_cast<const P*>(b);
      b2 = *reinterpret_cast<const P*>(b + half);
    }
  }
  pdl_wait();
  pdl_launch_dependents();
  if (!live) return;

  const unsigned g = hs / slots, i = hs - g * slots;
  const T* x = qkv + ((size_t)tok * kv_heads * slots + hs) * head_dim + col;
  P x1 = *reinterpret_cast<const P*>(x);
  P x2 = *reinterpret_cast<const P*>(x + half);
  if constexpr (BIAS) {
    add_bias(x1, b1);
    add_bias(x2, b2);
  }
  if (i == slots - 1) {
    T* dst = v + ((size_t)tok * kv_heads + g) * head_dim + col;
    *reinterpret_cast<P*>(dst) = x1;
    *reinterpret_cast<P*>(dst + half) = x2;
    return;
  }
  float c[E], s[E];
  load_f32<E>(cos_t + (size_t)tok * half + col, c);
  load_f32<E>(sin_t + (size_t)tok * half + col, s);
  P o1, o2;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float a = to_f32(x1.v[e]), b = to_f32(x2.v[e]);
    o1.v[e] = from_f32<T>(__fsub_rn(__fmul_rn(a, c[e]), __fmul_rn(b, s[e])));
    o2.v[e] = from_f32<T>(__fadd_rn(__fmul_rn(b, c[e]), __fmul_rn(a, s[e])));
  }
  T* dst = (i < (unsigned)group
                ? q + ((size_t)tok * kv_heads * group + g * group + i) *
                          head_dim
                : k + ((size_t)tok * kv_heads + g) * head_dim) +
           col;
  *reinterpret_cast<P*>(dst) = o1;
  *reinterpret_cast<P*>(dst + half) = o2;
}

// Launch `kernel` as a programmatic dependent of the stream's previous
// kernel.
template <typename K, typename... Args>
int launch_pdl(K kernel, dim3 grid, int threads, cudaStream_t stream,
               Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The block of a row of `nv` vectors at V vectors a thread: a power of two
// of at least one warp.
int row_threads(int nv, int v) {
  const int need = (nv + v - 1) / v;
  int t = 32;
  while (t < need) t *= 2;
  return t;
}

// One vector a thread up to 512 vectors (a 4096-value bf16 row: thread t
// holds values 8t .. 8t + 7), then 4, 8 or 16 vectors a thread.
template <typename T, int E, bool RES>
int launch_rmsnorm(const void* x, const void* r, const void* w, void* y,
                   void* h, int n, int hidden, float eps,
                   cudaStream_t stream) {
  const int nv = hidden / E;
  const T *xt = static_cast<const T*>(x), *rt = static_cast<const T*>(r),
          *wt = static_cast<const T*>(w);
  T *yt = static_cast<T*>(y), *ht = static_cast<T*>(h);
  if (nv <= 512)
    return launch_pdl(rmsnorm_kernel<T, E, RES, 1, 512>, dim3(n),
                      row_threads(nv, 1), stream, xt, rt, wt, yt, ht, hidden,
                      eps);
  if (nv <= 512 * 4)
    return launch_pdl(rmsnorm_kernel<T, E, RES, 4, 512>, dim3(n),
                      row_threads(nv, 4), stream, xt, rt, wt, yt, ht, hidden,
                      eps);
  if (nv <= 512 * 8)
    return launch_pdl(rmsnorm_kernel<T, E, RES, 8, 512>, dim3(n),
                      row_threads(nv, 8), stream, xt, rt, wt, yt, ht, hidden,
                      eps);
  if (nv <= kMaxRowVecs)
    return launch_pdl(rmsnorm_kernel<T, E, RES, 16, kMaxThreads>, dim3(n),
                      row_threads(nv, 16), stream, xt, rt, wt, yt, ht, hidden,
                      eps);
  return (int)cudaErrorInvalidValue;
}

// 16-byte vectors where every row and pointer allows them, else one value
// a load
template <typename T>
int rmsnorm_typed(const void* x, const void* r, const void* w, void* y,
                  void* h, int n, int hidden, float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const bool res = r != nullptr;
  const bool vec = hidden % E == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(y) && (!res || (aligned16(r) && aligned16(h)));
  if (vec)
    return res ? launch_rmsnorm<T, E, true>(x, r, w, y, h, n, hidden, eps,
                                            stream)
               : launch_rmsnorm<T, E, false>(x, r, w, y, h, n, hidden, eps,
                                             stream);
  return res ? launch_rmsnorm<T, 1, true>(x, r, w, y, h, n, hidden, eps,
                                          stream)
             : launch_rmsnorm<T, 1, false>(x, r, w, y, h, n, hidden, eps,
                                           stream);
}

template <typename T>
int silu_mul_typed(const void* gate_up, void* out, int n, int inter,
                   cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const T* g = static_cast<const T*>(gate_up);
  T* o = static_cast<T*>(out);
  if (inter % E == 0 && aligned16(gate_up) && aligned16(out))
    return launch_pdl(silu_mul_kernel<T, E>,
                      dim3(n, (inter / E + kActThreads - 1) / kActThreads),
                      kActThreads, stream, g, o, inter);
  return launch_pdl(silu_mul_kernel<T, 1>,
                    dim3(n, (inter + kActThreads - 1) / kActThreads),
                    kActThreads, stream, g, o, inter);
}

// J: 16-byte vectors where every pointer and the half row allow them,
// else one value a load; one thread a unit; the bias instance where a
// bias is given
template <typename T, int E>
int launch_split_qkv_rope(dim3 grid, cudaStream_t stream, const T* x,
                          const T* b, const float* c, const float* s, T* q,
                          T* k, T* v, int n, int kv_heads, int group,
                          int head_dim) {
  if (b != nullptr)
    return launch_pdl(split_qkv_rope_kernel<T, E, true>, grid, kRopeThreads,
                      stream, x, b, c, s, q, k, v, n, kv_heads, group,
                      head_dim);
  return launch_pdl(split_qkv_rope_kernel<T, E, false>, grid, kRopeThreads,
                    stream, x, b, c, s, q, k, v, n, kv_heads, group,
                    head_dim);
}

template <typename T>
int split_qkv_rope_typed(const void* qkv, const void* bias, const void* cos_t,
                         const void* sin_t, void* q, void* k, void* v, int n,
                         int kv_heads, int group, int head_dim,
                         cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const T* x = static_cast<const T*>(qkv);
  const T* b = static_cast<const T*>(bias);
  const float *c = static_cast<const float*>(cos_t),
              *s = static_cast<const float*>(sin_t);
  T *qt = static_cast<T*>(q), *kt = static_cast<T*>(k),
    *vt = static_cast<T*>(v);
  const int half = head_dim / 2;
  const bool vec = half % E == 0 && aligned16(qkv) && aligned16(cos_t) &&
                   aligned16(sin_t) && aligned16(q) && aligned16(k) &&
                   aligned16(v) && (bias == nullptr || aligned16(bias));
  const long long units =
      (long long)kv_heads * (group + 2) * (vec ? half / E : half);
  // the flat unit index stays 32-bit
  if ((long long)n * units + kRopeThreads > 0xFFFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n * units + kRopeThreads - 1) / kRopeThreads));
  if (vec)
    return launch_split_qkv_rope<T, E>(grid, stream, x, b, c, s, qt, kt, vt,
                                       n, kv_heads, group, head_dim);
  return launch_split_qkv_rope<T, 1>(grid, stream, x, b, c, s, qt, kt, vt, n,
                                     kv_heads, group, head_dim);
}

}  // namespace

// Kernel A. x, y (and residual, h) contiguous [n, hidden] of one dtype
// (0 bf16, 1 f16, 2 f32), weight [hidden]; residual == nullptr: plain
// RMSNorm (h unused). hidden up to 16384 values a row, or 16384 16-byte
// vectors where hidden is a multiple of one (the wrapper checks).
extern "C" int rmsnorm(const void* x, const void* residual, const void* weight,
                       void* y, void* h, int n, int hidden, int dtype,
                       float eps, void* stream) {
  if (n <= 0 || hidden <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return rmsnorm_typed<__nv_bfloat16>(x, residual, weight, y, h, n,
                                          hidden, eps, s);
    case kF16:
      return rmsnorm_typed<__half>(x, residual, weight, y, h, n, hidden, eps,
                                   s);
    case kF32:
      return rmsnorm_typed<float>(x, residual, weight, y, h, n, hidden, eps,
                                  s);
  }
  return (int)cudaErrorInvalidValue;
}

// Kernel B. gate_up contiguous [n, 2 * inter], out [n, inter], one dtype
// (codes as above).
extern "C" int silu_and_mul(const void* gate_up, void* out, int n, int inter,
                            int dtype, void* stream) {
  if (n <= 0 || inter <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return silu_mul_typed<__nv_bfloat16>(gate_up, out, n, inter, s);
    case kF16:
      return silu_mul_typed<__half>(gate_up, out, n, inter, s);
    case kF32:
      return silu_mul_typed<float>(gate_up, out, n, inter, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Kernel J. qkv contiguous [n, kv_heads * (group + 2) * head_dim], group-
// major; bias nullptr or contiguous [kv_heads * (group + 2) * head_dim] of
// qkv's dtype, added to every row first; cos, sin contiguous f32 [n,
// head_dim / 2]; q [n, kv_heads * group, head_dim], k and v [n, kv_heads,
// head_dim], contiguous, of qkv's dtype (codes as above). head_dim even.
extern "C" int split_qkv_rope(const void* qkv, const void* bias,
                              const void* cos_t, const void* sin_t, void* q,
                              void* k, void* v, int n, int kv_heads,
                              int group, int head_dim, int dtype,
                              void* stream) {
  if (n <= 0) return 0;
  if (kv_heads <= 0 || group <= 0 || head_dim <= 0 || head_dim % 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return split_qkv_rope_typed<__nv_bfloat16>(qkv, bias, cos_t, sin_t, q,
                                                 k, v, n, kv_heads, group,
                                                 head_dim, s);
    case kF16:
      return split_qkv_rope_typed<__half>(qkv, bias, cos_t, sin_t, q, k, v, n,
                                          kv_heads, group, head_dim, s);
    case kF32:
      return split_qkv_rope_typed<float>(qkv, bias, cos_t, sin_t, q, k, v, n,
                                         kv_heads, group, head_dim, s);
  }
  return (int)cudaErrorInvalidValue;
}

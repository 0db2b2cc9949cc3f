// Kernels E and F: bf16 activations times weight-only quantized weights,
// the dequantization fused into the matmul.
//
// Replaces two TPU kernels of the JAX package:
//   - E (INT4 = true): llm_inference_engine_tpu/ops/quant.py
//     `_int4_matmul_kernel`. Weight q int8 [k/2, n], byte r holding K row
//     2r in its low nibble and row 2r+1 in its high nibble (both signed,
//     -8..7); scales f32 [k/group, n]. One f32 partial product per scale
//     group is multiplied by that group's scales and added to the f32
//     accumulator.
//   - F (INT4 = false): `_int8_matmul_kernel`. Weight q int8 [k, n] cast
//     exactly to bf16; scale f32 [1, n] multiplies the f32 accumulator once
//     at the end.
// x bf16 [m, k] (m < 1024 on the engine's path), out bf16 or f32
// [m, halves * n]. With halves = 2 the weight is one layer of the gate|up
// stack [2, k', n]: one launch covers both halves and writes gate into
// columns [0, n) and up into [n, 2n) of each output row.
//
// Bound: at decode (m = 8) every weight byte is read once per step and
// used by 8 rows, so the kernel is bound by HBM bytes; the work per byte
// is small. What the design does about it:
//   - weights stay quantized in memory and in shared memory; they become
//     bf16 only in registers (INT4: two nibbles -> a bf16 pair with a few
//     integer ops and one exact bf16 subtraction);
//   - tensor cores through mma.sync m16n8k16 with the roles swapped
//     (A = weight^T, 16 output columns; B = x^T, 8 rows): an 8-row decode
//     batch fills the 8-wide side, nothing is padded;
//   - the nibble order is exactly the mma fragment order: a byte's two K
//     rows are the two bf16 halves of one A register;
//   - each warp streams its own K slices (whole scale groups) through a
//     private cp.async ring of 16-byte copies, so no block-wide barrier
//     sits in the main loop, several loads per warp are in flight, and
//     narrow column tiles (32 at decode) still give >= 128 blocks for the
//     4096-wide projections; the warps' partial sums meet once, in shared
//     memory, at the end (split-K inside the block, no second pass);
//   - every copy past the end of x (rows >= m, the K tail) or of the
//     weight (columns >= n) is zero-filled by cp.async, and nothing past
//     row m or column n is stored.
// Simple rather than fast: no wgmma, no TMA; see PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KU = 64;                 // K rows per pipeline unit
constexpr int XPITCH = KU * 2 + 16;    // bytes per staged x row (padded)

struct Params {
  const __nv_bfloat16* x;  // [m, k]
  const int8_t* q;         // [halves][kr, n], kr = k/2 (INT4) or k
  const float* scale;      // [halves][groups, n], groups = k/group or 1
  void* out;               // [m, halves * n]
  long long q_half;        // elements between the two halves of q
  long long s_half;        // elements between the two halves of scale
  int m, k, n, halves, group, out_f32, tiles_n;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A byte of two signed nibbles -> bf16 pair (low nibble in the low half).
// nibble ^ 8 is the value + 8 in [0, 15]; 0x4300 | v is the bf16 of 128 + v,
// and subtracting 136 is exact.
__device__ __forceinline__ uint32_t int4x2_to_bf16x2(uint32_t b) {
  const uint32_t u = b ^ 0x88u;
  uint32_t w = (u & 0xFu) | ((u & 0xF0u) << 12) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<__nv_bfloat162*>(&w),
              __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Two int8 values -> bf16 pair (exact: |v| <= 128).
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(int lo, int hi) {
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool INT4, int BM, int BN>
struct Tile {
  static constexpr int MT = BN / 16;               // 16-column tiles (A)
  static constexpr int NT = BM / 8;                // 8-row tiles (B)
  static constexpr int WROWS = INT4 ? KU / 2 : KU; // stored weight rows/unit
  static constexpr int WPITCH = BN + 16;           // padded: no bank clashes
  static constexpr int WBYTES = WROWS * WPITCH;
  static constexpr int STAGE = WBYTES + BM * XPITCH;
  static constexpr int RPITCH = BN + 4;            // reduction row, floats
};

// Block: NW warps over one [BM rows, BN columns] output tile of one half.
// Warp w owns scale groups w, w + NW, ... (INT4; a group is group/KU units)
// or units w, w + NW, ... (INT8) and accumulates the whole tile over them.
template <bool INT4, int BM, int BN, int NW, int STAGES>
__global__ void __launch_bounds__(NW * 32)
    quant_matmul_kernel(const Params p) {
  using T = Tile<INT4, BM, BN>;
  constexpr int MT = T::MT, NT = T::NT;
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int half = blockIdx.x / p.tiles_n;
  const int col0 = (blockIdx.x - half * p.tiles_n) * BN;
  const int row0 = blockIdx.y * BM;
  const int8_t* q = p.q + half * p.q_half;
  const float* sc = p.scale + half * p.s_half;
  const int kr = INT4 ? p.k / 2 : p.k;
  const int units = (p.k + KU - 1) / KU;
  const int upg = INT4 ? p.group / KU : 1;  // units per scale group
  const int groups = units / upg;
  const int my_units =
      warp < groups ? ((groups - 1 - warp) / NW + 1) * upg : 0;
  unsigned char* ring = smem + warp * STAGES * T::STAGE;

  // i-th unit of this warp -> global unit index
  auto unit_of = [&](int i) { return (warp + (i / upg) * NW) * upg + i % upg; };

  auto load = [&](int i, int s) {
    const int u = unit_of(i);
    unsigned char* ws = ring + s * T::STAGE;
    unsigned char* xs = ws + T::WBYTES;
    constexpr int WPIECES = T::WROWS * (BN / 16);
    for (int j = lane; j < WPIECES; j += 32) {
      const int r = j / (BN / 16), c = (j % (BN / 16)) * 16;
      const int gr = u * T::WROWS + r, gc = col0 + c;
      const bool ok = gr < kr && gc < p.n;
      cp_async16(ws + r * T::WPITCH + c,
                 ok ? q + static_cast<long long>(gr) * p.n + gc : q, ok);
    }
    constexpr int XPIECES = BM * (KU / 8);
    for (int j = lane; j < XPIECES; j += 32) {
      const int r = j / (KU / 8), c = (j % (KU / 8)) * 8;
      const int gr = row0 + r, gc = u * KU + c;
      const bool ok = gr < p.m && gc < p.k;
      cp_async16(xs + r * XPITCH + c * 2,
                 ok ? p.x + static_cast<long long>(gr) * p.k + gc : p.x, ok);
    }
  };

  // one unit (KU rows of K) of mma into d
  auto compute = [&](int s, float(&d)[MT][NT][4]) {
    const unsigned char* ws = ring + s * T::STAGE;
    const unsigned char* xs = ws + T::WBYTES;
#pragma unroll
    for (int ks = 0; ks < KU / 16; ++ks) {
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned char* xr =
            xs + (nt * 8 + g) * XPITCH + (ks * 16 + 2 * t) * 2;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(xr + 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        const int c = mt * 16 + g;
        if constexpr (INT4) {
          const unsigned char* w0 = ws + (ks * 8 + t) * T::WPITCH + c;
          a[0] = int4x2_to_bf16x2(w0[0]);
          a[1] = int4x2_to_bf16x2(w0[8]);
          a[2] = int4x2_to_bf16x2(w0[4 * T::WPITCH]);
          a[3] = int4x2_to_bf16x2(w0[4 * T::WPITCH + 8]);
        } else {
          const int8_t* w0 = reinterpret_cast<const int8_t*>(ws) +
                             (ks * 16 + 2 * t) * T::WPITCH + c;
          constexpr int P = T::WPITCH;
          a[0] = int8x2_to_bf16x2(w0[0], w0[P]);
          a[1] = int8x2_to_bf16x2(w0[8], w0[P + 8]);
          a[2] = int8x2_to_bf16x2(w0[8 * P], w0[9 * P]);
          a[3] = int8x2_to_bf16x2(w0[8 * P + 8], w0[9 * P + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (row0 + nt * 8 < p.m) mma_bf16(d[mt][nt], a, b[nt]);
      }
    }
  };

  float acc[MT][NT][4];
  float part[MT][NT][4];
  float sreg[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < my_units) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < my_units; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();  // unit i visible to the warp; unit i-1's slot is free
    if (i + STAGES - 1 < my_units) load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    if constexpr (INT4) {
      if (i % upg == 0) {  // a new group: fetch its scales, clear the partial
        const float* srow = sc + static_cast<long long>(unit_of(i) / upg) * p.n;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int c = col0 + mt * 16 + g;
          sreg[mt][0] = c < p.n ? __ldg(srow + c) : 0.f;
          sreg[mt][1] = c + 8 < p.n ? __ldg(srow + c + 8) : 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
        }
      }
      compute(i % STAGES, part);
      if (i % upg == upg - 1) {  // group done: acc += partial * scale
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] += part[mt][nt][e] * sreg[mt][e >> 1];
      }
    } else {
      compute(i % STAGES, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it below

  // D fragment: d0/d1 at column g, d2/d3 at column g + 8 of the m-tile;
  // x rows 2t and 2t + 1 of the n-tile
  float* red = reinterpret_cast<float*>(smem);  // [NW][BM][RPITCH]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = mt * 16 + g + (e >> 1) * 8;
        const int row = nt * 8 + 2 * t + (e & 1);
        red[(warp * BM + row) * T::RPITCH + col] = acc[mt][nt][e];
      }
  __syncthreads();

  const long long ldo = static_cast<long long>(p.halves) * p.n;
  for (int j = threadIdx.x; j < BM * BN; j += NW * 32) {
    const int r = j / BN, c = j % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= p.m || gc >= p.n) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) v += red[(w * BM + r) * T::RPITCH + c];
    if constexpr (!INT4) v *= sc[gc];
    const long long o = gr * ldo + static_cast<long long>(half) * p.n + gc;
    if (p.out_f32)
      static_cast<float*>(p.out)[o] = v;
    else
      static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
  }
}

template <bool INT4, int BM, int BN, int NW, int STAGES>
int launch(Params p, cudaStream_t stream) {
  using T = Tile<INT4, BM, BN>;
  constexpr int ring = NW * STAGES * T::STAGE;
  constexpr int red = NW * BM * T::RPITCH * 4;
  constexpr int smem = ring > red ? ring : red;
  auto kernel = quant_matmul_kernel<INT4, BM, BN, NW, STAGES>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  p.tiles_n = (p.n + BN - 1) / BN;
  const dim3 grid(p.tiles_n * p.halves, (p.m + BM - 1) / BM);
  kernel<<<grid, NW * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Decode-sized m (<= 8): one 8-row tile, narrow 32-column tiles so that
// n = 4096 still gives 128 blocks, 8 warps splitting K. Larger m: 32-row,
// 64-column tiles, 4 warps.
template <bool INT4>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.m <= 0 || p.n <= 0) return 0;
  if (p.m <= 8) return launch<INT4, 8, 32, 8, 4>(p, stream);
  return launch<INT4, 32, 64, 4, 3>(p, stream);
}

Params make_params(const void* x, const void* q, const void* scale, void* out,
                   int m, int k, int n, int halves, long long q_half,
                   long long s_half, int group, int out_f32) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.q_half = q_half;
  p.s_half = s_half;
  p.m = m;
  p.k = k;
  p.n = n;
  p.halves = halves;
  p.group = group;
  p.out_f32 = out_f32;
  p.tiles_n = 0;
  return p;
}

}  // namespace

// Kernel E. Requires k % group == 0, group % 64 == 0, n % 16 == 0, and
// 16-byte aligned x and q (the wrapper in ops/quant.py checks).
extern "C" int int4_matmul(const void* x, const void* q, const void* scale,
                           void* out, int m, int k, int n, int halves,
                           long long q_half, long long s_half, int group,
                           int out_f32, void* stream) {
  if (group <= 0 || group % KU || k % group || n % 16 || k % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(make_params(x, q, scale, out, m, k, n, halves, q_half,
                                    s_half, group, out_f32),
                        static_cast<cudaStream_t>(stream));
}

// Kernel F. Requires k % 8 == 0, n % 16 == 0, 16-byte aligned x and q.
extern "C" int int8_matmul(const void* x, const void* q, const void* scale,
                           void* out, int m, int k, int n, int halves,
                           long long q_half, long long s_half, int out_f32,
                           void* stream) {
  if (n % 16 || k % 8) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(make_params(x, q, scale, out, m, k, n, halves, q_half,
                                     s_half, KU, out_f32),
                         static_cast<cudaStream_t>(stream));
}

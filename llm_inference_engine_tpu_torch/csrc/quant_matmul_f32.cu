// Kernels Ef and Ff, float32 instances: float32 activations times INT4 /
// INT8 weights on the CUDA cores. Replace the JAX package's ops/quant.py
// `_int4_matmul_kernel` and `_int8_matmul_kernel` for a float32 model.
// TF32 would keep ~3 decimal digits of x and break the f32 tolerance, so
// every product is an f32 FMA; the weights become f32 exactly (the byte
// under 0x4b000000 is 2^23 + byte, `biased_byte_to_f32`). Kernels E and
// F's plan, launch, weight tensor maps and PDL points are shared
// (quant_matmul.cuh: make_plan with a 4-byte element, DecF32, PreF32).
//
// Decode mode (m <= 16). Bound by the weight's bytes at m 1-4 and by the
// FMAs above (8 rows: 8 FMAs a weight value, about as long as the
// weight's read at the card's f32 rate). E's skeleton, one launch and no
// workspace: 64 columns a block, the cluster's ranks on whole scale
// groups (INT4) or 128-row units (INT8), the weight boxes by TMA through
// E's 3 / 4-stage ring (issued before `griddepcontrol.wait`, x after it),
// the ranks' sums merged in rank order through distributed shared memory.
// Inside a block, thread t owns 4 adjacent columns (t % 16) and one of 8
// K slices (t / 16) of each stage: per 4 K rows it converts 16 weight
// values once and takes each x row's 4 values with one 16-byte shared
// load, 16 FMAs each. An INT4 slice (32 K rows) lies in one scale group:
// its f32 partial times the group's scale is added to the accumulator
// (acc = fma(part, scale, acc)); INT8 scales the merged sum once. The 8
// slices' sums meet in shared memory in slice order, then the cluster's.
//
// Prefill mode (16 < m < 1024). Bound by the f32 FMAs (m 512 on wqkv:
// 51.5 GFLOP against 0.4 GB of bytes). A register-tiled SIMT kernel: a
// block of 256 threads takes 128 x rows by 128 columns, a thread 8 x 8
// outputs (rows ty + 16 i, columns 4 tx + 64 j + 0..3); x (f32 [128][32])
// and the stage's weight bytes come through a 4-stage cp.async ring, and
// the weights are dequantized once a stage into f32 [32][128] in shared
// memory. A K step reads 8 x values (8 16-byte loads a 4-step) and 8
// weights (2 16-byte loads) for 64 FMAs. INT4 keeps the JAX numerics:
// each scale group's f32 partial, then acc = fma(part, scale, acc) in
// group order; INT8 scales in the epilogue.
// Ragged tails: x rows past m and K past k are zero-filled (cp.async
// src-size 0; TMA zero-fills weight rows past the weight's end), columns
// past n are never stored and their scales never read.

#include "quant_matmul.cuh"

namespace {

// INT4 bytes of 4 adjacent columns (byte c: column c, K row 2r low and
// 2r + 1 high) -> lo[c], hi[c] as f32, exact: nibble ^ 8 is the value + 8,
// under 0x4b000000 the f32 2^23 + value + 8.
__device__ __forceinline__ void int4_cols_f32(uint32_t w, float (&lo)[4],
                                              float (&hi)[4]) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t l = u & 0x0F0F0F0Fu, h = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    lo[c] = __uint_as_float(__byte_perm(l, 0x4b000000u, 0x7540u | c)) -
            8388616.f;
    hi[c] = __uint_as_float(__byte_perm(h, 0x4b000000u, 0x7540u | c)) -
            8388616.f;
  }
}

// INT8 bytes of 4 adjacent columns -> f32, exact.
__device__ __forceinline__ void int8_cols_f32(uint32_t w, float (&o)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < 4; ++c) o[c] = biased_byte_to_f32(u, c);
}

// ---------------------------------------------------------------------------
// decode mode
// ---------------------------------------------------------------------------

template <bool INT4, int BM>
__global__ void __launch_bounds__(kDecThreads)
    quant_matmul_decode_f32(const __grid_constant__ CUtensorMap wmap,
                            const Params<float> p) {
  using D = DecF32<INT4, BM>;
  constexpr int S = D::kStages;
  constexpr int XP = D::kXPitch / 4;   // floats an x row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);       // S weight boxes
  unsigned char* xring = ring + S * D::kW;         // S x parts
  float* sring = reinterpret_cast<float*>(xring + S * D::kX);  // S scales
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(sring) + S * D::kS);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int wc = (tid % 16) * kF32Cols;   // this thread's columns wc..+3
  const int sl = tid / 16;                // its K slice of each stage
  const int tile = blockIdx.x / p.cluster;
  const int half = tile / p.tiles_n;
  const int col0 = (tile - half * p.tiles_n) * kDecCols;
  const float* sc = p.scale + half * p.s_half;

  // this rank's K rows [k_lo, k_hi): whole split units, balanced
  const int u_lo = (int)((long long)rank * p.nsu / p.cluster);
  const int u_hi = (int)((long long)(rank + 1) * p.nsu / p.cluster);
  const int k_lo = u_lo * p.su;
  const int k_hi = min(u_hi * p.su, p.k);
  const int nstage = k_hi > k_lo ? (k_hi - k_lo + D::kK - 1) / D::kK : 0;
  const int kr_lo = INT4 ? k_lo / 2 : k_lo;

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&wmap))
                 : "memory");
    for (int s = 0; s < S; ++s) mbar_init(&full[s], kDecThreads + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stage j into slot j % S: the weight box by TMA and the INT4 scales
  // (constants), then x
  auto issue_weights = [&](int j) {
    const int s = j % S;
    const int k0 = k_lo + j * D::kK;
    if (tid == 0) {
      fence_proxy_async();
      mbar_expect_tx(&full[s], D::kW);
      tma_load_3d(ring + s * D::kW, &wmap, &full[s], col0,
                  kr_lo + j * D::kRows, half);
    }
    if constexpr (INT4) {
      const int groups = min(D::kK, k_hi - k0) / p.group;
      for (int i = tid; i < groups * (kDecCols / 4); i += kDecThreads) {
        const int gi = i / (kDecCols / 4), c = (i % (kDecCols / 4)) * 4;
        const bool ok = col0 + c < p.n;
        cp_async16(sring + s * (D::kS / 4) + gi * kDecCols + c,
                   ok ? sc + (long long)(k0 / p.group + gi) * p.n + col0 + c
                      : sc,
                   ok);
      }
    }
  };
  // x's 16-byte chunks (4 values), slice q's 16 bytes past slice q - 1's
  auto issue_x = [&](int j) {
    const int s = j % S;
    const int k0 = k_lo + j * D::kK;
    unsigned char* xs = xring + s * D::kX;
    for (int i = tid; i < BM * (D::kK / 4); i += kDecThreads) {
      const int r = i / (D::kK / 4), c = (i % (D::kK / 4)) * 4;
      const bool ok = r < p.m && k0 + c < k_hi;
      cp_async16(xs + r * D::kXPitch + c * 4 + (c / D::kSlice) * 16,
                 ok ? p.x + (long long)r * p.k + k0 + c : p.x, ok);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                     smem_u32(&full[s]))
                 : "memory");
  };
  // a programmatic dependent: constants before the wait, x after it
  for (int j = 0; j < S - 1 && j < nstage; ++j) issue_weights(j);
  pdl_wait();
  for (int j = 0; j < S - 1 && j < nstage; ++j) issue_x(j);

  float acc[BM][4], part[INT4 ? BM : 1][4];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll
  for (int r = 0; r < (INT4 ? BM : 1); ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[r][c] = 0.f;

  const int ku = sl * D::kSlice;   // the slice's K offset in a stage
  for (int j = 0; j < nstage; ++j) {
    if (j + S - 1 < nstage) {
      issue_weights(j + S - 1);
      issue_x(j + S - 1);
    }
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    if (k_lo + j * D::kK + ku < k_hi) {
      const unsigned char* ws = ring + s * D::kW;
      const float* xs = reinterpret_cast<const float*>(xring + s * D::kX) +
                        sl * (D::kSlice + 4);
#pragma unroll
      for (int i = 0; i < D::kSlice / 4; ++i) {   // 4 K rows
        float w[4][4];   // [K row][column]
        if constexpr (INT4) {
          const int r = ku / 2 + 2 * i;   // stored rows r and r + 1
          int4_cols_f32(lds32(sw64_at(ws, r, wc)), w[0], w[1]);
          int4_cols_f32(lds32(sw64_at(ws, r + 1, wc)), w[2], w[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            int8_cols_f32(lds32(sw64_at(ws, ku + 4 * i + q, wc)), w[q]);
        }
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + r * XP + 4 * i);
          float* d = INT4 ? part[r] : acc[r];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            d[c] = fmaf(xv.x, w[0][c], d[c]);
            d[c] = fmaf(xv.y, w[1][c], d[c]);
            d[c] = fmaf(xv.z, w[2][c], d[c]);
            d[c] = fmaf(xv.w, w[3][c], d[c]);
          }
        }
      }
      if constexpr (INT4) {   // the slice lies in one group: fold it
        const float4 s4 = *reinterpret_cast<const float4*>(
            sring + s * (D::kS / 4) + (ku / p.group) * kDecCols + wc);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int r = 0; r < BM; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(part[r][c], sv[c], acc[r][c]);
            part[r][c] = 0.f;
          }
      }
    }
    __syncthreads();   // slot j % S is free for stage j + S
  }

  // the K loop is done: the kernel after this one may become resident
  pdl_launch_dependents();

  // the slices' sums meet in shared memory in slice order (the ring is
  // free), then the ranks' through distributed shared memory
  float* sums = reinterpret_cast<float*>(ring);        // [8][BM][64]
  float* red = sums + kF32Slices * BM * kDecCols;      // [BM][kRedPitch]
#pragma unroll
  for (int r = 0; r < BM; ++r)
    *reinterpret_cast<float4*>(sums + (sl * BM + r) * kDecCols + wc) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int i = tid; i < BM * kDecCols; i += kDecThreads) {
    const int r = i / kDecCols, c = i % kDecCols;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kF32Slices; ++q) v += sums[(q * BM + r) * kDecCols + c];
    red[r * kRedPitch + c] = v;
  }
  cluster.sync();
  const long long ldo = (long long)p.halves * p.n;
  for (int i = rank * kDecThreads + tid; i < BM * kDecCols;
       i += p.cluster * kDecThreads) {
    const int r = i / kDecCols, c = i % kDecCols;
    const int gc = col0 + c;
    if (r >= p.m || gc >= p.n) continue;
    float v = 0.f;
    for (int s = 0; s < p.cluster; ++s)
      v += cluster.map_shared_rank(red, s)[r * kRedPitch + c];
    if constexpr (!INT4) v *= sc[gc];
    static_cast<float*>(p.out)[r * ldo + (long long)half * p.n + gc] = v;
  }
  cluster.sync();   // every block's sums stay until all have read
}

// ---------------------------------------------------------------------------
// prefill mode
// ---------------------------------------------------------------------------

template <bool INT4>
__global__ void __launch_bounds__(kPreF32Threads, 1)
    quant_matmul_prefill_f32(const Params<float> p) {
  using P = PreF32<INT4>;
  constexpr int S = kPreF32Stages, BK = kPreF32K;
  constexpr int XP = P::kXPitch / 4;   // floats an x row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  float* wf = reinterpret_cast<float*>(sm + S * P::kStage);   // [2][BK][128]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int half = blockIdx.x / p.tiles_n;
  const int col0 = (blockIdx.x - half * p.tiles_n) * kPreCols;
  const int row0 = blockIdx.y * kPreF32Rows;
  const int kr = INT4 ? p.k / 2 : p.k;
  const int nk = (p.k + BK - 1) / BK;
  const int8_t* q = p.q + half * p.q_half;
  const float* sc = p.scale + half * p.s_half;

  // stage i into slot i % S: x [128][BK] and the weight's stored rows
  // [kWRows][128], zero past m, k, the weight's rows and n; one commit
  // group a stage (empty past the last)
  auto issue = [&](int i) {
    if (i < nk) {
      unsigned char* st = sm + (i % S) * P::kStage;
      const int k0 = i * BK;
      for (int e = tid; e < kPreF32Rows * (BK / 4); e += kPreF32Threads) {
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const bool ok = row0 + r < p.m && k0 + c < p.k;
        cp_async16(st + r * P::kXPitch + c * 4,
                   ok ? p.x + (long long)(row0 + r) * p.k + k0 + c : p.x, ok);
      }
      for (int e = tid; e < P::kWRows * (kPreCols / 16);
           e += kPreF32Threads) {
        const int r = e / (kPreCols / 16), c = (e % (kPreCols / 16)) * 16;
        const int gr = (INT4 ? k0 / 2 : k0) + r;
        const bool ok = gr < kr && col0 + c < p.n;
        cp_async16(st + P::kX + r * kPreCols + c,
                   ok ? q + (long long)gr * p.n + col0 + c : q, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // acc[i][j]: x row row0 + ty + 16 i, column col0 + 64 (j / 4) + 4 tx +
  // j % 4
  float acc[8][8], part[INT4 ? 8 : 1][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < (INT4 ? 8 : 1); ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[i][j] = 0.f;

  // stage i's weight bytes into f32 [K row][column] in wf buffer i % 2,
  // once a stage
  auto dequant = [&](int i) {
    const unsigned char* wb = sm + (i % S) * P::kStage + P::kX;
    float* w = wf + (i & 1) * (BK * kPreCols);
    if constexpr (INT4) {   // 16 stored rows: 8 bytes (16 values) a thread
      const int r = tid / 16, c = (tid % 16) * 8;
      const uint2 v = *reinterpret_cast<const uint2*>(wb + r * kPreCols + c);
      float lo0[4], hi0[4], lo1[4], hi1[4];
      int4_cols_f32(v.x, lo0, hi0);
      int4_cols_f32(v.y, lo1, hi1);
      float* d0 = w + (2 * r) * kPreCols + c;
      float* d1 = d0 + kPreCols;
      *reinterpret_cast<float4*>(d0) =
          make_float4(lo0[0], lo0[1], lo0[2], lo0[3]);
      *reinterpret_cast<float4*>(d0 + 4) =
          make_float4(lo1[0], lo1[1], lo1[2], lo1[3]);
      *reinterpret_cast<float4*>(d1) =
          make_float4(hi0[0], hi0[1], hi0[2], hi0[3]);
      *reinterpret_cast<float4*>(d1 + 4) =
          make_float4(hi1[0], hi1[1], hi1[2], hi1[3]);
    } else {   // 32 rows: 16 bytes a thread
      const int r = tid / 8, c = (tid % 8) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(wb + r * kPreCols + c);
      const uint32_t vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float f[4];
        int8_cols_f32(vs[e], f);
        *reinterpret_cast<float4*>(w + r * kPreCols + c + 4 * e) =
            make_float4(f[0], f[1], f[2], f[3]);
      }
    }
  };

  // One barrier a stage: at iteration i stage i + 1 has landed and is
  // dequantized into the other wf buffer while stage i is multiplied, and
  // stage i + S - 1 refills the slot stage i - 1 left.
  for (int i = 0; i < S - 1; ++i) issue(i);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2) : "memory");
  __syncthreads();
  dequant(0);
  for (int i = 0; i < nk; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 3) : "memory");
    __syncthreads();   // stage i + 1 has landed, wf i % 2 is complete,
                       // stage i - 1 is consumed
    issue(i + S - 1);
    if (i + 1 < nk) dequant(i + 1);
    const float* wfi = wf + (i & 1) * (BK * kPreCols);
    const float* xs = reinterpret_cast<const float*>(sm + (i % S) * P::kStage);
#pragma unroll
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      float4 a[8];
#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
        a[ii] = *reinterpret_cast<const float4*>(xs + (ty + 16 * ii) * XP +
                                                 4 * k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wr = wfi + (4 * k4 + kk) * kPreCols + 4 * tx;
        const float4 b0 = *reinterpret_cast<const float4*>(wr);
        const float4 b1 = *reinterpret_cast<const float4*>(wr + 64);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const float av = kk == 0 ? a[ii].x
                           : kk == 1 ? a[ii].y
                           : kk == 2 ? a[ii].z
                                     : a[ii].w;
          float* d = INT4 ? part[ii] : acc[ii];
#pragma unroll
          for (int j = 0; j < 8; ++j) d[j] = fmaf(av, bv[j], d[j]);
        }
      }
    }
    if constexpr (INT4) {
      const int kend = (i + 1) * BK;
      if (kend % p.group == 0 || i == nk - 1) {   // a group ends: fold it
        const long long grow = (long long)((kend - 1) / p.group) * p.n;
        float sv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = col0 + 64 * (j / 4) + 4 * tx + j % 4;
          sv[j] = c < p.n ? __ldg(sc + grow + c) : 0.f;
        }
#pragma unroll
        for (int ii = 0; ii < 8; ++ii)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[ii][j] = fmaf(part[ii][j], sv[j], acc[ii][j]);
            part[ii][j] = 0.f;
          }
      }
    }
  }

  // epilogue: INT8's channel scale, rows past m and columns past n unstored
  float f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col0 + 64 * (j / 4) + 4 * tx + j % 4;
    f[j] = INT4 ? 1.f : (c < p.n ? __ldg(sc + c) : 0.f);
  }
  const long long ldo = (long long)p.halves * p.n;
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int r = row0 + ty + 16 * ii;
    if (r >= p.m) continue;
#pragma unroll
    for (int jb = 0; jb < 2; ++jb) {
      const int c = col0 + 64 * jb + 4 * tx;
      if (c >= p.n) continue;
      const float* a = acc[ii] + 4 * jb;
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + r * ldo +
                                 (long long)half * p.n + c) =
          make_float4(a[0] * f[4 * jb], a[1] * f[4 * jb + 1],
                      a[2] * f[4 * jb + 2], a[3] * f[4 * jb + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <bool INT4, int BM>
int launch_decode_f32(const Params<float>& p, const Plan& pl,
                      cudaStream_t stream, int* blocks_per_sm) {
  static int allowed[kMaxDevices] = {};
  return launch_decode_kernel(quant_matmul_decode_f32<INT4, BM>, p, pl, INT4,
                              allowed, stream, blocks_per_sm);
}

template <bool INT4>
int launch_prefill_f32(const Params<float>& p, const Plan& pl,
                       cudaStream_t stream, int* blocks_per_sm) {
  auto kernel = quant_matmul_prefill_f32<INT4>;
  static int allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, pl.smem, allowed);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kPreF32Threads, pl.smem);
  const dim3 grid(pl.tiles_n * p.halves, cdiv(p.m, kPreF32Rows));
  kernel<<<grid, kPreF32Threads, pl.smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The plan's mode and tile pick the instance (with `blocks_per_sm`,
// launch nothing and report the blocks an SM holds).
template <bool INT4>
int dispatch_f32(Params<float> p, cudaStream_t stream, int* blocks_per_sm) {
  const Plan pl = plan_of(p, INT4);
  if (pl.mode == 0)
    return pl.rows == 8
               ? launch_decode_f32<INT4, 8>(p, pl, stream, blocks_per_sm)
               : launch_decode_f32<INT4, 16>(p, pl, stream, blocks_per_sm);
  return launch_prefill_f32<INT4>(p, pl, stream, blocks_per_sm);
}

}  // namespace

// Ef: x f32 [m, k] times the packed INT4 weight; out f32. qd (the
// fragment order) is not read: float32 has no fragment mode.
extern "C" int int4_matmul_f32(const void* x, const void* q, const void* qd,
                               const void* scale, void* out, int m, int k,
                               int n, int halves, long long q_half,
                               long long s_half, int group, int out_f32,
                               void* stream) {
  return int4_entry<float, dispatch_f32<true>>(x, q, qd, scale, out, m, k, n,
                                               halves, q_half, s_half, group,
                                               out_f32, stream);
}

// Ff: x f32 [m, k] times the INT8 weight; out f32.
extern "C" int int8_matmul_f32(const void* x, const void* q,
                               const void* scale, void* out, int m, int k,
                               int n, int halves, long long q_half,
                               long long s_half, int out_f32, void* stream) {
  return int8_entry<float, dispatch_f32<false>>(
      x, q, scale, out, m, k, n, halves, q_half, s_half, out_f32, stream);
}

// The plan of Ef (int4 != 0) or Ff's float32 instance (plan_entry).
extern "C" int quant_matmul_plan_f32(int m, int k, int n, int halves,
                                     int int4, int group, int* out) {
  return plan_entry<float, dispatch_f32<true>, dispatch_f32<false>>(
      m, k, n, halves, int4, group, out);
}

// Kernels E and F: 16-bit activations times weight-only quantized
// weights, the dequantization fused into the matmul. One template over the
// element type E of x and out: __nv_bfloat16 (quant_matmul.cu, kernels E
// and F) and __half (quant_matmul_f16.cu: kernels Ef and Ff for a float16
// model, the same design on the same tensor cores). The float32 instances
// (quant_matmul_f32.cu) keep this file's plan, launch and tensor maps and
// run kernels of their own on the CUDA cores: TF32 would break the f32
// tolerance.
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
// x E [m, k] (m < 1024 on the engine's path), out E or f32
// [m, halves * n]. With halves = 2 the weight is one layer of the gate|up
// stack [2, k', n]: one launch covers both halves and writes gate into
// columns [0, n) and up into [n, 2n) of each output row. The weights are
// read in the JAX package's layout as they are: no repacking.
//
// Both modes swap the roles of the product: the tensor cores' A operand is
// the dequantized weight^T (rows = output columns), B is x^T (columns = x
// rows). The dequantized weight is then the one operand built in
// registers, and a byte of two nibbles is exactly one A register (two K
// rows of one column). A thread's A rows g and g + 8 stand for two
// adjacent columns, so one shared load fetches the columns it needs
// (decode: four columns, two m16 tiles, one 32-bit load; prefill: two
// columns, one 16-bit load). INT4 bytes become E pairs with a byte
// permute, a LOP3 and an FMA (`int4_to_x2`: bf16 0x4300 | u is 128 + u,
// f16 0x6400 | u is 1024 + u), INT8 ones through exact f32 in bf16 and
// with a byte permute and a subtraction of 1152 in f16 (`int8_pairs`).
// Only the mma's type, these conversions, x's TMA data type and the
// output rounding differ between the two instances (`if constexpr`, so
// the bf16 code is the one kernels E and F always ran).
//
// Decode mode (m <= 16, and 17-48 where n is narrow: `make_plan`; the
// float32 instances m <= 16: generate, the server's decode step, the
// lm_head, a speculative verify of B x (k + 1) rows). Every weight byte is
// read once and used by at most 48 rows: bound by HBM bytes, and at INT4
// the dequantizing instructions come close to it (PERF.md). The design:
//   - a block owns 64 output columns of one half; the blocks of a
//     thread-block cluster (1, 2, 4 or 8: the plan's `cluster`) split K
//     into whole split units (INT4: scale groups of 64 or 128 rows; INT8:
//     128 rows), balanced, so that every 7B projection, n = 4096
//     included, launches >= 2 blocks an SM (`decode_cluster`);
//   - the weights stream by TMA (one 8 KB box a stage: 128 stored rows x
//     64 bytes, 64-byte swizzle; tensor maps kept by weight address, so a
//     decode step encodes none) through a 3-stage (INT4, 256 K rows a
//     stage) or 4-stage (INT8, 128 K rows) ring, one mbarrier a stage;
//     5 blocks an SM at m <= 8, 4 at m <= 16, 2-4 at m 17-48 (x's stage
//     grows with the rows): >= 32 KB of weights in flight an SM;
//   - x is staged once a block, a stage at a time behind the weights:
//     every thread copies its share of the stage's x rows (and INT4
//     scales) by cp.async and arrives on the same mbarrier when they land
//     (x is never restaged per warp);
//   - warps 0-1 take the first half of each stage's K rows, warps 2-3 the
//     second (whole scale groups each), mma.sync m16n8k16 on an x tile of
//     8 (m <= 8), 16 (m 9-16), 32 (m 17-32) or 48 (m 33-48) rows, one n8
//     tile per 8 rows; the two halves meet once in shared memory;
//   - the cluster's partial sums meet in distributed shared memory: after
//     a cluster barrier every rank sums a share of the tile over ranks 0,
//     1, ... in order and stores it. Deterministic, no workspace, no host
//     read: a CUDA graph can capture it;
//   - it is launched as a programmatic dependent (PDL, the rule in
//     csrc/norm_act.cu): on the decode step x comes from kernel A or B,
//     so the first S - 1 stages' weight boxes and INT4 scales are
//     requested before `griddepcontrol.wait`, and x's copies after it;
//     it lets the kernel after it (A or B, which wait for it to finish
//     and only then let the next E launch) become resident once its K
//     loop is done, not at its start: with the trigger at the start, E
//     launched back to back (chip_smoke.py phase 3b) ran up to 1.3x
//     slower at m8 on wqkv and gate|up, the next launch's blocks sharing
//     the SMs with a decode E that still streams.
// Prefill mode (16 < m < 1024 but the decode mode's narrow 17-48; float32
// 16 < m: the 64-row prefill tails, mixed steps, a wide verify).
// Bound by tensor-core operations above m ~ 75. The design:
//   - a block owns 128 output columns x 64 or 128 x rows, no split-K;
//     3 warpgroups: one producer thread issues TMA loads of the x tiles
//     (bf16 [rows, 64 K] boxes, 128-byte swizzle, the layout wgmma reads
//     as B) and the weight tile (int8 bytes [stored rows, 128 columns],
//     128-byte swizzle, so the dequantizing reads hit distinct banks),
//     128 K rows a stage, into a 4-stage ring guarded by an mbarrier pair
//     a stage; two consumer warpgroups (64 columns each, `setmaxnreg`
//     232) dequantize their weight fragments into registers and issue
//     `wgmma.mma_async m64nNk16` with A from registers, B from the ring;
//   - the A registers alternate between two sets, so a stage's dequant
//     overlaps the previous stage's wgmma (wait_group 1), and a stage is
//     released as soon as the wgmmas reading it have completed;
//   - INT4 keeps the JAX numerics: each scale group (a multiple of 64
//     rows) accumulates into a second set of f32 registers (scale-d = 0
//     at its first k-step), then acc += partial * scale[column];
//     INT8 has one accumulator, scaled in the epilogue;
//   - TMA zero-fills rows past m, columns past n and the K tail.
// Both modes sit under the two C entry points of each dtype
// (`int4_matmul`, `int8_matmul`, suffixed `_f16` / `_f32` for the float
// instances); `dispatch` picks the mode by m (and INT4 groups other than
// 64 and 128 take the prefill mode at any m), and `quant_matmul_plan`
// reports the plan (ops/quant.py mirrors it in Python for the CPU tests).

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// the plan
// ---------------------------------------------------------------------------

constexpr int kDecodeM = 48;          // m <= this: the decode mode
constexpr int kDecodeMF32 = 16;       // the same for the float32 instances
constexpr int kDecCols = 64;          // output columns of a decode block
constexpr int kDecThreads = 128;      // 2 pairs of warps, 32 columns a warp
constexpr int kInt8Unit = 128;        // K rows of an INT8 split unit
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kRedPitch = kDecCols + 4;   // floats a row of partial sums

constexpr int kPreCols = 128;         // output columns of a prefill block
constexpr int kPreK = 128;            // K elements a prefill stage
constexpr int kPreStages = 4;
constexpr int kPreThreads = 384;      // 2 consumer warpgroups + producer

// A decode stage: 128 stored weight rows of 64 columns (INT4: 256 K
// rows; INT8: 128), a TMA box of 8 KB, 1024-aligned; the stage's x rows
// [BM][kK] bf16, rows padded by 16 bytes; (INT4) the scales of its groups
// [<= 4][64] f32. INT4 keeps 3 stages, INT8 4 (3 at 32 and 48 rows): 5
// blocks an SM at m <= 8, 4 at m <= 16; INT4 2 at 32 and 48 rows (79 and
// 105 KB a block), INT8 4 and 3.
template <bool INT4, int BM>
struct Dec {
  static constexpr int kK = INT4 ? 256 : 128;       // K rows a stage
  // INT8 at 32 and 48 rows keeps 3 stages, 3-4 blocks an SM (4 stages,
  // or deeper rings at one block an SM, ran no faster on the H100)
  static constexpr int kStages = INT4 || BM > 16 ? 3 : 4;
  static constexpr int kRows = 128;                 // stored rows a stage
  static constexpr int kW = kRows * kDecCols;       // 1024-aligned
  static constexpr int kXPitch = kK * 2 + 16;       // bytes an x row
  static constexpr int kX = BM * kXPitch;
  static constexpr int kS = INT4 ? kK / 64 * kDecCols * 4 : 0;
  static constexpr int kSmem = 1024 + kStages * (kW + kX + kS) + 8 * kStages;
  // the pairs' sums [BM][kRedPitch] reuse the weight boxes
  static_assert(BM * kRedPitch * 4 <= kStages * kW, "the sums fit the ring");
};

template <bool INT4, int N>
struct Pre {
  static constexpr int kXAtom = N * 128;                    // [N][64] bf16
  static constexpr int kXBytes = 2 * kXAtom;                // [2][N][64]
  static constexpr int kWRows = INT4 ? kPreK / 2 : kPreK;   // stored rows
  static constexpr int kWBytes = kWRows * kPreCols;         // [rows][128]
  static constexpr int kStage = kXBytes + kWBytes;          // 1024-aligned
  static constexpr int kSmem = 1024 + kPreStages * kStage + 2 * kPreStages * 8;
};

// The float32 instances (quant_matmul_f32.cu). A decode stage holds the
// same weight box; its x rows are 4-byte values, each of the 8 K slices
// of a row 16 bytes apart from the last (the two slices a warp reads sit
// in distinct banks), so a stage's x takes twice bf16's bytes. The
// prefill mode takes 128 x rows by 128 columns a block, 32 K rows a
// stage: x [128][32] f32 at a 144-byte pitch and the weight's bytes by
// cp.async, then the stage's weights dequantized once into f32 [32][128]
// (two such tiles, one filled while the other is read).
constexpr int kF32Slices = 8;         // K slices of a decode block
constexpr int kF32Cols = 4;           // adjacent columns a decode thread
template <bool INT4, int BM>
struct DecF32 {
  static constexpr int kK = INT4 ? 256 : 128;
  static constexpr int kStages = INT4 ? 3 : 4;
  static constexpr int kRows = 128;
  static constexpr int kW = kRows * kDecCols;
  static constexpr int kSlice = kK / kF32Slices;    // K rows a slice
  static constexpr int kXPitch = kK * 4 + kF32Slices * 16 + 16;
  static constexpr int kX = BM * kXPitch;
  static constexpr int kS = INT4 ? kK / 64 * kDecCols * 4 : 0;
  static constexpr int kSmem = 1024 + kStages * (kW + kX + kS) + 8 * kStages;
  // the slices' sums [8][BM][64] and the block's [BM][kRedPitch] reuse
  // the ring
  static_assert((kF32Slices * BM * kDecCols + BM * kRedPitch) * 4 <=
                    kStages * (kW + kX + kS),
                "the sums must fit in the ring");
};

constexpr int kPreF32Rows = 128;      // x rows a prefill block
constexpr int kPreF32K = 32;          // K rows a prefill stage
constexpr int kPreF32Stages = 4;
constexpr int kPreF32Threads = 256;   // 16 x 16 threads, 8 x 8 outputs each
template <bool INT4>
struct PreF32 {
  static constexpr int kXPitch = kPreF32K * 4 + 16;           // bytes
  static constexpr int kX = kPreF32Rows * kXPitch;
  static constexpr int kWRows = INT4 ? kPreF32K / 2 : kPreF32K;
  static constexpr int kWB = kWRows * kPreCols;               // bytes
  static constexpr int kStage = kX + kWB;
  static constexpr int kWF = 2 * kPreF32K * kPreCols * 4;     // 2 f32 tiles
  static constexpr int kSmem = 128 + kPreF32Stages * kStage + kWF;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The fragment mode (INT4, a 16-bit x, m <= 16): a warp owns 64 columns
// (four m16 tiles) and a K slice of whole scale groups; a block of 4 warps
// holds wc column groups x 4 / wc slices, a cluster cs blocks along K.
// A lane holds 3 chunks of 64 K rows (16 bytes a tile each): two in
// flight while it computes on the third.
constexpr int kFragThreads = 128;
constexpr int kFragWarpCols = 64;
constexpr int kFragChunkK = 64;
constexpr int kFragBufs = 3;
constexpr int kFragMinSliceK = 128;   // K rows a warp's slice keeps on average
constexpr int kFragFillSliceK = 256;  // ... to count as filling the card
constexpr int kFragFill = 256;        // blocks (1024 warps) that fill the card
constexpr int kSmemMax = 232448;      // dynamic shared memory a block may take
// blocks an SM the launch bounds allow at x tiles of 8 and 16 rows
template <int BM>
constexpr int kFragOcc = BM == 8 ? 4 : 3;
constexpr int frag_occ(int rows) {
  return rows == 8 ? kFragOcc<8> : kFragOcc<16>;
}

struct Plan {
  int mode;      // 0 decode, 1 prefill, 2 fragment
  int rows;      // x rows a block
  int cols;      // output columns a block
  int cluster;   // decode: blocks of a cluster along K
  int blocks;    // grid size
  int stages;    // ring stages
  int smem;      // dynamic shared memory a block
  int tiles_n;   // column tiles of one half
  int su;        // decode: K rows of a split unit
  int nsu;       // decode: split units along K
};

// A function of the shapes, x's element size (2: bf16 and f16 share every
// size; 4: the float32 instances) and the SM count only. INT4 groups
// other than 64 and 128 (a half stage must hold whole groups) take the
// prefill mode.
#ifdef PLAN_SWEEP
// tools/plan_sweep.py only: a forced decode cluster (0: the plan's), and
// a forced mode (0: the plan's, 1: prefill, 2: decode wherever it runs)
int g_force_cluster = 0, g_force_mode = 0;
#endif

// The decode mode's cluster along K, each rank keeping >= kMinRankK rows
// of whole split units: the smallest power of two (<= 8) that gives >= 2
// blocks an SM at x tiles of 8 and 16 rows (4-5 resident an SM); at 32
// and 48 rows, >= 1 block on 7/8 of the SMs (INT4: 2 resident) or
// >= 4/3 blocks an SM (INT8, 3-4 resident). Swept on the H100
// (tools/plan_sweep.py, PERF.md): at the draft's widths (tinyllama-1.1b
// and its tp = 2 shards, n 1280-5632) no cluster reaches the target and
// the largest was fastest down to 256 rows a rank, a rank of 128 rows
// slower; at 40 rows the clusters that 8 rows take ran up to 1.6x slower
// than these. No 7B projection's cluster at m <= 16 changes.
constexpr int kMinRankK = 256;
int decode_cluster(long long tiles, int su, int nsu, int rows, bool int4,
                   int sms) {
  const long long fill = rows <= 16 ? 2LL * sms
                         : int4     ? sms - sms / 8
                                    : sms + sms / 3;
  int cs = 1;
  while (cs < kMaxCluster && (long long)(nsu / (2 * cs)) * su >= kMinRankK &&
         tiles * cs < fill)
    cs *= 2;
#ifdef PLAN_SWEEP
  if (g_force_cluster > 0) cs = g_force_cluster;
#endif
  return cs;
}

// Dynamic shared memory of a fragment-mode block: x's rows of its K range
// at a pitch 16 bytes past them (so the 8 rows an ldmatrix reads sit in
// distinct banks) and the scales of its groups and columns, which the
// warps' partial sums [4][rows][kRedPitch] reuse after the K loop, then
// an mbarrier for each round of x (a chunk of every slice).
int frag_smem(int rows, int k, int group, int cs, int wc) {
  const int groups = cdiv(k / group, cs);
  const int x = rows * (groups * group * 2 + 16);
  const int scales = groups * wc * kFragWarpCols * 4;
  const int bars = cdiv(k / group, cs * (4 / wc)) * (group / kFragChunkK) * 8;
  const int red = 4 * rows * kRedPitch * 4;
  return (x + scales > red ? x + scales : red) + bars;
}

#ifdef PLAN_SWEEP
// tools/plan_sweep.py only: a forced fragment-mode arrangement (0: the
// plan's)
int g_force_frag_wc = 0, g_force_frag_cs = 0;
#endif

// The fragment mode's arrangement. Candidates: every (wc, cs) whose warp
// K slices are whole scale groups of >= kFragMinSliceK rows on average
// (or all of K) and whose shared memory fits, in the order wc = 4, 2, 1
// (1, 2, 4 at m <= 4, where x is half as many bytes) then cs = 1, 2, 4, 8.
// The first whose slices keep >= kFragFillSliceK rows on average (a slice
// of two chunks pays its prologue twice over) and whose blocks fill the
// card (>= kFragFill) in one wave (<= sms
// x the blocks an SM holds by registers and shared memory, less a tenth
// for clusters of 4 and 8, which place less densely) wins; else, where
// every candidate is more than a wave (the widest vocabularies), of those
// with wc >= 2 and cs <= 2 the one that fills its waves best, then holds
// most blocks an SM; else the one of most blocks within a wave, then the
// smallest cluster. Chosen from
// tools/plan_sweep.py on the H100 (PERF.md); ops/quant.py `_frag_split`
// mirrors it.
void frag_plan(Plan& pl, int m, int k, int n, int halves, int group,
               int sms) {
  const int rows = m <= 8 ? 8 : 16;
  const long long ncg = (long long)cdiv(n, kFragWarpCols) * halves;
  const int G = k / group;
  int cwc[12], ccs[12], cblocks[12], ccap[12], cocc[12], csmem[12], nc = 0;
  int pick = -1;
  for (int a = 0; a < 3; ++a) {
    const int wc = m <= 4 ? 1 << a : 4 >> a;
    for (int cs = 1; cs <= kMaxCluster; cs *= 2) {
      const int S = cs * (4 / wc);
      if (S > G || G * group < S * (k < kFragMinSliceK ? k : kFragMinSliceK))
        continue;
      const int smem = frag_smem(rows, k, group, cs, wc);
      int occ = (kSmemMax + 1024) / (smem + 1024);
      if (occ > frag_occ(rows)) occ = frag_occ(rows);
      if (occ == 0) continue;
      int cap = sms * occ;
      if (cs >= 4) cap -= cap / 10;
      cwc[nc] = wc;
      ccs[nc] = cs;
      cblocks[nc] = (int)((ncg + wc - 1) / wc * cs);
      ccap[nc] = cap;
      cocc[nc] = occ;
      csmem[nc] = smem;
#ifdef PLAN_SWEEP
      if (wc == g_force_frag_wc && cs == g_force_frag_cs) pick = nc;
#endif
      ++nc;
    }
  }
  for (int i = 0; i < nc && pick < 0; ++i) {
    const int S = ccs[i] * (4 / cwc[i]);
    if (cblocks[i] >= kFragFill && cblocks[i] <= ccap[i] &&
        G * group >= S * (k < kFragFillSliceK ? k : kFragFillSliceK))
      pick = i;
  }
  if (pick < 0) {
    bool waves = nc > 0;
    for (int i = 0; i < nc; ++i) waves &= cblocks[i] > ccap[i];
    // more than a wave: blocks of >= 2 column groups in clusters of <= 2
    bool wide = false;
    for (int i = 0; i < nc; ++i) wide |= cwc[i] >= 2 && ccs[i] <= 2;
    long long best = -1;
    for (int i = 0; i < nc; ++i) {
      if (waves && wide && (cwc[i] < 2 || ccs[i] > 2)) continue;
      // waves: the slots its waves fill (%), then blocks an SM; else its
      // blocks within a wave, then the smaller cluster
      const int within = cblocks[i] < ccap[i] ? cblocks[i] : ccap[i];
      const long long key =
          waves ? (long long)cblocks[i] * 100 /
                          ((long long)cdiv(cblocks[i], ccap[i]) * ccap[i]) *
                          16 + cocc[i]
                : (long long)within * 16 + (15 - ccs[i]);
      if (key > best) {
        best = key;
        pick = i;
      }
    }
  }
  pl.mode = 2;
  pl.rows = rows;
  pl.cols = cwc[pick] * kFragWarpCols;
  pl.cluster = ccs[pick];
  pl.blocks = cblocks[pick];
  pl.stages = kFragBufs;
  pl.smem = csmem[pick];
  pl.tiles_n = cdiv(n, kFragWarpCols);
  pl.su = group;
  pl.nsu = G;
}

Plan make_plan(int m, int k, int n, int halves, bool int4, int group,
               int sms, int esize = 2) {
  Plan pl{};
  const bool f32 = esize == 4;
  // INT4 at m <= 16 with a 16-bit x: the fragment mode
  if (int4 && !f32 && m <= 16 && (group == 64 || group == 128)) {
    frag_plan(pl, m, k, n, halves, group, sms);
    return pl;
  }
  // 17-48 rows take the decode mode where the prefill mode's grid (128
  // columns a block, one 64-row tile) would hold at most half the SMs:
  // wider, that grid beat the decode mode on the H100 at every m timed
  // (llama2-7b's wqkv, gate|up and lm_head; tinyllama's gate|up)
  const bool narrow = 2LL * cdiv(n, kPreCols) * halves <= sms;
  bool decode = (m <= kDecodeMF32 || (!f32 && m <= kDecodeM && narrow)) &&
                (!int4 || group == 64 || group == 128);
#ifdef PLAN_SWEEP
  if (g_force_mode == 1) decode = false;
  if (g_force_mode == 2)
    decode = m <= (f32 ? kDecodeMF32 : kDecodeM) &&
             (!int4 || group == 64 || group == 128);
#endif
  if (decode) {
    pl.mode = 0;
    pl.rows = m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32 : 48;
    pl.cols = kDecCols;
    pl.tiles_n = cdiv(n, kDecCols);
    pl.su = int4 ? group : kInt8Unit;
    pl.nsu = cdiv(k, pl.su);
    const long long tiles = (long long)pl.tiles_n * halves;
    pl.cluster = decode_cluster(tiles, pl.su, pl.nsu, pl.rows, int4, sms);
    pl.blocks = (int)(tiles * pl.cluster);
    pl.stages = pl.rows <= 16
                    ? (int4 ? Dec<true, 8>::kStages : Dec<false, 8>::kStages)
                    : (int4 ? Dec<true, 48>::kStages : Dec<false, 48>::kStages);
    if (f32)
      pl.smem = pl.rows == 8 ? (int4 ? DecF32<true, 8>::kSmem
                                     : DecF32<false, 8>::kSmem)
                             : (int4 ? DecF32<true, 16>::kSmem
                                     : DecF32<false, 16>::kSmem);
    else if (pl.rows <= 16)
      pl.smem = pl.rows == 8 ? (int4 ? Dec<true, 8>::kSmem
                                     : Dec<false, 8>::kSmem)
                             : (int4 ? Dec<true, 16>::kSmem
                                     : Dec<false, 16>::kSmem);
    else
      pl.smem = pl.rows == 32 ? (int4 ? Dec<true, 32>::kSmem
                                      : Dec<false, 32>::kSmem)
                              : (int4 ? Dec<true, 48>::kSmem
                                      : Dec<false, 48>::kSmem);
  } else {
    pl.mode = 1;
    pl.rows = f32 ? kPreF32Rows : m <= 64 ? 64 : 128;
    pl.cols = kPreCols;
    pl.tiles_n = cdiv(n, kPreCols);
    pl.cluster = 1;
    pl.blocks = pl.tiles_n * halves * cdiv(m, pl.rows);
    pl.stages = f32 ? kPreF32Stages : kPreStages;
    if (f32)
      pl.smem = int4 ? PreF32<true>::kSmem : PreF32<false>::kSmem;
    else
      pl.smem = pl.rows == 64
                    ? (int4 ? Pre<true, 64>::kSmem : Pre<false, 64>::kSmem)
                    : (int4 ? Pre<true, 128>::kSmem : Pre<false, 128>::kSmem);
  }
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

template <typename E>
struct Params {
  const E* x;              // [m, k]
  const int8_t* q;         // [halves][kr, n], kr = k/2 (INT4) or k
  const float* scale;      // [halves][groups, n], groups = k/group or 1
  void* out;               // [m, halves * n]
  long long q_half;        // elements between the two halves of q
  long long s_half;        // elements between the two halves of scale
  int m, k, n, halves, group, out_f32;
  int tiles_n, cluster, su, nsu;   // from the plan
  const int8_t* q_frag;    // INT4: q in fragment order (the fragment mode)
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

template <typename E>
constexpr bool kIsHalf = std::is_same<E, __half>::value;

// Bytes 0 .. NB-1 of w, each two signed nibbles (low: K row 2r, high:
// K row 2r + 1) -> NB E pairs, the low nibble in the low half. Exact:
// nibble ^ 8 is the value + 8 in [0, 15]; 0x4300 | u is the bf16 of
// 128 + u and 1 * x - 136 rounds nothing, 0x6400 | u the f16 of 1024 + u
// and 1 * x - 1032 rounds nothing. A byte permute, a LOP3 and an FMA a
// pair.
template <typename E, int NB>
__device__ __forceinline__ void int4_to_x2(uint32_t w, uint32_t* o) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t h = u >> 4;   // byte i: its high nibble in bits 0-3
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    if constexpr (kIsHalf<E>) {
      const uint32_t v =
          (__byte_perm(u, h, i | ((4 + i) << 8)) & 0x000F000Fu) | 0x64006400u;
      asm("fma.rn.f16x2 %0, %1, %2, %3;\n"
          : "=r"(o[i])
          : "r"(v), "r"(0x3C003C00u), "r"(0xE408E408u));
    } else {
      const uint32_t v =
          (__byte_perm(u, h, i | ((4 + i) << 8)) & 0x000F000Fu) | 0x43004300u;
      asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
          : "=r"(o[i])
          : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
    }
  }
}

// Byte i of u (int8 ^ 0x80, i.e. value + 128) -> the f32 value, exact:
// 0x4b0000uu is 2^23 + u.
__device__ __forceinline__ float biased_byte_to_f32(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540u | i)) -
         8388736.f;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t pack_f16x2(float lo, float hi) {
  const __half2 r = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <typename E>
__device__ __forceinline__ uint32_t pack_x2(float lo, float hi) {
  if constexpr (kIsHalf<E>)
    return pack_f16x2(lo, hi);
  else
    return pack_bf16x2(lo, hi);
}

template <typename E>
__device__ __forceinline__ E round_to(float v) {
  if constexpr (kIsHalf<E>)
    return __float2half_rn(v);
  else
    return __float2bfloat16_rn(v);
}

// Bytes 0 and 1 (sel 0x4140) or 2 and 3 (0x4342) of u (int8 ^ 0x80, the
// value + 128) -> an f16 pair, exact: 0x64uu is the f16 of 1024 + u, and
// 1 * x - 1152 rounds nothing.
__device__ __forceinline__ uint32_t biased_bytes_to_f16x2(uint32_t u,
                                                         uint32_t sel) {
  uint32_t o;
  asm("fma.rn.f16x2 %0, %1, %2, %3;\n"
      : "=r"(o)
      : "r"(__byte_perm(u, 0x64u, sel)), "r"(0x3C003C00u),
        "r"(0xE480E480u));
  return o;
}

// INT8 A fragments: w0, w1 hold K rows r and r + 1 of NC consecutive
// columns (NC = 2 or 4 bytes). o[i] = column i's (row r, row r + 1) as an
// E pair (exact: |v| <= 128).
template <typename E, int NC>
__device__ __forceinline__ void int8_pairs(uint32_t w0, uint32_t w1,
                                           uint32_t* o) {
#pragma unroll
  for (int j = 0; j < NC / 2; ++j) {
    const uint32_t u =
        __byte_perm(w0, w1, j ? 0x7362u : 0x5140u) ^ 0x80808080u;
    if constexpr (kIsHalf<E>) {
      o[2 * j] = biased_bytes_to_f16x2(u, 0x4140u);
      o[2 * j + 1] = biased_bytes_to_f16x2(u, 0x4342u);
    } else {
      o[2 * j] =
          pack_bf16x2(biased_byte_to_f32(u, 0), biased_byte_to_f32(u, 1));
      o[2 * j + 1] =
          pack_bf16x2(biased_byte_to_f32(u, 2), biased_byte_to_f32(u, 3));
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t lds16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

template <typename E>
__device__ __forceinline__ void mma_x(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (kIsHalf<E>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename E>
__device__ __forceinline__ void store_pair(const Params<E>& p, long long o,
                                           float v0, float v1) {
  if (p.out_f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
        make_float2(v0, v1);
  } else {
    *reinterpret_cast<uint32_t*>(static_cast<E*>(p.out) + o) =
        pack_x2<E>(v0, v1);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Programmatic dependent launch: wait for the previous kernel's results
// (at once without the launch attribute), and let the next kernel launch.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// decode mode
// ---------------------------------------------------------------------------

// Byte (row r, column c) of a [rows][64] tile stored with the 64-byte
// swizzle (16-byte chunk index ^ ((r / 2) % 4)).
__device__ __forceinline__ const unsigned char* sw64_at(
    const unsigned char* tile, int r, int c) {
  return tile + r * 64 + ((((c >> 4) ^ ((r >> 1) & 3)) << 4) | (c & 15));
}

// One block: BM x rows (m <= BM) by 64 columns of one half, the K rows of
// its cluster rank, in stages of 256 K rows through a ring of S slots
// (Dec). Thread 0 loads a stage's weight box by TMA; every thread copies
// its share of the stage's x rows (zero past m and past the rank's K
// rows) and INT4 scales by cp.async and arrives on the stage's barrier
// when they land, so x is staged once a block, a stage at a time, behind
// the weights. S - 1 stages are in flight; the block's barrier at the end
// of each stage frees its slot.
// A stage's first 128 K rows go to warps 0-1, its second to warps 2-3
// (whole scale groups: the plan sends groups other than 64 and 128 to the
// prefill mode); warp w owns columns (w % 2) * 32 .. + 32, as two m16
// tiles whose four columns a thread reads with one 32-bit load.
template <typename E, bool INT4, int BM>
__global__ void __launch_bounds__(kDecThreads)
    quant_matmul_decode(const __grid_constant__ CUtensorMap wmap,
                        const Params<E> p) {
  using D = Dec<INT4, BM>;
  constexpr int S = D::kStages;
  constexpr int NT = BM / 8;
  constexpr int HR = D::kRows / 2;   // stored rows of a half stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);       // S weight boxes
  unsigned char* xring = ring + S * D::kW;         // S x parts
  float* sring = reinterpret_cast<float*>(xring + S * D::kX);  // S scales
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(sring) + S * D::kS);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp >> 1;               // which half of each stage
  const int wc = (warp & 1) * 32 + 4 * g;   // this thread's columns wc..+3
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
  // stage j into slot j % S, in two parts: what is constant (the weight
  // box by TMA, the INT4 scales) and the activations (x). Weight rows
  // past the weight's end are zero-filled by TMA, and weight rows past
  // k_hi meet zeros of x.
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
  // x's copies, then this thread's arrival on the stage's barrier when
  // all its copies so far have landed (the barrier counts arrivals and
  // bytes, not their order)
  auto issue_x = [&](int j) {
    const int s = j % S;
    const int k0 = k_lo + j * D::kK;
    unsigned char* xs = xring + s * D::kX;
    for (int i = tid; i < BM * (D::kK / 8); i += kDecThreads) {
      const int r = i / (D::kK / 8), c = (i % (D::kK / 8)) * 8;
      const bool ok = r < p.m && k0 + c < k_hi;
      cp_async16(xs + r * D::kXPitch + c * 2,
                 ok ? p.x + (long long)r * p.k + k0 + c : p.x, ok);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                     smem_u32(&full[s]))
                 : "memory");
  };
  // Launched as a programmatic dependent (launch_decode): the first S - 1
  // stages' weights and scales are requested before the wait for the
  // kernel that writes x (kernel A or B) to finish; x, and every global
  // store, come after it.
  for (int j = 0; j < S - 1 && j < nstage; ++j) issue_weights(j);
  pdl_wait();
  for (int j = 0; j < S - 1 && j < nstage; ++j) issue_x(j);

  // acc[mt][nt]: m16 tile mt (A-row g: column wc + 2 mt, A-row g + 8:
  // column wc + 2 mt + 1) by x rows nt * 8 ..
  float acc[2][NT][4], part[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = part[mt][nt][e] = 0.f;

  for (int j = 0; j < nstage; ++j) {
    if (j + S - 1 < nstage) {
      issue_weights(j + S - 1);
      issue_x(j + S - 1);
    }
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    const unsigned char* ws = ring + s * D::kW + pair * HR * 64;
    const unsigned char* xs = xring + s * D::kX;
    const float* ss = sring + s * (D::kS / 4);
#pragma unroll
    for (int h = 0; h < D::kK / 128; ++h) {   // units of 64 K rows
      const int ku = pair * (D::kK / 2) + h * 64;   // K offset in the stage
      const int kk = j * D::kK + ku;                // K offset in the slice
      if (k_lo + kk >= k_hi) break;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[2][4];   // [m tile][fragment register]
        if constexpr (INT4) {
          const int r = h * 32 + ks * 8 + t;
          uint32_t lo[4], hi[4];   // columns wc .. wc + 3
          int4_to_x2<E, 4>(lds32(sw64_at(ws, r, wc)), lo);
          int4_to_x2<E, 4>(lds32(sw64_at(ws, r + 4, wc)), hi);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            a[mt][0] = lo[2 * mt];
            a[mt][1] = lo[2 * mt + 1];
            a[mt][2] = hi[2 * mt];
            a[mt][3] = hi[2 * mt + 1];
          }
        } else {
          const int r = h * 64 + ks * 16 + 2 * t;
          uint32_t lo[4], hi[4];
          int8_pairs<E, 4>(lds32(sw64_at(ws, r, wc)),
                           lds32(sw64_at(ws, r + 1, wc)), lo);
          int8_pairs<E, 4>(lds32(sw64_at(ws, r + 8, wc)),
                           lds32(sw64_at(ws, r + 9, wc)), hi);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            a[mt][0] = lo[2 * mt];
            a[mt][1] = lo[2 * mt + 1];
            a[mt][2] = hi[2 * mt];
            a[mt][3] = hi[2 * mt + 1];
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned char* xr =
              xs + (nt * 8 + g) * D::kXPitch + (ku + ks * 16 + 2 * t) * 2;
          const uint32_t b0 = lds32(xr), b1 = lds32(xr + 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_x<E>(INT4 ? part[mt][nt] : acc[mt][nt], a[mt], b0, b1);
        }
      }
      if constexpr (INT4) {
        if (((kk + 64) & (p.group - 1)) == 0) {   // a group ends: fold it
          const float4 s4 = *reinterpret_cast<const float4*>(
              ss + (ku / p.group) * kDecCols + wc);
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[mt][nt][e] += part[mt][nt][e] * sv[2 * mt + (e >> 1)];
                part[mt][nt][e] = 0.f;
              }
        }
      }
    }
    __syncthreads();   // slot j % S is free for stage j + S
  }

  // the K loop is done: the kernel after this one (A or B) may become
  // resident and load its constants while the sums meet
  pdl_launch_dependents();

  // the two halves' sums meet in shared memory (the ring is free), pair 0
  // first; d0/d1 of a tile hold x rows 2t and 2t + 1 of its A-row g
  float* red = reinterpret_cast<float*>(ring);   // [BM][kRedPitch]
  for (int turn = 0; turn < 2; ++turn) {
    if (pair == turn) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& r = red[(nt * 8 + 2 * t + (e & 1)) * kRedPitch + wc +
                           2 * mt + (e >> 1)];
            r = turn ? r + acc[mt][nt][e] : acc[mt][nt][e];
          }
    }
    __syncthreads();
  }

  // every rank sums a share of the tile over the ranks, in rank order
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
    const long long o = r * ldo + (long long)half * p.n + gc;
    if (p.out_f32)
      static_cast<float*>(p.out)[o] = v;
    else
      static_cast<E*>(p.out)[o] = round_to<E>(v);
  }
  cluster.sync();   // every block's partial sums stay until all have read
}

// ---------------------------------------------------------------------------
// fragment mode (INT4, a 16-bit x, m <= 16)
// ---------------------------------------------------------------------------
//
// Replaces, with the decode and prefill modes, the JAX package's
// llm_inference_engine_tpu/ops/quant.py `_int4_matmul_kernel` on the
// decode step's rows. Bound by HBM bytes: every weight byte is read once
// and used by at most 16 rows (2 to 64 operations a byte), so the kernel
// has to keep enough weight bytes in flight and spend few instructions a
// byte. It reads the weight's copy in fragment order (ops/quant.py
// `repack_int4_decode`, made once on the card when an engine is built):
// for each m16 tile (16 columns) and chunk of 64 K rows, lane l's 16 bytes
// are its mma.sync A fragments of the chunk's four k16 steps, so
//   - a lane loads its weights straight into registers, one 128-bit load a
//     tile and chunk (a warp's 512 contiguous bytes), three chunks held:
//     two in flight while it computes on the third, >= 32 KB an SM; no
//     TMA, no shared-memory weight ring, no swizzle, no barrier a stage;
//   - a 32-bit word holds register i's two K rows at bits 4i and 16 + 4i,
//     so one LOP3 (mask, sign bias and exponent in one) and one FMA make
//     an exact bf16 / f16 pair (`frag_to_x2`), plus a shift for three of
//     four pairs (bf16) or one of four (f16);
//   - x is staged in shared memory once a block (its K range, rows past m
//     zero-filled by cp.async without a read) in rounds, round r the r-th
//     chunk of every slice behind an mbarrier, so a warp starts on its
//     first chunk while the rest of x lands; read by ldmatrix, each x
//     fragment feeds the warp's four m16 tiles, and a block of wc column
//     groups shares its x over 64 wc columns;
//   - one f32 partial a scale group (an mma with a zero C opens it), then
//     acc += partial * scale[column] (the JAX numerics); the scales of the
//     block's groups are staged beside x;
//   - split-K only as far as the plan needs blocks to fill the card: the
//     warps of a block and the blocks of a cluster each take whole groups,
//     and every partial meets in one reduction, summed in K order by every
//     rank of the cluster through distributed shared memory, four columns
//     a load (deterministic, no atomics, no workspace, no host read);
//   - a programmatic dependent (the PDL rule, csrc/norm_act.cu): its first
//     chunks and its scales are requested before `griddepcontrol.wait`, x
//     and every store after it.

template <typename E>
struct FragParams {
  const E* x;              // [m, k]
  const uint4* qd;         // [halves][n/16 tiles][k/64 chunks][32 lanes]
  const float* scale;      // [halves][groups, n]
  void* out;               // [m, halves * n]
  long long qd_half;       // 16-byte words between the two halves of qd
  long long s_half;        // floats between the two halves of scale
  int m, k, n, halves, out_f32;
  int tiles;               // m16 tiles of one half (n / 16)
  int ncg;                 // 64-column groups of one half
  int wc, cs;              // column groups a block, blocks a cluster
  int groups;              // scale groups along K
  int kb_groups;           // groups of the longest block K range
};

__device__ __forceinline__ uint32_t lop3_6a(uint32_t a, uint32_t b,
                                            uint32_t c) {
  // (b & (a ^ c)) | (~b & c): a's bits under the mask b, flipped where c
  // has a bit, c's bits elsewhere
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t fma_x2(bool half, uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  if (half)
    asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  else
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// A fragment-order word -> the tile's four A registers at one k16 step.
// Register i's nibbles sit at bits 4i (even K row) and 16 + 4i (odd).
// Exact: the LOP3 sets each half to 0x4300 | (nibble ^ 8), the bf16 of
// 128 + value + 8, and 1 * x - 136 rounds nothing; in f16 0x6400 |
// (nibble ^ 8) is 1024 + value + 8 (less 1032), and for the nibbles at
// bits 4-7 of a half 0x6400 | (nibble ^ 8) << 4 is 1024 + 16 (value + 8),
// times 1/16 less 72: every step exact in f16.
template <typename E>
__device__ __forceinline__ void frag_to_x2(uint32_t w, uint32_t (&a)[4]) {
  if constexpr (kIsHalf<E>) {
    const uint32_t h = w >> 8;
    a[0] = fma_x2(true, lop3_6a(w, 0x000F000Fu, 0x64086408u), 0x3C003C00u,
                  0xE408E408u);
    a[1] = fma_x2(true, lop3_6a(w, 0x00F000F0u, 0x64806480u), 0x2C002C00u,
                  0xD480D480u);
    a[2] = fma_x2(true, lop3_6a(h, 0x000F000Fu, 0x64086408u), 0x3C003C00u,
                  0xE408E408u);
    a[3] = fma_x2(true, lop3_6a(h, 0x00F000F0u, 0x64806480u), 0x2C002C00u,
                  0xD480D480u);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = fma_x2(false, lop3_6a(w >> (4 * i), 0x000F000Fu, 0x43084308u),
                    0x3F803F80u, 0xC308C308u);
  }
}

// D = A B (a zero C: the first k16 step of a scale group)
template <typename E>
__device__ __forceinline__ void mma_x0(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  const float z = 0.f;
  if constexpr (kIsHalf<E>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(z));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(z));
}

// 16 bytes the kernel reads once: not kept in L1
__device__ __forceinline__ uint4 ldg_stream(const uint4* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One block: 4 warps, wc column groups of 64 columns by 4 / wc K slices,
// rank `rank` of a cluster of cs along K. Warp (wks, wcol) computes its
// column group over slice rank x 4 / wc + wks of S = cs x 4 / wc, whole
// scale groups [i G / S, (i + 1) G / S). BM: 8 (m <= 8) or 16 x rows;
// GROUP: 64 or 128 (one or two chunks a group).
template <typename E, int BM, int GROUP>
__global__ void __launch_bounds__(kFragThreads, kFragOcc<BM>)
    quant_matmul_fragment(const FragParams<E> p) {
  constexpr int NT = BM / 8;                  // n8 tiles of x rows
  constexpr int GC = GROUP / kFragChunkK;     // chunks a scale group
  constexpr int U = kFragBufs * GC;           // chunks a loop turn
  extern __shared__ __align__(16) unsigned char frag_raw[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = p.cs > 1 ? (int)cluster.block_rank() : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk = 4 / p.wc;
  const int wcol = warp % p.wc, wks = warp / p.wc;
  const int tile = blockIdx.x / p.cs;
  const int ncg_all = p.ncg * p.halves;
  const int cgw = tile * p.wc + wcol;         // this warp's column group
  const bool live = cgw < ncg_all;
  const int half = live ? cgw / p.ncg : 0;
  const int tile0 = (cgw - half * p.ncg) * 4;     // its first m16 tile

  // K: this block's groups [gb_lo, gb_hi), this warp's [g_lo, g_hi)
  const int S = p.cs * wk;
  const int gb_lo = (int)((long long)rank * wk * p.groups / S);
  const int gb_hi = (int)((long long)(rank + 1) * wk * p.groups / S);
  const int sl = rank * wk + wks;
  const int g_lo = (int)((long long)sl * p.groups / S);
  const int g_hi = (int)((long long)(sl + 1) * p.groups / S);
  const int nchunk = live ? (g_hi - g_lo) * GC : 0;
  const int ntile = live ? min(4, p.tiles - tile0) : 0;

  const int xpitch = p.kb_groups * GROUP * 2 + 16;   // bytes an x row
  const int scols = p.wc * kFragWarpCols;            // scale columns
  unsigned char* xs = frag_raw;                      // [BM][xpitch]
  float* ss = reinterpret_cast<float*>(frag_raw + BM * xpitch);
  // x arrives in rounds, round r the r-th chunk of every slice of the
  // block, each behind an mbarrier: a warp computes chunk r as soon as
  // round r has landed
  const int rounds = (p.groups + S - 1) / S * GC;
  const int data = BM * xpitch + p.kb_groups * scols * 4;
  const int red_bytes = 4 * BM * kRedPitch * 4;
  uint64_t* xbar = reinterpret_cast<uint64_t*>(
      frag_raw + (data > red_bytes ? data : red_bytes));
  if (tid == 0) {
    for (int r = 0; r < rounds; ++r) mbar_init(&xbar[r], kFragThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the weights: chunk c of tile mt at wq[mt * tstride + c * 32]
  const long long tstride = (long long)(p.k / kFragChunkK) * 32;
  const uint4* wq = p.qd + half * p.qd_half + tile0 * tstride +
                    (long long)g_lo * GC * 32 + lane;
  uint4 buf[kFragBufs][4];
  auto load = [&](uint4 (&b)[4], int c) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      if (c < nchunk && mt < ntile) b[mt] = ldg_stream(wq + mt * tstride + c * 32);
  };
  // constants first: the first chunks and the block's scales
#pragma unroll
  for (int i = 0; i < kFragBufs; ++i) load(buf[i], i);
  const int ng = gb_hi - gb_lo;
  for (int i = tid; i < ng * (scols / 4); i += kFragThreads) {
    const int gi = i / (scols / 4), c = (i % (scols / 4)) * 4;
    const int cgc = tile * p.wc + c / kFragWarpCols;
    const int hc = cgc < ncg_all ? cgc / p.ncg : 0;
    const int col = (cgc - hc * p.ncg) * kFragWarpCols + c % kFragWarpCols;
    const bool ok = cgc < ncg_all && col < p.n;
    cp_async16(ss + gi * scols + c,
               ok ? p.scale + hc * p.s_half + (long long)(gb_lo + gi) * p.n +
                        col
                  : p.scale,
               ok);
  }
  __syncthreads();   // the barriers are initialized
  pdl_wait();
  // x rows [0, m) of each slice's K rows, round by round (rows past m
  // zero-filled without a read); this thread's arrival on round r's
  // barrier comes when all its copies so far (its scales too) have landed
  int slo[4], schunks[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int sw = rank * wk + (w < wk ? w : 0);
    slo[w] = sw * p.groups / S;
    schunks[w] = ((sw + 1) * p.groups / S - slo[w]) * GC;
  }
  for (int r = 0; r < rounds; ++r) {
    for (int i = tid; i < wk * BM * (kFragChunkK / 8); i += kFragThreads) {
      const int w = i / (BM * (kFragChunkK / 8));
      const int row = (i / (kFragChunkK / 8)) % BM;
      const int kc = (i % (kFragChunkK / 8)) * 8;
      if (r >= schunks[w]) continue;
      const int kx = slo[w] * GROUP + r * kFragChunkK + kc;   // x's column
      const bool ok = row < p.m;
      cp_async16(xs + row * xpitch + (kx - gb_lo * GROUP) * 2,
                 ok ? p.x + (long long)row * p.k + kx : p.x, ok);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                     smem_u32(&xbar[r]))
                 : "memory");
  }

  // ldmatrix.x4: NT 1, matrices (rows 0-7) x K 0-7, 8-15, 16-23, 24-31:
  // b0, b1 of two k16 steps; NT 2, (rows 0-7, 8-15) x K 0-7, 8-15: b0, b1
  // of both n8 tiles at one step
  const int lrow = (NT == 2 ? (lane >> 4) * 8 : 0) + (lane & 7);
  const int lk = NT == 2 ? ((lane >> 3) & 1) * 8 : (lane >> 3) * 8;
  uint32_t xaddr = smem_u32(xs) + lrow * xpitch +
                   ((g_lo - gb_lo) * GROUP + lk) * 2;
  // this lane's scales (columns 16 mt + 2g, + 1), one row a group
  const float* sw = ss + (g_lo - gb_lo) * scols + wcol * kFragWarpCols + 2 * g;

  // acc[mt][nt]: tile mt's A rows g (column 2g) and g + 8 (column 2g + 1)
  // by x rows nt * 8 + 2t, + 1
  float acc[4][NT][4], part[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int c0 = 0; c0 < nchunk; c0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      if (u % GC == 0 && c >= nchunk) break;   // whole groups
      mbar_wait(&xbar[c], 0);                   // x of chunk c is here
      uint4 (&b)[4] = buf[u % kFragBufs];
#pragma unroll
      for (int j = 0; j < 4; j += 3 - NT) {
        uint32_t xb[4];
        ldsm_x4(xb, xaddr);
        xaddr += (3 - NT) * 32;
#pragma unroll
        for (int h = 0; h < 3 - NT; ++h) {
          const bool open = u % GC == 0 && j + h == 0;   // a group's first
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t a[4];
            frag_to_x2<E>(word_of(b[mt], j + h), a);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint32_t b0 = NT == 1 ? xb[2 * h] : xb[2 * nt];
              const uint32_t b1 = NT == 1 ? xb[2 * h + 1] : xb[2 * nt + 1];
              if (open)
                mma_x0<E>(part[mt][nt], a, b0, b1);
              else
                mma_x<E>(part[mt][nt], a, b0, b1);
            }
          }
        }
      }
      load(b, c + kFragBufs);
      if (u % GC == GC - 1) {   // the group is complete: fold it
        float2 sv[4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          sv[mt] = *reinterpret_cast<const float2*>(sw + mt * 16);
        sw += scols;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[mt][nt][0] += part[mt][nt][0] * sv[mt].x;
            acc[mt][nt][1] += part[mt][nt][1] * sv[mt].x;
            acc[mt][nt][2] += part[mt][nt][2] * sv[mt].y;
            acc[mt][nt][3] += part[mt][nt][3] * sv[mt].y;
          }
      }
    }
  }

  // the K loop is done: the kernel after this one may become resident
  pdl_launch_dependents();
  __syncthreads();   // every warp is done with x and the scales
  float* red = reinterpret_cast<float*>(frag_raw);   // [4][BM][kRedPitch]
  if (live) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {   // x rows 2t + e: columns 2g, + 1
          const int r = nt * 8 + 2 * t + e;
          if (r < p.m)
            *reinterpret_cast<float2*>(
                red + (warp * BM + r) * kRedPitch + mt * 16 + 2 * g) =
                make_float2(acc[mt][nt][e], acc[mt][nt][2 + e]);
        }
  }
  if (p.cs > 1)
    cluster.sync();
  else
    __syncthreads();
  // every rank sums a share of the block's outputs, four columns a load,
  // over the ranks and their slices in K order
  const int bq = p.wc * (kFragWarpCols / 4);   // column quads a row
  const long long ldo = (long long)p.halves * p.n;
  for (int i = rank * kFragThreads + tid; i < p.m * bq;
       i += p.cs * kFragThreads) {
    const int r = i / bq, q4 = i % bq;
    const int oc = q4 / (kFragWarpCols / 4);
    const int cc = (q4 % (kFragWarpCols / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sr = 0; sr < p.cs; ++sr) {
      const float* rs = p.cs > 1 ? cluster.map_shared_rank(red, sr) : red;
#pragma unroll 4
      for (int w = 0; w < wk; ++w) {
        const float4 u = *reinterpret_cast<const float4*>(
            rs + ((w * p.wc + oc) * BM + r) * kRedPitch + cc);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
    }
    const int cgo = tile * p.wc + oc;
    if (cgo >= ncg_all) continue;
    const int ho = cgo / p.ncg;
    const int col = (cgo - ho * p.ncg) * kFragWarpCols + cc;
    if (col >= p.n) continue;   // n % 16 == 0: a quad is whole or out
    const long long o = r * ldo + (long long)ho * p.n + col;
    if (p.out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) = v;
    } else {
      uint2 pk;
      pk.x = pack_x2<E>(v.x, v.y);
      pk.y = pack_x2<E>(v.z, v.w);
      *reinterpret_cast<uint2*>(static_cast<E*>(p.out) + o) = pk;
    }
  }
  if (p.cs > 1) cluster.sync();   // partial sums stay until all have read
}

// ---------------------------------------------------------------------------
// prefill mode
// ---------------------------------------------------------------------------

// wgmma descriptor of a K-major bf16 tile of 128-byte rows, 128-byte
// swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define WG_R8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x N] (+)= A[64 x 16] (registers) x B[16 x N] (shared, descriptor),
// the operands of type T ("bf16" or "f16")
#define WG_N128(T)                                                        \
  asm volatile(                                                           \
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." T "." T " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"                        \
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40),   \
        WG_R8(48), WG_R8(56)                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),            \
        "r"(scale_d))
#define WG_N64(T)                                                         \
  asm volatile(                                                           \
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." T "." T " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31}, "                                              \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"                        \
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24)                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),            \
        "r"(scale_d))

template <typename E, int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 128) {
    if constexpr (kIsHalf<E>)
      WG_N128("f16");
    else
      WG_N128("bf16");
  } else {
    if constexpr (kIsHalf<E>)
      WG_N64("f16");
    else
      WG_N64("bf16");
  }
}

#undef WG_N128
#undef WG_N64
#undef WG_R8

// Byte (row r, column c) of a [rows][128] tile stored with the 128-byte
// swizzle (16-byte chunk index ^ (r % 8)).
__device__ __forceinline__ const unsigned char* sw128_at(
    const unsigned char* tile, int r, int c) {
  return tile + r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
}

// One block: N x rows by 128 columns of one half. Warpgroups 0 and 1
// consume (64 columns each); warp 8 of warpgroup 2 produces. A stage is
// 128 K rows: two x boxes of [N rows, 64 K] (one 128-byte swizzle atom
// each) and one weight box. Scale groups (multiples of 64 rows) end after
// the stage's fourth or eighth k-step, so a stage is issued as two
// segments of 4 wgmmas; a segment that starts a group clears the partial
// (scale-d = 0), one that ends it waits for it and folds it into acc.
template <typename E, bool INT4, int N>
__global__ void __launch_bounds__(kPreThreads, 1)
    quant_matmul_prefill(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const Params<E> p) {
  using P = Pre<INT4, N>;
  constexpr int S = kPreStages;
  constexpr int NR = N / 2;   // accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S * P::kStage);
  uint64_t* empty = full + S;

  const int wg = threadIdx.x >> 7;
  const int half = blockIdx.x / p.tiles_n;
  const int col0 = (blockIdx.x - half * p.tiles_n) * kPreCols;
  const int row0 = blockIdx.y * N;
  const int nk = (p.k + kPreK - 1) / kPreK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      for (int i = 0; i < nk; ++i) {
        const int s = i % S;
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], P::kStage);
        unsigned char* st = sm + s * P::kStage;
        tma_load_2d(st, &xmap, &full[s], i * kPreK, row0);
        tma_load_2d(st + P::kXAtom, &xmap, &full[s], i * kPreK + 64, row0);
        tma_load_3d(st + P::kXBytes, &wmap, &full[s], col0, i * P::kWRows,
                    half);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wq = (threadIdx.x >> 5) & 3;
    const int wcol = wg * 64 + wq * 16;      // this warp's 16 columns
    const int c = col0 + wcol + 2 * g;       // this thread's columns c, c+1
    const float* sc = p.scale + half * p.s_half;

    float acc[NR];
    float part[INT4 ? NR : 1];
    if constexpr (INT4) {   // INT8: the first wgmma clears acc (scale-d 0)
#pragma unroll
      for (int j = 0; j < NR; ++j) acc[j] = 0.f;
    }
    uint32_t areg[2][8][4];
    float s0 = 0.f, s1 = 0.f;   // the current group's scales (INT4)
    int pend = -1;              // stage whose release waits on wgmma

    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    auto fold = [&]() {   // acc += partial * scale
#pragma unroll
      for (int j = 0; j < NR; j += 4) {
        acc[j] += part[j] * s0;
        acc[j + 1] += part[j + 1] * s0;
        acc[j + 2] += part[j + 2] * s1;
        acc[j + 3] += part[j + 3] * s1;
      }
    };
    auto scales = [&](int k0) {   // the scales of the group at row k0
      const long long grow = (long long)(k0 / p.group) * p.n;
      s0 = c < p.n ? __ldg(sc + grow + c) : 0.f;
      s1 = c < p.n ? __ldg(sc + grow + c + 1) : 0.f;
    };

    // stage i with A register set `a`
    auto stage = [&](int i, uint32_t (&a)[8][4]) {
      const int s = i % S;
      const unsigned char* st = sm + s * P::kStage;
      const unsigned char* ws = st + P::kXBytes;
      const int kb = i * kPreK;
      // INT4 group edges at the two segments (k-steps 0-3 and 4-7)
      const bool new_a = INT4 && kb % p.group == 0;
      const bool end_a = INT4 && (kb + 64) % p.group == 0;
      const bool live_b = kb + 64 < p.k;
      const bool end_b = INT4 && live_b &&
                         ((kb + kPreK) % p.group == 0 || i == nk - 1);
      if (new_a) scales(kb);
      mbar_wait(&full[s], (i / S) & 1);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if constexpr (INT4) {
          const int r = ks * 8 + t;
          int4_to_x2<E, 2>(lds16(sw128_at(ws, r, wcol + 2 * g)), &a[ks][0]);
          int4_to_x2<E, 2>(lds16(sw128_at(ws, r + 4, wcol + 2 * g)),
                           &a[ks][2]);
        } else {
          const int r = ks * 16 + 2 * t;
          const int cc = wcol + 2 * g;
          int8_pairs<E, 2>(lds16(sw128_at(ws, r, cc)),
                           lds16(sw128_at(ws, r + 1, cc)), &a[ks][0]);
          int8_pairs<E, 2>(lds16(sw128_at(ws, r + 8, cc)),
                           lds16(sw128_at(ws, r + 9, cc)), &a[ks][2]);
        }
      }
      const uint64_t desc_a = sw128_desc(st), desc_b = sw128_desc(st + P::kXAtom);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if constexpr (INT4)
          wgmma_rs<E, N>(part, a[ks], desc_a + 2 * ks,
                         new_a && ks == 0 ? 0 : 1);
        else
          wgmma_rs<E, N>(acc, a[ks], desc_a + 2 * ks,
                         i == 0 && ks == 0 ? 0 : 1);
      }
      if constexpr (INT4) {
        if (end_a || !live_b) {   // a group ends mid-stage (or K does)
          wgmma_commit();
          wgmma_wait<0>();
          fold();
          if (!live_b) {
            if (pend >= 0) release(pend);
            release(s);
            pend = -1;
            return;
          }
          scales(kb + 64);
          wgmma_fence();
        }
      }
#pragma unroll
      for (int ks = 4; ks < 8; ++ks) {
        if constexpr (INT4)
          wgmma_rs<E, N>(part, a[ks], desc_b + 2 * (ks - 4),
                         end_a && ks == 4 ? 0 : 1);
        else
          wgmma_rs<E, N>(acc, a[ks], desc_b + 2 * (ks - 4), 1);
      }
      wgmma_commit();
      if constexpr (INT4) {
        if (end_b) {   // the group is complete: fold it
          wgmma_wait<0>();
          if (pend >= 0) release(pend);
          release(s);
          pend = -1;
          fold();
          return;
        }
      }
      wgmma_wait<1>();   // the previous stage's wgmmas are done
      if (pend >= 0) release(pend);
      pend = s;
    };

    for (int i = 0; i < nk; i += 2) {
      stage(i, areg[0]);
      if (i + 1 < nk) stage(i + 1, areg[1]);
    }
    wgmma_wait<0>();

    // epilogue: accumulator j = 4 jj + e holds x row 8 jj + 2t + (e & 1)
    // of column c + (e >> 1)
    if (c < p.n) {
      float f0 = 1.f, f1 = 1.f;
      if constexpr (!INT4) {
        f0 = sc[c];
        f1 = sc[c + 1];
      }
      const long long ldo = (long long)p.halves * p.n;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row0 + jj * 8 + 2 * t + e;
          if (r < p.m)
            store_pair(p, r * ldo + (long long)half * p.n + c,
                       acc[4 * jj + e] * f0, acc[4 * jj + 2 + e] * f1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The tensor map of a weight, bytes [halves, kr, n] (kr stored rows), in
// boxes of [rows, cols] with `swizzle`. A decode step launches the same
// weights every step, so maps are kept by (address, shape, box): the host
// encodes each once (a map holds nothing but these). Returns false if
// encoding failed.
bool weight_map(CUtensorMap* map, const int8_t* q, int n, int halves, int kr,
                int rows, int cols, CUtensorMapSwizzle swizzle) {
  struct Entry {
    const void* q;
    int n, kr, halves, rows, cols, swizzle;
    CUtensorMap map;
  };
  static Entry cache[1024];
  static int used = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.q == q && e.n == n && e.kr == kr && e.halves == halves &&
        e.rows == rows && e.cols == cols && e.swizzle == (int)swizzle) {
      *map = e.map;
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dim[3] = {(cuuint64_t)n, (cuuint64_t)kr,
                             (cuuint64_t)halves};
  const cuuint64_t stride[2] = {(cuuint64_t)n, (cuuint64_t)kr * n};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(q),
             dim, stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  Entry& e = cache[next];
  e = Entry{q, n, kr, halves, rows, cols, (int)swizzle, *map};
  next = (next + 1) % 1024;
  used = used < 1024 ? used + 1 : used;
  return true;
}

// Allow `smem` bytes of dynamic shared memory for `kernel` on the current
// device (once per size reached; an attribute set on one device does not
// reach another, so `allowed` holds a size a device).
constexpr int kMaxDevices = 16;
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}

// Launch a decode-mode kernel (E's or the float32 one: both take the
// weight box of Dec) as a programmatic dependent of the kernel before it
// (the PDL rule: csrc/norm_act.cu), in a cluster of pl.cluster blocks.
// With `blocks_per_sm`, launch nothing and report the blocks an SM holds.
template <typename E, typename K>
int launch_decode_kernel(K kernel, const Params<E>& p, const Plan& pl,
                         bool int4, int (&allowed)[kMaxDevices],
                         cudaStream_t stream, int* blocks_per_sm) {
  cudaError_t err = allow_smem(kernel, pl.smem, allowed);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kDecThreads, pl.smem);
  CUtensorMap wmap;
  if (!weight_map(&wmap, p.q, p.n, p.halves, int4 ? p.k / 2 : p.k,
                  Dec<true, 8>::kRows, kDecCols, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.blocks);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = pl.cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.cluster > 1 ? 2 : 1;   // one block: no cluster
  err = cudaLaunchKernelEx(&cfg, kernel, wmap, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename E, bool INT4, int BM>
int launch_decode(const Params<E>& p, const Plan& pl, cudaStream_t stream,
                  int* blocks_per_sm) {
  static int allowed[kMaxDevices] = {};
  return launch_decode_kernel(quant_matmul_decode<E, INT4, BM>, p, pl, INT4,
                              allowed, stream, blocks_per_sm);
}

// Launch the fragment mode (a programmatic dependent, in a cluster of
// cs blocks where cs > 1). With `blocks_per_sm`, launch nothing and
// report the blocks an SM holds.
template <typename E, int BM, int GROUP>
int launch_fragment(const Params<E>& p, const Plan& pl, cudaStream_t stream,
                    int* blocks_per_sm) {
  auto kernel = quant_matmul_fragment<E, BM, GROUP>;
  static int allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, pl.smem, allowed);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kFragThreads, pl.smem);
  if (!p.q_frag || reinterpret_cast<uintptr_t>(p.q_frag) % 16)
    return (int)cudaErrorInvalidValue;
  FragParams<E> f{};
  f.x = p.x;
  f.qd = reinterpret_cast<const uint4*>(p.q_frag);
  f.scale = p.scale;
  f.out = p.out;
  f.qd_half = p.q_half / 16;
  f.s_half = p.s_half;
  f.m = p.m;
  f.k = p.k;
  f.n = p.n;
  f.halves = p.halves;
  f.out_f32 = p.out_f32;
  f.tiles = p.n / 16;
  f.ncg = cdiv(p.n, kFragWarpCols);
  f.wc = pl.cols / kFragWarpCols;
  f.cs = pl.cluster;
  f.groups = p.k / GROUP;
  f.kb_groups = cdiv(f.groups, f.cs);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.blocks);
  cfg.blockDim = dim3(kFragThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = pl.cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.cluster > 1 ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, kernel, f);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename E, bool INT4, int N>
int launch_prefill(const Params<E>& p, const Plan& pl, cudaStream_t stream,
                   int* blocks_per_sm) {
  using P = Pre<INT4, N>;
  auto kernel = quant_matmul_prefill<E, INT4, N>;
  static int allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, P::kSmem, allowed);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kPreThreads, P::kSmem);
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  // x: E [m, k], boxes of [N rows, 64 K] (two a stage)
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[2] = {(cuuint64_t)p.k, (cuuint64_t)p.m};
  const cuuint64_t xstride[1] = {(cuuint64_t)p.k * 2};
  const cuuint32_t xbox[2] = {64, N};
  const cuuint32_t ones[2] = {1, 1};
  if (encode(&xmap,
             kIsHalf<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<E*>(p.x), xdim, xstride, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      !weight_map(&wmap, p.q, p.n, p.halves, INT4 ? p.k / 2 : p.k, P::kWRows,
                  kPreCols, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(pl.tiles_n * p.halves, cdiv(p.m, N));
  kernel<<<grid, kPreThreads, P::kSmem, stream>>>(xmap, wmap, p);
  return (int)cudaGetLastError();
}

// The plan of p's shapes, its split written into p.
template <typename E>
Plan plan_of(Params<E>& p, bool int4) {
  const Plan pl = make_plan(p.m, p.k, p.n, p.halves, int4, p.group,
                            sm_count(), (int)sizeof(E));
  p.tiles_n = pl.tiles_n;
  p.cluster = pl.cluster;
  p.su = pl.su;
  p.nsu = pl.nsu;
  return pl;
}

// The plan's mode and tile pick the instance of a 16-bit E. With
// `blocks_per_sm`, launch nothing and report the blocks an SM holds
// instead. (The float32 instances have their own, quant_matmul_f32.cu.)
template <typename E, bool INT4>
int dispatch(Params<E> p, cudaStream_t stream, int* blocks_per_sm) {
  const Plan pl = plan_of(p, INT4);
  if constexpr (INT4) {
    // m <= 16 (groups of 64 or 128): the fragment mode; INT4 keeps only
    // the decode mode's 32- and 48-row tiles
    if (pl.mode == 2) {
      if (pl.rows == 8)
        return p.group == 64
                   ? launch_fragment<E, 8, 64>(p, pl, stream, blocks_per_sm)
                   : launch_fragment<E, 8, 128>(p, pl, stream, blocks_per_sm);
      return p.group == 64
                 ? launch_fragment<E, 16, 64>(p, pl, stream, blocks_per_sm)
                 : launch_fragment<E, 16, 128>(p, pl, stream, blocks_per_sm);
    }
    if (pl.mode == 0)
      return pl.rows == 32
                 ? launch_decode<E, true, 32>(p, pl, stream, blocks_per_sm)
                 : launch_decode<E, true, 48>(p, pl, stream, blocks_per_sm);
  } else if (pl.mode == 0) {
    switch (pl.rows) {
      case 8: return launch_decode<E, INT4, 8>(p, pl, stream, blocks_per_sm);
      case 16: return launch_decode<E, INT4, 16>(p, pl, stream, blocks_per_sm);
      case 32: return launch_decode<E, INT4, 32>(p, pl, stream, blocks_per_sm);
      default: return launch_decode<E, INT4, 48>(p, pl, stream, blocks_per_sm);
    }
  }
  return pl.rows == 64
             ? launch_prefill<E, INT4, 64>(p, pl, stream, blocks_per_sm)
             : launch_prefill<E, INT4, 128>(p, pl, stream, blocks_per_sm);
}

template <typename E>
Params<E> make_params(const void* x, const void* q, const void* scale,
                      void* out, int m, int k, int n, int halves,
                      long long q_half, long long s_half, int group,
                      int out_f32, const void* q_frag = nullptr) {
  Params<E> p{};
  p.x = static_cast<const E*>(x);
  p.q = static_cast<const int8_t*>(q);
  p.q_frag = static_cast<const int8_t*>(q_frag);
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
  return p;
}

bool valid_int4(int k, int n, int group) {
  return group > 0 && group % 64 == 0 && k % group == 0 && n % 16 == 0;
}

// The bodies of each dtype's C entry points (quant_matmul.cu,
// quant_matmul_f16.cu, quant_matmul_f32.cu), over that dtype's dispatch
// `D` (dispatch<E, INT4> above, or the float32 one).
// E (INT4): requires k % group == 0, group % 64 == 0, n % 16 == 0, and
// 16-byte aligned x, q and scale (the wrapper in ops/quant.py checks);
// the fragment mode (a 16-bit x, m <= 16) also q_frag, q in fragment
// order (ops/quant.py `repack_int4_decode`), and refuses a null one.
template <typename E, int (*D)(Params<E>, cudaStream_t, int*)>
int int4_entry(const void* x, const void* q, const void* q_frag,
               const void* scale, void* out, int m, int k, int n, int halves,
               long long q_half, long long s_half, int group, int out_f32,
               void* stream) {
  if (!valid_int4(k, n, group)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return 0;
  return D(make_params<E>(x, q, scale, out, m, k, n, halves, q_half, s_half,
                          group, out_f32, q_frag),
           static_cast<cudaStream_t>(stream), nullptr);
}

// F: requires k % 8 == 0, n % 16 == 0, 16-byte aligned x and q.
template <typename E, int (*D)(Params<E>, cudaStream_t, int*)>
int int8_entry(const void* x, const void* q, const void* scale, void* out,
               int m, int k, int n, int halves, long long q_half,
               long long s_half, int out_f32, void* stream) {
  if (n % 16 || k % 8) return (int)cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return 0;
  return D(make_params<E>(x, q, scale, out, m, k, n, halves, q_half, s_half,
                          kInt8Unit, out_f32),
           static_cast<cudaStream_t>(stream), nullptr);
}

// The plan of a launch at these shapes (group: INT4 only), for reports
// and tests: out = {mode (0 decode, 1 prefill, 2 fragment), x rows a
// block, columns a block, blocks a cluster, blocks, ring stages (the
// fragment mode: chunks a lane holds), dynamic shared memory bytes,
// blocks an SM holds}.
template <typename E, int (*D4)(Params<E>, cudaStream_t, int*),
          int (*D8)(Params<E>, cudaStream_t, int*)>
int plan_entry(int m, int k, int n, int halves, int int4, int group,
               int* out) {
  if (m <= 0 || n <= 0 || n % 16 || k % 8 ||
      (int4 && !valid_int4(k, n, group)))
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(m, k, n, halves, int4 != 0,
                            int4 ? group : kInt8Unit, sm_count(),
                            (int)sizeof(E));
  const Params<E> p = make_params<E>(nullptr, nullptr, nullptr, nullptr, m,
                                     k, n, halves, 0, 0,
                                     int4 ? group : kInt8Unit, 0);
  int occ = 0;
  const int err = int4 ? D4(p, nullptr, &occ) : D8(p, nullptr, &occ);
  const int vals[8] = {pl.mode,   pl.rows,   pl.cols, pl.cluster,
                       pl.blocks, pl.stages, pl.smem, occ};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return err;
}

}  // namespace

#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``llm_inference_engine_tpu_torch``)
on one CUDA card, an H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. card check: no CUDA device -> exit non-zero; print the card's name and
   power limit (nvidia-smi) and the torch / CUDA / Triton / nvcc versions;
2. build the CUDA kernels from the sources in the checkout;
3. every hand-written kernel against its plain PyTorch version on the
   card, at Llama2-7B shapes, with its time beside the plain version's
   (CUDA events, after warm-up): A, B, J (the QKV split with RoPE at a
   prefill chunk and a decode step, bit for bit, NaN past the tails), C,
   kernel D2 (the prefill modes:
   B4 T512, GQA with and without a window, G = 8 against kv_len 2048)
   and kernel D's fused decode (split-KV over a cluster; B4, then the
   engine's B8, kv_len of one tile and one tile + 1, G = 7 with a
   window), then E and F (fused dequant-matmul, INT4 and INT8: E's
   fragment mode over the weights' fragment-order copy and F's decode
   mode at m = 8 on every projection and the lm_head and at m = 16 on
   wo and down, each with its plan (the gate|up stack's library call one
   ``_weight_int4pack_mm`` on the [k, 2I] weight); the prefill mode at
   m = 512 on
   the four projections beside G + cuBLAS; library calls
   ``_weight_int4pack_mm`` and ``_weight_int8pack_mm``), INT8 at m =
   4096 on the four projections (G8 + cuBLAS, the parent's cast + cuBLAS
   and F's prefill mode in turns; G8 and its epilogue alone, bit for
   bit) and G (INT4 dequantize, bit-identical), then (3c) H (the paged
   write) and D2's paged mode (a B=16, T=64 mixed step, then 8 x 512) over a pool
   of page 64 with a random page permutation, D's fused paged decode
   (the write through the table and the attention in one launch) at the
   server's B=16, then at 4d's shape, each bit for bit H then the
   attend-only decode and timed beside them, the attend-only decode
   alone, the mixed step and the B=16 decode cases again at page 16, and
   a G = 7 paged decode, then both bf16 decode modes at G = 4, 7 and 8
   at the engine's B8, timed; every decode row prints kernel D's split
   plan (blocks a cluster, tile, stages, shared memory, blocks an SM
   holds), and D2's tiling of every head dim is printed; the decode rows
   are held per row (DECODE_ROW_TOL); every K/V row write (C, H, H's
   int8 mode, I) prints its floor (floor_ms: one ``copy_`` of the same
   live rows under the same warm or cold method) and C and H two
   ``index_copy_``, and H and its int8
   mode are also timed at decode shape (B = 8 and 16, one token each at
   odd in-page offsets, DECODE_WRITE_STARTS), I at 8 x 64 as well as
   8 x 512; (3e) A, A with residual, B and J at decode shape (B = 8)
   held against and timed beside their plain versions and
   ``F.rms_norm``, 64
   calls captured in one CUDA graph: CUDA events around its replays, and
   the union of the kernels' intervals under the profiler; (3f) the float
   instances in float32 and float16 at 7B widths (``phase_float_kernels``:
   D2f slot, int8 and paged, Df's fused slot decode, its fused paged
   decode bit for bit H + the attend-only one (B16 at pages of 64 and
   16, 4d's B8), the attend-only paged decode, its fused decode over an
   int8 pool bit for bit If + the attend-only one (B16 and 4d's B8 at
   pages of 64), If (kernel I's template over f16 / f32 rows) bit for bit
   at 8 x 512 and 3c's 520 rows, Ef / Ff at m 8 and 512, A, B and C on
   float rows, J at 7B widths; head_dim 16 and 64 small),
   NaN planted past every tail, each timed cold beside its bound
   (operations at the f32 or f16 rate), its plain version, SDPA and the
   time of the simple instances they replaced;
4. the main paths, each through ``create_engine`` with dummy weights (seed
   0) at full width and depth (4k: 4 layers), with every launch counter
   set to 0 just
   before the path and read just after, and a rerun of round 1 with
   ``kernels="torch"`` on the same weights as the reference:
   a. llama2-7b bf16, B=4: two ``generate`` rounds (greedy, then sampled)
      over four ragged prompts, then ``graph_checks``: 16 decode steps
      through the eager bodies and the same 16 through the CUDA-graph
      replays, then a 16-step ``decode_rollout``, from one state (ids and
      launch counts equal; wall, card busy and idle share of each), and
      ``generate``'s tail eager against replayed: greedy with a row that
      reaches capacity, sampled from one seed, sampled with a stop id
      from a row's eager token (that row stops there);
   b. llama2-7b INT4 (group 128), B=8: eight ragged prompts whose prefill
      runs through G (1024+ rows) and E, the same two rounds and
      ``graph_checks``, decode through E's fragment mode (lm_head
      included); every INT4 path prints the bytes of its weights'
      fragment-order copies (the context they would hold as KV cache)
      and its peak without them;
   c. llama2-7b INT8, B=8: the same through F;
   d. paged == slot: llama2-7b INT4, B=8, the prompts of 4b, chunks of
      64: a paged engine (page 64) and a slot engine give bit-identical
      prefill logits and the same 32 greedy tokens; the paged engine
      launches H and D2's paged mode in prefill and a decode step D's
      fused paged decode once a layer and no H, never kernel C, the slot
      fused decode or the attend-only paged decode;
      ``graph_checks`` on the paged engine, and a warm paged
      prefill profiled (card busy by kernel group);
   e. the serving path: the port's HTTP server in-process on
      127.0.0.1:0 over the continuous-batching scheduler and a paged
      INT4 engine (B=16, 193 pages of 64 = 12288 tokens, automatic prefix
      cache): 24 concurrent greedy completions (wave 1, admission gated
      by pages), then 8 multi-turn resends (wave 2, prefix reuse); the
      scheduler's pure-decode steps (replays) and mixed steps (eager)
      counted and timed, each pure-decode step's launches held (one
      fused paged decode a layer, no H); wave 1 again through a fresh
      scheduler with eager decode bodies gives every request the
      server's ids;
   f. recompute preemption: the scheduler alone on that engine with 16
      prompts that fit the pool and full lengths that do not; prefill
      logits held against the plain path within the limits of 4b, then
      first tokens under the f32 tie rule;
   g. llama2-7b INT4 with an int8 KV cache (slot, B=8, snapped scales):
      4b's prompts and rounds through kernel I and kernel D's int8 prefill
      and fused decode, never C or D's bf16 modes; KV bytes against 4b's
      cache, and the prefill logits' distance to 4b's (printed only);
      the plain prefill is rerun with faults planted in its int8
      attention (INT8_FAULTS) and the distances printed: the INT4
      dummies' logits barely move with K/V;
   j. llama2-7b INT8 with an int8 KV cache (slot, B=8): as 4g through F,
      whose logits do move with K/V: every planted fault must leave the
      logit limits;
   n. tensor and data parallelism on one card (after 4j, on 4b's
      weights): meshes of two ranks on cuda:0, every launch counter set
      to 0 just before each path and read just after: tp = 2 (prefill
      logits against 4b's, first tokens under the tie rule, 16 greedy
      tokens, 16 replayed steps equal to 16 eager ones, the step's wall,
      busy and idle with the cross-rank sums split out of the glue, A's,
      B's and J's launches per rank); dp = 2 (ids identical to 4b's); tp = 2
      over the int8 slot cache (against 4g); tp = 2 paged (pages of 64)
      through the scheduler, 4 requests whose ids equal the slot tp = 2
      engine's and the same scheduler's with its decode bodies eager,
      each pure-decode step one fused paged decode a layer a rank and no
      H; then E/F at m 8 and 512 on the tp = 2 local shapes (wqkv
      n 6144, wo k 2048, gate|up 2 x 5504, down k 5504, the lm_head's
      16000-row vocab shard), B at [8, 2 x 5504], J, C, I, H, D2 and D
      (D's fused paged decode too) at 16
      heads, every input with NaN past its end and every cache row past
      kv_len NaN, against the plain versions, timed with bound and
      library call;
   o. context parallelism on one card (after 4n; 4b's weights made
      again, the engines on their first DEPTH_CUT layers, a depth cut):
      llama2-7b INT4, B = 4, max_seq_len 8192, chunks of 512,
      prompts of 1000-6500 tokens, seq ranks on cuda:0, against a cp = 1
      engine on the same weights: cp = 2 over a bf16 log (a planted ring
      of own chunks must move the last layer's K rows CP_FAULT_RATIO
      times as far as the clean path; prefill logits within
      TP_LOGIT_REL_L2, first tokens under the tie rule, layer 0's K rows
      put in position order by kv_pos bit for bit the cp = 1 cache's, 16
      greedy ids equal or ties only; the cp engine's own launches of A,
      B and C, exact per forward, counted over its prefill and its
      rollout alone, no D or D2); its decode replays
      against the eager bodies, the step's wall, busy and idle with the
      split-KV math split out of the glue, beside the cp = 1 step's D at
      the same contexts; one more 512-token chunk profiled on both: the
      ring's ms against D2's; the int8 log (snapped) against the cp = 1
      int8 slot cache; cp = 2 x tp = 2 (four ranks; the planted fault a
      model rank's partial left out); then C and I at the CP write
      shapes (ragged log tails, counts 0 .. 256 and a decode token on
      one rank of two, NaN past every tail) bit for bit, timed with
      their bounds; the peak memory;
   p. the pipeline forward (after 4o, on its weights): pp = 2 on cuda:0
      against the one-rank forward, pp = 2 x tp = 2 against the tp = 2
      forward, a [4, 512] chunk and a decode step: logits and every K/V
      row bit for bit; the stages' weights are views;
   q. prefix snapshots, speculation and beams on a mesh (after 4p, on its
      weights): tp = 2 on cuda:0, B = 8, chunks of 1024, every launch
      counter set to 0 just before each path: (a) the slot PrefixStore
      through the scheduler, 4k (c)'s prompts (restored rows bit for bit
      on each rank, the tails' logits within PREFIX_TP2_LIMITS of the
      full prompts' and both wrong-prefix controls outside them, ids
      equal with and without the store, TTFT); (b) SpeculativeDecoder
      over a tinyllama-1.1b INT4 draft on the same mesh, k = 4: 8
      replayed rounds equal to 8 eager, the ids against the tp = 2
      target's ``generate`` (a divergence only at a near-tie), a round's
      wall, busy and idle, the launches of A-E exact per forward; (c)
      ``beam_search`` with 4 beams over the sharded params: replayed
      equal to eager, the first expansion's log-probs within
      TP_LOGIT_REL_L2 of the one-rank search's, the step's ms and its
      reorder's bytes, the launches exact; (d) E at m = 40 on the tp = 2
      shards and at m = 8 on tinyllama's, D2 at the verify at 16 heads,
      D at the draft's rank (G = 8, 2 kv heads, head_dim 64; paged ==
      slot bit for bit), B at
      [8, 5632], C into the beams' and the draft's local caches, NaN past
      every end, against the plain versions, timed with bound and
      library call;
   h. paged == slot with the int8 cache: as 4d, bit-identical logits and
      ids, through H's and D's int8 paged modes only, a decode step
      through D's fused decode over the int8 pool (no H int8);
   i. the server over a paged INT4 engine with an int8 pool of 4e's pool
      bytes (~2x the pages): 4e's wave 1;
   k. a checkpoint on disk (after 4i, every earlier engine freed): the
      seed-0 bf16 dummy weights of llama2-7b at full width and 4 layers
      (CKPT_LAYERS; the model named by a config JSON) written as an HF
      directory
      (two BF16 shards of unfused [out, in] projections, no
      ``safetensors`` package) and loaded INT4 through ``create_engine``
      by the native reader (``build/native/``): every leaf bit for bit
      ``quantize_params`` of the same weights, greedy ids on 4b's prompts
      equal to the in-memory engine's, the INT4 main path's kernels
      launched; load seconds, file GB/s (warm: from the page cache) and
      peak host RSS; the slot PrefixStore at B = 8 (a 320-token system
      prompt; the restore an exact copy, timed against its copy bound;
      tails' logits within the limits of 4b and first tokens under the
      tie rule; the same tails over a zeroed and over another prompt's
      prefix must leave the limits; prefill tokens skipped; TTFT with
      and without the store); a 3-round ChatSession (prefill lengths,
      the slot's length against the history, streaming tok/s beside
      ``generate``'s at B = 1); the prefix store again on an INT8 engine
      loaded from the same directory with chunks of 1024, where the
      scheduler's greedy ids with and without the store must be equal;
      then ``tools/quantize`` to an INT4 .npz (equal leaf for leaf) and
      the chat CLI over it and the SentencePiece asset as a subprocess
      (exit 0, the streaming protocol), and again with ``--beams 2``;
      after the session's 3 rounds one ``response_beam`` round (the
      slot's length equal to the history after it);
   l. speculative decoding and beam search (after 4k): first the kernels
      at the shapes these paths add (E and F at m = 40, the verify's
      projections and its f32 lm_head, NaN past every tail, with their
      plans; D2 at T = 5 in chunk mode; at tinyllama-1.1b's widths, B =
      8: E's decode mode, D's fused decode at G = 8 and head_dim 64 with
      its plan, paged == slot bit for bit, A, B and J; J at the
      verify's m = 40), each against its
      plain version with its time, bound and library call; then llama2-7b
      INT4 at 4b's engine config with a tinyllama-1.1b INT4 draft of
      the same config, k = 4, every launch counter set to 0 just before
      and read just after: (a) greedy generate of 64 tokens over 4b's
      prompts (rounds, acceptance, wall a round, tok/s, launches a
      round, card busy and idle share a round by kernel group), 8
      replayed rounds equal to 8 eager rounds from one state, the ids
      against plain greedy printed; (c) sampled rounds (temperature
      0.8, top-p 0.95), replayed equal to eager from one generator
      state, and a round at temperature 0 equal to the greedy round;
      (b) the target as its own draft (a second engine over its
      parameters): acceptance >= 0.9, replayed rounds (the ingest
      among them) equal to eager, and each rejection's top-2 margin
      against the verify and decode paths' logit difference (near-ties
      counted); (d) the HTTP server over SpeculativeScheduler, 8
      requests sharing a 64-token prefix (TTFT, tok/s, acceptance, the
      ``/metrics`` gauge), one DualPrefixStore restore held against its
      snapshots' bytes; (e) beam_search on a 128-token prompt, 32 new
      tokens: one beam equal to ``generate`` at B = 1, 4 beams replayed
      equal to eager, the step's time and its reorder's bytes beside
      their bounds, the best score against a teacher-forced recompute;
   m. evals, calibration and the debugging utilities (after 4l):
      first the kernels at the shapes scoring adds (G on the lm_head
      [4096, 32000], the INT4 lm_head at m = 2048 with an f32 output, D2's
      int8 mode at B 4, T 512), then llama2-7b bf16 (32 layers, seed 0)
      with every launch counter set to 0 just before and read just after:
      (a) the windowed ``Scorer`` (window 512, batch 4) over 4089 tokens:
      4088 predictions, a zeroed lm_head gives ppl 32000 (1e-5), one
      window against ``forward_all_logits`` at B = 1 (1e-3), the kernel
      route against ``kernels="torch"`` (2e-2 on the mean NLL), and
      ``python -m llm_inference_engine_tpu_torch.evals.ppl --quant int4``
      in a subprocess (7B width, 4 layers, from a config JSON) printing
      the in-process value (1e-6); (b) a tapped ``generate`` at B = 2 on
      both routes: the JAX package's 29 dump names, prefill and decode
      dumps, the same names from ``compare_dumps``, each name's largest
      relative difference printed; (c) ``calibrate_act_sq`` over 512
      tokens and ``quantize_params_calibrated`` INT4 in
      ``quantize_params``' format; ``tools/quantize --calibrate
      random:512`` over an HF directory (7B width, 4 layers) bit for bit
      the in-process run; ``create_engine`` over its .npz generates
      through E and D; (d) ``nan_guard`` over a forward: clean (logits
      unchanged), then a NaN planted in layer 5's ``wo`` (named:
      ``aten.mm``) and in its ``ffn_norm`` (named: kernel A's wrapper);
      printed only: (e) fp, int8, int4 (``quant_ppl_report``),
      calibrated INT4 and int8-KV perplexities (dummy weights: no
      quality), (f) tokens scored a second, card busy a batch by kernel
      group (``utils.profiling.trace``), calibration and clip-search
      seconds, peak memory;
   r. the quantization quality proxy (after 4m), in this process:
      ``tools.quant_divergence``'s synthetic weights (the JAX tool's, seed
      0) at llama2-7b's width, 4 layers; fp, int8, int4 and int4cal
      (calibrated through the kernels) built on the card; (a) layer 0's
      q and scales of each quantized variant equal the CPU's bit for
      bit; (b) each variant's logits over B 4 x T 512 teacher-forced
      tokens, kernel route against ``kernels="torch"``, within
      QDIV_REL_L2, and a planted fault (one layer's wo scales doubled)
      outside it; (c) every kernel's launches exact per forward; (d)
      the report printed;
   s. every example driver of ``examples_torch`` (after 4r), its
      ``main`` in this process on the card: a driver's exit 1 fails the
      script;
   t. float models end to end (after 4s, ``phase_float_models``): (a) the
      ``debug`` preset as shipped (float32, head_dim 16) and in float16,
      params from seed 0 on the CPU copied to the card, six engines
      (slot; paged through the scheduler; int8 slot cache; int8 pool;
      INT4 group 64; INT8), each against the same engine on the CPU:
      greedy ids equal (float16: where they part, the card's token is the
      CPU's second there), prefill logits within FLOAT_LOGIT_REL_L2, the
      replays equal to the eager bodies, a paged engine's pure-decode step
      with no H (a float pool: Df's fused paged decode; paged == slot bit
      for bit); (b) llama2-7b float16, its first DEPTH_CUT layers (a depth
      cut), at B 4 (4a's prompts, 32 tokens;
      then paged over pages of 64, bit for bit the slot engine, its step
      with no H, ``graph_checks``), the same weights over an int8 cache
      (slot B 4, then paged over pages of 64: If and D2f in prefill, a
      decode step Df's fused int8 decode a layer and no If) and INT4 at
      B 8 (4b's prompts), (c)
      llama2-7b float32 at B 2 (7 and 700 tokens, 16 tokens; its first
      DEPTH_CUT layers, a depth cut): the first token against
      ``kernels="torch"`` by 4a's rule, launches per forward (no bf16
      kernel, no plain version), ``graph_checks``;
   u. the model families beside Llama-2 at full width and depth
      (``FAMILIES``): llama3.1-8b (G 4, vocabulary 128256, Llama-3 RoPE
      scaling), mistral-7b (a sliding window of 4096, prompts of 700-6100
      in 8192 tokens) and qwen2-7b (qkv bias, G 7, hidden 3584,
      vocabulary 152064): each family's kernels at its shapes, NaN past
      every tail (E, G, A, B, J with Qwen2's bias, C, D2 and D under the
      window, Mistral's H and fused paged D through a table), then its
      bf16 path at B 4 with a control that switches its feature off (the
      logits must move more than the kernel path's from the plain path's)
      and its INT4 path, each a main path as 4a's (``phase_main_path``,
      4b's tie rule), and Mistral's paged engine (pages and chunks of 64)
      against its slot engine past the window, as 4d's (Mistral's bf16
      path and paged check at 8 of its 32 layers: DEPTH_CUT_PATHS);
   v. the last paths (``phase_last_paths``): the INT4 prefill's product
      with a bf16 result (the route) bit for bit its f32 result cast at
      every m >= 1024 shape of 4b, the families and 13B; (a)
      llama2-13b at full width and depth (``LARGE``): its kernels at its
      shapes (``family_kernel_rows``), bf16 B 4 and INT4 B 8 as 4u's
      paths, each replayed step beside its weight bytes' bound, and
      paged == slot at INT4 B 8 as 4d's; (b) the server over llama3.1-8b:
      4d's, 4e's and 4f's checks, then 4i's wave over an int8 pool of the
      same bytes, each wave beside 4e's and 4i's; (c) mistral-7b INT8
      weights over an int8 slot cache at B 4 in 8192 (``WINDOW_INT8``):
      F, G8 and its epilogue, I, D2's and D's int8 modes at its shapes
      (and D's at Qwen2's G 7), scales NaN past kv_len and left of the
      window, then the path as 4j's;
   w. the model families under tensor parallelism (``phase_families_tp``,
      after 4v): meshes of two ranks on cuda:0, as 4n, through each
      family's INT4 path: (a) qwen2-7b B 8 at full depth (G 7, one kv head
      a rank, J's bias mode) against 4u's one-rank path; (b) llama3.1-8b
      B 8 and (c) mistral-7b B 4 in 8192 over prompts past its window,
      each its first DEPTH_CUT layers beside a one-rank engine at the same
      cut: prefill logits within TP_LOGIT_REL_L2 (a dropped rank's
      partial beyond it), first tokens under the tie rule, greedy ids,
      ``mesh_steps``, one decode step's launches, a paged tp = 2 engine
      through the scheduler whose ids equal the slot engine's
      ``generate``; the replayed step, warm prefill and peak memory
      beside the one-rank path's; (d) every kernel at each family's rank
      shapes (E with its plan and cluster K ranges, G, A, B, J, C, D2, D,
      H and D's fused paged decode), NaN past every tail;
   (3d, before 4: kernel I, H's int8 mode, D2's and D's int8 modes
   against their plain versions at 7B widths, in both scale numerics, the
   decode modes held per row, D's fused decode over an int8 pool bit for
   bit H's int8 mode then the attend-only decode (B16 and 4h's B8, pages
   of 64); then at head_dim 80, 96
   and 256, at small shapes, D's four decode modes, D2's four prefill
   modes and I's two writes; 4j runs after 4g, 4n after 4j, 4o, 4p and
   4q after 4n, before 4d); every profiled step and prefill prints its device time by kernel group
   (KERNEL_GROUPS, the writes and kernels A, B, J and G8 among them; a
   decode step's torch glue split into RoPE (rope_cos_sin), casts,
   sampling, a mesh's
   cross-rank sums and other by the ops that launch it, GLUE); card busy is the union of the card's
   activity intervals (kernels A, B, J and E's decode mode are
   programmatic dependents and overlap their neighbours); every
   forward's launches of A, B and J are counted (``check_norm_launches``);
5. one JSON line of kernel results (each with its time, its plain
   version's, its bound from this run's inputs and, where one PyTorch call
   computes the same function, that call's time), the whole run's time,
   the nvidia-smi line, and as the last line ``{"ok": true, "device":
   {...}}``.

It imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent

# Prefill logits of the kernel path against the plain paths on the same
# card and weights. Both bf16 paths round at the same points, but each
# kernel sums in another order, so ~1-ulp differences appear in a small
# share of activations, and a random-weight 32-layer stack amplifies them:
# measured on an H100, the kernel path and the plain bf16 path are each
# ~5.6% (relative L2) from the plain path run in f32, and ~3.9% from each
# other. Limits: 0.6 absolute and 10% relative L2 against the plain bf16
# path (a wrong kernel is off by order 100%), and the kernel path no
# further from f32 than 1.5 times the plain bf16 path's distance.
LOGIT_ATOL = 0.6
LOGIT_REL_L2 = 0.1
KERNEL_VS_F32 = 1.5
# bf16 kernel outputs vs plain: one bf16 ulp apart at most, plus f32 sums
# taken in another order.
KERNEL_TOL = dict(atol=2e-2, rtol=2e-2)
# The decode modes' outputs (bf16 and int8) at long contexts are averages
# of many random V rows, a few hundredths in size, where KERNEL_TOL's atol
# would hide a key dropped or read twice (a mask off by one, a split
# slice's edge). There each element is held to one bf16 ulp of itself (at
# most 2^-7 of it) plus 2^-5 of its (token, head) row's RMS.
DECODE_ROW_TOL = 2.0 ** -5
# int8 KV writes vs plain: bit for bit expected (the same CUDA log2f/exp2f
# and IEEE divide); otherwise no looser than the CPU tests' limits against
# the JAX package: values off by 1 in at most 0.1% of elements, scales
# within 2^-20 relative.
INT8_SHARE, INT8_SCALE_REL = 1e-3, 2.0 ** -20
# bound_ms: the H100 SXM data sheet's HBM rate and dense bf16 tensor-core
# rate (the int8 KV modes compute in bf16/f32, so their operations count
# at the bf16 rate)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
# the float instances' operations: f32 on the CUDA cores at the data
# sheet's 67 TFLOP/s (no tensor core runs in an f32 instance), f16 at the
# dense f16 tensor-core rate (the same 989 TFLOP/s as bf16)
F32_OPS_PER_S = 67e12
FLOAT_OPS_PER_S = {"f32": F32_OPS_PER_S, "f16": BF16_OPS_PER_S}
# 3f: the float instances against their plain versions on the card: max
# |kernel - plain| over max |plain| (both compute in f32 and sum in
# another order; a float16 output also rounds once, 2^-11 relative); If's
# int8 values and scales (and Df's fused int8 write) bit for bit
FLOAT_REL = {"f32": 1e-5, "f16": 2e-3}
# 4t (a): the debug preset's prefill logits on the card against the CPU
# plain route's, relative L2 (f32: the sums' order only; f16: its rounding
# points, which the CPU's plain route shares, but sums in another order)
FLOAT_LOGIT_REL_L2 = {"f32": 1e-4, "f16": 2e-2}
FLOAT_DTYPE = {"f32": "float32", "f16": "float16"}
# 3f's attention widths: Llama2-7B's heads, kv heads, head_dim, and the
# cache length of 3c's rows
FLOAT_WIDTHS = (32, 32, 128, 2048)

REPLACES = {
    "rmsnorm": "llm_inference_engine_tpu/ops/rmsnorm.py:58",
    "add_residual_rmsnorm": "llm_inference_engine_tpu/ops/rmsnorm.py:65",
    "silu_and_mul": "llm_inference_engine_tpu/ops/activations.py:41",
    "kv_write": "llm_inference_engine_tpu/ops/kv_cache.py:260",
    "attention_prefill": "llm_inference_engine_tpu/ops/attention.py:135",
    "attention_decode": "llm_inference_engine_tpu/ops/attention.py:569",
    "int4_matmul": "llm_inference_engine_tpu/ops/quant.py:416",
    "int8_matmul": "llm_inference_engine_tpu/ops/quant.py:389",
    "dequant_int4": "llm_inference_engine_tpu/ops/quant.py:308",
    "paged_kv_write": "llm_inference_engine_tpu/ops/paged_kv.py:169",
    "attention_prefill_paged": "llm_inference_engine_tpu/ops/attention.py:135",
    "attention_decode_paged": "llm_inference_engine_tpu/ops/attention.py:356",
    "attention_decode_paged_fused":
        "llm_inference_engine_tpu/ops/attention.py:356",
    "kv_write_quant": "llm_inference_engine_tpu/ops/kv_cache.py:289",
    "attention_prefill_int8": "llm_inference_engine_tpu/ops/attention.py:135",
    "attention_decode_int8": "llm_inference_engine_tpu/ops/attention.py:569",
    "paged_kv_write_int8": "llm_inference_engine_tpu/ops/paged_kv.py:169",
    "attention_prefill_paged_int8":
        "llm_inference_engine_tpu/ops/attention.py:135",
    "attention_decode_paged_int8":
        "llm_inference_engine_tpu/ops/attention.py:356",
    "attention_decode_paged_fused_int8":
        "llm_inference_engine_tpu/ops/attention.py:356",
    # J and G8 (its cast and its epilogue) replace no TPU kernel: the JAX
    # package runs the QKV split with RoPE, the INT8 cast and the scale
    # after the dot in XLA (its Pallas rotation kernel was retired,
    # ops/rope.py:123-140); each row names that XLA code
    "split_qkv_rope": "llm_inference_engine_tpu/ops/rope.py:167",
    "dequant_int8": "llm_inference_engine_tpu/ops/quant.py:262",
    "int8_scale_cast": "llm_inference_engine_tpu/ops/quant.py:373",
}
_TRITON = ("triton", "llm_inference_engine_tpu_torch/ops/_triton_kernels.py")
_NORM_ACT = ("cuda", "llm_inference_engine_tpu_torch/csrc/norm_act.cu")
SOURCES = {
    "rmsnorm": _NORM_ACT,
    "add_residual_rmsnorm": _NORM_ACT,
    "silu_and_mul": _NORM_ACT,
    "kv_write": ("cuda", "llm_inference_engine_tpu_torch/csrc/kv_write.cu"),
    "attention_prefill": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_prefill.cu"),
    "attention_decode": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_decode.cu"),
    "int4_matmul": ("cuda", "llm_inference_engine_tpu_torch/csrc/quant_matmul.cu"),
    "int8_matmul": ("cuda", "llm_inference_engine_tpu_torch/csrc/quant_matmul.cu"),
    "dequant_int4": _TRITON,
    "paged_kv_write": ("cuda", "llm_inference_engine_tpu_torch/csrc/kv_write.cu"),
    "attention_prefill_paged": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_prefill.cu"),
    "attention_decode_paged": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_decode.cu"),
    "attention_decode_paged_fused": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_decode.cu"),
    "kv_write_quant": ("cuda", "llm_inference_engine_tpu_torch/csrc/kv_write_quant.cu"),
    "attention_prefill_int8": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_prefill.cu"),
    "attention_decode_int8": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_decode.cu"),
    "paged_kv_write_int8": ("cuda", "llm_inference_engine_tpu_torch/csrc/kv_write_quant.cu"),
    "attention_prefill_paged_int8": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_prefill.cu"),
    "attention_decode_paged_int8": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_decode.cu"),
    "attention_decode_paged_fused_int8": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_decode.cu"),
    "split_qkv_rope": _NORM_ACT,
    "dequant_int8": _TRITON,
    "int8_scale_cast": _TRITON,
}
# the main path whose launch count each kernel reports; the attend-only
# decodes over a bf16 and an int8 pool run on none since the fused paged
# decodes took their place (3c and 3d hold and time them; they are left
# out of the JSON line)
PATH_OF = {name: "bf16" for name in REPLACES}
PATH_OF.update(int4_matmul="int4", dequant_int4="int4", int8_matmul="int8",
               dequant_int8="int8", int8_scale_cast="int8",
               paged_kv_write="server", attention_prefill_paged="server",
               attention_decode_paged=None,
               attention_decode_paged_fused="server",
               kv_write_quant="int4-kv8",
               attention_prefill_int8="int4-kv8",
               attention_decode_int8="int4-kv8",
               paged_kv_write_int8="server-kv8",
               attention_prefill_paged_int8="server-kv8",
               attention_decode_paged_int8=None,
               attention_decode_paged_fused_int8="server-kv8")
# The float instances, one JSON row per counter and dtype,
# "<counter>[f32]" and "<counter>[f16]": the TPU kernel each replaces, and
# the 4t engine whose run gives its launches (None: on no main path, left
# out of the JSON line; the attend-only decode over a float pool, which
# the fused paged decode replaced on the paged engines as bf16's did, is
# held and timed in 3f as its reference)
FLOAT_INSTANCES = {
    "attention_prefill_float": (
        "llm_inference_engine_tpu/ops/attention.py:135", "7b"),
    "attention_prefill_float_int8": (
        "llm_inference_engine_tpu/ops/attention.py:135", "debug kv8"),
    "attention_prefill_paged_float": (
        "llm_inference_engine_tpu/ops/attention.py:135", "debug paged"),
    "attention_prefill_paged_float_int8": (
        "llm_inference_engine_tpu/ops/attention.py:135", "debug paged-kv8"),
    "attention_decode_float": (
        "llm_inference_engine_tpu/ops/attention.py:569", "7b"),
    "attention_decode_float_int8": (
        "llm_inference_engine_tpu/ops/attention.py:569", "debug kv8"),
    "attention_decode_paged_fused_float": (
        "llm_inference_engine_tpu/ops/attention.py:356", "debug paged"),
    "attention_decode_paged_float": (
        "llm_inference_engine_tpu/ops/attention.py:356", None),
    "attention_decode_paged_fused_float_int8": (
        "llm_inference_engine_tpu/ops/attention.py:356", "debug paged-kv8"),
    "attention_decode_paged_float_int8": (
        "llm_inference_engine_tpu/ops/attention.py:356", None),
    "kv_write_quant_float": (
        "llm_inference_engine_tpu/ops/kv_cache.py:289", "debug kv8"),
    "paged_kv_write_quant_float": (
        "llm_inference_engine_tpu/ops/paged_kv.py:169", "debug paged-kv8"),
    "int4_matmul_float": (
        "llm_inference_engine_tpu/ops/quant.py:416", "debug int4"),
    "int8_matmul_float": (
        "llm_inference_engine_tpu/ops/quant.py:389", "debug int8w"),
}
_CSRC = "llm_inference_engine_tpu_torch/csrc/"


def _float_source(name: str, tag: str) -> tuple:
    """(route, source) of a float instance: D2f, Df, Ef and Ff are the f16
    / f32 sources of kernels D2, D, E and F; If is kernel I's source."""
    if name.startswith("attention_prefill"):
        return "cuda", f"{_CSRC}attention_prefill_{tag}.cu"
    if name.startswith("attention_decode"):
        return "cuda", f"{_CSRC}attention_decode_{tag}.cu"
    if name.endswith("_matmul_float"):
        return "cuda", f"{_CSRC}quant_matmul_{tag}.cu"
    return "cuda", f"{_CSRC}kv_write_quant.cu"


for _name, (_tpu, _engine) in FLOAT_INSTANCES.items():
    for _tag in FLOAT_DTYPE:
        REPLACES[f"{_name}[{_tag}]"] = _tpu
        SOURCES[f"{_name}[{_tag}]"] = _float_source(_name, _tag)
        PATH_OF[f"{_name}[{_tag}]"] = (None if _engine is None
                                       else f"{_tag} {_engine}")
# the timed 3f rows' kernel ms of the simple CUDA-core float instances
# that D2f and Df replaced (H100 80GB HBM3, 700.00 W; PERF.md, the kernel
# table's brackets), printed in brackets as "before"
FLOAT_BEFORE_MS = {
    "attention_prefill_float": (2.4693, 2.4724),
    "attention_prefill_float_int8": (2.8992, 2.9160),
    "attention_prefill_paged_float": (0.7396, 0.7241),
    "attention_prefill_paged_float_int8": (0.8538, 0.8566),
    "attention_decode_float": (0.2198, 0.1646),
    "attention_decode_float_int8": (0.1757, 0.1757),
    "attention_decode_paged_float": (0.6168, 0.5082),
    "attention_decode_paged_float_int8": (0.5852, 0.5853),
}
# 3f's If rows (8 x 512 into the slot cache warm, snapped and absmax;
# 3c's 520-row mixed step through the table warm): the kernel ms of the
# warp-a-row design that kernel I's template replaced, (f32, f16) (H100
# 80GB HBM3, 700.00 W; PERF.md, the kernel table's brackets)
IF_BEFORE_MS = {"slot snapped": (0.0544, 0.0556),
                "slot absmax": (0.0496, 0.0504),
                "pool": (0.0173, 0.0175)}
# 3f's Ef / Ff rows (m, QUANT_SHAPES label), and the kernel ms of the
# simple CUDA-core instances the redesign replaced, (f32, f16) (H100 80GB
# HBM3, 700.00 W; PERF.md, the kernel table's brackets; gate|up was not
# timed then)
FLOAT_MATMUL_ROWS = ((8, "wqkv"), (8, "down"), (8, "gate|up"), (512, "wqkv"),
                     (512, "down"), (512, "gate|up"))
FLOAT_MATMUL_BEFORE_MS = {
    ("int4", 8, "wqkv"): (0.0744, 0.0743), ("int4", 8, "down"): (0.0736, 0.0735),
    ("int4", 512, "wqkv"): (2.6120, 2.6130),
    ("int4", 512, "down"): (3.4895, 3.4879),
    ("int8", 8, "wqkv"): (0.1098, 0.1099), ("int8", 8, "down"): (0.1096, 0.1093),
    ("int8", 512, "wqkv"): (2.9083, 2.9053),
    ("int8", 512, "down"): (2.6355, 2.6307),
}
# at float16 the INT4 weights' launches come from llama2-7b's (4t (b)),
# and the int8 cache's kernels' from llama2-7b's over an int8 cache, slot
# and paged (4t (b))
PATH_OF["int4_matmul_float[f16]"] = "f16 7b int4"
PATH_OF.update({f"{name}[f16]": "f16 7b kv8" for name in (
    "kv_write_quant_float", "attention_prefill_float_int8",
    "attention_decode_float_int8")})
PATH_OF.update({f"{name}[f16]": "f16 7b paged-kv8" for name in (
    "paged_kv_write_quant_float", "attention_prefill_paged_float_int8",
    "attention_decode_paged_fused_float_int8")})
# kernels of the bf16 (and bf16-row) instances that no float path runs
BF16_ONLY = ("attention_prefill", "attention_decode", "kv_write_quant",
             "attention_prefill_int8", "attention_decode_int8",
             "attention_prefill_paged", "attention_decode_paged",
             "attention_decode_paged_fused", "paged_kv_write_int8",
             "attention_prefill_paged_int8", "attention_decode_paged_int8",
             "attention_decode_paged_fused_int8", "int4_matmul",
             "int8_matmul")
# kernels A, B and J: every forward of every path launches them
NORM_ACT = ("rmsnorm", "add_residual_rmsnorm", "silu_and_mul",
            "split_qkv_rope")
BF16_SLOT = ("kv_write", "attention_prefill", "attention_decode")
INT8_SLOT = ("kv_write_quant", "attention_prefill_int8",
             "attention_decode_int8")
BF16_PAGED = ("paged_kv_write", "attention_prefill_paged",
              "attention_decode_paged_fused")
INT8_PAGED = ("paged_kv_write_int8", "attention_prefill_paged_int8",
              "attention_decode_paged_fused_int8")
# G8: the INT8 weight's cast at m >= 1024 and its scale epilogue
G8 = ("dequant_int8", "int8_scale_cast")
# the paged kernels no slot path launches
PAGED_ALL = BF16_PAGED + INT8_PAGED + ("attention_decode_paged",
                                       "attention_decode_paged_int8")
# each slot main path: (kernels that must launch, kernels that must not)
MAIN_PATHS = {
    "bf16": (NORM_ACT + BF16_SLOT, INT8_SLOT + PAGED_ALL + G8),
    "int4": (NORM_ACT + BF16_SLOT + ("int4_matmul", "dequant_int4"),
             INT8_SLOT + PAGED_ALL + G8),
    "int8": (NORM_ACT + BF16_SLOT + ("int8_matmul",) + G8,
             INT8_SLOT + PAGED_ALL + ("dequant_int4",)),
    "int4-kv8": (NORM_ACT + INT8_SLOT + ("int4_matmul", "dequant_int4"),
                 BF16_SLOT + PAGED_ALL + G8),
    "int8-kv8": (NORM_ACT + INT8_SLOT + ("int8_matmul",) + G8,
                 BF16_SLOT + PAGED_ALL + ("dequant_int4",)),
}
# Faults planted in the plain int8 attention (attention_torch with scale
# planes) to show that a path's logit limits can see a broken int8 kernel:
# each maps (kv_len, k_scale, v_scale) to the faulted triple. On a path in
# MUST_SEE_FAULTS, the kernel path against each faulted plain path must
# leave the limits, or the check fails; elsewhere the distances are printed.
INT8_FAULTS = {
    "v scales set to 1": lambda kl, ks, vs: (kl, ks, vs * 0 + 1),
    "k and v scales swapped": lambda kl, ks, vs: (kl, vs, ks),
    "newest key dropped": lambda kl, ks, vs: (kl - 1, ks, vs),
}
MUST_SEE_FAULTS = ("int8-kv8",)
# off MUST_SEE_FAULTS the faults are planted only where a path's prompts
# total at most this many tokens (each fault costs one more plain prefill)
FAULT_PROMPT_TOKENS = 4096
# Depth cuts that keep every width: the paths of DEPTH_CUT_PATHS (4u's
# Mistral bf16 path and paged == slot check, 4w's Llama-3.1-8B and
# Mistral-7B tp = 2 paths), 4o's cp engines (the first layers of 4b's
# weights) and 4t's llama2-7b float16 and float32 paths run the first
# DEPTH_CUT layers of their model. Each layer only repeats the kernels,
# which a full-depth path at the same widths holds (Mistral's INT4 path,
# 4b and 4n, 3f; at a rank's shapes 4w's Qwen2-7B path and 4w (d)).
DEPTH_CUT = 8
DEPTH_CUT_PATHS = ("mistral-7b bf16", "mistral-7b paged int4",
                   "llama3.1-8b tp2 int4", "mistral-7b tp2 int4")
# per main path: decode wall and card busy per step, eager bodies against
# graph replays (graph_checks), printed as one line at the end of phase 4
DECODE: dict = {}
# each served path's waves (phase_server): {"model kv": {wave: (generated
# tok/s, TTFT p50 s, TTFT p99 s)}}
SERVED: dict = {}
# what 4n reuses of 4b (its prompts, kernel-path prefill logits and
# round-1 greedy ids) and of 4g (its logits and ids), and 4w (a) of 4u's
# Qwen2-7B INT4 path (also its warm prefill's card busy and peak memory),
# by path; 4n and 4w make the seed-0 weights again, so no later path's
# peak memory holds them
MAIN_RUNS: dict = {}
KEPT_RUNS = ("int4", "int4-kv8", "qwen2-7b int4")
# 4n: the largest relative L2 distance allowed between the prefill logits
# of a tp = 2 engine and of the one-rank engine on the same weights. The two
# differ in where each row sum splits (K/2 per rank, then the cross-rank
# sum), so in bf16 rounding only: 4.5e-4 (tp = 2) and 5.0e-4 (tp = 2 over
# the int8 cache) on an H100, beside 1.2e-3 between 4b's plain bf16 path
# and f32. A planted fault (one rank's partial product left out of every
# sum) must land above the limit.
TP_LOGIT_REL_L2 = 2e-3


def say(*parts) -> None:
    print(*parts, flush=True)


_FLUSH = []


def time_ms(torch, fn, iters: int = 10, warmup: int = 2,
            cold: bool = False, clean: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches.

    A ~30 ms device-side sleep is queued first, so the host has enqueued
    every launch before the first one runs (a case is at most a few
    hundred launches, well inside the card's launch queue): the CUDA
    events then time the kernels, not Python's launch overhead. A plain
    version that synchronises with the host inside cannot run ahead; its
    time is its real cost. Inputs that fit the 50 MB L2 stay there
    across repeats, unless ``cold``: then 128 MB are written before each
    launch (warm-up included), so the L2 holds none of its inputs; each
    launch is timed between its own pair of events, and the median is
    returned. Written lines are dirty: a launch that evicts them pays
    their writeback. ``clean`` reads the 128 MB instead (a sum), leaving
    clean lines, so the two methods together show what the writebacks
    cost."""
    if cold and not _FLUSH:
        _FLUSH.append(torch.zeros(32 << 20, dtype=torch.float32,
                                  device="cuda"))

    def flush():
        if clean:
            _FLUSH[0].sum()
        else:
            _FLUSH[0].zero_()
    for _ in range(warmup):
        if cold:
            flush()
        fn()
    torch.cuda.synchronize()
    if cold:
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        torch.cuda._sleep(50_000_000)
        for start, end in events:
            flush()
            start.record()
            fn()
            end.record()
        events[-1][1].synchronize()
        return sorted(s.elapsed_time(e) for s, e in events)[iters // 2]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(work):
    """(least time in ms, "bytes" or "operations") for ``work`` = (bytes
    moved, each input read once and each output written once; operations
    [, their peak rate]) at the H100's HBM rate and, unless a rate is
    given, its bf16 tensor-core rate."""
    t_bytes = work[0] / HBM_BYTES_PER_S * 1e3
    t_ops = work[1] / (work[2] if len(work) > 2 else BF16_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def record(name, err, results, case, timed=None, work=None, library=None,
           floor=None):
    """Record a kernel's check; the first timed case is the main path's
    shape, and its time, work and library time go into the JSON line. A
    write row's ``floor`` (floor_ms) is printed beside its time."""
    r = results.setdefault(name, {})
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
    line = f"  {name:22s} {case:44s} max_abs_err {err:.3e}"
    if timed is not None:
        ms, plain_ms = timed
        if "ms" not in r:
            r.update(ms=ms, plain_ms=plain_ms, work=work, library_ms=library)
        line += f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
        if work is not None:
            b, by = bound_ms(work)
            line += f"  bound {b:.4f} ms ({by}, {b / ms:.2f} of it)"
        if library is not None:
            line += f"  library {library:.4f} ms"
        if floor is not None:
            line += f"  floor {floor:.4f} ms ({ms / floor:.2f}x it)"
    say(line)


def check_close(torch, name, got, want, results, case, timed=None,
                work=None, library=None, row_rel=None, floor=None):
    """Hold a kernel's result against the plain version's; record it.
    With ``row_rel``, each element is held to 2^-7 of itself plus
    ``row_rel`` times the RMS of its row (the last dimension) in place of
    KERNEL_TOL."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = diff.max().item()
    if row_rel is None:
        bad = not torch.allclose(g, w, **KERNEL_TOL)
    else:
        rms = w.pow(2).mean(-1, keepdim=True).sqrt()
        limit = 2.0 ** -7 * w.abs() + row_rel * rms
        bad = bool((diff > limit).any())
        med = rms.median().item()
        case += (f" [row limit: worst err/limit "
                 f"{(diff / limit.clamp_min(1e-30)).max().item():.2f}; "
                 f"median row RMS {med:.3e}, KERNEL_TOL's atol "
                 f"{KERNEL_TOL['atol'] / med:.2f}x it]")
    if bad or not torch.isfinite(g).all():
        raise AssertionError(f"{name} [{case}]: kernel disagrees with its "
                             f"plain version (max abs err {err})")
    record(name, err, results, case, timed, work, library, floor)


def hold_int8_write(torch, name, got, want, results, case, timed=None,
                    work=None, floor=None):
    """Hold an int8 KV write (values, scale planes) against the plain
    version's: bit for bit, or else within the CPU tests' limits, with the
    share that differs printed. Records the largest difference of the
    dequantized rows."""
    (gv, gs), (wv, ws) = got, want
    if torch.equal(gv, wv) and torch.equal(gs, ws):
        note = "bit-identical"
    else:
        diff = (gv.int() - wv.int()).abs()
        share = (diff > 0).float().mean().item()
        rel = ((gs - ws).abs() / ws.abs()).max().item()
        note = (f"NOT bit-identical: {share:.2e} of values differ (max "
                f"{diff.max().item()}), scales up to {rel:.2e} relative")
        if diff.max().item() > 1 or share > INT8_SHARE or rel > INT8_SCALE_REL:
            raise AssertionError(f"{name} [{case}]: {note}")
    err = (gv.float() * gs[..., None] - wv.float() * ws[..., None]).abs()
    record(name, err.max().item(), results, f"{case} {note}", timed, work,
           floor=floor)


def attn_work(q_start, kv_len, T, H, K, D, kv_elem=2, new_rows=0,
              q_elem=2, window=None):
    """(bytes, operations) of kernel D over this run's rows: every query
    row t < T of sequence b at p = q_start[b] + t sees the keys j <
    min(kv_len[b], p + 1) and, with a sliding ``window`` W, j > p - W; q
    and out (``q_elem`` bytes a value) are read and written once, each
    sequence's keys that some row sees once (k and v, int8 with a 4-byte
    scale per head, or ``kv_elem`` bytes a value), plus ``new_rows``
    bytes of a fused write. Operations: QK^T and PV, 2 per multiply-add
    each."""
    qs, kl = [int(x) for x in q_start], [int(x) for x in kv_len]

    def low(p):
        return 0 if window is None else max(0, p - window + 1)
    pairs = sum(max(0, min(l, s + t + 1) - low(s + t))
                for s, l in zip(qs, kl) for t in range(T))
    keys = sum(max(0, l - low(s)) for s, l in zip(qs, kl))
    per_key = K * (D * kv_elem + (4 if kv_elem == 1 else 0)) * 2
    return (2 * len(qs) * T * H * D * q_elem + keys * per_key + new_rows,
            4 * D * H * pairs)


def write_work(rows, K, D, quant=False):
    """(bytes, operations) of a K/V row write: bf16 rows read (k and v),
    bf16 rows or int8 rows with a 4-byte scale per head written."""
    out = K * (D + 4) if quant else K * D * 2
    return rows * 2 * (K * D * 2 + out), (rows * 2 * K * D * 4 if quant
                                          else 0)


def sdpa_ms(torch, q, k_layer, v_layer, q_start, kv_len, window=None):
    """Time of torch's scaled_dot_product_attention over the slot layer's
    view (q [B, T, H, D]; k/v [B, S, K, D]) with an explicit causal and
    length mask (and sliding ``window``) and enable_gqa: the library
    yardstick of kernel D's bf16 slot modes (the port never calls it)."""
    import torch.nn.functional as F
    B, T = q.shape[:2]
    S = k_layer.shape[1]
    pos = q_start.long()[:, None] + torch.arange(T, device=q.device)[None]
    j = torch.arange(S, device=q.device)
    mask = ((j[None, None, :] < kv_len.long()[:, None, None])
            & (j[None, None, :] <= pos[:, :, None]))
    if window is not None:
        mask = mask & (j[None, None, :] > pos[:, :, None] - window)
    mask = mask[:, None]
    qt, kt, vt = q.transpose(1, 2), k_layer.transpose(1, 2), \
        v_layer.transpose(1, 2)
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=5)


def index_copy_ms(torch, pools, news, rows_of):
    """Time of index_copy_ into the k and v row views over precomputed row
    indices and gathered sources (two calls): the library yardstick of the
    bf16 row writes C and H (the port never calls it)."""
    idx, picked = rows_of
    views = [p.view(-1, p.shape[-2] * p.shape[-1]) for p in pools]
    srcs = [n.reshape(-1, views[0].shape[1])[picked].contiguous()
            for n in news]
    return time_ms(torch, lambda: [v.index_copy_(0, idx, s)
                                   for v, s in zip(views, srcs)], cold=True)


def floor_ms(torch, news, picked, out_dtype, cold, clean=False):
    """The floor of a K/V row write: one ``torch.Tensor.copy_`` of its live
    new rows (k and v, gathered into one contiguous tensor beforehand) into
    a contiguous tensor of the output's element type (bf16, or int8 by
    torch's cast), timed under the row's own method (``cold``: the L2
    flushed before each launch, as time_ms does, by writes unless
    ``clean``). It moves the row's bytes in one launch with no table, no
    scatter and no scales: the practical ceiling of a write kernel under
    that method, its launch and the flush's writebacks included. It is no
    library version of the write (the bound column stays the bytes over
    the HBM rate)."""
    idx = torch.as_tensor(picked, device=news[0].device, dtype=torch.long)
    src = torch.stack([n.reshape(-1, *n.shape[2:])[idx] for n in news])
    dst = torch.empty(src.shape, dtype=out_dtype, device=src.device)
    return time_ms(torch, lambda: dst.copy_(src), cold=cold, clean=clean)


def slot_rows(starts, new_len, T, S):
    """(cache row index per written row, its flat index in the new rows):
    row t < new_len[b] of sequence b lands at row b * S + starts[b] + t of
    a layer's [B * S] token rows (index_copy_'s precomputed indices)."""
    pairs = [(b * S + s + t, b * T + t)
             for b, (s, n) in enumerate(zip(starts, new_len))
             for t in range(n)]
    return [list(x) for x in zip(*pairs)]


def say_plan(attention, tag, B, H, K, D, **kw) -> None:
    """Print kernel D's split plan for a decode row's launch."""
    plan = attention.decode_plan(B, H, K, D, **kw)
    say(f"  decode plan {tag}: " + ", ".join(f"{k} {v}"
                                             for k, v in plan.items()))


def fused_decode_case(torch, attention, results, case, randn, ints, *, B, H,
                      K, D, S, q_start, active, window=None, int8=False,
                      timed=False, fill=None):
    """Kernel D's fused decode (``attention_decode``, or with ``int8`` an
    int8 cache in both numerics, ``attention_decode_int8``) against the
    plain version on a copy of a random two-layer slot cache at layer 1:
    the writes bit for bit, the output per row (DECODE_ROW_TOL). ``timed``
    prints the kernel's time and returns it (the JSON line keeps each
    row's first timed case)."""
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    q_start, kv_len = ints(q_start), ints(q_start) + ints(active)
    q, kn, vn = randn(B, 1, H, D), randn(B, 1, K, D), randn(B, 1, K, D)
    cache = kvc.new_kv_cache(2, B, K, S, D, device=q.device, quantized=int8)
    if int8:
        fill(cache)
    else:
        cache.k.copy_(randn(2, B, S, K, D))
        cache.v.copy_(randn(2, B, S, K, D))
    name = "attention_decode_int8" if int8 else "attention_decode"
    ms = None
    for snapped in ((True, False) if int8 else (False,)):
        ref = dataclasses.replace(cache, **{
            n: getattr(cache, n).clone()
            for n in ("k", "v", "k_scale", "v_scale")
            if getattr(cache, n) is not None})
        planes = (dict(k_scale=cache.k_scale, v_scale=cache.v_scale,
                       snapped=snapped) if int8 else {})
        ref_planes = (dict(k_scale=ref.k_scale, v_scale=ref.v_scale,
                           snapped=snapped) if int8 else {})
        run = lambda: attention.attention_decode_fused(  # noqa: E731
            q, kn, vn, cache.k, cache.v, q_start, kv_len, 1, window=window,
            kernels="cuda", **planes)[0]
        got = run()
        want = attention.attention_decode_fused_torch(
            q, kn, vn, ref.k, ref.v, q_start, kv_len, 1, window=window,
            **ref_planes)[0]
        torch.cuda.synchronize()
        for n in ("k", "v", "k_scale", "v_scale"):
            if getattr(cache, n) is not None and not torch.equal(
                    getattr(cache, n), getattr(ref, n)):
                raise AssertionError(f"{name} [{case}]: the fused write of "
                                     f"{n} differs from the plain write")
        tag = case + (f" {'snapped' if snapped else 'absmax'}" if int8
                      else "")
        if timed:
            ms = ms or time_ms(torch, run)
            tag += f" kernel {ms:.4f} ms (printed only)"
        check_close(torch, name, got, want, results, tag + " (write bit for "
                    "bit)", row_rel=DECODE_ROW_TOL)
    return ms


def paged_equals_slot(torch, dev, gen, tag, B, H, K, D, hist,
                      page: int = 64) -> None:
    """Kernel D's fused decode over a slot cache and over a pool of page
    ``page`` (a random page permutation) holding the same rows, at the
    token positions ``hist``: the two plans split alike and the outputs
    are equal bit for bit (a paged engine reproduces a slot engine)."""
    from llm_inference_engine_tpu_torch.ops import attention
    S = 2048
    maxp, P = S // page, 1 + B * (S // page)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    kc, vc = randn(2, B, S, K, D), randn(2, B, S, K, D)
    kp, vp = randn(2, P, page, K, D), randn(2, P, page, K, D)
    table = (torch.randperm(P - 1, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(B, maxp)
    for pool, slot in ((kp, kc), (vp, vc)):
        pool[1][table.long()] = slot[1].view(B, maxp, page, K, D)
    q, kn, vn = randn(B, 1, H, D), randn(B, 1, K, D), randn(B, 1, K, D)
    qs = torch.tensor(hist, dtype=torch.int32, device=dev)
    kl = qs + 1
    slot = attention.attention_decode_fused(q, kn, vn, kc, vc, qs, kl, 1,
                                            kernels="cuda")[0]
    paged = attention.attention_decode_paged_fused(
        q, kn, vn, kp, vp, qs, kl, 1, table=table, kernels="cuda")[0]
    torch.cuda.synchronize()
    plans = [attention.decode_plan(B, H, K, D, **kw)["nsplit"]
             for kw in ({}, dict(page=page, max_pages=maxp))]
    same = torch.equal(slot, paged)
    say(f"  attention_decode {tag} B{B} H{H} K{K} D{D}: paged (page {page}) "
        f"== slot bit for bit: {same}; nsplit slot / paged {plans}")
    if not same or plans[0] != plans[1]:
        raise AssertionError(f"attention_decode {tag}: the paged decode "
                             "differs from the slot decode")


def decode_shape_rows(torch, dev, hidden: int = 4096,
                      inter: int = 11008) -> dict:
    """Kernels A, A with residual and B at the decode shape of 4b (B = 8:
    [8, hidden], [8, 2 inter]; 4096 and 11008 are llama2-7b's, 4l passes
    tinyllama-1.1b's), where each is a fixed-cost launch, held
    against their plain versions and timed as the decode programs run
    them: 64 calls captured in one CUDA graph, replayed; a call's time is
    CUDA events around 4 replays over 4 x 64, and beside it the union of
    the kernels' intervals under torch.profiler over 4 more replays; each
    beside its plain version and, for A, ``F.rms_norm``, timed the same
    way. Returns {name: {kernel, kernel_union, plain, library: ms a call,
    bound}}."""
    import torch.nn.functional as F

    from llm_inference_engine_tpu_torch.ops import activations, rmsnorm
    gen = torch.Generator(device=dev).manual_seed(99)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    x, r, gu = randn(8, hidden), randn(8, hidden), randn(8, 2 * inter)
    w = randn(hidden) * 0.1 + 1.0

    got = rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda")
    want = rmsnorm.add_residual_rmsnorm_torch(x, r, w)
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"add_residual_rmsnorm [8,{hidden}]: residual "
                             "sum differs")
    for name, a, b in (
            ("rmsnorm", rmsnorm.rmsnorm(x, w, kernels="cuda"),
             rmsnorm.rmsnorm_torch(x, w)),
            ("add_residual_rmsnorm", got[0], want[0]),
            ("silu_and_mul", activations.silu_and_mul(gu, kernels="cuda"),
             activations.silu_and_mul_torch(gu))):
        if not torch.allclose(a.float(), b.float(), **KERNEL_TOL):
            raise AssertionError(f"{name} at decode shape: kernel disagrees "
                                 f"with its plain version")

    cases = {
        "rmsnorm": (lambda: rmsnorm.rmsnorm(x, w, kernels="cuda"),
                    lambda: rmsnorm.rmsnorm_torch(x, w),
                    lambda: F.rms_norm(x, (hidden,), w, 1e-5),
                    (2 * 8 + 1) * hidden * 2),
        "add_residual_rmsnorm": (
            lambda: rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda"),
            lambda: rmsnorm.add_residual_rmsnorm_torch(x, r, w), None,
            (4 * 8 + 1) * hidden * 2),
        "silu_and_mul": (
            lambda: activations.silu_and_mul(gu, kernels="cuda"),
            lambda: activations.silu_and_mul_torch(gu), None,
            3 * 8 * inter * 2)}
    rows = {}
    for name, (kern, plain, library, nbytes) in cases.items():
        k_ev, k_union = graph_replayed_ms(torch, kern)
        p_ev = graph_replayed_ms(torch, plain)[0]
        row = rows[name] = dict(
            kernel=k_ev, kernel_union=k_union, plain=p_ev,
            library=(graph_replayed_ms(torch, library)[0] if library
                     else None),
            bound=bound_ms((nbytes, 0))[0])
        width = 2 * inter if name == "silu_and_mul" else hidden
        say(f"  {name:22s} decode shape [8, {width}], graph replays, held "
            f"against plain: "
            f"kernel {k_ev * 1e3:.3f} us a call (events; union of kernel "
            f"intervals {k_union * 1e3:.3f} us), plain {p_ev * 1e3:.3f} us"
            + (f", F.rms_norm {row['library'] * 1e3:.3f} us"
               if library else "")
            + f"; bound {row['bound'] * 1e3:.4f} us (bytes)")
    return rows


def graph_replayed_ms(torch, fn, calls: int = 64):
    """(CUDA events, union of the card's activity intervals) ms a call of
    ``fn``, ``calls`` calls captured in one CUDA graph and replayed: as
    the decode programs run a fixed-cost launch."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    torch.cuda.synchronize()
    start.record()
    for _ in range(4):
        graph.replay()
    end.record()
    end.synchronize()
    return (start.elapsed_time(end) / 4 / calls,
            device_profile(torch, graph.replay, 4).busy / calls)


def rope_route():
    """The tree's QKV split with RoPE as its ``models.llama`` calls it:
    kernel J where the tree has it, else the split, two rotations and v's
    copy (the glue J replaced). ``tools/chip_kernel_ab.py --rows rope``
    times both trees through it."""
    from llm_inference_engine_tpu_torch.models import llama
    if hasattr(llama, "split_qkv_rope_fused"):
        return llama.split_qkv_rope_fused

    def glue(qkv, cos, sin, H, K, D):
        q, k, v = llama.split_qkv(qkv, H, K, D)
        return (llama.rotate(q, cos, sin), llama.rotate(k, cos, sin),
                v.contiguous())
    return glue


def rope_inputs(torch, gen, n: int, K: int, G: int, D: int, dtype,
                poison: bool = False, bias: bool = False):
    """J's inputs for ``n`` tokens: packed qkv [n, K*(G+2)*D] of
    ``dtype``, cos/sin [n, 1, D/2] (``rope_tables``' layout) of random
    positions below 4096 (llama2-7b's theta) and, with ``bias``, a packed
    bias row [K*(G+2)*D] at a dummy bias's magnitude (0.02), else None;
    with ``poison``, each at the head of a buffer whose tail is NaN."""
    from llm_inference_engine_tpu_torch.ops import rope
    dev = gen.device
    qkv = torch.randn(n, K * (G + 2) * D, generator=gen, device=dev,
                      dtype=dtype)
    pos = torch.randint(0, 4096, (n,), generator=gen, device=dev)
    cos, sin = (t[:, None, :].contiguous()
                for t in rope.rope_cos_sin(pos, D, 10000.0))
    b = (torch.randn(K * (G + 2) * D, generator=gen, device=dev,
                     dtype=dtype) * 0.02 if bias else None)
    if poison:
        qkv, cos, sin = (poisoned(torch, t) for t in (qkv, cos, sin))
        b = None if b is None else poisoned(torch, b)
    return qkv, cos, sin, b


def rope_work(n: int, K: int, G: int, D: int, elem: int,
              bias: bool = False):
    """(bytes, operations, their rate) of J: the packed rows read and q, k,
    v written once (the same element count), cos and sin read once (and a
    bias row, added to each value: one f32 operation a value); 6 f32
    operations a rotated pair (four products, a sum, a difference)."""
    row = K * (G + 2) * D
    return (2 * n * row * elem + 2 * n * (D // 2) * 4 + bias * row * elem,
            6 * n * K * (G + 1) * (D // 2) + bias * n * row, F32_OPS_PER_S)


def rope_case(torch, gen, results, case: str, n: int, K: int, G: int,
              D: int, dtype=None, timed: bool = True,
              bias: bool = False) -> None:
    """Kernel J for ``n`` tokens at K kv heads, group G, head_dim D (with
    ``bias``: its bias mode, Qwen2's packed qkv bias added first): q, k
    and v bit for bit its plain version's (the bias add, the split, two
    rotations, v's copy), every input at the head of a buffer whose tail
    is NaN; timed beside the plain version with its bound. No single
    PyTorch call splits and rotates: its library column is none."""
    from llm_inference_engine_tpu_torch.ops import rope
    dtype = dtype or torch.bfloat16
    qkv, cos, sin, b = rope_inputs(torch, gen, n, K, G, D, dtype,
                                   poison=True, bias=bias)
    H = K * G
    got = rope.split_qkv_rope_fused(qkv, cos, sin, H, K, D, bias=b,
                                    kernels="cuda")
    want = rope.split_qkv_rope_fused_torch(qkv, cos, sin, H, K, D, b)
    torch.cuda.synchronize()
    for part, g, w in zip("qkv", got, want):
        if not torch.equal(g, w):
            bad = (g != w).sum().item()
            raise AssertionError(f"split_qkv_rope [{case}]: {part} differs "
                                 f"from the plain version in {bad} of "
                                 f"{w.numel()} values")
    t = None
    if timed:
        t = (time_ms(torch, lambda: rope.split_qkv_rope_fused(
                qkv, cos, sin, H, K, D, bias=b, kernels="cuda"), iters=20),
             time_ms(torch, lambda: rope.split_qkv_rope_fused_torch(
                 qkv, cos, sin, H, K, D, b), iters=20))
    record("split_qkv_rope", 0.0, results,
           f"{case} [{n}] K{K} G{G} D{D} {str(dtype)[6:]}"
           f"{' with bias' if bias else ''} bit for bit, NaN past the tails, "
           "library none", t,
           rope_work(n, K, G, D, qkv.element_size(), bias))


def rope_replayed_rows(torch, dev, tag: str, K: int, G: int, D: int,
                       n: int = 8, held: bool = True,
                       bias: bool = False) -> dict:
    """J at a decode step's ``n`` tokens, timed as the decode programs run
    it (``graph_replayed_ms``: 64 calls in one CUDA graph), beside the
    plain version timed the same way, with its bound; ``held``: its
    outputs bit for bit the plain version's first (this tree's kernel;
    ``tools/chip_kernel_ab.py`` times the other tree's route, which
    ``rope_route`` picks, without it); ``bias``: J's bias mode (this
    tree's wrapper). Returns {name: ms a call}."""
    from llm_inference_engine_tpu_torch.ops import rope
    gen = torch.Generator(device=dev).manual_seed(77)
    qkv, cos, sin, bq = rope_inputs(torch, gen, n, K, G, D, torch.bfloat16,
                                    bias=bias)
    H = K * G
    route = (functools.partial(rope.split_qkv_rope_fused, bias=bq) if bias
             else rope_route())
    if held:
        got = route(qkv, cos, sin, H, K, D)
        want = rope.split_qkv_rope_fused_torch(qkv, cos, sin, H, K, D, bq)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"split_qkv_rope {tag} in graph replays: "
                                 "not bit for bit the plain version")
    (k_ev, k_union) = graph_replayed_ms(
        torch, lambda: route(qkv, cos, sin, H, K, D))
    row = {f"split_qkv_rope {tag} decode": k_ev,
           f"split_qkv_rope {tag} decode union": k_union}
    if held:
        row[f"split_qkv_rope {tag} decode plain"] = graph_replayed_ms(
            torch, lambda: rope.split_qkv_rope_fused_torch(
                qkv, cos, sin, H, K, D, bq))[0]
    b = bound_ms(rope_work(n, K, G, D, 2, bias))[0]
    say(f"  split_qkv_rope {tag} [{n}] K{K} G{G} D{D}"
        f"{' with bias' if bias else ''}, graph replays"
        + (", bit for bit the plain version" if held else "")
        + f": {k_ev * 1e3:.3f} us a call (events; union {k_union * 1e3:.3f}"
        " us)" + (f", plain {row[f'split_qkv_rope {tag} decode plain'] * 1e3:.3f}"
                  " us" if held else "")
        + f"; bound {b * 1e3:.4f} us (bytes); library none")
    return row


def phase_kernels(torch, dev, results) -> None:
    import torch.nn.functional as F

    from llm_inference_engine_tpu_torch.ops import _native, activations
    from llm_inference_engine_tpu_torch.ops import attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import rmsnorm

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf16)

    def ints(vals):
        return torch.tensor(vals, device=dev, dtype=torch.int32)

    # A: rmsnorm / add_residual_rmsnorm at prefill (B*T = 4*512) and
    # decode (B = 8) token counts, hidden 4096
    for n in (2048, 8):
        x, r = randn(n, 4096), randn(n, 4096)
        w = randn(4096) * 0.1 + 1.0
        # A's working set fits the L2: timed cold (128 MB written between
        # launches), as the library call
        got = rmsnorm.rmsnorm(x, w, kernels="cuda")
        check_close(torch, "rmsnorm", got, rmsnorm.rmsnorm_torch(x, w),
                    results, f"[{n},4096] cold L2", (
                        time_ms(torch, lambda: rmsnorm.rmsnorm(
                            x, w, kernels="cuda"), cold=True),
                        time_ms(torch, lambda: rmsnorm.rmsnorm_torch(x, w))),
                    work=((2 * n + 1) * 4096 * 2, 4 * n * 4096),
                    library=time_ms(torch, lambda: F.rms_norm(
                        x, (4096,), w, 1e-5), cold=True))
        y, h = rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda")
        y0, h0 = rmsnorm.add_residual_rmsnorm_torch(x, r, w)
        if not torch.equal(h, h0):
            raise AssertionError("add_residual_rmsnorm: residual sum differs")
        check_close(torch, "add_residual_rmsnorm", y, y0, results,
                    f"[{n},4096] with residual, cold L2", (
                        time_ms(torch, lambda: rmsnorm.add_residual_rmsnorm(
                            x, r, w, kernels="cuda"), cold=True),
                        time_ms(torch, lambda: rmsnorm.add_residual_rmsnorm_torch(
                            x, r, w))),
                    work=((4 * n + 1) * 4096 * 2, 5 * n * 4096))

    # B: silu_and_mul over the packed gate|up [N, 2*11008]
    for n in (2048, 8):
        gu = randn(n, 22016)
        check_close(torch, "silu_and_mul",
                    activations.silu_and_mul(gu, kernels="cuda"),
                    activations.silu_and_mul_torch(gu), results,
                    f"[{n},22016]", (
                        time_ms(torch, lambda: activations.silu_and_mul(
                            gu, kernels="cuda")),
                        time_ms(torch, lambda: activations.silu_and_mul_torch(gu))),
                    work=(3 * n * 11008 * 2, 5 * n * 11008))

    # J: a prefill chunk's 8 x 512 tokens and a decode step's 8
    for n, case in ((8 * 512, "prefill 8 x 512"), (8, "decode")):
        rope_case(torch, gen, results, case, n, 32, 1, 128)

    # C: a 512-token prefill chunk into the full 7B cache at layer 31
    L, B, S, K, D = 32, 4, 2048, 32, 128
    T, starts_l, new_len_l = C_CHUNK
    starts, new_len = ints(starts_l), ints(new_len_l)
    kn, vn = randn(B, T, K, D), randn(B, T, K, D)
    cache = kvc.new_kv_cache(L, B, K, S, D, device=dev)
    cache.k[31], cache.v[31] = randn(B, S, K, D), randn(B, S, K, D)
    ref = kvc.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths)
    kvc.update_cache_at_layer(cache, 31, kn, vn, starts, new_len,
                              kernels="cuda")
    kvc.update_cache_at_layer_torch(ref, 31, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    if not (torch.equal(cache.k, ref.k) and torch.equal(cache.v, ref.v)):
        raise AssertionError("kv_write: cache differs from the plain write")
    rows, picked = slot_rows(starts_l, new_len_l, T, S)
    check_close(torch, "kv_write", cache.k[31], ref.k[31], results,
                "[4,512,32,128] -> [32,4,2048,32,128] @31 cold L2", (
                    time_ms(torch, lambda: kvc.update_cache_at_layer(
                        cache, 31, kn, vn, starts, new_len, kernels="cuda"),
                        cold=True),
                    time_ms(torch, lambda: kvc.update_cache_at_layer_torch(
                        ref, 31, kn, vn, starts, new_len))),
                work=write_work(len(rows), K, D),
                library=index_copy_ms(torch, (cache.k[31], cache.v[31]),
                                      (kn, vn), (ints(rows).long(),
                                                 ints(picked).long())),
                floor=floor_ms(torch, (kn, vn), picked, torch.bfloat16,
                               cold=True))
    del ref

    # D2's tiling of every instance (the paged modes tile alike)
    for d in _native.HEAD_DIMS:
        for int8 in (False, True):
            say(f"  prefill plan D{d}{' int8' if int8 else ''}: " + ", ".join(
                f"{k} {v}" for k, v in attention.prefill_plan(
                    d, int8=int8).items()))
    # D prefill: the chunk above attends its random history + itself
    q = randn(B, T, 32, D)
    q_start = starts
    kv_len = starts + new_len
    run = lambda kern: attention.attention(  # noqa: E731
        q, cache.k, cache.v, q_start, kv_len, layer=31, kernels=kern)
    check_close(torch, "attention_prefill", run("cuda"), run("torch"),
                results, "B4 T512 H32 K32 qs[0,100,1000,1535]", (
                    time_ms(torch, lambda: run("cuda"), iters=5),
                    time_ms(torch, lambda: run("torch"), iters=5)),
                work=attn_work(starts_l, [s + n for s, n in zip(
                    starts_l, new_len_l)], T, 32, K, D),
                library=sdpa_ms(torch, q, cache.k[31], cache.v[31], q_start,
                                kv_len))

    # D decode: row 0 has no history, row 2 is inactive
    say_plan(attention, "B4 H32 K32 D128", B, 32, K, D)
    dq_start = ints([0, 700, 1300, 2047])
    dkv_len = dq_start + ints([1, 1, 0, 1])
    q1, k1, v1 = randn(B, 1, 32, D), randn(B, 1, K, D), randn(B, 1, K, D)
    kc, vc = cache.k, cache.v
    kc2, vc2 = kc.clone(), vc.clone()
    out, _, _ = attention.attention_decode_fused(
        q1, k1, v1, kc, vc, dq_start, dkv_len, 31, kernels="cuda")
    want, _, _ = attention.attention_decode_fused_torch(
        q1, k1, v1, kc2, vc2, dq_start, dkv_len, 31)
    torch.cuda.synchronize()
    if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
        raise AssertionError("attention_decode: cache write differs")
    del kc2, vc2
    check_close(torch, "attention_decode", out, want, results,
                "B4 H32 K32 qs[0,700,1300,2047] row2 inactive", (
                    time_ms(torch, lambda: attention.attention_decode_fused(
                        q1, k1, v1, kc, vc, dq_start, dkv_len, 31,
                        kernels="cuda")),
                    time_ms(torch, lambda: attention.attention_decode_fused_torch(
                        q1, k1, v1, kc, vc, dq_start, dkv_len, 31))),
                work=attn_work([0, 700, 1300, 2047], [1, 701, 1300, 2048], 1,
                               32, K, D, new_rows=3 * 2 * K * D * 2 * 2),
                library=sdpa_ms(torch, q1, kc[31], vc[31], dq_start,
                                dkv_len),
                row_rel=DECODE_ROW_TOL)
    del cache, kc, vc

    # D at GQA widths (H=32, K=8, as in llama3-8b), without and with a
    # sliding window
    Kg = 8
    kc, vc = randn(2, B, S, Kg, D), randn(2, B, S, Kg, D)
    for window in (None, 256):
        tag = f"GQA K8 window {window}"
        got = attention.attention(q, kc, vc, q_start, kv_len, layer=1,
                                  window=window, kernels="cuda")
        check_close(torch, "attention_prefill", got, attention.attention_torch(
            q, kc, vc, q_start, kv_len, layer=1, window=window), results,
            f"B4 T512 H32 {tag}")
        k1g, v1g = randn(B, 1, Kg, D), randn(B, 1, Kg, D)
        kc2, vc2 = kc.clone(), vc.clone()
        got, _, _ = attention.attention_decode_fused(
            q1, k1g, v1g, kc, vc, dq_start, dkv_len, 1, window=window,
            kernels="cuda")
        want, _, _ = attention.attention_decode_fused_torch(
            q1, k1g, v1g, kc2, vc2, dq_start, dkv_len, 1, window=window)
        torch.cuda.synchronize()
        if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
            raise AssertionError(f"attention_decode [{tag}]: cache differs")
        check_close(torch, "attention_decode", got, want, results,
                    f"B4 H32 {tag}", row_rel=DECODE_ROW_TOL)
    del kc, vc, kc2, vc2
    # D decode at the engine's B = 8 shape (4b's decode contexts), at
    # kv_len of one 32-key tile and one tile + 1, and at G = 7 (H = 28,
    # K = 4, qwen2-7b's group) with a window starting inside a tile
    hist = [p + 16 + f + 16 for p, f in zip(QUANT_PROMPTS, QUANT_FOLLOW)]
    say_plan(attention, "B8 H32 K32 D128", 8, 32, 32, D)
    fused_decode_case(torch, attention, results, "B8 H32 K32 4b contexts "
                      f"{min(hist)}-{max(hist)}", randn, ints, B=8, H=32,
                      K=32, D=D, S=S, q_start=hist, active=[1] * 8,
                      timed=True)
    fused_decode_case(torch, attention, results, "B4 kv_len 1, 32, 33, 65",
                      randn, ints, B=4, H=32, K=32, D=D, S=S,
                      q_start=[0, 31, 32, 64], active=[1] * 4)
    say_plan(attention, "B4 H28 K4 D128", B, 28, 4, D)
    fused_decode_case(torch, attention, results, "B4 G7 H28 K4 window 300",
                      randn, ints, B=4, H=28, K=4, D=D, S=S,
                      q_start=[0, 700, 1300, 2047], active=[1, 1, 0, 1],
                      window=300)
    # D2 at G = 8 (H=32, K=4): 130 rows against kv_len up to 2048 (32
    # tiles, the copy ring wraps), once with a window that starts inside a
    # tile
    kc, vc = randn(1, B, S, 4, D), randn(1, B, S, 4, D)
    q_start, kv_len = ints([0, 5, 1024, 1918]), ints([130, 75, 1025, 2048])
    q130 = randn(B, 130, 32, D)
    for window in (None, 100):
        got = attention.attention(q130, kc, vc, q_start, kv_len, layer=0,
                                  window=window, kernels="cuda")
        check_close(torch, "attention_prefill", got, attention.attention_torch(
            q130, kc, vc, q_start, kv_len, layer=0, window=window), results,
            f"B4 T130 H32 K4 kv_len 75-2048 window {window}")
    del kc, vc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# Kernels E and F in phase 3b: (k, n, halves) of Llama2-7B's quantized
# projections, and the timed rows (m, projection): a decode layer and the
# lm_head at the engine's m = 8, the server's B = 16 step and generate at
# B = 32 (wo and down, the n = 4096 projections; m 32 takes the decode
# mode's 32-row tile), and the 8 x 64 prefill tail (m = 512)
QUANT_SHAPES = {"wqkv": (4096, 12288, 1), "wo": (4096, 4096, 1),
                "gate|up": (4096, 11008, 2), "down": (11008, 4096, 1),
                "lm_head": (4096, 32000, 1)}
QUANT_ROWS = ([(8, p) for p in QUANT_SHAPES] + [(16, "wo"), (16, "down"),
                                                (32, "wo"), (32, "down")]
              + [(512, p) for p in ("wqkv", "wo", "gate|up", "down")])


def write_rows(torch, dev) -> dict:
    """Kernel ms of the K/V row writes, no checks: C at C_CHUNK, H and its
    int8 mode at 3c's mixed step (520 rows) and at decode shape (B = 8 and
    16), cold; I at I_CHUNKS, warm (snapped); each beside its floor, and
    the 520-row rows and their floors again under a clean flush
    (time_ms's ``clean``); then C and H at the narrower rows of the mesh
    paths, cold: C at 16 heads (4n's 8 x 512 chunk, 4q's beams' 4 x 128
    prefill) and at 2 kv heads of 64 (4q's draft chunk, 256-byte rows),
    H at 16 heads (4n (d)'s chunk); then If (float16 and float32 rows
    into an int8 cache, snapped) at 3f's rows, warm: 8 x 512 into the slot
    cache and 3c's 520-row mixed step through the table.
    ``tools/chip_kernel_ab.py --rows writes`` times another tree's kernels
    through this function, so it calls only the wrappers every tree
    has."""
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    bf16, i8 = torch.bfloat16, torch.int8
    gen = torch.Generator(device=dev).manual_seed(1234)
    L, K, D, S = 32, 32, 128, 2048
    out = {}

    def ints(vals):
        return torch.tensor(vals, device=dev, dtype=torch.int32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf16)

    def row(label, write, news, picked, dtype, cold, clean=False):
        out[label] = time_ms(torch, write, cold=cold, clean=clean)
        out[label + " floor"] = floor_ms(torch, news, picked, dtype, cold,
                                         clean)

    T, st, nl = C_CHUNK
    cache = kvc.new_kv_cache(L, len(st), K, S, D, device=dev)
    kn, vn = randn(len(st), T, K, D), randn(len(st), T, K, D)
    starts, new_len = ints(st), ints(nl)
    row(f"kv_write {len(st)}x{T} cold", lambda: kvc.update_cache_at_layer(
        cache, 31, kn, vn, starts, new_len, kernels="cuda"), (kn, vn),
        slot_rows(st, nl, T, S)[1], bf16, True)
    del cache
    cache = kvc.new_kv_cache(L, 8, K, S, D, device=dev, quantized=True,
                             snapped=True)
    for T, st, nl in I_CHUNKS:
        kn, vn = randn(8, T, K, D), randn(8, T, K, D)
        starts, new_len = ints(st), ints(nl)
        row(f"kv_write_quant 8x{T} ({sum(nl)} rows) warm",
            lambda: kvc.update_cache_at_layer(cache, 31, kn, vn, starts,
                                              new_len, kernels="cuda"),
            (kn, vn), slot_rows(st, nl, T, S)[1], i8, False)
    del cache
    torch.cuda.empty_cache()
    maxp = S // 64
    P = 1 + 16 * maxp
    table = (torch.randperm(P - 1, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(16, maxp)
    for quant, name, dtype in ((False, "paged_kv_write", bf16),
                               (True, "paged_kv_write_int8", i8)):
        pool = pkv.new_paged_kv_cache(L, 16, K, P, 64, D, maxp, device=dev,
                                      quantized=quant)
        pool.block_table.copy_(table)
        kn, vn = randn(16, 64, K, D), randn(16, 64, K, D)
        starts, new_len = ints(H_STARTS), ints(H_NEW_LEN)
        picked = slot_rows(H_STARTS, H_NEW_LEN, 64, 0)[1]
        for clean in (False, True):
            row(f"{name} {sum(H_NEW_LEN)} rows cold"
                + (" clean" if clean else ""),
                lambda: pkv.paged_update_at_layer(
                    pool, 31, kn, vn, starts, new_len, kernels="cuda"),
                (kn, vn), picked, dtype, True, clean)
        for B in (8, 16):
            sub = dataclasses.replace(pool, block_table=pool.block_table[:B])
            kn1, vn1 = randn(B, 1, K, D), randn(B, 1, K, D)
            s1, n1 = ints(DECODE_WRITE_STARTS[:B]), ints([1] * B)
            row(f"{name} decode B{B} cold", lambda: pkv.paged_update_at_layer(
                sub, 31, kn1, vn1, s1, n1, kernels="cuda"), (kn1, vn1),
                list(range(B)), dtype, True)
        del pool
        torch.cuda.empty_cache()
    first = [min(n, 512) for n in QUANT_PROMPTS]
    for tag, B, T, Kn, Dn, nl in (
            ("16 heads 8x512", 8, 512, TP2_HEADS, 128, first),
            ("16 heads 4x128", BEAMS, BEAM_PROMPT, TP2_HEADS, 128,
             [BEAM_PROMPT] * BEAMS),
            ("2x64 heads 8x512", 8, 512, TINY_TP2_HEADS[1], TINY_HEAD_DIM,
             first)):
        cache = kvc.new_kv_cache(2, B, Kn, S, Dn, device=dev)
        kn, vn = randn(B, T, Kn, Dn), randn(B, T, Kn, Dn)
        starts, new_len = ints([0] * B), ints(nl)
        row(f"kv_write {tag} cold", lambda: kvc.update_cache_at_layer(
            cache, 1, kn, vn, starts, new_len, kernels="cuda"), (kn, vn),
            slot_rows([0] * B, nl, T, S)[1], bf16, True)
        del cache
    chunk = list(TP2_SCHED_PROMPTS) + [0] * 4
    pool = pkv.new_paged_kv_cache(2, 8, TP2_HEADS, P, 64, D, maxp,
                                  device=dev)
    pool.block_table.copy_(table[:8])
    kn, vn = randn(8, 64, TP2_HEADS, D), randn(8, 64, TP2_HEADS, D)
    starts, new_len = ints([0] * 8), ints(chunk)
    row("paged_kv_write 16 heads 4n (d) chunk cold",
        lambda: pkv.paged_update_at_layer(pool, 1, kn, vn, starts, new_len,
                                          kernels="cuda"),
        (kn, vn), slot_rows([0] * 8, chunk, 64, 0)[1], bf16, True)
    del pool
    torch.cuda.empty_cache()
    T, st, nl = I_CHUNKS[0]
    for name in FLOAT_DTYPE.values():
        dtype = getattr(torch, name)
        cache = kvc.new_kv_cache(1, 8, K, S, D, device=dev, quantized=True,
                                 snapped=True)
        kn, vn = (torch.randn(8, T, K, D, generator=gen, device=dev,
                              dtype=dtype) for _ in range(2))
        starts, new_len = ints(st), ints(nl)
        row(f"If {name} 8x{T} ({sum(nl)} rows) warm",
            lambda: kvc.update_cache_at_layer(cache, 0, kn, vn, starts,
                                              new_len, kernels="cuda"),
            (kn, vn), slot_rows(st, nl, T, S)[1], i8, False)
        del cache
        pool = pkv.new_paged_kv_cache(1, 16, K, P, 64, D, maxp, device=dev,
                                      quantized=True)
        pool.block_table.copy_(table)
        kn, vn = (torch.randn(16, 64, K, D, generator=gen, device=dev,
                              dtype=dtype) for _ in range(2))
        starts, new_len = ints(H_STARTS), ints(H_NEW_LEN)
        row(f"If {name} paged {sum(H_NEW_LEN)} rows warm",
            lambda: pkv.paged_update_at_layer(pool, 0, kn, vn, starts,
                                              new_len, kernels="cuda"),
            (kn, vn), slot_rows(H_STARTS, H_NEW_LEN, 64, 0)[1], i8, False)
        del pool
        torch.cuda.empty_cache()
    return out


def prefill_rows(torch, dev) -> dict:
    """Card busy ms of one warm prefill of 4b's prompts (llama2-7b INT4,
    B = 8) and the K/V writes' share of it, no checks: paged with a bf16
    pool (4d) and an int8 pool (4h), pages and chunks of 64, and slot with
    an int8 cache (4g); then slot at INT4 (4b) and INT8 (4c), the first
    chunk 8 x 512 rows (the m >= 1024 route: G or G8, cuBLAS), with the
    ms of kernel J, G, G8, cuBLAS and the rest (KERNEL_GROUPS).
    ``tools/chip_kernel_ab.py --rows prefill`` times another tree through
    this function, so it calls only what every tree has."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import EngineConfig
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, n).tolist() for n in QUANT_PROMPTS]
    base = EngineConfig(max_batch_size=len(prompts), max_seq_len=2048,
                        quant_mode="int4")
    paged = dict(kv_layout="paged", page_size=64, max_prefill_len=64)
    out = {}
    for tag, cfg in (("4d bf16 pool", base.replace(**paged)),
                     ("4h int8 pool", base.replace(
                         kv_cache_dtype_name="int8", **paged)),
                     ("4g int8 slot", base.replace(
                         kv_cache_dtype_name="int8"))):
        engine = create_engine("llama2-7b", None, cfg, seed=0, device=dev)
        engine.prefill(prompts)                  # first use of each shape
        engine.reset()
        prof = device_profile(torch, lambda: engine.prefill(prompts), 1)
        out[f"{tag} prefill busy"] = prof.busy
        out[f"{tag} prefill writes"] = sum(
            ms for ms, name in prof.per_kernel if "kv_write" in name)
        del engine
        torch.cuda.empty_cache()
    for tag, quant in (("4b int4 slot", "int4"), ("4c int8 slot", "int8")):
        engine = create_engine("llama2-7b", None, base.replace(
            quant_mode=quant), seed=0, device=dev)
        engine.prefill(prompts)
        engine.reset()
        prof = device_profile(torch, lambda: engine.prefill(prompts), 1)
        out[f"{tag} prefill busy"] = prof.busy
        groups = group_ms(prof.per_kernel)
        for g in ("J", "G", "G8", "cuBLAS", "rest"):
            out[f"{tag} prefill {g}"] = groups[g]
        del engine
        torch.cuda.empty_cache()
    return out


def replayed_step_rows(torch, dev, engine, tag: str, prompts) -> dict:
    """One slot engine's replayed decode step after a 16-token greedy
    ``generate`` of ``prompts``: wall a step over 32 replays, the card's
    busy ms a step (4 replays), kernel J's ms and the RoPE glue's ms of it
    (``glue_labels`` over one eager step: rope_cos_sin, and the split and
    rotations in a tree that still runs them), the RoPE group (their
    sum), the casts' ms (where a tree's copy of v lands) and a checksum of
    the ids."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import SamplingParams
    from llm_inference_engine_tpu_torch.runtime.decode_graph import (
        run_eagerly)
    res = engine.generate(prompts, SamplingParams(greedy=True,
                                                  max_new_tokens=16),
                          eos_token_id=None)
    toks = torch.tensor([o[-1] for o in res.token_ids], device=dev,
                        dtype=torch.int32)
    active, sp = np.ones(len(prompts), bool), SamplingParams(greedy=True)
    toks = engine.decode_step(toks, active, sp)   # captures the step
    snap = snapshot(engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = []
    for _ in range(32):
        toks = engine.decode_step(toks, active, sp)
        ids.append(toks)
    torch.cuda.synchronize()
    out = {f"{tag} replayed step wall": (time.perf_counter() - t0) / 32 * 1e3,
           f"{tag} greedy ids checksum": bits_checksum(
               torch, [torch.tensor(res.token_ids, device=dev), *ids])}
    restore(engine, snap)
    prof = device_profile(torch, lambda: engine.decode_step(toks, active,
                                                            sp), 4)
    restore(engine, snap)
    with run_eagerly(engine), glue_labels():
        _, cpu = device_profile(torch, lambda: engine.decode_step(
            toks, active, sp), 1, cpu_ops=True)
    groups = group_ms(prof.per_kernel, glue_map(cpu))
    adds = [ms for ms, name in prof.per_kernel
            if _group_of(name) == "rest" and "_add" in name]
    out.update({f"{tag} replayed step busy": prof.busy,
                f"{tag} replayed step J": groups["J"],
                f"{tag} replayed step RoPE glue": groups["RoPE"],
                f"{tag} replayed step RoPE group": groups["J"]
                + groups["RoPE"],
                f"{tag} replayed step casts": groups["casts"],
                f"{tag} replayed step other": groups["other"],
                f"{tag} replayed step elementwise adds": sum(adds),
                f"{tag} replayed step activities": prof.activities})
    engine.reset()
    return out


def rope_rows(torch, dev) -> dict:
    """The QKV split with RoPE of this tree (``rope_route``: kernel J, or
    the glue J replaced), no checks: at 4b's decode step ([8] tokens,
    llama2-7b: 64 calls in a CUDA graph), at tinyllama's ([8], G 8,
    head_dim 64) and a tp = 2 rank's (K 16), all in graph replays; at a
    prefill chunk (8 x 512) and the verify's 8 x 5 (CUDA events); a
    checksum of the route's outputs at the prefill chunk; then the
    replayed decode step (``replayed_step_rows``) of 4a (bf16, B 4), 4b
    (INT4, B 8), 4n (INT4 at tp = 2 on two ranks of this card, B 8) and
    4t (float16, B 4). ``tools/chip_kernel_ab.py --rows rope`` times
    another tree through this function, so it calls only what every tree
    has."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
    from llm_inference_engine_tpu_torch.models import weights as W
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.parallel import make_mesh, sharding
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    out = {}
    for tag, K, G, D in (("4b", 32, 1, 128), ("tinyllama", 4, 8, 64),
                         ("tp2", TP2_HEADS, 1, 128)):
        rows = rope_replayed_rows(torch, dev, tag, K, G, D, held=False)
        out[f"split_qkv_rope {tag} decode"] = rows[
            f"split_qkv_rope {tag} decode"]
    route = rope_route()
    gen = torch.Generator(device=dev).manual_seed(78)
    for tag, n in (("prefill 8 x 512", 8 * 512),
                   ("verify 8 x 5", 8 * (SPEC_K + 1))):
        qkv, cos, sin, _ = rope_inputs(torch, gen, n, 32, 1, 128,
                                       torch.bfloat16)
        out[f"split_qkv_rope {tag}"] = time_ms(
            torch, lambda: route(qkv, cos, sin, 32, 32, 128), iters=20)
        if n == 8 * 512:
            out["split_qkv_rope outputs checksum"] = bits_checksum(torch, [
                t.reshape(-1).view(torch.int16)
                for t in route(qkv, cos, sin, 32, 32, 128)])
    rng = np.random.default_rng(0)
    quant_prompts = [rng.integers(3, 32000, n).tolist()
                     for n in QUANT_PROMPTS]
    rng = np.random.default_rng(0)
    b4_prompts = [rng.integers(3, 32000, n).tolist()
                  for n in (7, 129, 384, 700)]
    b4 = EngineConfig(max_batch_size=4, max_seq_len=2048)
    engine = create_engine("llama2-7b", None, b4, seed=0, device=dev)
    out.update(replayed_step_rows(torch, dev, engine, "4a", b4_prompts))
    del engine
    torch.cuda.empty_cache()
    int4 = EngineConfig(quant_mode="int4", max_batch_size=8,
                        max_seq_len=2048)
    engine = create_engine("llama2-7b", None, int4, seed=0, device=dev)
    out.update(replayed_step_rows(torch, dev, engine, "4b", quant_prompts))
    params = engine.params
    del engine
    engine = InferenceEngine(get_config("llama2-7b"), int4,
                             sharding.shard_params(params, make_mesh(
                                 1, 2, devices=[dev, dev])))
    del params
    out.update(replayed_step_rows(torch, dev, engine, "4n tp2",
                                  quant_prompts))
    del engine
    torch.cuda.empty_cache()
    cfg = get_config("llama2-7b").replace(dtype_name="float16")
    engine = InferenceEngine(cfg, b4, W.init_dummy_params(cfg, seed=0,
                                                          device=dev),
                             device=dev)
    out.update(replayed_step_rows(torch, dev, engine, "4t f16", b4_prompts))
    del engine
    torch.cuda.empty_cache()
    return out


def bias_rows(torch, dev) -> dict:
    """qwen2-7b's replayed decode step (``replayed_step_rows``; 4u's paths:
    INT4 at B 8 on 4b's prompts, bf16 at B 4 on 4a's) and kernel J at its
    decode step in graph replays (K 4, G 7; this tree's J, with its bias
    mode where the tree's wrapper takes a bias): the step's busy ms, J's
    ms and the elementwise adds' ms, where a tree that adds Qwen2's qkv
    bias apart from J pays it. ``tools/chip_kernel_ab.py --rows bias``
    times another tree through this function."""
    import inspect

    import numpy as np

    from llm_inference_engine_tpu_torch.config import EngineConfig
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.ops import rope
    out = {}
    takes_bias = "bias" in inspect.signature(
        rope.split_qkv_rope_fused).parameters
    rows = rope_replayed_rows(torch, dev, "qwen2", 4, 7, 128, held=False,
                              bias=takes_bias)
    out["split_qkv_rope qwen2 decode"] = rows["split_qkv_rope qwen2 decode"]
    for tag, eng, lens in (
            ("qwen2 int4", dict(quant_mode="int4", max_batch_size=8,
                                max_seq_len=2048), QUANT_PROMPTS),
            ("qwen2 bf16", dict(max_batch_size=4, max_seq_len=2048),
             B4_PROMPTS)):
        rng = np.random.default_rng(0)
        engine = create_engine("qwen2-7b", None, EngineConfig(**eng), seed=0,
                               device=dev)
        prompts = [rng.integers(3, engine.config.vocab_size, n).tolist()
                   for n in lens]
        out.update(replayed_step_rows(torch, dev, engine, tag, prompts))
        del engine
        torch.cuda.empty_cache()
    return out


def quant_weights(torch, quant, dev, gen, mode, k, n, halves=1,
                  min_bytes=0):
    """Random quantized weights at the dummy model's magnitudes (scale
    ~0.02 / qmax a value step): enough copies to hold ``min_bytes``
    together, so that cycling through them leaves none in the 50 MB L2
    between uses, as in a decode step."""
    lead = (2,) if halves == 2 else ()
    int4 = mode == "int4"

    def one():
        q = torch.randint(-128 if int4 else -127, 128,
                          (*lead, k // 2 if int4 else k, n), generator=gen,
                          dtype=torch.int8, device=dev)
        s = torch.rand((*lead, k // 128 if int4 else 1, n), generator=gen,
                       device=dev) + 0.5
        return with_layout(quant, quant.QuantizedTensor(
            q, s * (0.02 / (7 if int4 else 127)), mode, 128))
    first = one()
    return [first] + [one() for _ in range(
        max(1, -(-min_bytes // first.nbytes)) - 1)]


def poisoned(torch, t, pad: int = 1 << 16):
    """``t``'s values at the head of a larger buffer whose tail holds NaN
    (127 for an integer dtype): a kernel that reads past any ragged tail
    of ``t`` shows it (the OOB rule)."""
    fill = float("nan") if t.is_floating_point() else 127
    buf = torch.full((t.numel() + pad,), fill, dtype=t.dtype,
                     device=t.device)
    buf[:t.numel()].copy_(t.flatten())
    return buf[:t.numel()].view(t.shape)


def with_layout(quant, t):
    """INT4 ``t`` with the fragment-order copy (``qd``) that kernel E reads
    at m <= 16 on the card, where the tree has one
    (``quant.add_decode_layout``; engines build theirs); ``t`` as it is
    otherwise."""
    add = getattr(quant, "add_decode_layout", None)
    return add(t) if add is not None and t.mode == "int4" else t


def layout_of(t) -> dict:
    """``qd=`` for kernel E's wrapper where ``t`` carries the fragment
    order (a tree that has none takes no such argument)."""
    qd = getattr(t, "qd", None)
    return {} if qd is None else {"qd": qd}


def poisoned_weight(torch, quant, t):
    """``t`` with q, scale and (INT4, where the tree has it) the fragment
    order each at the head of a NaN- (127-) tailed buffer (``poisoned``)."""
    out = quant.QuantizedTensor(poisoned(torch, t.q),
                                poisoned(torch, t.scale), t.mode,
                                t.group_size)
    if getattr(t, "qd", None) is not None:
        out.qd = poisoned(torch, quant.repack_int4_decode(out.q))
    return out


def fused_matmul(quant, t, x, out, kern):
    """Kernel E or F (or its plain version) through the wrapper every tree
    has (E's fragment mode reads ``t.qd`` where the tree has it)."""
    if t.mode == "int4":
        return quant.int4_matmul(x, t.q, t.scale, 128, out, kernels=kern,
                                 **layout_of(t))
    return quant.int8_matmul(x, t.q, t.scale, out, kernels=kern)


def cycling(ts, fn):
    """A thunk that calls ``fn`` on the next of ``ts`` each time."""
    it = [0]

    def run():
        it[0] += 1
        return fn(ts[it[0] % len(ts)])
    return run


def e_decode_rows() -> dict:
    """E's rows at m <= 16 beyond QUANT_ROWS, {label: (m, (k, n,
    halves))}: the decode steps of the families (4u: llama3.1-8b and
    qwen2-7b at m 8, mistral-7b at m 4), llama2-13b (4v, m 8), the tp = 2
    ranks of llama2-7b (4n) and of the families (4w d), and tinyllama-1.1b
    with its tp = 2 rank (4l, 4q, the draft's m 8); shapes listed once."""
    from llm_inference_engine_tpu_torch.config import get_config
    out, seen = {}, {(m, QUANT_SHAPES[label]) for m, label in QUANT_ROWS}
    for model, m in (("llama3.1-8b", 8), ("qwen2-7b", 8), ("mistral-7b", 4),
                     ("llama2-13b", 8), ("tinyllama-1.1b", 8)):
        cfg = get_config(model)
        H, I = cfg.hidden_size, cfg.intermediate_size
        for tp in (1, 2):
            if tp == 2 and model == "llama2-13b":
                continue
            for label, shape in (
                    ("wqkv", (H, cfg.qkv_size // tp, 1)),
                    ("wo", (cfg.q_size // tp, H, 1)),
                    ("gate|up", (H, I // tp, 2)),
                    ("down", (I // tp, H, 1)),
                    ("lm_head", (H, cfg.vocab_size // tp, 1))):
                if (m, shape) not in seen:
                    seen.add((m, shape))
                    out[f"{model}{' tp2' if tp == 2 else ''} {label}"] = (
                        m, shape)
    for label, shape in TP2_SHAPES.items():
        if (8, shape) not in seen:
            seen.add((8, shape))
            out[f"llama2-7b tp2 {label}"] = (8, shape)
    return out


def quant_rows(torch, dev) -> dict:
    """Kernel ms of E and F at QUANT_ROWS, then of E at e_decode_rows()
    (weights cycled as in 3b), no checks: ``tools/chip_kernel_ab.py``
    times another tree's kernels through this function, so it calls only
    the wrappers every tree has."""
    from llm_inference_engine_tpu_torch.ops import quant
    gen = torch.Generator(device=dev).manual_seed(4321)
    out = {}

    def row(name, mode, m, label, k, n, halves):
        dt = torch.float32 if label.endswith("lm_head") else torch.bfloat16
        ts = quant_weights(torch, quant, dev, gen, mode, k, n, halves,
                           120_000_000)
        x = torch.randn(m, k, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        out[f"{name} m{m} {label}"] = time_ms(torch, cycling(
            ts, lambda t: fused_matmul(quant, t, x, dt, "cuda")))
        del ts
    for mode, name in (("int4", "int4_matmul"), ("int8", "int8_matmul")):
        for m, label in QUANT_ROWS:
            row(name, mode, m, label, *QUANT_SHAPES[label])
        torch.cuda.empty_cache()
    for label, (m, shape) in e_decode_rows().items():
        row("int4_matmul", "int4", m, label, *shape)
        torch.cuda.empty_cache()
    return out


def float_attention_rows(torch, dev) -> dict:
    """Kernel ms (cold L2) of the float attention instances at 3f's shapes,
    in float16 and float32, no checks: the prefill over the slot cache (B4
    T512, C_CHUNK) and through the table (3c's B16 T64 mixed step, pages
    of 64), the fused slot decode (B4, 4a's contexts) and the attend-only
    paged decode (B16, DECODE_WRITE_STARTS, pages of 64); and a decode
    step's K/V work over an int8 pool at that shape, in float16,
    float32 and bf16, by the route the tree's engine takes: the fused
    int8 paged decode where the tree has it
    (``attention_decode_paged_fused_int8``), else kernel H's int8 mode
    (If for float rows) then the attend-only int8 decode.
    ``tools/chip_kernel_ab.py --rows float`` times another tree's kernels
    through this function, so it calls only the wrappers every tree has
    (the fused paged float decode is new: 3f times it)."""
    from llm_inference_engine_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(2020)
    H, K, D, S = FLOAT_WIDTHS
    out = {}

    def ints(vals):
        return torch.tensor(vals, device=dev, dtype=torch.int32)
    for tag, name in FLOAT_DTYPE.items():
        dtype = getattr(torch, name)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        slot, _ = float_caches(torch, dev, gen, dtype, 1, 4, S, K, D)
        T, st, nl = C_CHUNK
        starts = ints(st)
        kv_len = starts + ints(nl)
        q = randn(4, T, H, D)
        out[f"prefill {tag} B4 T512"] = time_ms(
            torch, lambda: attention.attention(q, slot.k, slot.v, starts,
                                               kv_len, layer=0,
                                               kernels="cuda"), cold=True)
        qs = ints([7, 129, 384, 700])
        q1, k1, v1 = randn(4, 1, H, D), randn(4, 1, K, D), randn(4, 1, K, D)
        out[f"decode {tag} slot B4"] = time_ms(
            torch, lambda: attention.attention_decode_fused(
                q1, k1, v1, slot.k, slot.v, qs, qs + 1, 0,
                kernels="cuda"), cold=True)
        del slot
        pool, _ = float_caches(torch, dev, gen, dtype, 1, 16, S, K, D,
                               page=64)
        ms, mkv = ints(MIXED_START), ints(MIXED_START) + ints(MIXED_LEN)
        qm = randn(16, 64, H, D)
        out[f"prefill {tag} paged B16 T64"] = time_ms(
            torch, lambda: attention.attention(
                qm, pool.k, pool.v, ms, mkv, layer=0, table=pool.block_table,
                kernels="cuda"), cold=True)
        dq = ints(DECODE_WRITE_STARTS)
        q16 = randn(16, 1, H, D)
        out[f"decode {tag} paged attend-only B16"] = time_ms(
            torch, lambda: attention.attention_decode(
                q16, pool.k, pool.v, dq, dq + 1, 0, table=pool.block_table,
                kernels="cuda"), cold=True)
        del pool
        torch.cuda.empty_cache()
    for tag, name in (*FLOAT_DTYPE.items(), ("bf16", "bfloat16")):
        dtype = getattr(torch, name)
        _, pool8 = float_caches(torch, dev, gen, dtype, 1, 16, S, K, D,
                                page=64)
        dq = ints(DECODE_WRITE_STARTS)
        q16, kn, vn = (torch.randn(16, 1, n, D, generator=gen, device=dev,
                                   dtype=dtype) for n in (H, K, K))
        out[f"int8 pool decode step {tag} B16"] = time_ms(
            torch, lambda: int8_pool_decode_step(
                attention, pool8, q16, kn, vn, dq), cold=True)
        del pool8
        torch.cuda.empty_cache()
    return out


def int8_pool_decode_step(attention, pool, q, kn, vn, q_start):
    """A decode step's K/V work at one layer of an int8 pool, by the route
    the tree's engine takes: the fused decode (one launch) where the tree
    has it, else kernel H's int8 mode (If for float rows) and the
    attend-only int8 decode (two)."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    kv_len = q_start + 1
    planes = dict(k_scale=pool.k_scale, v_scale=pool.v_scale)
    if hasattr(attention, "attention_decode_paged_fused_int8"):
        return attention.attention_decode_paged_fused(
            q, kn, vn, pool.k, pool.v, q_start, kv_len, 0,
            table=pool.block_table, kernels="cuda", **planes)[0]
    pkv.paged_update_at_layer(pool, 0, kn, vn, q_start,
                              kv_len - q_start, kernels="cuda")
    return attention.attention_decode(q, pool.k, pool.v, q_start, kv_len, 0,
                                      table=pool.block_table, kernels="cuda",
                                      **planes)


def float_matmul_rows(torch, dev) -> dict:
    """Kernel ms of the float instances of E and F (Ef, Ff) at m 8 and 512
    on wqkv and down, in float16 and float32, weights cycled past the L2
    as in 3f, no checks; ``tools/chip_kernel_ab.py --rows float`` times
    another tree's through this function (the wrappers every tree has)."""
    from llm_inference_engine_tpu_torch.ops import quant
    gen = torch.Generator(device=dev).manual_seed(2121)
    out = {}
    for tag, name in FLOAT_DTYPE.items():
        dtype = getattr(torch, name)
        for mode in ("int4", "int8"):
            for m, label in ((8, "wqkv"), (8, "down"), (512, "wqkv"),
                             (512, "down")):
                k, n, halves = QUANT_SHAPES[label]
                ts = quant_weights(torch, quant, dev, gen, mode, k, n, halves,
                                   120_000_000)
                x = torch.randn(m, k, generator=gen, device=dev, dtype=dtype)
                out[f"{mode}_matmul_float {tag} m{m} {label}"] = time_ms(
                    torch, cycling(ts, lambda t: fused_matmul(
                        quant, t, x, dtype, "cuda")))
                del ts
        torch.cuda.empty_cache()
    return out


def quant_case(torch, dev, gen, results, mode, m, label,
               shapes=QUANT_SHAPES, tag="", poison=False):
    """Kernel E (``mode`` int4) or F (int8) for x [m, k] times the
    ``label`` weight of ``shapes`` (k, n, halves; an f32 output for the
    lm_head), random weights cycled through 120 MB: held against its plain
    version and timed beside it, with its bound, its library call (one
    weight with a bf16 output: ``_weight_int4pack_mm`` /
    ``_weight_int8pack_mm``) and its plan; with ``poison``, x and the
    first weight's q and scale lie at the head of buffers whose tails are
    NaN (``poisoned``). Returns (kernel ms, the weights, x, the output
    dtype); the library's plan must equal its mirror
    (``quant_matmul_plan``). A decode plan whose cluster ranks take K
    ranges of unequal length (``cluster_k_ranges``) prints them too."""
    from llm_inference_engine_tpu_torch.ops import quant
    bf16 = torch.bfloat16
    name = f"{mode}_matmul"
    k, n, halves = shapes[label]
    out = torch.float32 if label == "lm_head" else bf16
    ts = quant_weights(torch, quant, dev, gen, mode, k, n, halves,
                       120_000_000)
    x = torch.randn(m, k, generator=gen, device=dev, dtype=bf16)
    if poison:
        x = poisoned(torch, x)
        ts[0] = poisoned_weight(torch, quant, ts[0])
    ms = time_ms(torch, cycling(ts, lambda t: fused_matmul(quant, t, x, out,
                                                           "cuda")))
    plain_ms = time_ms(torch, cycling(ts, lambda t: fused_matmul(
        quant, t, x, out, "torch")), iters=3, warmup=1)
    gbs = ts[0].nbytes / ms / 1e6     # weight bytes read per second
    n_out = halves * n
    library = None
    if out == bf16 and (halves == 1 or mode == "int4"):
        # the gate|up stack: one _weight_int4pack_mm on the [k, 2I] weight
        library = (int4pack_ms(torch, quant, ts, x, out) if mode == "int4"
                   else int8pack_ms(torch, ts, x, out))
    check_close(torch, name, fused_matmul(quant, ts[0], x, out, "cuda"),
                fused_matmul(quant, ts[0], x, out, "torch"), results,
                f"{tag}m{m} {label} {gbs:.0f} GB/s", (ms, plain_ms),
                work=(ts[0].nbytes + x.numel() * 2
                      + m * n_out * out.itemsize, 2 * m * k * n_out),
                library=library)
    plan = quant.quant_matmul_plan_native(m, k, n, halves,
                                          int4=mode == "int4")
    ranges = ""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if plan["mode"] == "decode":
        rows = [hi - lo for lo, hi in quant.cluster_k_ranges(
            m, k, n, halves, int4=mode == "int4", sms=sms)]
        if len(set(rows)) > 1:
            ranges = f"; uneven K rows a cluster rank {rows}"
    elif plan["mode"] == "fragment":
        rows = sorted({hi - lo for lo, hi in quant.fragment_k_slices(
            m, k, n, halves, sms=sms)})
        ranges = f"; K rows a warp {rows}"
    say(f"    plan: {plan}{ranges}")
    mirror = quant.quant_matmul_plan(
        m, k, n, halves, int4=mode == "int4",
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    if {key: v for key, v in plan.items() if key != "blocks_per_sm"} \
            != mirror:
        raise AssertionError(f"{name} {tag}m{m} {label}: the library's plan "
                             f"{plan} is not its mirror's {mirror}")
    return ms, ts, x, out


def phase_quant_kernels(torch, dev, results) -> None:
    """E and F at QUANT_ROWS, each timed with its plain version, its bound
    and its library call (F: ``_weight_int8pack_mm``; E:
    ``_weight_int4pack_mm``), the decode rows with their plan, the m = 512
    rows with G + cuBLAS (``_large_m_linear``, the m >= 1024 route) beside
    them; then ragged m (5, 300, 1023; 1023 timed with G + cuBLAS too) on
    the gate|up stack and the down projection, and G at two weight
    shapes."""
    from llm_inference_engine_tpu_torch.ops import quant

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4321)

    def qweight(mode, k, n, halves=1):
        return quant_weights(torch, quant, dev, gen, mode, k, n, halves)[0]

    def fused(t, x, out, kern):
        return fused_matmul(quant, t, x, out, kern)

    def cutover(ts, x, out):
        ms = time_ms(torch, cycling(ts, lambda t: quant._large_m_linear(
            x, t, out, "auto")), iters=5)
        say(f"    G + cuBLAS (_large_m_linear, the m >= 1024 route) on the "
            f"same weights: {ms:.4f} ms")

    for mode, name in (("int4", "int4_matmul"), ("int8", "int8_matmul")):
        layer, summed = {}, {}
        for m, label in QUANT_ROWS:
            ms, ts, x, out = quant_case(torch, dev, gen, results, mode, m,
                                        label)
            if label != "lm_head":
                layer[m] = layer.get(m, 0.0) + ms
                summed.setdefault(m, []).append(label)
            if m >= 512:
                cutover(ts, x, out)
            del ts
        for m, ms in layer.items():
            say(f"  {name} at m={m}, {' + '.join(summed[m])}: kernel "
                f"{ms:.4f} ms")
        # ragged m, the structured stack and the down projection's K
        for m in (5, 300, 1023):
            for label in ("gate|up", "down"):
                k, n, halves = QUANT_SHAPES[label]
                t = qweight(mode, k, n, halves)
                x = torch.randn(m, k, generator=gen, device=dev, dtype=bf16)
                timed = None
                if m == 1023 and halves == 1:
                    timed = (time_ms(torch, lambda: fused(t, x, bf16, "cuda"),
                                     iters=5),
                             time_ms(torch, lambda: fused(t, x, bf16, "torch"),
                                     iters=2, warmup=1))
                check_close(torch, name, fused(t, x, bf16, "cuda"),
                            fused(t, x, bf16, "torch"), results,
                            f"m{m} {label}", timed)
                if timed is not None:
                    cutover([t], x, bf16)
        torch.cuda.empty_cache()

    # INT8 at m 4096: G8's route, its parent's, F; G8 alone
    large_m_int8_rows(torch, dev, gen, results)

    # G: bit-identical to its plain version
    for k, n in ((4096, 12288), (11008, 4096)):
        ts = quant_weights(torch, quant, dev, gen, "int4", k, n,
                           min_bytes=120_000_000)
        got = quant.dequant_int4(ts[0].q, ts[0].scale, 128, kernels="cuda")
        want = quant.dequant_int4(ts[0].q, ts[0].scale, 128, kernels="torch")
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"dequant_int4 [{k},{n}]: not bit-identical "
                                 "to the plain dequant")
        check_close(torch, "dequant_int4", got, want, results,
                    f"[{k // 2},{n}] -> bf16 [{k},{n}] (torch.equal)", work=(
                        ts[0].nbytes + k * n * 2, 2 * k * n), timed=(
                        time_ms(torch, cycling(ts, lambda t: quant.dequant_int4(
                            t.q, t.scale, 128, kernels="cuda"))),
                        time_ms(torch, cycling(ts, lambda t: quant.dequant_int4(
                            t.q, t.scale, 128, kernels="torch")), iters=3,
                            warmup=1)))
        del ts, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# 3b's INT8 rows at m = 4096 (4c's first prefill chunk, 8 x 512): the
# routes timed in turns on each projection
LARGE_M = 8 * 512


def large_m_int8_rows(torch, dev, gen, results) -> dict:
    """INT8 weights at m = LARGE_M on the four projections of QUANT_SHAPES
    (weights cycled through 120 MB): the route ``_large_m_linear`` takes
    (G8, cuBLAS with an f32 result, the scale, the cast), its parent's
    (the same with ``.to(bfloat16)`` and ``_cat`` in place of G8: the
    plain version on the card) and kernel F's wgmma prefill mode at the
    same m, timed in turns (parent, G8, F, F, G8, parent); G8's route
    bit for bit the parent's, F's within KERNEL_TOL of it; then G8 alone
    bit for bit its plain version (cast + ``_cat``), q at the head of a
    buffer whose tail holds 127, and G8's epilogue alone (the f32 product
    times the scale, rounded to bf16) bit for bit ``(y * post).to``, y and
    the scale with NaN past their tails, each timed with its bound.
    Returns {row: ms}."""
    from llm_inference_engine_tpu_torch.ops import quant
    bf16 = torch.bfloat16
    out = {}
    for label in ("wqkv", "wo", "gate|up", "down"):
        k, n, halves = QUANT_SHAPES[label]
        ts = quant_weights(torch, quant, dev, gen, "int8", k, n, halves,
                           120_000_000)
        x = torch.randn(LARGE_M, k, generator=gen, device=dev, dtype=bf16)
        routes = {
            "parent cast + cuBLAS": lambda t: quant._large_m_linear(
                x, t, bf16, "torch"),
            "G8 + cuBLAS": lambda t: quant._large_m_linear(x, t, bf16,
                                                           "auto"),
            "F (wgmma)": lambda t: quant.int8_matmul(x, t.q, t.scale, bf16,
                                                     kernels="cuda")}
        ref = routes["parent cast + cuBLAS"](ts[0])
        if not torch.equal(routes["G8 + cuBLAS"](ts[0]), ref):
            raise AssertionError(f"G8 + cuBLAS m{LARGE_M} {label}: not bit "
                                 "for bit the cast + _cat route")
        f_out = routes["F (wgmma)"](ts[0])
        if not torch.allclose(f_out.float(), ref.float(), **KERNEL_TOL):
            raise AssertionError(f"F m{LARGE_M} {label}: disagrees with the "
                                 "cast + cuBLAS route")
        ms = {r: [] for r in routes}
        for r in ("parent cast + cuBLAS", "G8 + cuBLAS", "F (wgmma)",
                  "F (wgmma)", "G8 + cuBLAS", "parent cast + cuBLAS"):
            ms[r].append(time_ms(torch, cycling(ts, routes[r]), iters=5))
        n_out = halves * n
        b, by = bound_ms((ts[0].nbytes + x.numel() * 2 + LARGE_M * n_out * 2,
                          2 * LARGE_M * k * n_out))
        say(f"  int8 m{LARGE_M} {label} [{k},{n_out}]: " + "; ".join(
            f"{r} {sum(v) / 2:.4f} ms ({v[0]:.4f}, {v[1]:.4f})"
            for r, v in ms.items())
            + f"; bound {b:.4f} ms ({by}); F vs cast + cuBLAS max abs "
            f"{(f_out.float() - ref.float()).abs().max().item():.3e}")
        for r, v in ms.items():
            out[f"int8 m{LARGE_M} {label} {r}"] = sum(v) / 2
        g8, ep, lib_ms = g8_cases(torch, dev, gen, results, ts, label, k,
                                  n_out, LARGE_M)
        out[f"dequant_int8 {label}"] = g8
        out[f"int8_scale_cast {label}"] = ep
        out[f"torch.mul out=bf16 {label}"] = lib_ms
        del ts, x, ref, f_out
        torch.cuda.empty_cache()
    return out


def g8_cases(torch, dev, gen, results, ts, label, k, n_out, m, tag=""):
    """G8 alone on the INT8 weights ``ts`` (cycled; the first with q at
    the head of a buffer whose tail holds 127), bit for bit its plain
    version (cast + ``_cat``) and the library call (``library_int8_cast``),
    then G8's epilogue alone on an f32 product [m, n_out] (the product
    times the scale, rounded to bf16) bit for bit ``(y * post).to`` and
    ``torch.mul(y, post, out=<bf16>)``, y and the scale with NaN past
    their tails, timed in turns against that call; each with its bound.
    Returns (G8 ms, epilogue ms, torch.mul ms)."""
    from llm_inference_engine_tpu_torch.ops import quant
    bf16 = torch.bfloat16
    ts[0] = quant.QuantizedTensor(poisoned(torch, ts[0].q), ts[0].scale,
                                  "int8", 128)
    got = quant.dequant_int8(ts[0].q, kernels="cuda")
    want = quant.dequant_int8_torch(ts[0].q)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"dequant_int8 {tag}{label}: not bit for bit "
                             ".to(bfloat16) + _cat")
    lib = library_int8_cast(torch, k, n_out)
    if not torch.equal(lib(ts[0]), want):
        raise AssertionError(f"dequant_int8 {tag}{label}: the library call "
                             "is not bit for bit .to(bfloat16) + _cat")
    g8 = time_ms(torch, cycling(ts, lambda t: quant.dequant_int8(
        t.q, kernels="cuda")))
    record("dequant_int8", 0.0, results,
           f"{tag}{label} int8 [{k},{n_out}] -> bf16 (torch.equal), 127 "
           "past the tail", (g8, time_ms(torch, cycling(
               ts, lambda t: quant.dequant_int8_torch(t.q)), iters=3,
               warmup=1)),
           work=(k * n_out * 3, 0),
           library=time_ms(torch, cycling(ts, lib)))
    # G8's epilogue alone
    y = poisoned(torch, torch.randn(m, n_out, generator=gen, device=dev))
    post = poisoned(torch, quant._cat([
        sh.reshape(1, -1) for _, sh in quant._halves(ts[0].q,
                                                     ts[0].scale)]))
    got = quant.int8_scale_cast(y, post, bf16, kernels="cuda")
    want = quant.int8_scale_cast_torch(y, post, bf16)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"int8_scale_cast {tag}{label}: not bit for "
                             "bit (y * post).to(bfloat16)")

    def mul():   # one torch call, the product rounded on the store
        return torch.mul(y, post, out=torch.empty(y.shape, dtype=bf16,
                                                  device=dev))
    if not torch.equal(mul(), want):
        raise AssertionError(f"torch.mul(out=bf16) {tag}{label}: not bit "
                             "for bit (y * post).to(bfloat16)")
    turns = {"kernel": [], "mul": []}
    for r in ("kernel", "mul", "mul", "kernel"):
        turns[r].append(time_ms(torch, mul if r == "mul" else (
            lambda: quant.int8_scale_cast(y, post, bf16, kernels="cuda"))))
    ep, lib_ms = (sum(turns["kernel"]) / 2, sum(turns["mul"]) / 2)
    say(f"  int8_scale_cast {tag}{label} in turns: kernel "
        f"{turns['kernel'][0]:.4f}, {turns['kernel'][1]:.4f} ms; "
        f"torch.mul(out=bf16) {turns['mul'][0]:.4f}, "
        f"{turns['mul'][1]:.4f} ms")
    record("int8_scale_cast", 0.0, results,
           f"{tag}{label} f32 [{m},{n_out}] x scale -> bf16 (torch.equal), "
           "NaN past the tails",
           (ep, time_ms(torch, lambda: quant.int8_scale_cast_torch(
               y, post, bf16))),
           work=(m * n_out * 6 + n_out * 4, m * n_out),
           library=lib_ms)
    return g8, ep, lib_ms


def library_int8_cast(torch, k, n_out):
    """One PyTorch call that computes G8's function on a QuantizedTensor:
    ``.to(bfloat16)`` of a 2-D weight, ``torch.cat(..., out=)`` into a
    bf16 [k, 2I] buffer for the gate|up stack (the library yardstick; the
    port never calls it)."""
    def lib(t):
        if t.q.dim() == 2:
            return t.q.to(torch.bfloat16)
        return torch.cat([t.q[0], t.q[1]], dim=-1, out=torch.empty(
            (k, n_out), dtype=torch.bfloat16, device=t.q.device))
    return lib


def int8pack_ms(torch, ts, x, out_dtype):
    """Time of torch._weight_int8pack_mm (per-output-channel scales, as
    kernel F's) over the same weights laid out [n, k] beforehand, cycled
    as the kernel's: F's library yardstick (the port never calls it)."""
    packed = [(t.q.t().contiguous(), t.scale.reshape(-1).to(x.dtype))
              for t in ts]
    it = [0]

    def run():
        it[0] += 1
        w, sc = packed[it[0] % len(packed)]
        return torch._weight_int8pack_mm(x, w, sc).to(out_dtype)
    return time_ms(torch, run)


def int4pack_ms(torch, quant, ts, x, out_dtype):
    """Time of torch._weight_int4pack_mm (tinygemm: group-128 bf16 scales
    and zero points, its own packing) over the same weights converted
    beforehand with torch._convert_weight_to_int4pack (unsigned nibble =
    value + 8, zero point 0), cycled as the kernel's: E's library
    yardstick (the port never calls it); the gate|up stack as one
    [k/2, 2I] weight, whose output is E's flat [gate | up]. Its distance
    to kernel E's output is printed (its scales are bf16, E's f32). None,
    with the reason printed, where this torch refuses it."""
    try:
        packed = []
        for t in ts:
            q, scale = t.q, t.scale
            if q.dim() == 3:    # the gate|up stack: one [k/2, 2I] weight
                q, scale = torch.cat([q[0], q[1]], -1), torch.cat(
                    [scale[0], scale[1]], -1)
            u = (quant._unpack_int4(q).to(torch.int32) + 8).t()  # [n, k]
            w = ((u[:, 0::2] << 4) | u[:, 1::2]).to(torch.uint8)
            sz = torch.stack([scale.to(x.dtype),
                              torch.zeros_like(scale, dtype=x.dtype)],
                             dim=-1).contiguous()                 # [k/g, n, 2]
            packed.append((torch._convert_weight_to_int4pack(
                w.contiguous(), 8), sz))
        got = torch._weight_int4pack_mm(x, packed[0][0], 128, packed[0][1])
        want = fused_matmul(quant, ts[0], x, x.dtype, "cuda")
        say(f"    _weight_int4pack_mm vs kernel E: max abs "
            f"{(got.float() - want.float()).abs().max().item():.3e} "
            f"(output max {want.float().abs().max().item():.3e})")
    except (RuntimeError, NotImplementedError) as e:
        say(f"    _weight_int4pack_mm refused: {str(e).splitlines()[0]}")
        return None
    it = [0]

    def run():
        it[0] += 1
        w, sz = packed[it[0] % len(packed)]
        return torch._weight_int4pack_mm(x, w, 128, sz).to(out_dtype)
    return time_ms(torch, run)


class Profile(NamedTuple):
    """What ``device_profile`` read: ms per rep."""
    busy: float        # the union of the card's activity intervals
    per_kernel: list   # [(ms, kernel name)], summed durations, by time
    summed: float      # the sum of the activities' durations
    overlaps: float    # activities that start before an earlier one ends
    activities: float  # activities


def device_profile(torch, fn, reps: int, cpu_ops: bool = False):
    """``reps`` calls of ``fn`` under torch.profiler (a ``Profile``; with
    ``cpu_ops``, also the profiler, which then records the CPU ops). The
    card's busy time is the union of its activities' intervals (kernels,
    copies, fills): once kernels are launched as programmatic dependents,
    a kernel's duration includes the time its blocks sit resident in
    ``griddepcontrol.wait``, and the sum of durations counts that time
    twice."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if cpu_ops else [])
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = profile_of(prof, reps)
    return (out, prof) if cpu_ops else out


def profile_of(prof, reps: int):
    """The ``Profile`` of a finished torch.profiler run over ``reps``
    repetitions: the card's activities only (a trace that also recorded
    CPU ops, as ``utils.profiling.trace`` does, counts each kernel once)."""
    from torch.autograd import DeviceType

    def activity(e):
        # a ``glue_labels`` range also shows on the card's timeline (a
        # user annotation): it is no activity
        return (e.device_type == DeviceType.CUDA
                and not e.key.startswith("glue:"))
    per_kernel = sorted(((e.self_device_time_total / 1e3 / reps, e.key)
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0 and activity(e)),
                        reverse=True)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if activity(e))
    union, overlaps, reach = 0.0, 0, float("-inf")
    for start, end in spans:
        if start < reach:
            overlaps += 1
        union += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return Profile(union / 1e3 / reps, per_kernel,
                   sum(ms for ms, _ in per_kernel), overlaps / reps,
                   len(spans) / reps)


def _short(kernel_name: str) -> str:
    """A profiler kernel name without its namespace and argument list, its
    template arguments kept (kernel D's modes differ only there)."""
    name = kernel_name.replace("void ", "").replace(
        "(anonymous namespace)::", "")
    return name.split("(")[0][:60]


# device time by group of kernels (profiler names, first match wins): the
# float16 / float32 instances of D2 and D (D2f/Df: the same templates over
# __half or float, and the f32 prefill kernel) and of E and F (Ef/Ff: E/F's
# template over __half, and the f32 kernels), kernel D2 (the prefill
# modes), kernel D (the decode modes), E/F, G, G8, cuBLAS, the K/V row
# writes C, H, I (kv_write_kernel: C and H; kv_write_quant_kernel: I and
# H's int8 mode), kernels A, B and J
KERNEL_GROUPS = (("D2f/Df", ("attention_prefill_kernel<__half",
                             "attention_prefill_f32_kernel",
                             "attention_decode_kernel<__half",
                             "attention_decode_kernel<float")),
                 ("Ef/Ff", ("quant_matmul_decode<__half",
                            "quant_matmul_prefill<__half",
                            "quant_matmul_fragment<__half",
                            "quant_matmul_decode_f32",
                            "quant_matmul_prefill_f32")),
                 ("D2", ("attention_prefill_kernel",)),
                 ("D", ("attention_decode_kernel",)),
                 ("E/F", ("quant_matmul_decode", "quant_matmul_prefill",
                          "quant_matmul_fragment")),
                 ("G", ("dequant_int4_kernel",)),
                 ("G8", ("dequant_int8_kernel", "int8_scale_cast_kernel")),
                 ("cuBLAS", ("nvjet", "gemm", "cutlass", "xmma")),
                 ("writes", ("kv_write",)),
                 ("A", ("rmsnorm_kernel",)),
                 ("B", ("silu_mul_kernel",)),
                 ("J", ("split_qkv_rope_kernel",)))
# the torch glue of a decode step (the kernels outside KERNEL_GROUPS), by
# where the eager body launched them: RoPE (ops/rope.py's rope_cos_sin,
# once a forward; a tree whose decoder still calls rotate and split_qkv,
# its rotations too), sampling (ops/sampling.py's functions the engine
# calls), the cross-rank sums of a mesh engine (parallel/sharding.py's
# rank_sum), the
# context-parallel attention math (parallel/context_parallel.py's stats,
# merges and combine; its f32 matmuls are cuBLAS kernels, which
# ``label_ms`` counts), casts (aten::to / copy_ elsewhere), other
GLUE = ("RoPE", "casts", "sampling", "sums", "CP", "other")


@contextlib.contextmanager
def glue_labels():
    """Run the RoPE and sampling functions that the decoder and the engine
    call, a mesh engine's cross-rank sums and the context-parallel
    attention math, under ``record_function("glue:RoPE")`` /
    ``("glue:sampling")`` / ``("glue:sums")`` / ``("glue:CP")``, so that
    a profile names the ops they launch
    (instrumentation of this check only; the functions are put back
    after)."""
    import torch
    from llm_inference_engine_tpu_torch.models import llama
    from llm_inference_engine_tpu_torch.parallel import (
        context_parallel, sharding)
    from llm_inference_engine_tpu_torch.runtime import engine
    patches = [(llama, n, "RoPE") for n in ("rope_cos_sin", "rotate",
                                             "split_qkv")
               if hasattr(llama, n)] + [
        (engine, n, "sampling") for n in ("apply_penalties", "greedy_sample",
                                          "sample_tokens", "token_logprobs")
    ] + [(sharding, "rank_sum", "sums")] + [
        (context_parallel, n, "CP") for n in ("chunk_attention_stats",
                                              "merge_stats", "combine_stats",
                                              "_finalize")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]

    def labelled(fn, group):
        def run(*args, **kwargs):
            with torch.profiler.record_function(f"glue:{group}"):
                return fn(*args, **kwargs)
        return run
    for (m, n, group), (_, _, fn) in zip(patches, saved):
        setattr(m, n, labelled(fn, group))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _group_of(name: str) -> str:
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in keys)), "rest")


def group_ms(per_kernel, glue=None) -> dict:
    """``per_kernel`` ([(ms, name)]) summed by KERNEL_GROUPS, the rest
    apart; with ``glue`` (``glue_map``), the rest split into GLUE too."""
    sums = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + ["rest"], 0.0)
    if glue is not None:
        sums.update(dict.fromkeys(GLUE, 0.0))
    for ms, name in per_kernel:
        group = _group_of(name)
        sums[group] += ms
        if group == "rest" and glue is not None:
            for g, share in glue.get(name, {"other": 1.0}).items():
                sums[g] += ms * share
    return sums


def _groups(per_kernel, glue=None) -> str:
    """``group_ms`` as text, the split of the rest in brackets."""
    sums = group_ms(per_kernel, glue)
    text = ", ".join(f"{g} {sums[g]:.3f}"
                     for g in [g for g, _ in KERNEL_GROUPS] + ["rest"])
    if glue is not None:
        text += " (" + ", ".join(f"{g} {sums[g]:.3f}" for g in GLUE) + ")"
    return text


def glue_map(prof) -> dict:
    """{kernel name: {GLUE group: share of its time}} of the torch glue in
    a profile of CPU ops taken under ``glue_labels``: each kernel goes to
    the group of the CPU op that launched it, read from the labels around
    the op (its parents). A replayed step runs the same kernels as the
    eager body, so its glue is split by these shares."""
    from torch.autograd import DeviceType
    ms = {}

    def group(op):
        while op is not None:
            if op.name.startswith("glue:"):
                return op.name[5:]
            op = op.cpu_parent
        return None

    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        g = group(e)
        if g is None:
            names, op = [], e
            while op is not None:
                names.append(op.name)
                op = op.cpu_parent
            g = "casts" if any(n in ("aten::to", "aten::_to_copy",
                                     "aten::copy_") for n in names) \
                else "other"
        for k in e.kernels:
            if _group_of(k.name) == "rest":
                d = ms.setdefault(k.name, {})
                d[g] = d.get(g, 0.0) + k.duration
    return {name: {g: v / sum(d.values()) for g, v in d.items()}
            for name, d in ms.items() if sum(d.values()) > 0}


def label_ms(prof, per_kernel, label: str) -> float:
    """Device ms of ``per_kernel`` ([(ms, kernel name)]) launched under
    ``glue_labels``' ``glue:<label>``, by the profile of CPU ops ``prof``
    (the same run, or an eager run of the body a replay replays): each
    kernel name's time times the share of its time in ``prof`` that ops
    under the label launched, whatever its KERNEL_GROUPS group."""
    from torch.autograd import DeviceType
    under, total = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        op = e
        while op is not None and op.name != f"glue:{label}":
            op = op.cpu_parent
        for k in e.kernels:
            total[k.name] = total.get(k.name, 0.0) + k.duration
            if op is not None:
                under[k.name] = under.get(k.name, 0.0) + k.duration
    return sum(ms * under.get(name, 0.0) / total[name]
               for ms, name in per_kernel if total.get(name))


def _logit_diff(x, ref):
    d = (x - ref).abs().max().item()
    return d, ((x - ref).norm() / ref.norm()).item()


def _counters():
    from llm_inference_engine_tpu_torch.ops import activations, attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    from llm_inference_engine_tpu_torch.ops import quant, rmsnorm, rope
    return {
        "rmsnorm": rmsnorm.rmsnorm,
        "add_residual_rmsnorm": rmsnorm.add_residual_rmsnorm,
        "silu_and_mul": activations.silu_and_mul,
        "kv_write": kvc.update_cache_at_layer,
        "attention_prefill": attention.attention,
        "attention_decode": attention.attention_decode_fused,
        "int4_matmul": quant.int4_matmul,
        "int8_matmul": quant.int8_matmul,
        "dequant_int4": quant.dequant_int4,
        "paged_kv_write": pkv.paged_update_at_layer,
        "attention_prefill_paged": attention.attention_prefill_paged,
        "attention_decode_paged": attention.attention_decode,
        "attention_decode_paged_fused":
            attention.attention_decode_paged_fused,
        "kv_write_quant": kvc.kv_write_quant,
        "attention_prefill_int8": attention.attention_int8,
        "attention_decode_int8": attention.attention_decode_fused_int8,
        "paged_kv_write_int8": pkv.paged_kv_write_quant,
        "attention_prefill_paged_int8":
            attention.attention_prefill_paged_int8,
        "attention_decode_paged_int8": attention.attention_decode_int8,
        "attention_decode_paged_fused_int8":
            attention.attention_decode_paged_fused_int8,
        "split_qkv_rope": rope.split_qkv_rope_fused,
        "dequant_int8": quant.dequant_int8,
        "int8_scale_cast": quant.int8_scale_cast,
        **{name: getattr(attention, name, None)
           or getattr(kvc, name, None) or getattr(pkv, name, None)
           or getattr(quant, name) for name in FLOAT_INSTANCES},
    }


def kv_bytes(cache) -> int:
    """Bytes of a KV cache or pool: values, and an int8 cache's scale
    planes."""
    return sum(t.numel() * t.element_size() for t in (
        cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None)


def _launch_counts(counters) -> dict:
    return {k: f.launches for k, f in counters.items() if f.launches}


def check_norm_launches(label: str, counts: dict, layers: int,
                        forwards=None) -> None:
    """Each forward of ``layers`` layers launches kernel A once plain (the
    first norm), 2 x layers times with a residual (each layer's second
    norm, and each later first norm or the final norm adding the layer
    before's output), B once a layer and J (the QKV split with RoPE) once
    a layer; ``forwards``: how many forwards ``counts`` covers, where
    known."""
    f = counts.get("rmsnorm", 0)
    want = dict(rmsnorm=f, add_residual_rmsnorm=2 * layers * f,
                silu_and_mul=layers * f, split_qkv_rope=layers * f)
    got = {k: counts.get(k, 0) for k in want}
    if f == 0 or got != want or forwards not in (None, f):
        raise AssertionError(f"{label}: launches of A, B and J {got}, want "
                             f"{want} for {forwards or 'some'} forward(s)")


def snapshot(engine):
    """What a decode run changes besides K/V rows past the lengths: the
    lengths, both count planes, the generator, and a context-parallel
    engine's log row counts (device and host mirror; the kv_pos entries
    past them are rewritten before they are read, as the rows are).
    Restoring it replays the same run on the same state (the rows it
    rewrites are rewritten with the same values before they are read)."""
    snap = (engine._lengths.copy(), engine._counts_ctx.clone(),
            engine._counts_gen.clone(), engine._gen.get_state())
    if engine.cp > 1:
        snap += (engine._llen.copy(), engine.cache.llen.clone())
    return snap


def restore(engine, snap) -> None:
    lengths, ctx, gen, rng, *logs = snap
    engine._set_lengths(lengths)
    engine._counts_ctx.copy_(ctx)
    engine._counts_gen.copy_(gen)
    engine._gen.set_state(rng)
    if logs:
        engine._llen = logs[0].copy()
        engine.cache.llen.copy_(logs[1])


def sm_clock_mhz() -> int:
    """The card's SM clock now, as nvidia-smi reads it (MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return int(out.stdout.split()[0])


def _steps(torch, engine, toks, active, n: int, eager: bool):
    """``n`` greedy decode steps from ``toks``, through the engine's
    replays or its eager bodies: (ids [n][B], wall ms a step, the
    launches they added to the counters)."""
    from llm_inference_engine_tpu_torch.config import SamplingParams
    from llm_inference_engine_tpu_torch.runtime.decode_graph import (
        run_eagerly)
    sp = SamplingParams(greedy=True)
    counters = _counters()
    before = {k: f.launches for k, f in counters.items()}
    ids = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with run_eagerly(engine) if eager else contextlib.nullcontext():
        for _ in range(n):
            toks = engine.decode_step(toks, active, sp)
            ids.append(toks)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    added = {k: f.launches - before[k] for k, f in counters.items()}
    return [t.tolist() for t in ids], wall, {k: n for k, n in added.items()
                                             if n}


def graph_checks(torch, engine, tag: str, toks, active, prompts):
    """The decode programs as CUDA-graph replays against the same bodies
    run eagerly, from one state (``snapshot``): 16 steps (ids and launch
    counts identical, wall per step of each; card busy per step over 4
    steps, in turns eager, graphs, graphs, eager), a 16-step
    greedy ``decode_rollout`` (ids identical to the eager steps'), then
    ``generate``'s non-streaming tail from fresh slots, row 0 a prompt of
    max_seq_len - 24 tokens that reaches capacity mid-tail: greedy
    replayed equals eager (ids, logprobs, lengths, row 0 stopped at the
    same length); sampled (temperature 0.8, top-k 5) from one seed,
    replayed equals eager; with a stop id taken from a row's eager
    sampled token at step 5 (or the nearest step where the row draws a
    token new to it), that row stops there and every row equals the eager
    ids cut at its first stop id. Records the per-step numbers in
    DECODE and returns the replayed step's kernels."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import SamplingParams
    from llm_inference_engine_tpu_torch.runtime.decode_graph import (
        run_eagerly)
    B = engine.engine_config.max_batch_size
    S = engine.engine_config.max_seq_len
    snap = snapshot(engine)
    eager_ids, eager_ms, eager_launches = _steps(torch, engine, toks,
                                                 active, 16, True)
    restore(engine, snap)
    graph_ids, _, _ = _steps(torch, engine, toks, active, 16, False)
    restore(engine, snap)
    again, graph_ms, graph_launches = _steps(torch, engine, toks, active,
                                             16, False)
    # card busy a step, in turns (eager, graphs, graphs, eager), each
    # window followed by the SM clock nvidia-smi reads at its end
    busy = {"eager": [], "graphs": []}
    clocks = {"eager": [], "graphs": []}
    profs = {}
    state = {}

    def step():
        state["toks"] = engine.decode_step(state["toks"], active,
                                           SamplingParams(greedy=True))
    for mode in ("eager", "graphs", "graphs", "eager"):
        restore(engine, snap)
        state["toks"] = toks
        with (run_eagerly(engine) if mode == "eager"
              else contextlib.nullcontext()):
            profs[mode] = device_profile(torch, step, 4)
        busy[mode].append(profs[mode].busy)
        clocks[mode].append(sm_clock_mhz())
    # one more eager step with its CPU ops: which op launched each glue
    # kernel (RoPE, casts, sampling, other)
    restore(engine, snap)
    state["toks"] = toks
    with run_eagerly(engine), glue_labels():
        _, prof = device_profile(torch, step, 1, cpu_ops=True)
    glue = glue_map(prof)
    del prof
    restore(engine, snap)
    rolled = engine.decode_rollout(toks, 16).tolist()
    restore(engine, snap)
    failures = []
    if graph_ids != eager_ids or again != eager_ids:
        failures.append("replayed steps differ from the eager steps")
    if graph_launches != eager_launches:
        failures.append(f"launches of 16 replays {graph_launches} != of 16 "
                        f"eager steps {eager_launches}")
    if rolled != eager_ids:
        failures.append("decode_rollout differs from the eager steps")
    busy_e, busy_g = (sum(busy[m]) / 2 for m in ("eager", "graphs"))
    kernels_e, kernels_g = (profs[m].per_kernel for m in ("eager", "graphs"))
    say(f"  {tag} decode, eager / graphs: wall {eager_ms:.3f} / "
        f"{graph_ms:.3f} ms/step ({B * 1e3 / eager_ms:.1f} / "
        f"{B * 1e3 / graph_ms:.1f} tok/s at B={B}); card busy "
        f"{busy_e:.3f} / {busy_g:.3f} ms/step (graphs/eager "
        f"{busy_g / busy_e:.4f}); idle {1 - busy_e / eager_ms:.3f} / "
        f"{1 - busy_g / graph_ms:.3f}; wall over busy "
        f"{eager_ms / busy_e:.3f} / {graph_ms / busy_g:.3f}")
    say(f"  {tag} card busy in turns (eager, graphs, graphs, eager): "
        f"{busy['eager'][0]:.3f}, {busy['graphs'][0]:.3f}, "
        f"{busy['graphs'][1]:.3f}, {busy['eager'][1]:.3f} ms/step; SM clock "
        f"after each window {clocks['eager'][0]}, {clocks['graphs'][0]}, "
        f"{clocks['graphs'][1]}, {clocks['eager'][1]} MHz")
    for mode, key in (("eager", "eager"), ("replayed", "graphs")):
        pr = profs[key]
        say(f"  {tag} {mode} decode step, device ms by group (durations; "
            f"the rest split into {', '.join(GLUE)}): "
            f"{_groups(pr.per_kernel, glue)}; by kernel: "
            + "; ".join(f"{_short(name)} {ms:.4f}"
                        for ms, name in pr.per_kernel[:8]))
        say(f"  {tag} {mode} decode step: union of activity intervals "
            f"{pr.busy:.3f} ms, durations summed {pr.summed:.3f} ms; "
            f"{pr.overlaps:.0f} of {pr.activities:.0f} activities start "
            f"before an earlier one ends")
    say(f"  {tag} 16 replayed steps == 16 eager steps: "
        f"{graph_ids == eager_ids}; decode_rollout(16) == eager: "
        f"{rolled == eager_ids}; launches equal: "
        f"{graph_launches == eager_launches}")

    # generate's tail, from fresh slots
    rng = np.random.default_rng(2)
    cases = [rng.integers(3, engine.config.vocab_size, S - 24).tolist()] + [
        p[:40] for p in prompts[1:B]]
    greedy = SamplingParams(greedy=True, max_new_tokens=32)
    sampled = SamplingParams(temperature=0.8, top_k=5, max_new_tokens=32)

    def gen(sp, eager):
        engine.reset()
        engine._gen.manual_seed(7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if eager:
            with run_eagerly(engine):
                r = engine.generate(cases, sp, eos_token_id=None)
        else:
            r = engine.generate(cases, sp, eos_token_id=None)
        wall = time.perf_counter() - t0
        return r.token_ids, r.logprobs, engine.cache.lengths.tolist(), wall
    ref = gen(greedy, True)
    got = gen(greedy, False)
    if got[:3] != ref[:3]:
        failures.append("generate (greedy) replayed differs from eager")
    if not (len(ref[0][0]) < 32 and ref[2][0] == S
            and got[2][0] == ref[2][0]):
        failures.append(f"row 0 did not stop at capacity: "
                        f"{len(ref[0][0])} tokens, lengths eager "
                        f"{ref[2][0]} graphs {got[2][0]} (max_seq_len {S})")
    sam_ref = gen(sampled, True)
    sam = gen(sampled, False)
    if sam[:3] != sam_ref[:3]:
        failures.append("generate (sampled) replayed differs from eager")
    # stop id: a token a row draws at step k, nearest 5, that it has not
    # drawn before (k >= 1: the tail's, not the first token's), the one
    # the fewest other rows draw. Sampled, since greedy INT4 dummies
    # repeat one token a row; with the same seed each row draws as
    # without the stop id until it stops
    picks = sorted((abs(k - 5), sum(ids[k] in other for other in sam_ref[0]),
                    r, k) for r, ids in enumerate(sam_ref[0])
                   for k in range(1, len(ids)) if ids[k] not in ids[:k])
    if not picks:
        raise AssertionError(f"{tag}: every row repeats one token; no stop "
                             "id can stop a row mid-tail")
    _, _, row, k = picks[0]
    stop = sam_ref[0][row][k]
    cut = [ids[:ids.index(stop)] if stop in ids else ids
           for ids in sam_ref[0]]
    stopped = gen(dataclasses.replace(sampled, stop_token_ids=(stop,)),
                  False)
    ran_on = [r for r in range(B) if len(cut[r]) == len(sam_ref[0][r])]
    if stopped[0] != cut or len(stopped[0][row]) != k:
        failures.append(f"stop id {stop}: row {row} gave "
                        f"{len(stopped[0][row])} tokens, rows differ from "
                        f"the eager ids cut at the stop id")
    say(f"  {tag} generate tail, eager / graphs: greedy {ref[3]:.3f} / "
        f"{got[3]:.3f} s, equal {got[:3] == ref[:3]}; capacity row 0: "
        f"{len(got[0][0])} tokens, length {got[2][0]} (eager "
        f"{ref[2][0]}); sampled {sam_ref[3]:.3f} / {sam[3]:.3f} s, equal "
        f"{sam[:3] == sam_ref[:3]}, tokens[1][:6] {sam[0][1][:6]}; stop id "
        f"{stop} (row {row}'s sampled token {k}): row {row} "
        f"{len(stopped[0][row])} tokens, rows that ran on {ran_on}, all "
        f"rows as eager cut at the stop {stopped[0] == cut}")
    engine.reset()
    if failures:
        raise AssertionError(f"{tag} graphs: " + "; ".join(failures))
    DECODE[tag] = dict(B=B, eager_ms=eager_ms, graph_ms=graph_ms,
                       eager_busy_ms=busy["eager"],
                       graph_busy_ms=busy["graphs"],
                       graph_summed_ms=profs["graphs"].summed,
                       graph_overlaps=profs["graphs"].overlaps,
                       graph_groups_ms=group_ms(kernels_g, glue),
                       greedy_generate_s=[ref[3], got[3]])
    return kernels_g


def preset(model: str, name: str):
    """What ``create_engine`` builds for the path ``name`` of ``model``:
    the preset's name, or where ``name`` is in DEPTH_CUT_PATHS its config
    cut to the first DEPTH_CUT layers at full width."""
    from llm_inference_engine_tpu_torch.config import get_config
    if name in DEPTH_CUT_PATHS:
        return get_config(model).replace(num_layers=DEPTH_CUT)
    return model


def upcast_in_place(torch, params: dict) -> dict:
    """``params`` with every dense tensor replaced by its float32 copy,
    one at a time, so that each bf16 tensor is freed as its copy is made
    (Llama-2-13B: 26 GB of bf16 become 52 GB of f32 with no 78-GB peak);
    quantized weights stay as they are (their plain versions take f32).
    The caller holds no other reference to the bf16 tensors."""
    from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
    for tree in [params] + [v for v in params.values()
                            if isinstance(v, dict)]:
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                tree[k] = v.float()
                del v
                torch.cuda.empty_cache()
            elif not isinstance(v, (dict, QuantizedTensor)):
                raise TypeError(f"params[{k!r}]: {type(v).__name__}")
    return params


def layout_bytes(tree) -> tuple:
    """(bytes, weights) of the fragment-order copies (``qd``) the INT4
    weights of a params tree hold."""
    if isinstance(tree, dict):
        parts = [layout_bytes(v) for v in tree.values()]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)
    qd = getattr(tree, "qd", None)
    return (0, 0) if qd is None else (qd.numel(), 1)


def layout_line(engine) -> int:
    """Print the bytes of the engine's fragment-order copies (what kernel
    E reads at m <= 16; built when the engine was made) and the context
    they would hold as this model's KV cache; returns the bytes."""
    nbytes, n = layout_bytes(engine.params)
    if n:
        eng = engine.engine_config
        per_token = kv_bytes(engine.cache) // (eng.max_batch_size
                                               * eng.max_seq_len)
        say(f"  fragment order (E's m <= 16 copy of {n} INT4 weights): "
            f"{nbytes / 1e9:.3f} GB = {nbytes / 2**30:.3f} GiB, the KV cache "
            f"of {nbytes // per_token} tokens of this model's context "
            f"({per_token} bytes a token)")
    return nbytes


def phase_main_path(torch, dev, results, path: str, eng_cfg, prompt_lens,
                    follow_lens, greedy_tokens: int,
                    model: str = "llama2-7b", control=None,
                    plain_generate: bool = True):
    """One slot main path of ``model`` (a preset; seed-0 dummy weights made
    on the card; cut in depth where ``preset`` says so): ``path`` names its
    MAIN_PATHS row, the kernels that must launch and those that must not.
    ``control``: (what, config fields, rows): the same prompts' prefill
    with a feature of the model switched off (``cfg.replace(**fields)``;
    ``attention_bias=False`` also drops the bias tensor), whose last-row
    logits on ``rows`` (None: every row) must differ from the feature's by
    more than the kernel path's from the plain path's (max abs and
    relative L2), or the logit checks could not have seen the feature.
    ``plain_generate``: round 1 again through the plain versions, its
    greedy ids' agreement with the kernel path printed (4u's paths leave
    it out: a printed ratio that costs the plain route's prefill again,
    14300 tokens in Mistral's). On an int8 cache the INT8_FAULTS prefills
    run on MUST_SEE_FAULTS and where the prompts total at most
    FAULT_PROMPT_TOKENS (off MUST_SEE_FAULTS they are only printed, each
    one more plain prefill: 4v's Mistral path, 14300 tokens, has none).
    Prints the seconds of the kernel path's part, the plain route's, the
    control's and the f32 arbiter's. Returns the kernel path's prefill
    logits."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import SamplingParams, get_config
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.models.weights import (
        param_bytes, param_count)
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

    counters = _counters()
    expected, forbidden = MAIN_PATHS[path]
    B = eng_cfg.max_batch_size
    clock = [time.perf_counter()]

    def lap() -> float:
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]
    name = path if path.startswith(model) else f"{model} {path}"
    engine = create_engine(preset(model, name), None, eng_cfg, seed=0,
                           device=dev)
    cfg = engine.config
    V = cfg.vocab_size
    torch.cuda.synchronize()
    depth = get_config(model).num_layers
    if cfg.num_layers != depth:
        name += f" ({cfg.num_layers} of {depth} layers)"
    say(f"  engine: {name}, {param_count(engine.params) / 1e9:.3f} "
        f"G stored elements ({param_bytes(engine.params) / 1e9:.2f} GB), "
        f"B={B}, KV cache {kv_bytes(engine.cache) / 1e9:.2f} GB"
        + (f" (int8 values {2 * engine.cache.k.numel() / 1e9:.2f} GB + "
           f"scale planes {8 * engine.cache.k_scale.numel() / 1e9:.2f} GB, "
           f"{'snapped' if engine.cache.snapped else 'absmax'} scales; a "
           f"bf16 cache: {4 * engine.cache.k.numel() / 1e9:.2f} GB)"
           if engine.cache.quantized else ""))

    frag = layout_line(engine)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, V, n).tolist() for n in prompt_lens]
    follow = [rng.integers(3, V, n).tolist() for n in follow_lens]
    greedy = SamplingParams(greedy=True, max_new_tokens=greedy_tokens)
    sampled = SamplingParams(temperature=0.8, top_k=5, max_new_tokens=16)

    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    # prefill alone first: cold (first use of each shape), then warm; its
    # logits are held against the reference below
    walls = []
    for _ in range(2):
        engine.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = engine.prefill(prompts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if logits.shape != (B, V) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits bad: {tuple(logits.shape)}")
    # the two generate rounds on the same slots
    engine.reset()
    t0 = time.perf_counter()
    r1 = engine.generate(prompts, greedy, eos_token_id=None)
    gen1_s = time.perf_counter() - t0
    r2 = engine.generate(follow, sampled, eos_token_id=None)
    lengths = engine.cache.lengths.tolist()
    # steady decode from the rounds' last tokens, the eager bodies against
    # the replays (the card's busy time per step is the sum of its
    # kernels' durations; the rest of the wall time is the card waiting
    # for the host), then generate's tail cases
    active = np.ones(B, bool)
    toks = torch.tensor([o[-1] for o in r2.token_ids], device=dev,
                        dtype=torch.int32)
    graph_checks(torch, engine, path, toks, active, prompts)
    # the weights a decode step reads: all but the embedding table
    DECODE[path]["weight_bytes"] = (
        param_bytes(engine.params)
        - param_bytes({"embed": engine.params["embed"]}))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: f.launches for k, f in counters.items()}
    say(f"  launches during the {path} path: {launches}")
    missing = [n for n in expected if launches[n] <= 0]
    extra = [n for n in forbidden if launches[n]]
    if missing or extra:
        raise AssertionError(f"{path} path: kernels never launched "
                             f"{missing}; kernels that must not launch "
                             f"{extra}")
    for name in expected:
        if PATH_OF[name] == path:
            results.setdefault(name, {})["launches"] = launches[name]
    # one more warm prefill of the same prompts into fresh slots, profiled,
    # then one decode step: the launches of each
    engine.reset()
    _zero_counters()
    prefill = device_profile(torch, lambda: engine.prefill(prompts), 1)
    per_prefill = _launch_counts(counters)
    _zero_counters()
    engine.decode_step(toks, active, SamplingParams(greedy=True))
    per_step = _launch_counts(counters)
    say(f"  launches per prefill of the {B} prompts: {per_prefill}; per "
        f"decode step: {per_step}")
    check_norm_launches(f"{path} prefill", per_prefill, cfg.num_layers)
    check_norm_launches(f"{path} decode step", per_step, cfg.num_layers, 1)
    for rnd, res, n in (("round 1", r1, greedy_tokens), ("round 2", r2, 16)):
        if res.num_generated != [n] * B:
            raise AssertionError(f"{rnd}: tokens per row {res.num_generated}")
        if not all(np.isfinite(res.logprobs[i]).all() for i in range(B)):
            raise AssertionError(f"{rnd}: non-finite logprobs")
    say(f"  round 1 greedy  tokens[0][:8] {r1.token_ids[0][:8]}")
    say(f"  round 2 sampled tokens[0][:8] {r2.token_ids[0][:8]}")
    say(f"  slot lengths after both rounds: {lengths}")
    say(f"  prefill of {B} prompts ({sum(prompt_lens)} tokens): cold "
        f"{walls[0]:.4f} s, warm {walls[1]:.4f} s; round 1 generate "
        f"{gen1_s:.3f} s")
    say(f"  peak memory {peak / 2**30:.2f} GiB"
        + (f" ({(peak - frag) / 2**30:.2f} GiB without the fragment order)"
           if frag else ""))
    say(f"  warm prefill: card busy {prefill.busy:.3f} ms (kernel durations "
        f"summed {prefill.summed:.3f}); by group: "
        f"{_groups(prefill.per_kernel)}; by kernel: "
        + "; ".join(f"{_short(name)} {ms:.3f}"
                    for ms, name in prefill.per_kernel[:8]))

    # reference: round 1 again through the plain versions, same weights
    t_kernels = lap()
    ref = InferenceEngine(cfg, eng_cfg.replace(kernels="torch"),
                          engine.params, device=dev)
    logits_t = ref.prefill(prompts)
    r1_ref = None
    if plain_generate:
        ref.reset()
        r1_ref = ref.generate(prompts, greedy, eos_token_id=None)
    # int8 KV paths: the plain prefill again with a fault planted in its
    # int8 attention, for each of INT8_FAULTS (instrumentation of this
    # check only; the plain attention is restored after each)
    planted = {}
    if engine.cache.quantized and (path in MUST_SEE_FAULTS or sum(
            prompt_lens) <= FAULT_PROMPT_TOKENS):
        from llm_inference_engine_tpu_torch.ops import attention as attn_mod
        plain = attn_mod.attention_torch
        for fault, plant in INT8_FAULTS.items():
            def faulted(q, k, v, q_start, kv_len, *, k_scale=None,
                        v_scale=None, **kw):
                if k_scale is not None:
                    kv_len, k_scale, v_scale = plant(kv_len, k_scale,
                                                     v_scale)
                return plain(q, k, v, q_start, kv_len, k_scale=k_scale,
                             v_scale=v_scale, **kw)
            attn_mod.attention_torch = faulted
            try:
                ref.reset()
                planted[fault] = _logit_diff(logits, ref.prefill(prompts))
            finally:
                attn_mod.attention_torch = plain
    del ref
    torch.cuda.empty_cache()
    t_plain = lap()
    moved = None
    if control is not None:
        what, fields, rows = control
        params_off = engine.params
        if fields.get("attention_bias") is False:
            params_off = {**params_off, "layers": {
                k: v for k, v in params_off["layers"].items()
                if k != "bqkv"}}
        off = InferenceEngine(cfg.replace(**fields), eng_cfg, params_off,
                              device=dev)
        logits_off = off.prefill(prompts)
        del off, params_off
        torch.cuda.empty_cache()
        rows = list(range(B)) if rows is None else rows
        moved = (_logit_diff(logits_off[rows], logits[rows]),
                 _logit_diff(logits_t[rows], logits[rows]))
    t_control = lap()
    # arbiter: the plain path in f32 on the same (upcast) weights; the
    # kernel engine goes first, and its weights are upcast in place
    params = engine.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    params32 = upcast_in_place(torch, params)
    ref32 = InferenceEngine(cfg.replace(dtype_name="float32"),
                            eng_cfg.replace(kernels="torch"), params32,
                            device=dev)
    logits_32 = ref32.prefill(prompts)
    del ref32, params32, params
    torch.cuda.empty_cache()
    say(f"  seconds: kernel path {t_kernels:.1f}, plain route {t_plain:.1f}"
        f", control {t_control:.1f}, f32 arbiter {lap():.1f}")

    d_kt, r_kt = _logit_diff(logits, logits_t)
    d_k32, r_k32 = _logit_diff(logits, logits_32)
    d_t32, r_t32 = _logit_diff(logits_t, logits_32)
    say(f"  prefill logits (std {logits_t.std().item():.3f}): max abs / rel "
        f"L2 kernels vs torch-{path} {d_kt:.4e} / {r_kt:.4e}; kernels vs "
        f"torch-f32 {d_k32:.4e} / {r_k32:.4e}; torch-{path} vs torch-f32 "
        f"{d_t32:.4e} / {r_t32:.4e}")
    top2, top2_ids = logits_32.topk(2, dim=-1)
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    say(f"  f32 top-1 minus top-2 margin per row: "
        f"{[round(m, 4) for m in margins]}")
    first = {name: lg.argmax(-1).tolist() for name, lg in
             (("kernels", logits), ("torch", logits_t),
              ("torch-f32", logits_32))}
    # A row whose f32 top-1/top-2 margin is below the largest logit
    # difference between the kernel and plain paths is a tie at the
    # precision both paths carry; on a quantized path such a row may pick
    # either of f32's top two. The bf16 path keeps the strict check.
    # 4a (llama2-7b bf16) keeps the strict check. At the families'
    # vocabularies (128256 and 152064 columns) a random bf16 model's f32
    # top-two margins fall below the kernel-vs-plain noise (llama3.1-8b:
    # 0.0052 against 0.32 on an H100): their bf16 paths take the tie rule
    ties = [] if path == "bf16" else [
        i for i in range(B) if margins[i] < d_kt]
    differ = [i for i in range(B) if first["kernels"][i] != first["torch"][i]]
    bad = [i for i in differ if i not in ties
           or first["kernels"][i] not in top2_ids[i].tolist()]
    say(f"  tie rows (f32 margin < {d_kt:.4f}): {ties}; rows whose first "
        f"token differs from the plain path: {differ}")
    total = B * greedy_tokens
    if r1_ref is None:
        say(f"  first greedy tokens {first}")
    else:
        agree = sum(a == b for x, y in zip(r1.token_ids, r1_ref.token_ids)
                    for a, b in zip(x, y))
        say(f"  first greedy tokens {first}; round-1 greedy tokens agreeing "
            f"with the plain path position by position: {agree}/{total} "
            f"({agree / total:.3f})")
    failures = []
    if d_kt > LOGIT_ATOL or r_kt > LOGIT_REL_L2:
        failures.append("prefill logits disagree with the plain path")
    if planted:
        say("  planted faults, kernels vs the faulted plain path (max abs / "
            "rel L2): " + "; ".join(f"{f} {d:.4e} / {r:.4e}"
                                    for f, (d, r) in planted.items()))
        blind = [f for f, (d, r) in planted.items()
                 if d <= LOGIT_ATOL and r <= LOGIT_REL_L2]
        say(f"  faults inside the logit limits: {blind}"
            + ("" if path in MUST_SEE_FAULTS else " (printed only)"))
        if blind and path in MUST_SEE_FAULTS:
            failures.append(f"the logit limits cannot see planted faults "
                            f"{blind}")
    if r_k32 > KERNEL_VS_F32 * r_t32:
        failures.append("kernel path is further from f32 than the plain path")
    if moved is not None:
        (d_off, r_off), (d_rows, r_rows) = moved
        say(f"  control, {what} (rows {rows}): max abs / rel L2 of the last-"
            f"row logits, feature off vs on {d_off:.4e} / {r_off:.4e}; "
            f"kernels vs torch-{path} on those rows {d_rows:.4e} / "
            f"{r_rows:.4e}")
        if d_off <= d_rows or r_off <= r_rows:
            failures.append(f"the control ({what}) moves the logits no "
                            "more than the kernel path differs from the "
                            "plain path: these checks cannot see the "
                            "feature")
    if bad:
        failures.append(f"first greedy token differs from the reference in "
                        f"rows {bad}")
    if [o[0] for o in r1.token_ids] != first["kernels"]:
        failures.append("generate's first token is not the prefill argmax")
    if failures:
        raise AssertionError(f"{path} path: " + "; ".join(failures))
    if path in KEPT_RUNS:
        MAIN_RUNS[path] = dict(prompts=prompts, logits=logits,
                               ids=r1.token_ids, prefill_busy=prefill.busy,
                               peak=peak)
    return logits


# kernel C's row (phase 3): a 512-token prefill chunk at B = 4 into the
# full 7B slot cache, ragged, with a row of new_len 0: (T, starts, new_len)
C_CHUNK = (512, [0, 100, 1000, 1535], [512, 300, 1, 0])
# 3c's and 3d's mixed-step shapes at B = 16, pages of 64: kernel H's rows
# (8 page-aligned 64-row chunks and 8 decode rows at odd offsets) and
# kernel D's paged prefill rows (6 full chunks, 2 ragged tails, 7 decode
# rows, 1 inactive row; kv_len up to 808)
H_STARTS = [0, 192, 448, 768, 1280, 1600, 1920, 1984,
            1, 77, 333, 701, 1023, 1501, 1999, 2047]
H_NEW_LEN = [64] * 8 + [1] * 8
MIXED_START = [0, 64, 192, 320, 448, 576, 704, 768,
               1, 77, 129, 333, 501, 641, 799, 255]
MIXED_LEN = [64] * 6 + [37, 40] + [1] * 7 + [0]
# kernel I's rows (3d): the engine's 8 x 512 first chunk (2254 live rows)
# and 8 x 64 tail (251), ragged, with a row of new_len 0: (T, starts,
# new_len)
I_CHUNKS = ((512, [0, 512, 1000, 1535, 7, 1536, 100, 1200],
             [512, 300, 512, 1, 0, 512, 17, 400]),
            (64, [512, 64, 0, 1984, 333, 1000, 2047, 5],
             [64, 37, 64, 64, 0, 1, 1, 20]))
# kernel H's decode-shape rows: one token a sequence at odd in-page offsets
# (pages of 64), B = 8 (the first eight) and 16
DECODE_WRITE_STARTS = [1, 77, 333, 701, 1023, 1501, 1999, 2047,
                       3, 129, 517, 811, 1101, 1337, 1777, 2021]


def decode_write_rows(torch, results, cache, ints) -> None:
    """Kernel H (an int8 ``cache``: its int8 mode) at decode shape, layer
    31 of a pool of 16 table rows: B = 8 and 16 tokens at
    DECODE_WRITE_STARTS, a step's write of one layer; bit for bit against
    the plain write on a copy of the layer, timed cold beside the floor
    and (bf16) two ``index_copy_`` (printed only: the JSON line keeps each
    row's first timed case). Its rows come from a generator of its own, so
    the phase's later cases draw what they drew before."""
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    gen = torch.Generator(device=cache.k.device).manual_seed(77)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cache.k.device,
                           dtype=torch.bfloat16)
    K, D = cache.k.shape[3:]
    int8 = cache.quantized
    name = "paged_kv_write_int8" if int8 else "paged_kv_write"
    planes = ("k", "v", "k_scale", "v_scale") if int8 else ("k", "v")
    for B in (8, 16):
        pool = dataclasses.replace(cache, block_table=cache.block_table[:B])
        ref = dataclasses.replace(pool, **{
            n: getattr(cache, n)[31:].clone() for n in planes})
        starts, new_len = ints(DECODE_WRITE_STARTS[:B]), ints([1] * B)
        kn, vn = randn(B, 1, K, D), randn(B, 1, K, D)
        pkv.paged_update_at_layer(pool, 31, kn, vn, starts, new_len,
                                  kernels="cuda")
        pkv.paged_update_at_layer_torch(ref, 0, kn, vn, starts, new_len)
        torch.cuda.synchronize()
        timed = (time_ms(torch, lambda: pkv.paged_update_at_layer(
            pool, 31, kn, vn, starts, new_len, kernels="cuda"), cold=True),
            time_ms(torch, lambda: pkv.paged_update_at_layer_torch(
                ref, 0, kn, vn, starts, new_len)))
        floor = floor_ms(torch, (kn, vn), list(range(B)),
                         torch.int8 if int8 else torch.bfloat16, cold=True)
        case = f"decode B{B} T1 odd in-page offsets page 64 cold L2"
        work = write_work(B, K, D, quant=int8)
        page = cache.k.shape[2]
        rows = [int(pool.block_table[b, s // page]) * page + s % page
                for b, s in enumerate(DECODE_WRITE_STARTS[:B])]
        if int8:
            for side, v, sc in ((0, "k", "k_scale"), (1, "v", "v_scale")):
                hold_int8_write(torch, name, (getattr(pool, v)[31],
                                              getattr(pool, sc)[31]),
                                (getattr(ref, v)[0], getattr(ref, sc)[0]),
                                results, f"{case} {'kv'[side]}", timed, work,
                                floor)
        else:
            if not (torch.equal(pool.k[31], ref.k[0])
                    and torch.equal(pool.v[31], ref.v[0])):
                raise AssertionError(f"{name} [{case}]: pool differs from "
                                     "the plain write")
            check_close(torch, name, pool.k[31], ref.k[0], results, case,
                        timed, work=work, floor=floor,
                        library=index_copy_ms(
                            torch, (pool.k[31], pool.v[31]), (kn, vn),
                            (ints(rows).long(), ints(list(range(B))).long())))
        del ref


def fused_paged_decode_row(torch, dev, results) -> None:
    """Kernel D's fused paged decode (``attention_decode_paged_fused``) at
    4d's decode shape: llama2-7b widths (H = K = 32, D = 128), B = 8, 4b's
    decode contexts, a two-layer pool of page 64 with a random page
    permutation, layer 1, pool rows past kv_len NaN: the pool and the
    output bit for bit kernel H then the attend-only paged decode on a copy,
    the output per row against the plain version (DECODE_ROW_TOL); timed
    beside H + attend-only (back to back, the same method), the
    attend-only decode alone, its bound and the plain version."""
    from llm_inference_engine_tpu_torch.ops import attention
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    gen = torch.Generator(device=dev).manual_seed(88)
    B, H, K, D, S, page = 8, 32, 32, 128, 2048, 64
    maxp, P = S // page, 1 + B * S // page
    hist = [p + 16 + f + 16 for p, f in zip(QUANT_PROMPTS, QUANT_FOLLOW)]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, device=dev, dtype=torch.int32)
    q_start = ints(hist)
    kv_len, active = q_start + 1, ints([1] * B)
    table = (torch.randperm(P - 1, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(B, maxp)
    fused = pkv.PagedKVCache(randn(2, P, page, K, D), randn(2, P, page, K, D),
                             table, ints([0] * B))
    keep = torch.zeros(P * page, dtype=torch.bool, device=dev)
    for b, n in enumerate(kv_len.tolist()):
        j = torch.arange(n, device=dev)
        keep[table[b, j // page].long() * page + j % page] = True
    clean = pkv.PagedKVCache(fused.k.clone(), fused.v.clone(), table,
                             fused.lengths)
    for t in (fused.k, fused.v):
        t[1].view(P * page, K, D)[~keep] = float("nan")
    split = pkv.PagedKVCache(fused.k.clone(), fused.v.clone(), table,
                             fused.lengths)
    q, kn, vn = randn(B, 1, H, D), randn(B, 1, K, D), randn(B, 1, K, D)
    say_plan(attention, f"paged B{B} H{H} K{K} D{D} page {page}", B, H, K,
             D, page=page, max_pages=maxp)
    run = lambda: attention.attention_decode_paged_fused(  # noqa: E731
        q, kn, vn, fused.k, fused.v, q_start, kv_len, 1, table=table,
        kernels="cuda")[0]
    plain = lambda: attention.attention_decode_paged_fused_torch(  # noqa: E731
        q, kn, vn, clean.k, clean.v, q_start, kv_len, 1, table=table)[0]

    def write_then_attend():
        pkv.paged_update_at_layer(split, 1, kn, vn, q_start, active,
                                  kernels="cuda")
        return attention.attention_decode(q, split.k, split.v, q_start,
                                          kv_len, 1, table=table,
                                          kernels="cuda")
    got, want = run(), write_then_attend()
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int16)  # noqa: E731
    if not (torch.equal(bits(fused.k), bits(split.k))
            and torch.equal(bits(fused.v), bits(split.v))
            and torch.equal(got, want)):
        raise AssertionError("attention_decode_paged_fused: pool or output "
                             "differs from H then the attend-only decode")
    ms, two = time_ms(torch, run), time_ms(torch, write_then_attend)
    alone = time_ms(torch, lambda: attention.attention_decode(
        q, split.k, split.v, q_start, kv_len, 1, table=table,
        kernels="cuda"))
    new_rows = B * 2 * K * D * 2 * 2
    check_close(torch, "attention_decode_paged_fused", got, plain(), results,
                f"B{B} H{H} K{K} page {page} 4b contexts {min(hist)}-"
                f"{max(hist)}, NaN past kv_len (bits equal H + attend-only "
                f"{two:.4f} ms; attend-only alone {alone:.4f} ms)",
                (ms, time_ms(torch, plain, iters=3, warmup=1)),
                work=attn_work(hist, kv_len.tolist(), 1, H, K, D,
                               new_rows=new_rows),
                row_rel=DECODE_ROW_TOL)


def int8_fused_decode_case(torch, dev, gen, dtype, B, page, starts,
                           H=32, K=32, D=128, S=2048) -> dict:
    """The fused decode over an int8 pool (kernel D, or Df for a float16 /
    float32 q: ``attention_decode_paged_fused`` with scale planes) at B
    rows decoding at ``starts`` (kv_len = starts + 1), a one-layer pool of
    page ``page`` holding random rows quantized with snapped scales, a
    random page permutation, NaN scales in every row no key below kv_len
    maps to and NaN past the ends of q and the new rows. The pool (values
    and scales) and the output are held bit for bit against the route it
    replaced on a copy: kernel H's int8 mode (If for float rows), then the
    attend-only int8 decode. Returns the output, the plain version's on a
    clean copy, (kernel ms, plain ms) cold, the replaced route's ms and the
    attend-only decode's alone, and the work."""
    from llm_inference_engine_tpu_torch.ops import attention
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    _, pool = float_caches(torch, dev, gen, dtype, 1, B, S, K, D, page=page)
    fq = torch.tensor(starts, device=dev, dtype=torch.int32)
    fkv = fq + 1
    clean = plant_nan(torch, pool, fkv, page)
    split = cache_copy(pool)
    tbl = pool.block_table

    def randn(*shape):
        return poisoned(torch, torch.randn(shape, generator=gen, device=dev,
                                           dtype=dtype))
    q, kn, vn = randn(B, 1, H, D), randn(B, 1, K, D), randn(B, 1, K, D)
    planes = lambda c: dict(k_scale=c.k_scale, v_scale=c.v_scale)  # noqa

    def fused():
        return attention.attention_decode_paged_fused(
            q, kn, vn, pool.k, pool.v, fq, fkv, 0, table=tbl,
            kernels="cuda", **planes(pool))[0]

    def write_then_attend():
        pkv.paged_update_at_layer(split, 0, kn, vn, fq, torch.ones_like(fq),
                                  kernels="cuda")
        return attention.attention_decode(q, split.k, split.v, fq, fkv, 0,
                                          table=tbl, kernels="cuda",
                                          **planes(split))

    def plain():
        return attention.attention_decode_paged_fused_torch(
            q, kn, vn, clean.k, clean.v, fq, fkv, 0, table=tbl,
            **planes(clean))[0]
    got, want = fused(), write_then_attend()
    torch.cuda.synchronize()
    bits = lambda t: t.view({1: torch.int8, 2: torch.int16,  # noqa: E731
                             4: torch.int32}[t.element_size()])
    same = all(torch.equal(bits(getattr(pool, n)), bits(getattr(split, n)))
               for n in ("k", "v", "k_scale", "v_scale"))
    if not same or not torch.equal(bits(got), bits(want)):
        raise AssertionError(f"the fused int8 paged decode ({dtype}) B{B} "
                             f"page {page}: pool or output differs from "
                             "H's int8 mode (If) then the attend-only decode")
    esz = torch.empty((), dtype=dtype).element_size()
    return dict(
        got=got, plain=plain(),
        timed=(time_ms(torch, fused, cold=True),
               time_ms(torch, plain, iters=3, warmup=1)),
        two=time_ms(torch, write_then_attend, cold=True),
        alone=time_ms(torch, lambda: attention.attention_decode(
            q, split.k, split.v, fq, fkv, 0, table=tbl, kernels="cuda",
            **planes(split)), cold=True),
        work=attn_work(starts, fkv.tolist(), 1, H, K, D, kv_elem=1,
                       q_elem=esz,
                       new_rows=B * 2 * K * (D * esz + D + 4)))


def phase_paged_kernels(torch, dev, results) -> None:
    """3c: kernel H and kernel D's paged modes against their plain versions
    at Llama2-7B widths (L=32, K=32, D=128) over a pool of page 64 with a
    random page permutation, 2048 tokens per sequence; table entries past
    a sequence's pages point at the scratch page 0, as in the engine. The
    paged prefill runs at the mixed step's shape (B=16, T=64), then at
    8 x 512; the decode case runs again at page 16."""
    from llm_inference_engine_tpu_torch.ops import attention
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2024)
    L, K, D, S = 32, 32, 128, 2048

    def ints(vals):
        return torch.tensor(vals, device=dev, dtype=torch.int32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf16)

    def pool(B, page):
        maxp = S // page
        P = 1 + B * maxp
        pages = torch.randperm(P - 1, generator=gen, device=dev) + 1
        return pkv.PagedKVCache(randn(L, P, page, K, D),
                                randn(L, P, page, K, D),
                                pages.to(torch.int32).reshape(B, maxp),
                                ints([0] * B))

    def cut(table, kv_len, page):
        """A copy of ``table`` with entries past kv_len's pages at 0."""
        used = (kv_len.long() + page - 1) // page
        cols = torch.arange(table.shape[1], device=dev)
        return torch.where(cols[None, :] < used[:, None], table,
                           0).to(torch.int32).contiguous()

    def decode_case(cache, page, tag):
        """Kernel D over the pool at layer 31, B = 16 (the server's decode
        shape at 4e's page of 64), kv_len 1-2048: first the fused paged
        decode writing new rows at q_start = kv_len - 1, its pool and output
        bit for bit against kernel H then the attend-only decode on a copy
        of the layer, the output per row against its plain version; then
        the attend-only decode (the JAX package's order after H) alone. Both
        timed: the fused decode's JSON row is this first case, the shape
        its launches in 4e come from."""
        B = cache.block_table.shape[0]
        kv_len = torch.cat([ints([1, S]), torch.randint(
            2, S, (B - 2,), generator=gen, device=dev, dtype=torch.int32)])
        q_start = kv_len - 1
        table = cut(cache.block_table, kv_len, page)
        q = randn(B, 1, 32, D)
        kn, vn = randn(B, 1, K, D), randn(B, 1, K, D)
        say_plan(attention, f"paged B{B} H32 K32 D128 page {page}", B, 32, K,
                 D, page=page, max_pages=table.shape[1])
        split = pkv.PagedKVCache(cache.k[31:].clone(), cache.v[31:].clone(),
                                 table, cache.lengths)
        fused = lambda: attention.attention_decode_paged_fused(  # noqa: E731
            q, kn, vn, cache.k, cache.v, q_start, kv_len, 31, table=table,
            kernels="cuda")[0]

        def write_then_attend():
            pkv.paged_update_at_layer(split, 0, kn, vn, q_start,
                                      torch.ones_like(kv_len),
                                      kernels="cuda")
            return attention.attention_decode(q, split.k, split.v, q_start,
                                              kv_len, 0, table=table,
                                              kernels="cuda")
        got, want = fused(), write_then_attend()
        torch.cuda.synchronize()
        bits = lambda t: t.view(torch.int16)  # noqa: E731
        if not (torch.equal(bits(cache.k[31]), bits(split.k[0]))
                and torch.equal(bits(cache.v[31]), bits(split.v[0]))
                and torch.equal(bits(got), bits(want))):
            raise AssertionError(f"attention_decode_paged_fused B{B} page "
                                 f"{page}: pool or output differs from H "
                                 "then the attend-only decode")
        plain = lambda: attention.attention_decode_paged_fused_torch(  # noqa: E731
            q, kn, vn, split.k, split.v, q_start, kv_len, 0, table=table)[0]
        ms, two = time_ms(torch, fused), time_ms(torch, write_then_attend)
        kv_bytes = int(kv_len.sum()) * K * D * 2 * 2
        check_close(torch, "attention_decode_paged_fused", got, plain(),
                    results, f"B{B} page {page} {tag} "
                    f"{kv_bytes / ms / 1e6:.0f} GB/s (bits equal H + "
                    f"attend-only {two:.4f} ms)",
                    (ms, time_ms(torch, plain, iters=3, warmup=1)),
                    work=attn_work(q_start.tolist(), kv_len.tolist(), 1, 32,
                                   K, D, new_rows=B * 2 * K * D * 2 * 2),
                    row_rel=DECODE_ROW_TOL)
        del split
        run = lambda kern: attention.attention_decode(  # noqa: E731
            q, cache.k, cache.v, q_start, kv_len, 31, table=table,
            kernels=kern)
        ms = time_ms(torch, lambda: run("cuda"))
        plain_ms = time_ms(torch, lambda: run("torch"), iters=3, warmup=1)
        check_close(torch, "attention_decode_paged", run("cuda"), run("torch"),
                    results, f"B{B} page {page} {tag} "
                    f"{kv_bytes / ms / 1e6:.0f} GB/s", (ms, plain_ms),
                    work=attn_work(q_start.tolist(), kv_len.tolist(), 1, 32,
                                   K, D),
                    row_rel=DECODE_ROW_TOL)

    cache = pool(16, 64)
    # H: 8 page-aligned 64-row chunks and 8 decode rows at odd offsets in
    # one launch, at layer 31; the plain write runs on a copy of layer 31
    starts = ints(H_STARTS)
    new_len = ints(H_NEW_LEN)
    kn, vn = randn(16, 64, K, D), randn(16, 64, K, D)
    ref = pkv.PagedKVCache(cache.k[31:].clone(), cache.v[31:].clone(),
                           cache.block_table, cache.lengths)
    pkv.paged_update_at_layer(cache, 31, kn, vn, starts, new_len,
                              kernels="cuda")
    pkv.paged_update_at_layer_torch(ref, 0, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    if not (torch.equal(cache.k[31], ref.k[0])
            and torch.equal(cache.v[31], ref.v[0])):
        raise AssertionError("paged_kv_write: pool differs from the plain "
                             "write")
    rows = new_len.sum().item()
    # the pool row of each written token (its position translated through
    # the table), and its flat index in the new rows
    table = cache.block_table.tolist()
    pos, picked = slot_rows(H_STARTS, H_NEW_LEN, 64, 0)
    flat = [table[i // 64][p // 64] * 64 + p % 64
            for p, i in zip(pos, picked)]
    check_close(torch, "paged_kv_write", cache.k[31], ref.k[0], results,
                f"B16: 8x64-row chunks + 8 decode rows ({rows} rows) page 64"
                " cold L2",
                (time_ms(torch, lambda: pkv.paged_update_at_layer(
                    cache, 31, kn, vn, starts, new_len, kernels="cuda"),
                    cold=True),
                 time_ms(torch, lambda: pkv.paged_update_at_layer_torch(
                     ref, 0, kn, vn, starts, new_len))),
                work=write_work(rows, K, D),
                library=index_copy_ms(torch, (cache.k[31], cache.v[31]),
                                      (kn, vn), (ints(flat).long(),
                                                 ints(picked).long())),
                floor=floor_ms(torch, (kn, vn), picked, bf16, cold=True))
    del ref
    decode_write_rows(torch, results, cache, ints)

    # D paged prefill at the engine's shape first (chunks are capped to the
    # page): a scheduler mixed step, B = 16, T = 64, page-aligned chunk
    # rows (two ragged tails) beside decode rows at odd offsets and one
    # inactive row, kv_len up to 808
    mixed_start, mixed_len = ints(MIXED_START), ints(MIXED_LEN)
    kv_mixed = mixed_start + mixed_len
    table16 = cut(cache.block_table, kv_mixed, 64)
    q = randn(16, 64, 32, D)
    run = lambda kern: attention.attention(  # noqa: E731
        q, cache.k, cache.v, mixed_start, kv_mixed, layer=31, table=table16,
        kernels=kern)
    check_close(torch, "attention_prefill_paged", run("cuda"), run("torch"),
                results, "B16 T64 mixed step kv_len 1-808 page 64", (
                    time_ms(torch, lambda: run("cuda")),
                    time_ms(torch, lambda: run("torch"), iters=3, warmup=1)),
                work=attn_work(MIXED_START, [s + n for s, n in zip(
                    MIXED_START, MIXED_LEN)], 64, 32, K, D))
    # and a long prefill: 8 x 512 new rows against kv_len 512-2048
    q_start = ints([0, 256, 512, 768, 1024, 1280, 1536, 1536])
    kv_len = q_start + 512
    table8 = cut(cache.block_table[:8], kv_len, 64)
    q = randn(8, 512, 32, D)
    run = lambda kern: attention.attention(  # noqa: E731
        q, cache.k, cache.v, q_start, kv_len, layer=31, table=table8,
        kernels=kern)
    check_close(torch, "attention_prefill_paged", run("cuda"), run("torch"),
                results, "B8 T512 kv_len 512-2048 page 64", (
                    time_ms(torch, lambda: run("cuda"), iters=5),
                    time_ms(torch, lambda: run("torch"), iters=3, warmup=1)))
    # D's fused paged decode, then the attend-only one: B = 16, kv_len
    # 1-2048
    decode_case(cache, 64, "kv_len 1-2048")
    del cache, kn, vn, q
    torch.cuda.empty_cache()
    # D's fused paged decode at 4d's shape, against H + attend-only
    fused_paged_decode_row(torch, dev, results)
    cache = pool(16, 16)
    # D2's paged prefill at pages of 16: 64-key tiles straddle pages
    table16 = cut(cache.block_table, kv_mixed, 16)
    q = randn(16, 64, 32, D)
    check_close(torch, "attention_prefill_paged", attention.attention(
        q, cache.k, cache.v, mixed_start, kv_mixed, layer=31, table=table16,
        kernels="cuda"), attention.attention(
        q, cache.k, cache.v, mixed_start, kv_mixed, layer=31, table=table16,
        kernels="torch"), results, "B16 T64 mixed step kv_len 1-808 page 16")
    decode_case(cache, 16, "kv_len 1-2048")
    del cache, q
    torch.cuda.empty_cache()
    # D paged decode at G = 7 (H = 28, K = 4), pages of 16, kv_len 1, one
    # tile, one tile + 1 and 2048, a window starting inside a tile
    pool4 = pkv.PagedKVCache(randn(2, 1 + 4 * 128, 16, 4, D),
                             randn(2, 1 + 4 * 128, 16, 4, D),
                             (torch.randperm(4 * 128, generator=gen,
                                             device=dev) + 1)
                             .to(torch.int32).reshape(4, 128), ints([0] * 4))
    kv_len = ints([1, 32, 33, S])
    table = cut(pool4.block_table, kv_len, 16)
    q = randn(4, 1, 28, D)
    say_plan(attention, "paged B4 H28 K4 D128 page 16", 4, 28, 4, D, page=16,
             max_pages=128)
    check_close(torch, "attention_decode_paged", attention.attention_decode(
        q, pool4.k, pool4.v, kv_len - 1, kv_len, 1, table=table, window=300,
        kernels="cuda"), attention.attention_decode(
        q, pool4.k, pool4.v, kv_len - 1, kv_len, 1, table=table, window=300,
        kernels="torch"), results,
        "B4 G7 H28 K4 page 16 kv_len 1, 32, 33, 2048 window 300",
        row_rel=DECODE_ROW_TOL)
    del pool4, q
    torch.cuda.empty_cache()
    for H, Kg in GQA_WIDTHS:
        say_plan(attention, f"G{H // Kg} B8 H{H} K{Kg} D128", 8, H, Kg, D)
    gqa_decode_cases(torch, dev, results)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# Kernel D's bf16 decode at GQA widths (H, K), timed: G = 4 (llama3-8b,
# mistral-7b), 7 (qwen2-7b), 8
GQA_WIDTHS = ((32, 8), (28, 4), (32, 4))


def gqa_decode_cases(torch, dev, results) -> dict:
    """Kernel D's bf16 decode modes at GQA_WIDTHS, D = 128, at the engine's
    B = 8 and 4b's decode contexts: the fused decode over a two-layer slot
    cache and the attend-only decode over a pool of page 64 with a random
    page permutation, each held against its plain version per row
    (DECODE_ROW_TOL) and printed with its time. Returns {row: kernel ms};
    ``tools/chip_kernel_ab.py`` times another tree's kernels through this
    function, so it calls only the wrappers every tree has."""
    from llm_inference_engine_tpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(77)
    D, S, page, B = 128, 2048, 64, 8
    maxp, hist = S // page, [p + 16 + f + 16
                             for p, f in zip(QUANT_PROMPTS, QUANT_FOLLOW)]

    def ints(vals):
        return torch.tensor(vals, device=dev, dtype=torch.int32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q_start = ints(hist)
    kv_len = q_start + 1
    out = {}
    for H, K in GQA_WIDTHS:
        tag = f"G{H // K} B8 H{H} K{K}"
        out[f"attention_decode {tag}"] = fused_decode_case(
            torch, attention, results, f"{tag} 4b contexts {min(hist)}-"
            f"{max(hist)}", randn, ints, B=B, H=H, K=K, D=D, S=S,
            q_start=hist, active=[1] * B, timed=True)
        P = 1 + B * maxp
        kp, vp = randn(2, P, page, K, D), randn(2, P, page, K, D)
        table = (torch.randperm(P - 1, generator=gen, device=dev) + 1).to(
            torch.int32).reshape(B, maxp)
        q = randn(B, 1, H, D)
        run = lambda kern: attention.attention_decode(  # noqa: E731
            q, kp, vp, q_start, kv_len, 1, table=table, kernels=kern)
        ms = time_ms(torch, lambda: run("cuda"))
        out[f"attention_decode_paged {tag}"] = ms
        check_close(torch, "attention_decode_paged", run("cuda"),
                    run("torch"), results, f"{tag} page {page} 4b contexts "
                    f"kernel {ms:.4f} ms (printed only)",
                    row_rel=DECODE_ROW_TOL)
        del kp, vp
    return out


# 4b's and 4g's prompts and follow-ups: the first prefill chunk is 8 x 512
# rows, the 560-token prompt's tail an 8 x 64 chunk
QUANT_PROMPTS = (5, 40, 130, 200, 333, 420, 512, 560)
QUANT_FOLLOW = (3, 9, 17, 33, 5, 64, 12, 40)


def phase_kv_int8_kernels(torch, dev, results) -> None:
    """3d: the int8 KV kernels against their plain versions at Llama2-7B
    widths (L=32, K=32, D=128; random int8 values and scales): kernel I at
    the engine's prefill chunks (8 x 512 and 8 x 64 rows, ragged, one row of
    new_len 0, one all-zero row) in both scale numerics, bit for bit; D's
    int8 slot prefill at the engine's first 8 x 512 chunk, then ragged up to
    kv_len 560; D's fused int8 decode at B = 8 at 4g's contexts in both
    numerics, its write bit for bit; H's int8 mode at 3c's mixed step; D's
    int8 paged prefill at 3c's B = 16, T = 64 mixed step first; D's int8
    paged decode at B = 16, kv_len 1-2048, pages of 64 and 16."""
    from llm_inference_engine_tpu_torch.ops import attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(808)
    L, K, D, S = 32, 32, 128, 2048

    def ints(vals):
        return torch.tensor(vals, device=dev, dtype=torch.int32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf16)

    def fill(cache):
        for t in (cache.k, cache.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=dev, dtype=torch.int8))
        for t in (cache.k_scale, cache.v_scale):
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02
                    + 0.005)
        return cache

    def planes(cache):
        return dict(k_scale=cache.k_scale, v_scale=cache.v_scale)

    def layer_copy(cache):
        """The last layer alone, copied: the plain versions write it as
        layer 0."""
        return dataclasses.replace(cache, **{
            n: getattr(cache, n)[31:].clone()
            for n in ("k", "v", "k_scale", "v_scale")})

    def held(cache, layer):
        return [(getattr(cache, v)[layer], getattr(cache, sc)[layer])
                for v, sc in (("k", "k_scale"), ("v", "v_scale"))]

    cache = fill(kvc.new_kv_cache(L, 8, K, S, D, device=dev, quantized=True,
                                  snapped=True))
    # I: the engine's two prefill chunks, snapped (the engine's numerics on
    # the card) first, then absmax
    for T, st, nl in I_CHUNKS:
        kn, vn = randn(8, T, K, D), randn(8, T, K, D)
        kn[0, 0, 0] = 0.0                            # a row of zeros
        starts, new_len = ints(st), ints(nl)
        for snapped in (True, False):
            cache.snapped = snapped
            ref = layer_copy(cache)
            kvc.update_cache_at_layer(cache, 31, kn, vn, starts, new_len,
                                      kernels="cuda")
            kvc.update_cache_at_layer_torch(ref, 0, kn, vn, starts, new_len)
            torch.cuda.synchronize()
            timed = work = floor = None
            if snapped:                # the 8 x 512 row goes into the JSON
                timed = (time_ms(torch, lambda: kvc.update_cache_at_layer(
                    cache, 31, kn, vn, starts, new_len, kernels="cuda")),
                    time_ms(torch, lambda: kvc.update_cache_at_layer_torch(
                        ref, 0, kn, vn, starts, new_len), iters=3, warmup=1))
                work = write_work(sum(nl), K, D, quant=True)
                floor = floor_ms(torch, (kn, vn), slot_rows(st, nl, T, S)[1],
                                 torch.int8, cold=False)
            tag = (f"8x{T} rows ({sum(nl)} live) "
                   f"{'snapped' if snapped else 'absmax'}")
            for side, (got, want) in enumerate(zip(held(cache, 31),
                                                   held(ref, 0))):
                hold_int8_write(torch, "kv_write_quant", got, want, results,
                                f"{tag} {'kv'[side]}", timed, work, floor)
            del ref

    # D int8 slot prefill: the engine's first chunk (q_start 0, kv_len
    # 5-512), then ragged chunks reaching kv_len 560
    cache.snapped = True
    q = randn(8, 512, 32, D)
    for qs, kl, timed in (([0] * 8, [min(n, 512) for n in QUANT_PROMPTS],
                           True),
                          ([0, 48, 0, 7, 0, 30, 0, 48], None, False)):
        kl = kl or [s + 512 for s in qs]
        q_start, kv_len = ints(qs), ints(kl)
        run = lambda kern: attention.attention(  # noqa: E731
            q, cache.k, cache.v, q_start, kv_len, layer=31, kernels=kern,
            **planes(cache))
        check_close(torch, "attention_prefill_int8", run("cuda"),
                    run("torch"), results,
                    f"B8 T512 qs {qs[:2]}.. kv_len {min(kl)}-{max(kl)}",
                    (time_ms(torch, lambda: run("cuda"), iters=5),
                     time_ms(torch, lambda: run("torch"), iters=3,
                             warmup=1)) if timed else None,
                    work=attn_work(qs, kl, 512, 32, K, D, kv_elem=1))

    # D fused int8 decode at 4g's contexts (two rounds of 16 tokens on
    # 4b's prompts and follow-ups), row 2 inactive
    hist = [p + 16 + f + 16 for p, f in zip(QUANT_PROMPTS, QUANT_FOLLOW)]
    q_start, kv_len = ints(hist), ints([h + (i != 2)
                                        for i, h in enumerate(hist)])
    q1, k1, v1 = randn(8, 1, 32, D), randn(8, 1, K, D), randn(8, 1, K, D)
    say_plan(attention, "int8 B8 H32 K32 D128", 8, 32, K, D, int8=True)
    for snapped in (True, False):
        cache.snapped = snapped
        ref = layer_copy(cache)
        got, _, _ = attention.attention_decode_fused(
            q1, k1, v1, cache.k, cache.v, q_start, kv_len, 31, kernels="cuda",
            snapped=snapped, **planes(cache))
        want, _, _ = attention.attention_decode_fused_torch(
            q1, k1, v1, ref.k, ref.v, q_start, kv_len, 0, snapped=snapped,
            **planes(ref))
        torch.cuda.synchronize()
        for got_w, want_w in zip(held(cache, 31), held(ref, 0)):
            if not all(torch.equal(a, b) for a, b in zip(got_w, want_w)):
                raise AssertionError("attention_decode_int8: the in-kernel "
                                     "write differs from the plain write")
        timed = None
        if snapped:
            timed = (time_ms(torch, lambda: attention.attention_decode_fused(
                q1, k1, v1, cache.k, cache.v, q_start, kv_len, 31,
                kernels="cuda", snapped=True, **planes(cache))),
                time_ms(torch, lambda: attention.attention_decode_fused_torch(
                    q1, k1, v1, ref.k, ref.v, q_start, kv_len, 0,
                    snapped=True, **planes(ref))))
        check_close(torch, "attention_decode_int8", got, want, results,
                    f"B8 H32 K32 contexts {min(hist)}-{max(hist)} "
                    f"{'snapped' if snapped else 'absmax'} (write bit for "
                    "bit)", timed,
                    work=attn_work(hist, kv_len.tolist(), 1, 32, K, D,
                                   kv_elem=1, new_rows=7 * 2 * K * (
                                       D * 2 + D + 4)),
                    row_rel=DECODE_ROW_TOL)
        del ref
    del cache
    torch.cuda.empty_cache()

    def int8_pool(page):
        maxp = S // page
        P = 1 + 16 * maxp
        pool = fill(pkv.new_paged_kv_cache(L, 16, K, P, page, D, maxp,
                                           device=dev, quantized=True))
        pool.block_table.copy_((torch.randperm(P - 1, generator=gen,
                                               device=dev) + 1)
                               .to(torch.int32).reshape(16, maxp))
        return pool

    def cut(table, kv_len, page):
        used = (kv_len.long() + page - 1) // page
        cols = torch.arange(table.shape[1], device=dev)
        return torch.where(cols[None, :] < used[:, None], table,
                           0).to(torch.int32).contiguous()

    pool = int8_pool(64)
    # H's int8 mode at 3c's mixed step
    starts, new_len = ints(H_STARTS), ints(H_NEW_LEN)
    kn, vn = randn(16, 64, K, D), randn(16, 64, K, D)
    ref = layer_copy(pool)
    pkv.paged_update_at_layer(pool, 31, kn, vn, starts, new_len,
                              kernels="cuda")
    pkv.paged_update_at_layer_torch(ref, 0, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    timed = (time_ms(torch, lambda: pkv.paged_update_at_layer(
        pool, 31, kn, vn, starts, new_len, kernels="cuda"), cold=True),
        time_ms(torch, lambda: pkv.paged_update_at_layer_torch(
            ref, 0, kn, vn, starts, new_len)))
    floor = floor_ms(torch, (kn, vn),
                     slot_rows(H_STARTS, H_NEW_LEN, 64, 0)[1], torch.int8,
                     cold=True)
    for side, (got, want) in enumerate(zip(held(pool, 31), held(ref, 0))):
        hold_int8_write(torch, "paged_kv_write_int8", got, want, results,
                        f"B16 3c's mixed step ({sum(H_NEW_LEN)} rows) page "
                        f"64 cold L2 {'kv'[side]}", timed,
                        write_work(sum(H_NEW_LEN), K, D, quant=True), floor)
    del ref
    decode_write_rows(torch, results, pool, ints)
    # D's int8 paged prefill at the mixed step
    mixed_start, kv_mixed = ints(MIXED_START), ints(
        [s + n for s, n in zip(MIXED_START, MIXED_LEN)])
    table = cut(pool.block_table, kv_mixed, 64)
    q = randn(16, 64, 32, D)
    run = lambda kern: attention.attention(  # noqa: E731
        q, pool.k, pool.v, mixed_start, kv_mixed, layer=31, table=table,
        kernels=kern, **planes(pool))
    check_close(torch, "attention_prefill_paged_int8", run("cuda"),
                run("torch"), results,
                "B16 T64 mixed step kv_len 1-808 page 64", (
                    time_ms(torch, lambda: run("cuda")),
                    time_ms(torch, lambda: run("torch"), iters=3, warmup=1)),
                work=attn_work(MIXED_START, kv_mixed.tolist(), 64, 32, K, D,
                               kv_elem=1))
    # D's int8 attend-only paged decode, B = 16, kv_len 1-2048
    for page in (64, 16):
        if page == 16:
            del pool
            torch.cuda.empty_cache()
            pool = int8_pool(16)
            # D2's int8 paged prefill at pages of 16 (tiles straddle pages)
            table = cut(pool.block_table, kv_mixed, 16)
            q = randn(16, 64, 32, D)
            check_close(torch, "attention_prefill_paged_int8",
                        attention.attention(
                            q, pool.k, pool.v, mixed_start, kv_mixed,
                            layer=31, table=table, kernels="cuda",
                            **planes(pool)),
                        attention.attention(
                            q, pool.k, pool.v, mixed_start, kv_mixed,
                            layer=31, table=table, kernels="torch",
                            **planes(pool)), results,
                        "B16 T64 mixed step kv_len 1-808 page 16")
        kv_len = torch.cat([ints([1, S]), torch.randint(
            2, S, (14,), generator=gen, device=dev, dtype=torch.int32)])
        table = cut(pool.block_table, kv_len, page)
        q = randn(16, 1, 32, D)
        say_plan(attention, f"int8 paged B16 H32 K32 D128 page {page}", 16,
                 32, K, D, int8=True, page=page, max_pages=table.shape[1])
        run = lambda kern: attention.attention_decode(  # noqa: E731
            q, pool.k, pool.v, kv_len - 1, kv_len, 31, table=table,
            kernels=kern, **planes(pool))
        ms = time_ms(torch, lambda: run("cuda"))
        kv_bytes = int(kv_len.sum()) * K * (D + 4) * 2
        check_close(torch, "attention_decode_paged_int8", run("cuda"),
                    run("torch"), results, f"B16 page {page} kv_len 1-2048 "
                    f"{kv_bytes / ms / 1e6:.0f} GB/s",
                    (ms, time_ms(torch, lambda: run("torch"), iters=3,
                                 warmup=1)),
                    work=attn_work((kv_len - 1).tolist(), kv_len.tolist(), 1,
                                   32, K, D, kv_elem=1),
                    row_rel=DECODE_ROW_TOL)
    del pool
    torch.cuda.empty_cache()
    # D's fused decode over an int8 pool (a decode step's write and attend
    # in one launch): B16 at pages of 64 (the server's shape: the JSON
    # row), and 4h's B8 at 4b's contexts; bit for bit H's int8 mode then
    # the attend-only decode
    hist = [p + 16 + f + 16 for p, f in zip(QUANT_PROMPTS, QUANT_FOLLOW)]
    for B, starts in ((16, DECODE_WRITE_STARTS), (8, hist)):
        say_plan(attention, f"int8 paged fused B{B} H32 K32 D128 page 64",
                 B, 32, K, D, int8=True, page=64, max_pages=S // 64)
        c = int8_fused_decode_case(torch, dev, gen, bf16, B, 64, starts)
        check_close(torch, "attention_decode_paged_fused_int8", c["got"],
                    c["plain"], results,
                    f"B{B} page 64 kv_len {min(starts) + 1}-"
                    f"{max(starts) + 1} NaN outside the table (bits equal H "
                    f"int8 + attend-only, {c['two']:.4f} ms; attend-only "
                    f"alone {c['alone']:.4f} ms)", c["timed"],
                    work=c["work"], row_rel=DECODE_ROW_TOL)
        del c
    torch.cuda.empty_cache()
    for head_dim in (80, 96, 256):
        head_dim_kernels(torch, dev, results, head_dim, gen, fill)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def head_dim_kernels(torch, dev, results, D, gen, fill) -> None:
    """Kernel D's five decode modes, D2's four prefill modes and kernel
    I's two writes at head_dim D (80, 96 or 256: no Llama2-7B width, so
    small shapes: B = 4, S = 512, H = 28, K = 4, G = 7, pages of 16),
    each against its plain version; the writes bit for bit."""
    from llm_inference_engine_tpu_torch.ops import attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv

    B, S, H, K, page = 4, 512, 28, 4, 16
    maxp = S // page

    def ints(vals):
        return torch.tensor(vals, device=dev, dtype=torch.int32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def pool(int8):
        P = 1 + B * maxp
        c = pkv.new_paged_kv_cache(2, B, K, P, page, D, maxp, device=dev,
                                   quantized=int8)
        if int8:
            fill(c)
        else:
            c.k.copy_(randn(*c.k.shape))
            c.v.copy_(randn(*c.v.shape))
        c.block_table.copy_((torch.randperm(P - 1, generator=gen,
                                            device=dev) + 1)
                            .to(torch.int32).reshape(B, maxp))
        return c

    def planes(c):
        return ({} if c.k_scale is None
                else dict(k_scale=c.k_scale, v_scale=c.v_scale))

    tag = f"D{D} B4 H28 K4"
    say_plan(attention, tag, B, H, K, D)
    # decode: the fused slot modes, then the attend-only paged modes
    for int8 in (False, True):
        fused_decode_case(torch, attention, results, f"{tag} kv_len 1, 32, "
                          "33, 512, row 2 inactive", randn, ints, B=B, H=H,
                          K=K, D=D, S=S, q_start=[0, 31, 300, 511],
                          active=[1, 1, 0, 1], window=None, int8=int8,
                          fill=fill)
    kv_len = ints([1, 32, 33, S])
    q1 = randn(B, 1, H, D)
    for int8 in (False, True):
        c = pool(int8)
        name = "attention_decode_paged_int8" if int8 else \
            "attention_decode_paged"
        run = lambda kern: attention.attention_decode(  # noqa: E731
            q1, c.k, c.v, kv_len - 1, kv_len, 1, table=c.block_table,
            window=200, kernels=kern, **planes(c))
        check_close(torch, name, run("cuda"), run("torch"), results,
                    f"{tag} page {page} kv_len 1, 32, 33, 512 window 200",
                    row_rel=DECODE_ROW_TOL)
    # the fused paged mode (bf16 pool) against H then the attend-only mode
    c = pool(False)
    split = dataclasses.replace(c, k=c.k.clone(), v=c.v.clone())
    q_start = ints([0, 31, 300, 511])
    kv_len = q_start + ints([1, 1, 0, 1])
    kn, vn = randn(B, 1, K, D), randn(B, 1, K, D)
    got = attention.attention_decode_paged_fused(
        q1, kn, vn, c.k, c.v, q_start, kv_len, 1, table=c.block_table,
        window=200, kernels="cuda")[0]
    pkv.paged_update_at_layer(split, 1, kn, vn, q_start, kv_len - q_start,
                              kernels="cuda")
    run = lambda kern: attention.attention_decode(  # noqa: E731
        q1, split.k, split.v, q_start, kv_len, 1, table=c.block_table,
        window=200, kernels=kern)
    if not (torch.equal(c.k, split.k) and torch.equal(c.v, split.v)
            and torch.equal(got, run("cuda"))):
        raise AssertionError(f"attention_decode_paged_fused {tag}: pool or "
                             "output differs from H then the attend-only "
                             "decode")
    check_close(torch, "attention_decode_paged_fused", got, run("torch"),
                results, f"{tag} page {page} kv_len 1, 32, 300 (inactive), "
                "512 window 200 (bits equal H + attend-only)",
                row_rel=DECODE_ROW_TOL)
    del c, split
    # D2: a 64-row chunk (ragged) in the four prefill modes
    q_start, new = ints([0, 100, 300, 448]), ints([64, 37, 1, 64])
    kv_len = q_start + new
    q = randn(B, 64, H, D)
    slot = kvc.new_kv_cache(2, B, K, S, D, device=dev)
    slot.k.copy_(randn(2, B, S, K, D))
    slot.v.copy_(randn(2, B, S, K, D))
    slot8 = fill(kvc.new_kv_cache(2, B, K, S, D, device=dev, quantized=True))
    for name, c, table in (("attention_prefill", slot, None),
                           ("attention_prefill_int8", slot8, None),
                           ("attention_prefill_paged", pool(False), True),
                           ("attention_prefill_paged_int8", pool(True),
                            True)):
        kw = dict(table=c.block_table) if table else {}
        run = lambda kern: attention.attention(  # noqa: E731
            q, c.k, c.v, q_start, kv_len, layer=1, kernels=kern, **kw,
            **planes(c))
        check_close(torch, name, run("cuda"), run("torch"), results,
                    f"{tag} T64 kv_len 64-512")
    # I: slot (both numerics) and paged, bit for bit
    kn, vn = randn(B, 64, K, D), randn(B, 64, K, D)
    kn[0, 0, 0] = 0.0
    for snapped in (True, False):
        slot8.snapped = snapped
        ref = dataclasses.replace(slot8, k=slot8.k.clone(),
                                  v=slot8.v.clone(),
                                  k_scale=slot8.k_scale.clone(),
                                  v_scale=slot8.v_scale.clone())
        kvc.update_cache_at_layer(slot8, 1, kn, vn, q_start, new,
                                  kernels="cuda")
        kvc.update_cache_at_layer_torch(ref, 1, kn, vn, q_start, new)
        torch.cuda.synchronize()
        for v, sc in (("k", "k_scale"), ("v", "v_scale")):
            hold_int8_write(torch, "kv_write_quant", (getattr(slot8, v)[1],
                            getattr(slot8, sc)[1]), (getattr(ref, v)[1],
                                                     getattr(ref, sc)[1]),
                            results, f"{tag} T64 "
                            f"{'snapped' if snapped else 'absmax'} {v}")
    c = pool(True)
    ref = dataclasses.replace(c, k=c.k.clone(), v=c.v.clone(),
                              k_scale=c.k_scale.clone(),
                              v_scale=c.v_scale.clone())
    pkv.paged_update_at_layer(c, 1, kn, vn, q_start, new, kernels="cuda")
    pkv.paged_update_at_layer_torch(ref, 1, kn, vn, q_start, new)
    torch.cuda.synchronize()
    for v, sc in (("k", "k_scale"), ("v", "v_scale")):
        hold_int8_write(torch, "paged_kv_write_int8", (getattr(c, v)[1],
                        getattr(c, sc)[1]), (getattr(ref, v)[1],
                                             getattr(ref, sc)[1]),
                        results, f"{tag} T64 page {page} {v}")


def _zero_counters():
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    return counters


def _check_paged_launches(label, counters, expected) -> dict:
    """Read the counters after a paged path: every kernel of ``expected``
    launched; the slot cache's kernels never, nor the paged kernels of the
    other KV dtype, nor the attend-only paged decodes."""
    launches = {k: f.launches for k, f in counters.items()}
    say(f"  launches during {label}: {launches}")
    missing = [n for n in expected if launches[n] <= 0]
    other = (INT8_PAGED if "paged_kv_write" in expected else BF16_PAGED) + (
        "attention_decode_paged", "attention_decode_paged_int8")
    extra = [n for n in BF16_SLOT + INT8_SLOT + other if launches[n]]
    if missing or extra:
        raise AssertionError(f"{label}: kernels never launched {missing}; "
                             f"kernels that must not launch {extra}")
    return launches


def decode_phase_launches(sched, counters) -> list:
    """Wrap ``sched``'s pure-decode phase so that each call appends the
    launches it added ({kernel: n}) to the returned list."""
    seen, plain = [], sched._decode_phase

    def counted():
        before = {k: f.launches for k, f in counters.items()}
        plain()
        seen.append({k: f.launches - before[k] for k, f in counters.items()
                     if f.launches != before[k]})
    sched._decode_phase = counted
    return seen


def check_decode_step_launches(label, steps, layers, int8=False,
                               ranks=1) -> None:
    """Each pure-decode step (launch counts added, one dict a step) ran
    whole forwards on every rank (kernel A's plain mode once a forward a
    rank: a step that captures its program also runs the warm-up) and,
    for each forward a rank, a layer, exactly one fused paged decode (over
    an int8 pool its int8 instance) and no kernel H (nor its int8 mode) or
    attend-only decode."""
    def want(f):
        return ({"attention_decode_paged_fused_int8": layers * f,
                 "paged_kv_write_int8": 0, "attention_decode_paged_int8": 0,
                 "attention_decode_paged_fused": 0} if int8 else
                {"attention_decode_paged_fused": layers * f,
                 "paged_kv_write": 0, "attention_decode_paged": 0})
    bad = [s for s in steps
           if not s.get("rmsnorm") or s["rmsnorm"] % ranks
           or any(s.get(k, 0) != n for k, n in want(s["rmsnorm"]).items())]
    say(f"  {label}: {len(steps)} pure-decode steps, each launching "
        f"{want(ranks)} a forward on {ranks} rank(s): "
        f"{'yes' if steps and not bad else 'NO'}")
    if not steps or bad:
        raise AssertionError(f"{label}: pure-decode steps' launches "
                             f"{bad[:2] or steps}, want {want(ranks)} a "
                             "forward")


def bits_checksum(torch, values) -> float:
    """Position-weighted sum of integers (bf16 bit patterns, ids): equal in
    two trees where their bits are."""
    v = torch.cat([t.reshape(-1).to(torch.int64) for t in values])
    weights = torch.arange(v.numel(), device=v.device) % 65521 + 1
    return float((v * weights).sum().item())


def norm_rows(torch, dev) -> dict:
    """Kernels A, A with residual and B timed, no checks beyond 3e's: at
    decode shape (``decode_shape_rows``: 64 calls in a CUDA graph, CUDA
    events over its replays), at prefill shape (A cold at [2048, 4096], B
    at [2048, 22016], as phase 3 times them), and the wall of 4b's and
    4c's replayed decode step (llama2-7b INT4 and INT8, B = 8, 32 greedy
    steps after a 16-token ``generate`` of 4b's prompts) with the count
    of the card's activities (kernels, copies) in one. Two checksums
    (keys ending in "checksum") show two trees' bits equal: of A's, A's
    residual mode's and B's outputs at the prefill shapes, and of the
    ids of 4b's and 4c's ``generate`` and steps. 4d's replayed paged step
    (4b over a bf16 pool of pages of 64, chunks of 64) is timed the same
    way, with the card's busy ms a step (the union of its activity
    intervals, over 4 replays) beside each path's wall, and the kernels'
    durations a step summed: all, kernel D's and the K/V writes'
    (KERNEL_GROUPS). 4h's (4d over an int8 pool) likewise.
    ``tools/chip_kernel_ab.py --rows norm`` times another tree through
    this function, so it calls only what every tree has."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams)
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.ops import activations, rmsnorm
    out = {f"{name} decode": row["kernel"]
           for name, row in decode_shape_rows(torch, dev).items()}
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    x, r, gu = randn(2048, 4096), randn(2048, 4096), randn(2048, 22016)
    w = randn(4096) * 0.1 + 1.0
    out["rmsnorm prefill"] = time_ms(
        torch, lambda: rmsnorm.rmsnorm(x, w, kernels="cuda"), cold=True)
    out["add_residual_rmsnorm prefill"] = time_ms(
        torch, lambda: rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda"),
        cold=True)
    out["silu_and_mul prefill"] = time_ms(
        torch, lambda: activations.silu_and_mul(gu, kernels="cuda"))
    out["A, A with residual, B outputs checksum"] = bits_checksum(torch, [
        t.view(torch.int16) for t in (
            rmsnorm.rmsnorm(x, w, kernels="cuda"),
            *rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda"),
            activations.silu_and_mul(gu, kernels="cuda"))])
    del x, r, gu
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, n).tolist() for n in QUANT_PROMPTS]
    paged = dict(kv_layout="paged", page_size=64, max_prefill_len=64)
    for tag, quant, layout in (("4b", "int4", {}), ("4c", "int8", {}),
                               ("4d", "int4", paged),
                               ("4h", "int4", dict(
                                   paged, kv_cache_dtype_name="int8"))):
        engine = create_engine("llama2-7b", None, EngineConfig(
            quant_mode=quant, max_batch_size=8, max_seq_len=2048, **layout),
            seed=0, device=dev)
        res = engine.generate(prompts, SamplingParams(greedy=True,
                                                      max_new_tokens=16),
                              eos_token_id=None)
        toks = torch.tensor([o[-1] for o in res.token_ids], device=dev,
                            dtype=torch.int32)
        active, sp = np.ones(len(prompts), bool), SamplingParams(greedy=True)
        toks = engine.decode_step(toks, active, sp)   # captures the step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = []
        for _ in range(32):
            toks = engine.decode_step(toks, active, sp)
            ids.append(toks)
        torch.cuda.synchronize()
        out[f"{tag} replayed step wall"] = (time.perf_counter() - t0) / 32 * 1e3
        out[f"{tag} greedy ids checksum"] = bits_checksum(
            torch, [torch.tensor(res.token_ids, device=dev), *ids])
        prof = device_profile(
            torch, lambda: engine.decode_step(toks, active, sp), 4)
        out[f"{tag} replayed step busy"] = prof.busy
        out[f"{tag} replayed step activities"] = prof.activities
        # kernel durations a step: all, and kernel D's and the K/V writes'
        groups = group_ms(prof.per_kernel)
        out[f"{tag} replayed step summed"] = prof.summed
        for g in ("D", "writes"):
            out[f"{tag} replayed step {g}"] = groups[g]
        del engine
        torch.cuda.empty_cache()
    return out


def spec_rows(torch, dev) -> dict:
    """The speculative round's kernels and the round itself, for
    ``tools/chip_kernel_ab.py --rows spec`` (only what every tree has):
    kernel D's fused decode at the draft's shapes (4l: tinyllama B 8, 32 q
    heads over 4 kv heads, head_dim 64; 4q: its tp = 2 rank, 16 over 2;
    4l's contexts) and at GQA_WIDTHS (``gqa_decode_cases``); E and F at
    the verify's m = 40 on QUANT_SHAPES and E at the draft's m = 8 on
    TINY_SHAPES and TINY_TP2_SHAPES (weights cycled past the L2); a
    checksum of D's outputs at the G = 1 shapes of 4a (B 4, 4a's prompt
    lengths + 40), 4b (B 8, 4b's decode contexts), 4d (over a pool of
    page 64) and 4h (an int8 pool), equal in two trees where their bits
    are; then 4l (a)'s
    replayed round (llama2-7b INT4 target, tinyllama-1.1b INT4 draft, B 8,
    k = 4): its wall over 8 rounds and the card's busy ms with its groups
    (KERNEL_GROUPS) over 4 profiled rounds."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import EngineConfig
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.ops import attention, quant
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.runtime.speculative import (
        SpeculativeDecoder)
    gen = torch.Generator(device=dev).manual_seed(4243)
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)
    B, S = 8, 2048
    starts = [n + 40 for n in QUANT_PROMPTS]
    for tag, H, K, D in (("4l tinyllama", 32, 4, 64),
                         ("4q tinyllama tp2", 16, 2, 64)):
        cache = kvc.new_kv_cache(2, B, K, S, D, device=dev)
        cache.k.copy_(randn(2, B, S, K, D))
        cache.v.copy_(randn(2, B, S, K, D))
        q, kn, vn = randn(B, 1, H, D), randn(B, 1, K, D), randn(B, 1, K, D)
        qs = ints(starts)
        out[f"attention_decode {tag}"] = time_ms(
            torch, lambda: attention.attention_decode_fused(
                q, kn, vn, cache.k, cache.v, qs, qs + 1, 1,
                kernels="cuda"), iters=20)
        del cache
    out.update(gqa_decode_cases(torch, dev, {}))
    cases = [(mode, 8 * (SPEC_K + 1), label, QUANT_SHAPES, "verify")
             for mode in ("int4", "int8") for label in QUANT_SHAPES]
    cases += [("int4", 8, label, shapes, tag)
              for shapes, tag in ((TINY_SHAPES, "tinyllama"),
                                  (TINY_TP2_SHAPES, "tinyllama tp2"))
              for label in shapes]
    for mode, m, label, shapes, tag in cases:
        k, n, halves = shapes[label]
        dt = torch.float32 if label == "lm_head" else torch.bfloat16
        ts = quant_weights(torch, quant, dev, gen, mode, k, n, halves,
                           120_000_000)
        x = randn(m, k)
        out[f"{mode}_matmul {tag} m{m} {label}"] = time_ms(torch, cycling(
            ts, lambda t: fused_matmul(quant, t, x, dt, "cuda")), iters=20)
        del ts
    torch.cuda.empty_cache()

    # D's bits at G = 1: 4a, 4b (slot), 4d (pool), 4h (int8 pool)
    def checksum(t) -> float:
        return bits_checksum(torch, [t.view(torch.int16)])
    H = K = 32
    D, page = 128, 64
    hist4b = [p + 16 + f + 16 for p, f in zip(QUANT_PROMPTS, QUANT_FOLLOW)]
    for tag, Bx, hist in (("4a", 4, [7 + 40, 129 + 40, 384 + 40, 700 + 40]),
                          ("4b", 8, hist4b)):
        cache = kvc.new_kv_cache(2, Bx, K, S, D, device=dev)
        cache.k.copy_(randn(2, Bx, S, K, D))
        cache.v.copy_(randn(2, Bx, S, K, D))
        q, kn, vn = randn(Bx, 1, H, D), randn(Bx, 1, K, D), randn(Bx, 1, K, D)
        qs = ints(hist)
        got = attention.attention_decode_fused(q, kn, vn, cache.k, cache.v,
                                               qs, qs + 1, 1,
                                               kernels="cuda")[0]
        out[f"D {tag} output checksum"] = checksum(got)
        del cache
    maxp, P = S // page, 1 + B * S // page
    for tag, int8 in (("4d", False), ("4h", True)):
        table = (torch.randperm(P - 1, generator=gen, device=dev) + 1).to(
            torch.int32).reshape(B, maxp)
        q, kn, vn = randn(B, 1, H, D), randn(B, 1, K, D), randn(B, 1, K, D)
        qs = ints(hist4b)
        if int8:
            kp = torch.randint(-127, 128, (2, P, page, K, D), generator=gen,
                               device=dev, dtype=torch.int8)
            vp = torch.randint(-127, 128, (2, P, page, K, D), generator=gen,
                               device=dev, dtype=torch.int8)
            ks = torch.rand((2, P, page, K), generator=gen, device=dev) / 64
            vs = torch.rand((2, P, page, K), generator=gen, device=dev) / 64
            got = attention.attention_decode_paged_fused(
                q, kn, vn, kp, vp, qs, qs + 1, 1, table=table,
                k_scale=ks, v_scale=vs, kernels="cuda")[0]
        else:
            kp, vp = randn(2, P, page, K, D), randn(2, P, page, K, D)
            got = attention.attention_decode_paged_fused(
                q, kn, vn, kp, vp, qs, qs + 1, 1, table=table,
                kernels="cuda")[0]
        out[f"D {tag} output checksum"] = checksum(got)
        del kp, vp
    torch.cuda.empty_cache()

    # 4l (a)'s replayed round
    eng_cfg = EngineConfig(quant_mode="int4", max_batch_size=B,
                           max_seq_len=S)
    target = create_engine("llama2-7b", None, eng_cfg, seed=0, device=dev)
    draft = create_engine("tinyllama-1.1b", None, eng_cfg, seed=0,
                          device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, n).tolist() for n in QUANT_PROMPTS]
    spec = SpeculativeDecoder(target, draft, SPEC_K)
    res = spec.generate(prompts, SPEC_NEW, eos_token_id=None)   # captures
    from llm_inference_engine_tpu_torch.config import SamplingParams
    greedy = target._host_arrays(SamplingParams(greedy=True))
    last = np.array([t[-1] for t in res.token_ids], np.int32)
    snap = spec_snapshot(spec)
    _, out["4l (a) replayed round wall"] = spec_rounds(
        torch, spec, last, greedy, False, SPEC_ROUNDS, False)
    spec_restore(spec, snap)
    prof = device_profile(torch, lambda: spec.run_round(
        last, np.ones(B, bool), greedy, False), 4)
    out["4l (a) replayed round busy"] = prof.busy
    out["4l (a) replayed round activities"] = prof.activities
    for g, ms in group_ms(prof.per_kernel).items():
        out[f"4l (a) replayed round {g}"] = ms
    del spec, target, draft
    torch.cuda.empty_cache()
    return out


def paged_kernels(quant: dict) -> tuple:
    """The kernels a paged INT4 engine launches, by its KV dtype."""
    kv = INT8_PAGED if quant.get("kv_cache_dtype_name") else BF16_PAGED
    return NORM_ACT + ("int4_matmul",) + kv


def phase_paged_vs_slot(torch, dev, model: str, quant: dict, prompts,
                        greedy_tokens: int, max_seq_len: int = 2048,
                        tag=None):
    """4d (4h with an int8 cache; 4u's Mistral at ``max_seq_len`` 8192): a
    paged engine (page 64) and a slot engine, same kernels, same weights,
    chunks of 64: bit-identical prefill logits and the same greedy ids.
    ``tag`` names the path in the printed lines (default ``paged`` and the
    KV dtype, which ``preset`` reads for a depth cut).
    Returns the paged engine's params for the phases after it."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams)
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

    base = EngineConfig(max_batch_size=len(prompts), max_seq_len=max_seq_len,
                        max_prefill_len=64, **quant)
    greedy = SamplingParams(greedy=True, max_new_tokens=greedy_tokens)
    paged = create_engine(preset(model, tag), None,
                          base.replace(kv_layout="paged", page_size=64),
                          seed=0, device=dev)
    cfg = paged.config
    B = len(prompts)
    say(f"  paged engine: {model} {quant}, B={B}, {cfg.num_layers} layers, "
        f"{paged.cache.num_pages} pages of 64, pool "
        f"{kv_bytes(paged.cache) / 1e9:.2f} GB")
    counters = _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = paged.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    paged.reset()
    rp = paged.generate(prompts, greedy, eos_token_id=None)
    # steady decode, eager bodies against replays, and generate's tail
    # cases (graph_checks)
    active = np.ones(B, bool)
    toks = torch.tensor([o[-1] for o in rp.token_ids], device=dev,
                        dtype=torch.int32)
    sp = SamplingParams(greedy=True)
    kv = "int4-kv8" if quant.get("kv_cache_dtype_name") else "int4"
    tag = tag or f"paged {kv}"
    graph_checks(torch, paged, tag, toks, active, prompts)
    _check_paged_launches(f"the paged engine {quant}", counters,
                          paged_kernels(quant))
    # the launches of one decode step and of one warm prefill of the
    # prompts, the prefill profiled
    _zero_counters()
    paged.decode_step(toks, active, sp)
    per_step = _launch_counts(counters)
    paged.reset()
    _zero_counters()
    prefill = device_profile(torch, lambda: paged.prefill(prompts), 1)
    per_prefill = _launch_counts(counters)
    say(f"  launches per paged prefill of the {B} prompts: "
        f"{per_prefill}; per paged decode step: {per_step}")
    L = cfg.num_layers
    check_norm_launches(f"{tag} prefill", per_prefill, L)
    check_norm_launches(f"{tag} decode step", per_step, L, 1)
    check_decode_step_launches(f"{tag} decode step", [per_step], L,
                               int8=bool(quant.get("kv_cache_dtype_name")))
    say(f"  warm paged prefill: card busy {prefill.busy:.3f} ms (kernel "
        f"durations summed {prefill.summed:.3f}); by group: "
        f"{_groups(prefill.per_kernel)}; by kernel: "
        + "; ".join(f"{_short(name)} {ms:.3f}"
                    for ms, name in prefill.per_kernel[:8]))
    params = paged.params
    del paged
    torch.cuda.empty_cache()

    slot = InferenceEngine(cfg, base, params, device=dev)
    ls = slot.prefill(prompts)
    slot.reset()
    rs = slot.generate(prompts, greedy, eos_token_id=None)
    del slot
    torch.cuda.empty_cache()
    say(f"  paged prefill of {B} prompts ({sum(map(len, prompts))} tokens) "
        f"{prefill_s:.3f} s (first use of each shape)")
    same_ids = rp.token_ids == rs.token_ids
    say(f"  paged vs slot: prefill logits torch.equal {torch.equal(lp, ls)} "
        f"(max abs diff {(lp - ls).abs().max().item():.3e}); "
        f"{greedy_tokens} greedy ids equal {same_ids}; "
        f"tokens[0][:8] {rp.token_ids[0][:8]}")
    if not torch.equal(lp, ls) or not same_ids:
        raise AssertionError("paged engine differs from the slot engine")
    return params


def _percentiles(xs):
    import numpy as np
    return " / ".join(f"{np.percentile(xs, q):.3f}" for q in (50, 90, 99))


def int8_pool_pages(cfg) -> int:
    """4i's page count: an int8 pool of the bytes of 4e's 193 pages of 64
    (a page's values at 1 byte and its scales at 4 bytes per (token, head),
    against 2 bytes a value)."""
    page_heads = 2 * cfg.num_layers * 64 * cfg.num_kv_heads
    return 193 * page_heads * cfg.head_dim * 2 // (
        page_heads * (cfg.head_dim + 4))


def phase_server(torch, dev, results, model: str, quant: dict, params,
                 num_pages: int = 193, n_wave1: int = 24, n_wave2: int = 8,
                 expect_page_waits: bool = True):
    """4e: the port's HTTP server in-process over the scheduler and a
    paged engine (B=16, 193 pages of 64: 12288 tokens, against 32768 for
    a slot cache, so pages bound concurrency), automatic prefix cache on.
    Wave 1: concurrent greedy completions, prompts of 16-1200 ids and
    16-96 tokens from seed 0, all enqueued before the engine thread
    starts so the scheduler sees them in order. Wave 2: multi-turn
    resends (a wave-1 prompt + its answer + a short suffix) of the
    requests that finished last. Then wave 1 runs again through a fresh
    scheduler in-process with the decode bodies eager: every request's ids
    equal the server's. 4i runs wave 1 alone over an int8 pool of the same
    bytes (``num_pages`` ~2x), where admission need not wait for pages.
    The paged kernels' launches go into the JSON line where PATH_OF names
    this server path (``server`` / ``server-kv8``, llama2-7b's, 4e and 4i;
    another model's is ``<model> server``, as the main paths are named).
    Each wave's tok/s and TTFT p50 / p99 go into SERVED. Returns the
    engine."""
    import http.client
    import threading

    import numpy as np

    from llm_inference_engine_tpu_torch.cli import _IdTokenizer
    from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
    from llm_inference_engine_tpu_torch.runtime.chat_template import (
        get_chat_template)
    from llm_inference_engine_tpu_torch.runtime.decode_graph import (
        run_eagerly)
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    from llm_inference_engine_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)
    from llm_inference_engine_tpu_torch.server import make_server

    cfg = get_config(model)
    eng = EngineConfig(max_batch_size=16, max_seq_len=2048,
                       kv_layout="paged", page_size=64, num_pages=num_pages,
                       **quant)
    engine = InferenceEngine(cfg, eng, params, device=dev)
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None,
                                        auto_prefix_cache=True)
    # instrumentation of this check only: the Request of every submit, the
    # ids of the requests that found a free slot but too few free pages
    # (admission stops at the head of the queue), and the count and host
    # seconds of the scheduler's steps, pure decode (a replay) or mixed
    # (eager prefill chunks beside decode rows)
    requests, page_waits = [], set()
    steps = {"decode": [0, 0.0], "mixed": [0, 0.0]}
    submit, assign = sched.submit, sched._assign_slots
    sched_step, decode_phase = sched.step, sched._decode_phase
    kind = []

    def timed_step():
        kind.clear()
        t0 = time.perf_counter()
        done = sched_step()
        entry = steps["decode" if kind else "mixed"]
        entry[0] += 1
        entry[1] += time.perf_counter() - t0
        return done

    def noted_decode_phase():
        kind.append(1)
        return decode_phase()
    sched.step, sched._decode_phase = timed_step, noted_decode_phase
    decode_steps = decode_phase_launches(sched, _counters())

    def recording_submit(*a, **kw):
        requests.append(submit(*a, **kw))
        return requests[-1]

    def counting_assign():
        admitted = assign()
        if sched.waiting and any(r is None for r in sched.slots):
            page_waits.add(sched.waiting[0].id)
        return admitted
    sched.submit, sched._assign_slots = recording_submit, counting_assign
    httpd, llm = make_server(sched, _IdTokenizer(cfg.vocab_size),
                             get_chat_template("plain"), model,
                             host="127.0.0.1", port=0, max_queue=64)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    addr = httpd.server_address
    say(f"  server on {addr[0]}:{addr[1]}: {model} {quant}, B=16, "
        f"{num_pages} pages of 64 ({kv_bytes(engine.cache) / 1e9:.2f} GB "
        "pool), auto prefix cache")

    def post(body, out, i):
        conn = http.client.HTTPConnection(*addr, timeout=300)
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out[i] = (resp.status, json.loads(resp.read()))
        conn.close()

    def wave(bodies, ordered: bool):
        out = [None] * len(bodies)
        threads = [threading.Thread(target=post, args=(b, out, i))
                   for i, b in enumerate(bodies)]
        for i, t in enumerate(threads):
            t.start()
            while ordered and llm._submit_q.qsize() < i + 1:
                time.sleep(0.001)
        return threads, out

    def check(bodies, out, tag):
        for body, (status, resp) in zip(bodies, out):
            usage = resp.get("usage", {})
            text = resp["choices"][0]["text"] if status == 200 else ""
            if (status != 200 or usage["prompt_tokens"] != len(body["prompt"])
                    or usage["completion_tokens"] != body["max_tokens"]
                    or len(text.split()) != body["max_tokens"]
                    or usage["total_tokens"] != len(body["prompt"])
                    + body["max_tokens"]):
                raise AssertionError(f"{tag}: bad response {status} {usage}")

    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1201, n_wave1)
    max_tokens = rng.integers(16, 97, n_wave1)
    bodies1 = [dict(prompt=rng.integers(3, cfg.vocab_size, n).tolist(),
                    max_tokens=int(m), temperature=0.0)
               for n, m in zip(lens, max_tokens)]
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    threads, out1 = wave(bodies1, ordered=True)
    t0 = time.perf_counter()
    llm.start()
    for t in threads:
        t.join()
    wall1 = time.perf_counter() - t0
    check(bodies1, out1, "wave 1")
    wave1 = list(requests)
    waves = [("wave 1", wave1, wall1)]
    if n_wave2:
        last = sorted(wave1, key=lambda r: r.finish_time)[-n_wave2:]
        bodies2 = [dict(prompt=r.prompt_ids + r.output_ids
                        + rng.integers(3, cfg.vocab_size, 5).tolist(),
                        max_tokens=16, temperature=0.0) for r in last]
        threads, out2 = wave(bodies2, ordered=False)
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        waves.append(("wave 2", requests[len(wave1):],
                      time.perf_counter() - t0))
        check(bodies2, out2, "wave 2")
    while sched.has_work:
        time.sleep(0.01)
    peak = torch.cuda.max_memory_allocated()
    httpd.shutdown()
    httpd.server_close()
    llm.shutdown()
    server.join()
    expected = paged_kernels(quant)
    launches = _check_paged_launches(f"the server {quant}", counters,
                                     expected + ("dequant_int4",))
    check_decode_step_launches(f"the server {quant}", decode_steps,
                               cfg.num_layers,
                               int8=bool(quant.get("kv_cache_dtype_name")))
    kv = "int4-kv8" if quant.get("kv_cache_dtype_name") else "int4"
    path = "server-kv8" if kv == "int4-kv8" else "server"
    if model != "llama2-7b":
        path = f"{model} {path}"
    for name in expected:
        if PATH_OF[name] == path:
            results.setdefault(name, {})["launches"] = launches[name]
    ap = sched.auto_prefix
    reused = [r.reused_prefix_len for r in requests[len(wave1):]]
    for tag, reqs, wall in waves:
        gen = sum(len(r.output_ids) for r in reqs)
        ttft = [r.ttft for r in reqs]
        SERVED.setdefault(f"{model} {kv}", {})[tag] = (
            gen / wall, *np.percentile(ttft, (50, 99)).tolist())
        say(f"  {tag}: {len(reqs)} requests, "
            f"{sum(len(r.prompt_ids) for r in reqs)} prompt tokens, {gen} "
            f"generated in {wall:.3f} s ({gen / wall:.1f} generated tok/s); "
            f"TTFT p50/p90/p99 {_percentiles([r.ttft for r in reqs])} s; "
            f"e2e p50/p90/p99 {_percentiles([r.e2e_latency for r in reqs])} s")
    say(f"  scheduler steps (both waves): {steps['decode'][0]} pure decode "
        f"(replays) in {steps['decode'][1]:.3f} s, {steps['mixed'][0]} mixed "
        f"(eager) in {steps['mixed'][1]:.3f} s, host clock")
    say(f"  requests that waited for pages with a slot free: "
        f"{len(page_waits)}; preemptions "
        f"{sum(r.preemptions for r in requests)}; wave-2 reused prefix "
        f"lengths {reused}; prefix cache hits {ap.hits}, misses {ap.misses},"
        f" {ap.tokens_reused} tokens reused; peak memory "
        f"{peak / 2**30:.2f} GiB")
    say(f"  after the waves: free pages {engine.free_pages} + cached "
        f"{ap.cached_pages} = {engine.free_pages + ap.cached_pages} "
        f"(pool {engine._allocator.num_pages - 1} usable)")
    if expect_page_waits and not page_waits:
        raise AssertionError("no admission waited for pages")
    if n_wave2 and not any(n > 0 for n in reused):
        raise AssertionError("wave 2 reused no cached prefix")
    if engine.free_pages + ap.cached_pages != engine._allocator.num_pages - 1:
        raise AssertionError("pages leaked")
    ap.clear()
    # wave 1 again, in this thread, through a fresh scheduler with every
    # decode body eager: the same submissions in the same order take the
    # same steps, so each request's ids equal the server's (its pure-decode
    # steps replayed)
    eager = ContinuousBatchingScheduler(engine, eos_token_id=None,
                                        auto_prefix_cache=True)
    with run_eagerly(engine):
        again = [eager.submit(r.prompt_ids, r.sampling) for r in wave1]
        while eager.has_work:
            eager.step()
    differ = [i for i, (a, r) in enumerate(zip(again, wave1))
              if a.output_ids != r.output_ids]
    say(f"  wave 1 again with eager decode bodies: ids equal the server's "
        f"in {len(wave1) - len(differ)} of {len(wave1)} requests")
    if differ:
        raise AssertionError(f"the server's ids differ from eager ones in "
                             f"requests {differ}")
    eager.auto_prefix.clear()
    return engine


def _first_token_logits(torch, cfg, eng_cfg, params, prompts, dev, **kw):
    """Prefill logits of ``prompts`` on a fresh engine (the plain paths'
    reference runs)."""
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    engine = InferenceEngine(cfg, eng_cfg.replace(**kw), params, device=dev)
    logits = engine.prefill(prompts)
    del engine
    torch.cuda.empty_cache()
    return logits


def phase_preemption(torch, dev, model: str, engine, n: int = 16,
                     prompt_len: int = 700, new_tokens: int = 96) -> None:
    """4f: the scheduler alone on the server's engine (192 usable pages):
    16 prompts of 700 tokens fit at admission (11 pages each), their full
    lengths (13 pages each) do not, so the newest requests are preempted
    and recomputed. The kernel path's prefill logits must agree with the
    plain path's within LOGIT_ATOL / LOGIT_REL_L2, then first tokens are
    held against the plain path under the f32 tie rule of 4b."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import SamplingParams, get_config
    from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
    from llm_inference_engine_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)

    cfg = get_config(model)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, prompt_len).tolist()
               for _ in range(n)]
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    sp = SamplingParams(greedy=True, max_new_tokens=new_tokens)
    counters = _zero_counters()
    reqs = [sched.submit(p, sp) for p in prompts]
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_paged_launches("preemption (4f)", counters,
                          paged_kernels(dict(quant_mode="int4")))
    preempted = [r.preemptions for r in reqs]
    say(f"  {n} x {prompt_len}-token prompts, {new_tokens} tokens each: "
        f"{wall:.3f} s; preemptions per request {preempted}; free pages "
        f"{engine.free_pages} of {engine._allocator.num_pages - 1}")
    if (sum(preempted) == 0 or not all(r.finished for r in reqs)
            or any(len(r.output_ids) != new_tokens for r in reqs)
            or engine.free_pages != engine._allocator.num_pages - 1):
        raise AssertionError("preemption phase: no preemption, an "
                             "unfinished request, or a leaked page")
    # first tokens: the kernel path's prefill vs the plain path, with the
    # plain path in f32 as the arbiter of ties
    eng_cfg = engine.engine_config.replace(num_pages=0)
    logits = _first_token_logits(torch, cfg, eng_cfg, engine.params, prompts,
                                 dev)

    def up(v):
        return v if isinstance(v, QuantizedTensor) else v.float()
    params32 = {k: ({m: up(w) for m, w in v.items()}
                    if isinstance(v, dict) else up(v))
                for k, v in engine.params.items()}
    logits_t = _first_token_logits(torch, cfg, eng_cfg, engine.params,
                                   prompts, dev, kernels="torch")
    logits_32 = _first_token_logits(torch, cfg.replace(dtype_name="float32"),
                                    eng_cfg, params32, prompts, dev,
                                    kernels="torch")
    del params32
    d_kt, r_kt = _logit_diff(logits, logits_t)
    say(f"  prefill logits, kernels vs torch: max abs {d_kt:.4e}, rel L2 "
        f"{r_kt:.4e} (limits {LOGIT_ATOL}, {LOGIT_REL_L2})")
    if d_kt > LOGIT_ATOL or r_kt > LOGIT_REL_L2:
        raise AssertionError("preemption phase: prefill logits disagree "
                             "with the plain path")
    # the tie rule applies only once the logits agree within the limits
    top2, top2_ids = logits_32.topk(2, dim=-1)
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    first = [r.output_ids[0] for r in reqs]
    plain = logits_t.argmax(-1).tolist()
    bad = [i for i in range(n) if first[i] != plain[i]
           and not (margins[i] < d_kt and first[i] in top2_ids[i].tolist())]
    say(f"  first tokens vs the plain path: rows that differ "
        f"{[i for i in range(n) if first[i] != plain[i]]}; outside the tie "
        f"rule {bad}")
    if bad:
        raise AssertionError(f"preemption phase: first tokens differ from "
                             f"the plain path in rows {bad}")


# 4k: a checkpoint on disk. The system prompt and the tails of the 8
# requests that share it (c), and the chat turns of the session (d).
SYSTEM_LEN = 320
PREFIX_TAILS = (5, 17, 33, 64, 90, 128, 160, 200)
CHAT_TURNS = ("What does a tokenizer do?", "Say it in fewer words.",
              "And what does the cache keep?")
SPM_ASSET = "tests/assets/tiny_spm_bpe.model"
# 4k's depth: llama2-7b's full width at 4 layers (as 4r's), written as an
# HF directory of 1.7 GB and a .npz of 0.5 GB; 4k's every check runs on it
CKPT_LAYERS = 4
CKPT_FREE_GB = 6      # 1.7 GB of shards and a 0.5 GB .npz, with room


def hf_tensors(cfg, params, layers) -> dict:
    """The HF-format tensors of ``layers`` of a fused bf16 ``params``:
    unfused q/k/v and gate/up projections, [out, in], as views on the card
    (the writer copies each to the host in turn)."""
    K, D, Hd = cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    G = cfg.num_heads // K
    lp = params["layers"]
    out = {}
    for l in layers:
        p = f"model.layers.{l}."
        qkv = lp["wqkv"][l].view(Hd, K, G + 2, D)
        out.update({
            p + "self_attn.q_proj.weight": qkv[:, :, :G].reshape(Hd, -1).T,
            p + "self_attn.k_proj.weight": qkv[:, :, G].reshape(Hd, -1).T,
            p + "self_attn.v_proj.weight":
                qkv[:, :, G + 1].reshape(Hd, -1).T,
            p + "self_attn.o_proj.weight": lp["wo"][l].T,
            p + "mlp.gate_proj.weight": lp["w_gate_up"][l][:, 0].T,
            p + "mlp.up_proj.weight": lp["w_gate_up"][l][:, 1].T,
            p + "mlp.down_proj.weight": lp["w_down"][l].T,
            p + "input_layernorm.weight": lp["attn_norm"][l],
            p + "post_attention_layernorm.weight": lp["ffn_norm"][l]})
    return out


def write_hf_checkpoint(cfg, params, path: Path) -> int:
    """``params`` as an HF-format directory of two BF16 shards (the
    embedding and the first half of the layers; the second half, the
    final norm and the lm_head), written with no ``safetensors`` package.
    Returns the bytes written."""
    from llm_inference_engine_tpu_torch.runtime.native_io import (
        write_safetensors)
    L = cfg.num_layers
    shards = (
        {"model.embed_tokens.weight": params["embed"],
         **hf_tensors(cfg, params, range(L // 2))},
        {**hf_tensors(cfg, params, range(L // 2, L)),
         "model.norm.weight": params["final_norm"],
         "lm_head.weight": params["lm_head"].T})
    return sum(write_safetensors(
        str(path / f"model-{i + 1:05d}-of-00002.safetensors"), shard)
        for i, shard in enumerate(shards))


class RssPeak:
    """The process's resident set at entry (``base``) and its peak while
    the block runs, sampled every 2 ms from /proc/self/statm (bytes)."""

    def __enter__(self):
        import threading
        self._page = os.sysconf("SC_PAGE_SIZE")
        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def unequal_leaves(torch, got: dict, want: dict, prefix: str = "") -> list:
    """Names of the leaves of two parameter dicts that differ in any bit
    (a quantized leaf: its q, scale, mode or group)."""
    from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor

    def same(a, b):
        bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}
        return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.contiguous().view(bits[a.element_size()]),
            b.contiguous().view(bits[b.element_size()])))
    bad = [prefix + k for k in got if k not in want]
    for k, w in want.items():
        g, name = got.get(k), prefix + k
        if isinstance(w, dict):
            bad += unequal_leaves(torch, g or {}, w, name + ".")
        elif isinstance(w, QuantizedTensor):
            if not (isinstance(g, QuantizedTensor)
                    and (g.mode, g.group_size) == (w.mode, w.group_size)
                    and same(g.q, w.q) and same(g.scale, w.scale)):
                bad.append(name)
        elif g is None or not same(g, w):
            bad.append(name)
    return bad


def ckpt_dir() -> Path:
    """A scratch directory for 4k's files on the file system with the most
    room (the system temp dir or the checkout's build/)."""
    import shutil
    import tempfile
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    base = max((Path(tempfile.gettempdir()), build),
               key=lambda p: shutil.disk_usage(p).free)
    free = shutil.disk_usage(base).free / 1e9
    say(f"  scratch for the checkpoint: {base} ({free:.1f} GB free)")
    if free < CKPT_FREE_GB:
        raise AssertionError(f"4k needs {CKPT_FREE_GB} GB of disk, "
                             f"{free:.1f} GB free under {base}")
    return Path(tempfile.mkdtemp(prefix="llm_ckpt_", dir=base))


def phase_checkpoint(torch, dev) -> None:
    """4k: llama2-7b at full width and CKPT_LAYERS layers from a
    checkpoint on disk, the model named by a config JSON beside it (as
    every entry point takes it); (a) seed-0 bf16 dummy weights written as
    an HF directory and loaded INT4 through ``create_engine``: bit for bit
    ``quantize_params`` of the same weights, and the in-memory engine's
    greedy ids on 4b's prompts; (b) the offline quantizer's .npz, and the
    chat CLI over it in a subprocess; (c) and (d) on the loaded engine, and
    (c) again on an INT8 engine loaded from the same directory."""
    import gc
    import shutil

    import numpy as np

    from llm_inference_engine_tpu_torch import native
    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.models import weights as W
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.runtime import native_io
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    from llm_inference_engine_tpu_torch.tools import quantize

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama2-7b").replace(num_layers=CKPT_LAYERS)
    eng_cfg = EngineConfig(quant_mode="int4", max_batch_size=8,
                           max_seq_len=2048)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, n).tolist() for n in QUANT_PROMPTS]
    greedy = SamplingParams(greedy=True, max_new_tokens=16)
    tmp = ckpt_dir()
    try:
        # (a) write, the in-memory reference, load
        model = str(tmp / f"llama2-7b-{CKPT_LAYERS}l.json")
        Path(model).write_text(json.dumps(dataclasses.asdict(cfg)))
        say(f"  llama2-7b at {CKPT_LAYERS} layers, full width ({model})")
        ckpt = tmp / "llama2-7b-hf"
        ckpt.mkdir()
        params = W.init_dummy_params(cfg, seed=0, device=dev)
        t0 = time.perf_counter()
        nbytes = write_hf_checkpoint(cfg, params, ckpt)
        say(f"  (a) wrote {nbytes / 1e9:.3f} GB as 2 BF16 shards in "
            f"{time.perf_counter() - t0:.2f} s")
        want = W.quantize_params(params, "int4", eng_cfg.quant_group_size)
        del params
        ref = InferenceEngine(cfg, eng_cfg, want, device=dev)
        want_ids = ref.generate(prompts, greedy, eos_token_id=None).token_ids
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        counters = _zero_counters()
        before = dict(native_io.READ_BYTES)
        torch.cuda.synchronize()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            engine = create_engine(model, str(ckpt), eng_cfg, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        read = {k: native_io.READ_BYTES[k] - before[k] for k in before}
        lib = Path(native.library_path() or ".")
        say(f"  (a) create_engine from the directory (INT4 on load, warm: "
            f"the shards were just written, so they are read from the page "
            f"cache): {load_s:.3f} s, {read['native'] / 1e9 / load_s:.3f} "
            f"GB/s of file; bytes read by the native reader {read['native']}, by "
            f"Python {read['python']}; native library {lib}; host RSS "
            f"{rss.base / 2**30:.3f} GiB before, peak "
            f"{rss.peak / 2**30:.3f} GiB during the load")
        if (read["python"] or read["native"] < 0.99 * nbytes
                or lib.parent != ROOT / "build" / "native"):
            raise AssertionError(f"4k: the native reader did not read the "
                                 f"checkpoint ({read}, library {lib})")
        bad = unequal_leaves(torch, engine.params, want)
        if bad:
            raise AssertionError(f"4k: loaded INT4 leaves differ from "
                                 f"quantize_params of the weights: {bad}")
        say("  (a) every loaded leaf equals quantize_params of the dummy "
            "weights bit for bit")
        got_ids = engine.generate(prompts, greedy, eos_token_id=None).token_ids
        launches = {k: f.launches for k, f in counters.items()}
        say(f"  (a) launches during the load and generate: {launches}")
        expected, forbidden = MAIN_PATHS["int4"]
        missing = [n for n in expected if launches[n] <= 0]
        extra = [n for n in forbidden if launches[n]]
        if missing or extra:
            raise AssertionError(f"4k: kernels never launched {missing}; "
                                 f"kernels that must not launch {extra}")
        say(f"  (a) greedy ids[0][:8] {got_ids[0][:8]}; equal to the "
            f"in-memory engine's on 4b's prompts: {got_ids == want_ids}")
        if got_ids != want_ids:
            raise AssertionError("4k: greedy ids of the loaded engine differ "
                                 "from the in-memory engine's")

        # (c) and (d) on the loaded INT4 engine; (c) again on an INT8 engine
        # loaded from the same directory with chunks of 1024, so that every
        # prompt prefills in one chunk and the scheduler runs with and
        # without the store take steps of the same shapes: their ids must
        # be equal (at chunks of 512 the 520-token prompt's second chunk
        # makes a mixed step that the run with the store does not take)
        prefix = prefix_prompts(rng)
        prefix_store_rows(torch, engine, prefix, hold_ids=False)
        chat_session_rows(torch, engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        engine = create_engine(
            model, str(ckpt),
            eng_cfg.replace(quant_mode="int8", max_prefill_len=1024),
            device=dev)
        torch.cuda.synchronize()
        say(f"  (c) create_engine from the directory (INT8 on load, chunks "
            f"of 1024; warm: the shards are in the page cache): "
            f"{time.perf_counter() - t0:.3f} s")
        prefix_store_rows(torch, engine, prefix, hold_ids=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the offline quantizer, and the chat CLI over its .npz
        npz = tmp / "llama2-7b-int4.npz"
        t0 = time.perf_counter()
        if quantize.main(["--model", model, "--checkpoint", str(ckpt),
                          "--mode", "int4", "--out", str(npz)]) != 0:
            raise AssertionError("4k: tools/quantize failed")
        say(f"  (b) tools/quantize: {npz.stat().st_size / 1e9:.3f} GB .npz "
            f"in {time.perf_counter() - t0:.2f} s")
        shutil.rmtree(ckpt)
        bad = unequal_leaves(torch, W.load_saved_params(str(npz), dev), want)
        del want
        gc.collect()
        torch.cuda.empty_cache()
        if bad:
            raise AssertionError(f"4k: the .npz differs from quantize_params "
                                 f"in {bad}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "llm_inference_engine_tpu_torch.cli",
             "--model", model, "--checkpoint", str(npz),
             "--tokenizer", SPM_ASSET, "--quant", "int4", "--greedy",
             "--max-new-tokens", "16"],
            input=f"{CHAT_TURNS[0]}\n{CHAT_TURNS[1]}\ns\n", cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        replies = proc.stdout.split("ready.", 1)[-1].split(
            "please input the question: ")[1:]
        say(f"  (b) chat CLI over the .npz and {SPM_ASSET}: exit "
            f"{proc.returncode} in {time.perf_counter() - t0:.2f} s; "
            f"replies {replies}")
        if (proc.returncode != 0 or len(replies) != 3
                or not all(r.startswith(":") and r.endswith("\n")
                           for r in replies[:2])):
            raise AssertionError(f"4k: the chat CLI failed or broke the "
                                 f"streaming protocol:\n{proc.stdout[-2000:]}"
                                 f"\n{proc.stderr[-4000:]}")
        # the same over two beams
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "llm_inference_engine_tpu_torch.cli",
             "--model", model, "--checkpoint", str(npz),
             "--tokenizer", SPM_ASSET, "--quant", "int4", "--beams", "2",
             "--max-new-tokens", "16"],
            input=f"{CHAT_TURNS[0]}\ns\n", cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        replies = proc.stdout.split("ready.", 1)[-1].split(
            "please input the question: ")[1:]
        say(f"  (b) chat CLI --beams 2 over the .npz: exit {proc.returncode} "
            f"in {time.perf_counter() - t0:.2f} s; replies {replies}")
        if (proc.returncode != 0 or len(replies) != 2
                or not (replies[0].startswith(":")
                        and replies[0].endswith("\n"))):
            raise AssertionError(f"4k: the chat CLI with --beams 2 failed:"
                                 f"\n{proc.stdout[-2000:]}"
                                 f"\n{proc.stderr[-4000:]}")
        npz.unlink()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def prefix_prompts(rng) -> dict:
    """4k (c)'s token ids: the system prompt, the 8 tails, and a second
    system prompt of the same length for the misread-prefix control."""
    return dict(system=rng.integers(3, 32000, SYSTEM_LEN).tolist(),
                tails=[rng.integers(3, 32000, n).tolist()
                       for n in PREFIX_TAILS],
                other=rng.integers(3, 32000, SYSTEM_LEN).tolist())


def snapshot_parts(cache, slot: int, entry) -> list:
    """(shard, local row, snapshot part) of ``slot``: the cache and the
    entry of one device, or one a model rank over a mesh's ``MeshCache``
    (a ``MeshPrefixEntry``)."""
    if hasattr(cache, "slot_shards"):
        row, shards = cache.slot_shards(slot)
        return [(s, row, part) for s, part in zip(shards, entry.parts)]
    return [(cache, slot, entry)]


def restored_exactly(torch, cache, slot: int, entry) -> bool:
    """Every row (and an int8 cache's scale row) of ``entry`` lies in
    ``slot`` bit for bit, shard by shard."""
    return all(torch.equal(getattr(s, n)[:, row, :part.padded_length],
                           getattr(part, n))
               for s, row, part in snapshot_parts(cache, slot, entry)
               for n in ("k", "v", "k_scale", "v_scale")
               if getattr(part, n) is not None)


def prefix_store_rows(torch, engine, prefix: dict, hold_ids: bool,
                      tag: str = "", limits=(LOGIT_ATOL, LOGIT_REL_L2)
                      ) -> None:
    """4k (c): a 320-token system prompt registered through the scheduler
    (the slot PrefixStore) on a loaded engine, then 8 requests that share
    it. The restore must be an exact byte copy; the tails' prefill logits
    must agree with the full prompts' within ``limits`` (max abs, rel L2;
    LOGIT_ATOL / LOGIT_REL_L2 unless given),
    and first tokens under the tie rule (the full prompts' top two within
    the largest logit difference). Two controls prefill the same tails
    over a wrong prefix (its K/V zeroed; another prompt's K/V): each must
    leave the limits, or the limits could not see a tail prefill that
    ignores the restored rows. The scheduler's greedy ids with and
    without the store are compared position by position; with
    ``hold_ids`` (an engine whose chunks take every prompt whole) they
    must be equal. A mesh engine's cache is held shard by shard (4q)."""
    from llm_inference_engine_tpu_torch.config import SamplingParams
    from llm_inference_engine_tpu_torch.runtime.prefix_cache import (
        restore_prefix, snapshot_prefix)
    from llm_inference_engine_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)

    system, tails = prefix["system"], prefix["tails"]
    prompts = [system + t for t in tails]
    B = len(prompts)
    tag = tag or "(c) " + engine.engine_config.quant_mode.upper()
    phase_tag = tag.split(" ")[0] if tag.startswith("4") else "4k"
    atol, rel = limits
    engine.reset()
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    entry = sched.register_prefix(system)
    store = sched.prefix_store
    # the restore: an exact copy, then its time against the copy bound
    store.restore(B - 1, entry)
    c = engine.cache
    tpad = entry.padded_length
    exact = (restored_exactly(torch, c, B - 1, entry)
             and int(c.lengths[B - 1]) == engine._lengths[B - 1]
             == SYSTEM_LEN)
    ms = time_ms(torch, lambda: restore_prefix(c, B - 1, entry), iters=20)
    kv = sum(part.k.nbytes + part.v.nbytes
             for _, _, part in snapshot_parts(c, B - 1, entry))
    moved = 2 * kv                                    # read + write
    bound = moved / HBM_BYTES_PER_S * 1e3
    say(f"  {tag}: restore of {SYSTEM_LEN} tokens ({kv} bytes of K/V, "
        f"padded to {tpad}): exact copy {exact}; {ms:.4f} ms, "
        f"{moved / ms / 1e6:.1f} GB/s read + write; bound {bound:.4f} ms "
        f"(bytes, {bound / ms:.2f} of it)")
    if not exact:
        raise AssertionError(f"{phase_tag}: the restored rows differ from the "
                             "snapshot")
    # the misread-prefix control: another system prompt's K/V, same length
    engine.reset()
    engine.prefill([prefix["other"]])
    other = snapshot_prefix(engine.cache, 0, SYSTEM_LEN)

    def prefill_full():
        engine.reset()
        return engine.prefill(prompts)

    def prefill_over(e, zero=False):
        def run():
            engine.reset()
            for s in range(B):
                store.restore(s, e)
                if zero:
                    for sh, row, _ in snapshot_parts(engine.cache, s, e):
                        sh.k[:, row, :tpad].zero_()
                        sh.v[:, row, :tpad].zero_()
            return engine.prefill(tails)
        return run

    def prefill_reused():
        engine.reset()
        for s in range(B):
            store.restore(s, entry)
        return engine.prefill(tails)
    walls = {}
    for name, fn in (("full", prefill_full), ("reused", prefill_reused)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0, logits)
    lg_full, lg_reused = walls["full"][1], walls["reused"][1]
    d, r = _logit_diff(lg_reused, lg_full)
    top2, top2_ids = lg_full.topk(2, dim=-1)
    margins = (top2[:, 0] - top2[:, 1]).tolist()

    first_full = lg_full.argmax(-1).tolist()
    first_reused = lg_reused.argmax(-1).tolist()
    differ = [i for i in range(B) if first_full[i] != first_reused[i]]
    bad = [i for i in differ if not (margins[i] < d and first_reused[i]
                                     in top2_ids[i].tolist())]
    say(f"  {tag}: warm prefill of the 8 prompts ({sum(map(len, prompts))} "
        f"tokens): {walls['full'][0] * 1e3:.2f} ms; 8 restores + the tails "
        f"({sum(PREFIX_TAILS)} tokens): {walls['reused'][0] * 1e3:.2f} ms; "
        f"logits max abs {d:.4e}, rel L2 {r:.4e} (limits {atol}, "
        f"{rel}); first tokens that differ {differ}, outside the "
        f"tie rule {bad}")
    if d > atol or r > rel or bad:
        raise AssertionError(f"{phase_tag}: prefix reuse moved the logits past the "
                             "limits or a first token outside the tie rule")
    controls = {name: _logit_diff(prefill_over(e, zero)(), lg_full)
                for name, e, zero in (("prefix K/V zeroed", entry, True),
                                      ("another prompt's prefix", other,
                                       False))}
    blind = [k for k, (dc, rc) in controls.items()
             if dc <= atol and rc <= rel]
    say(f"  {tag}: controls, the tails over a wrong prefix against the full "
        f"prompts (max abs / rel L2): " + "; ".join(
            f"{k} {dc:.4e} / {rc:.4e}" for k, (dc, rc) in controls.items())
        + f"; inside the limits: {blind}")
    if blind:
        raise AssertionError(f"{phase_tag}: the logit limits cannot see a wrong "
                             f"prefix: {blind}")
    del other

    def serve(prefix_store):
        engine.reset()
        s = ContinuousBatchingScheduler(engine, eos_token_id=None,
                                        prefix_store=prefix_store)
        reqs = [s.submit(p, SamplingParams(greedy=True, max_new_tokens=16))
                for p in prompts]
        s.run()
        torch.cuda.synchronize()
        return reqs
    runs = {}
    for name, st in (("without", None), ("with", store)) * 2:
        runs[name] = serve(st)
    skipped = sum(q.reused_prefix_len for q in runs["with"])
    ttft = {k: 1e3 * sum(q.ttft for q in v) / B for k, v in runs.items()}
    agree = sum(a == b for x, y in zip(runs["with"], runs["without"])
                for a, b in zip(x.output_ids, y.output_ids))
    same = sum(x.output_ids == y.output_ids
               for x, y in zip(runs["with"], runs["without"]))
    say(f"  {tag}: scheduler, 8 requests sharing the prefix (tails "
        f"{list(PREFIX_TAILS)}, chunks of "
        f"{engine.engine_config.max_prefill_len}): prefill tokens skipped "
        f"{skipped}; mean TTFT {ttft['with']:.2f} ms with the store, "
        f"{ttft['without']:.2f} ms without; greedy tokens equal position by "
        f"position {agree}/{16 * B}, requests with all 16 equal {same}/{B}"
        + ("" if hold_ids else " (printed only: a prompt of two chunks "
           "makes a mixed step only the run without the store takes)"))
    if skipped != SYSTEM_LEN * B:
        raise AssertionError(f"{phase_tag}: {skipped} prefix tokens reused, want "
                             f"{SYSTEM_LEN * B}")
    if hold_ids and same != B:
        raise AssertionError(f"{phase_tag}: greedy ids with the store differ from "
                             f"those without ({agree}/{16 * B} equal)")
    engine.reset()


def chat_session_rows(torch, engine) -> None:
    """4k (d): a 3-round ChatSession on slot 0 of the loaded engine with
    the SentencePiece asset through the native encoder: each round's
    prefill is its new turn only, and the slot's length is the history
    less the final token of each later round that ended by length (the
    mirrored top-up). Streaming tok/s beside generate's non-streaming
    tok/s at B = 1 on round 1's input."""
    from llm_inference_engine_tpu_torch.config import SamplingParams
    from llm_inference_engine_tpu_torch.runtime.session import ChatSession
    from llm_inference_engine_tpu_torch.tokenizer import load_tokenizer

    tok = load_tokenizer(str(ROOT / SPM_ASSET))
    if type(tok).__name__ != "NativeBPETokenizer":
        raise AssertionError("4k: the tokenizer is not the native encoder")
    engine.reset()
    sess = ChatSession(engine, tok, system_prompt="You are brief.",
                       template="llama2")
    sp = SamplingParams(greedy=True, max_new_tokens=32)
    rounds, ended_by_length = [], []
    first_input = None
    for q in CHAT_TURNS:
        ids = sess.make_input(q)
        first_input = first_input or ids
        start = engine._lengths[0]
        stamps = []
        t0 = time.perf_counter()
        sess.response(q, sp, lambda i, c: stamps.append(time.perf_counter()))
        wall = time.perf_counter() - t0
        n = len(stamps) - 1
        ended_by_length.append(n == sp.max_new_tokens)
        rounds.append(dict(prefill=len(ids), history=start, tokens=n,
                           tok_s=n / wall))
    want_len = len(sess.token_history) - sum(ended_by_length[1:])
    say(f"  (d) ChatSession, 3 rounds on slot 0: "
        + "; ".join(f"round {i + 1}: prefill {r['prefill']} tokens after "
                    f"{r['history']} in the cache, {r['tokens']} tokens "
                    f"streamed at {r['tok_s']:.2f} tok/s"
                    for i, r in enumerate(rounds))
        + f"; slot length {engine._lengths[0]} (history "
        f"{len(sess.token_history)}, want {want_len})")
    if engine._lengths[0] != want_len:
        raise AssertionError("4k: the session's slot length is not its "
                             "history less the mirrored top-up")
    # a fourth round by beam search: the winning turn re-prefilled into
    # the slot
    t0 = time.perf_counter()
    text = sess.response_beam(CHAT_TURNS[0], num_beams=2, max_new_tokens=16)
    say(f"  (d) response_beam (2 beams, 16 new tokens): "
        f"{time.perf_counter() - t0:.3f} s, {text!r}; slot length "
        f"{engine._lengths[0]} (history {len(sess.token_history)})")
    if engine._lengths[0] != len(sess.token_history):
        raise AssertionError("4k: response_beam left the slot out of step "
                             "with the history")
    engine.reset()
    sp1 = SamplingParams(greedy=True, max_new_tokens=rounds[0]["tokens"])
    engine.generate([first_input], sp1, eos_token_id=None)   # warm
    engine.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = engine.generate([first_input], sp1, eos_token_id=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    say(f"  (d) generate, non-streaming, B = 1, round 1's input: "
        f"{r.num_generated[0]} tokens at {r.num_generated[0] / wall:.2f} "
        f"tok/s (streaming round 1: {rounds[0]['tok_s']:.2f} tok/s)")
    engine.reset()


# 4l: speculative decoding and beam search on llama2-7b INT4 (B = 8, the
# engine config of 4b) with a tinyllama-1.1b INT4 draft
SPEC_K = 4
SPEC_NEW = 64
SPEC_ROUNDS = 8          # eager rounds against replayed ones, one state
TINY_SHAPES = {"wqkv": (2048, 2560, 1), "wo": (2048, 2048, 1),
               "gate|up": (2048, 5632, 2), "down": (5632, 2048, 1),
               "lm_head": (2048, 32000, 1)}
SPEC_TAILS = (5, 17, 33, 64, 90, 128, 160, 200)
BEAM_PROMPT, BEAM_NEW, BEAMS = 128, 32, 4


def spec_snapshot(spec):
    """What a round changes besides K/V rows past the lengths, in both
    engines, and the decoder's generator."""
    return snapshot(spec.target), snapshot(spec.draft), spec._gen.get_state()


def spec_restore(spec, snap) -> None:
    restore(spec.target, snap[0])
    restore(spec.draft, snap[1])
    spec._gen.set_state(snap[2])


def spec_rounds(torch, spec, last, arrays, sampled: bool, n: int,
                eager: bool):
    """``n`` rounds with every row active from ``last``, replayed or
    through the eager bodies: ([(emitted, logprob bits, n_acc)] a round,
    as lists; wall ms a round, host read included)."""
    import numpy as np

    from llm_inference_engine_tpu_torch.runtime.decode_graph import (
        run_eagerly)
    B = len(last)
    active = np.ones(B, bool)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with run_eagerly(spec) if eager else contextlib.nullcontext():
        for _ in range(n):
            em, lp, na = spec.run_round(last, active, arrays, sampled)
            outs.append((em.tolist(), lp.view(np.int32).tolist(),
                         na.tolist()))
            last = em[np.arange(B), na]
    return outs, (time.perf_counter() - t0) / n * 1e3


def spec_kernel_rows(torch, dev, results) -> None:
    """The kernels at the shapes the speculative and beam paths add, each
    held against its plain version and timed beside it, its bound and its
    library call: E and F at m = 40 (the verify's projections at B = 8,
    k + 1 = 5, and its lm_head with an f32 output), D2 at T = 5 in chunk
    mode (the verify's attention, llama2-7b widths), and at tinyllama's
    widths (the draft's decode step, B = 8): E's decode mode, D's fused
    decode (32 q heads, 4 kv heads, head_dim 64), A and B."""
    from llm_inference_engine_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(4242)
    m = 8 * (SPEC_K + 1)
    for mode in ("int4", "int8"):
        for label in QUANT_SHAPES:
            quant_case(torch, dev, gen, results, mode, m, label,
                       tag="verify ", poison=True)
    for label in TINY_SHAPES:
        quant_case(torch, dev, gen, results, "int4", 8, label, TINY_SHAPES,
                   tag="tinyllama ")
    torch.cuda.empty_cache()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)
    # D2 at T = 5: 8 rows at 4b's prompt lengths plus a round's worth
    B, T, H, K, D, S = 8, SPEC_K + 1, 32, 32, 128, 2048
    starts = [n + 40 for n in QUANT_PROMPTS]
    q = randn(B, T, H, D)
    kc, vc = randn(B, S, K, D), randn(B, S, K, D)
    qs, kl = ints(starts), ints([s + T for s in starts])
    run = lambda: attention.attention(q, kc, vc, qs, kl,  # noqa: E731
                                      kernels="cuda")
    check_close(torch, "attention_prefill", run(),
                attention.attention_torch(q, kc, vc, qs, kl), results,
                f"verify B{B} T{T} q_start {starts[0]}..{starts[-1]}",
                (time_ms(torch, run), time_ms(torch, lambda: (
                    attention.attention_torch(q, kc, vc, qs, kl)), iters=3,
                    warmup=1)),
                work=attn_work(starts, kl.tolist(), T, H, K, D),
                library=sdpa_ms(torch, q, kc, vc, qs, kl))
    del kc, vc
    # D's fused decode at tinyllama's widths (G = 8, head_dim 64)
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    H, K, D = 32, 4, 64
    cache = kvc.new_kv_cache(2, B, K, S, D, device=dev)
    cache.k.copy_(randn(2, B, S, K, D))
    cache.v.copy_(randn(2, B, S, K, D))
    qd, kn, vn = randn(B, 1, H, D), randn(B, 1, K, D), randn(B, 1, K, D)
    kl = qs + 1

    def fused(kern):
        if kern == "torch":
            return attention.attention_decode_fused_torch(
                qd, kn, vn, cache.k, cache.v, qs, kl, 1)[0]
        return attention.attention_decode_fused(
            qd, kn, vn, cache.k, cache.v, qs, kl, 1, kernels=kern)[0]
    say_plan(attention, "tinyllama B8", B, H, K, D)
    check_close(torch, "attention_decode", fused("cuda"), fused("torch"),
                results, f"tinyllama B{B} H{H} K{K} D{D} kv_len "
                f"{starts[0] + 1}..{starts[-1] + 1}",
                (time_ms(torch, lambda: fused("cuda")),
                 time_ms(torch, lambda: fused("torch"), iters=3, warmup=1)),
                work=attn_work(starts, kl.tolist(), 1, H, K, D,
                               new_rows=2 * B * K * D * 2),
                library=sdpa_ms(torch, qd, cache.k[1], cache.v[1], qs, kl),
                row_rel=DECODE_ROW_TOL)
    del cache
    paged_equals_slot(torch, dev, gen, "tinyllama", B, H, K, D, starts)
    rows = decode_shape_rows(torch, dev, hidden=2048, inter=5632)
    say("  tinyllama A/B at decode shape (ms a call): " + json.dumps(rows))
    # J at tinyllama's widths (G = 8, head_dim 64: the draft's step, and
    # in graph replays) and at the verify's m 40 (8 x 5, llama2-7b)
    rope_case(torch, gen, results, "tinyllama decode", 8, 4, 8, 64)
    rope_replayed_rows(torch, dev, "tinyllama", 4, 8, 64)
    rope_case(torch, gen, results, "verify 8 x 5", 8 * (SPEC_K + 1), 32, 1,
              128)
    torch.cuda.empty_cache()


def all_logits(engine, ids, q_start, kv_len):
    """The logits at every position of ``ids`` appended to ``engine``'s
    cache (the verify path): ``forward_all_logits``, or its sharded
    counterpart over a mesh engine's ranks."""
    from llm_inference_engine_tpu_torch.models import llama
    from llm_inference_engine_tpu_torch.parallel import sharding
    if engine.mesh is None:
        return llama.forward_all_logits(
            engine.config, engine.engine_config, engine.params, ids,
            engine.cache, q_start, kv_len)[0]
    fwd = sharding.make_sharded_forward(engine.config, engine.engine_config,
                                        engine.mesh, all_logits=True)
    return fwd(engine.params, engine.cache, ids, q_start, kv_len)[0]


def near_ties(torch, engine, events) -> list:
    """For each rejection ``(context, draft token)`` of a self-draft run:
    the target's logits at the end of ``context`` through the verify path
    (a T = 5 forward after the first len - 5 tokens, as a round runs) and
    through the decode path (a T = 1 forward after the first len - 1),
    8 contexts a batch. Returns [(top-1 minus top-2 of the verify logits,
    max |verify - decode|, verify argmax, decode argmax, draft token)]."""
    B = engine.engine_config.max_batch_size
    out = []
    for i in range(0, len(events), B):
        batch = events[i:i + B]
        pads = [c for c, _ in batch] + [batch[0][0]] * (B - len(batch))
        logits = []
        for T in (SPEC_K + 1, 1):
            engine.reset()
            engine.prefill([c[:-T] for c in pads])
            ids = torch.tensor([c[-T:] for c in pads], dtype=torch.int32,
                               device=engine.device)
            q = engine.cache.lengths.clone()
            logits.append(all_logits(engine, ids, q, q + T)[:, -1])
        v, d = logits
        top2 = v.topk(2, dim=-1).values
        for r, (_, tok) in enumerate(batch):
            out.append(((top2[r, 0] - top2[r, 1]).item(),
                        (v[r] - d[r]).abs().max().item(),
                        int(v[r].argmax()), int(d[r].argmax()), tok))
    engine.reset()
    return out


def phase_speculative(torch, dev, results) -> None:
    """4l: speculative decoding (SpeculativeDecoder, SpeculativeScheduler
    behind the HTTP server, DualPrefixStore) and beam search on llama2-7b
    INT4 at 4b's engine config, the draft tinyllama-1.1b INT4 with the same
    config; the kernels at the shapes these paths add first
    (``spec_kernel_rows``). (a) greedy generate at k = 4: replayed rounds
    equal eager rounds from one state; ids against plain greedy printed.
    (b) self-draft (the target's own parameters): acceptance >= 0.9, and
    the rejections that were near-ties. (c) a sampled round (temperature
    0.8, top-p 0.95): replayed equals eager for the same generator state;
    at temperature 0 it equals the greedy round. (d) the server over
    SpeculativeScheduler, 8 requests, one DualPrefixStore restore held
    against its snapshots. (e) beam_search: one beam equals generate at
    B = 1, 4 beams replayed equal eager, the best score against a
    teacher-forced recompute. Every kernel of the INT4 slot path must
    launch."""
    import gc
    import http.client
    import threading
    import urllib.request

    import numpy as np

    from llm_inference_engine_tpu_torch.cli import _IdTokenizer
    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.models import llama
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.models.weights import param_bytes
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.runtime.beam_search import (
        BeamSearch, beam_search)
    from llm_inference_engine_tpu_torch.runtime.chat_template import (
        get_chat_template)
    from llm_inference_engine_tpu_torch.runtime import decode_graph
    from llm_inference_engine_tpu_torch.runtime.decode_graph import (
        run_eagerly)
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    from llm_inference_engine_tpu_torch.runtime.speculative import (
        SpeculativeDecoder)
    from llm_inference_engine_tpu_torch.runtime.speculative_scheduler import (
        SpeculativeScheduler)
    from llm_inference_engine_tpu_torch.server import make_server

    gc.collect()
    torch.cuda.empty_cache()
    spec_kernel_rows(torch, dev, results)
    cfg = get_config("llama2-7b")
    eng_cfg = EngineConfig(quant_mode="int4", max_batch_size=8,
                           max_seq_len=2048)
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    target = create_engine("llama2-7b", None, eng_cfg, seed=0, device=dev)
    draft = create_engine("tinyllama-1.1b", None, eng_cfg, seed=0,
                          device=dev)
    B = eng_cfg.max_batch_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, n).tolist() for n in QUANT_PROMPTS]
    greedy = target._host_arrays(SamplingParams(greedy=True))
    failures = []

    def instrumented(spec):
        """(instrumentation of this check only) record each round's n_acc
        and host seconds"""
        log = []
        run_round = spec.run_round

        def counted(*a, **kw):
            t0 = time.perf_counter()
            out = run_round(*a, **kw)
            log.append((out[2].copy(), time.perf_counter() - t0))
            return out
        spec.run_round = counted
        return log

    # (a) an unrelated draft
    spec = SpeculativeDecoder(target, draft, SPEC_K)
    log = instrumented(spec)
    spec.generate(prompts, SPEC_NEW, eos_token_id=None)   # captures
    log.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = spec.generate(prompts, SPEC_NEW, eos_token_id=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del spec.run_round
    round_s = sum(s for _, s in log)
    target.reset()
    plain = target.generate(prompts, SamplingParams(
        greedy=True, max_new_tokens=SPEC_NEW), eos_token_id=None).token_ids
    same = sum(a == b for x, y in zip(res.token_ids, plain)
               for a, b in zip(x, y))
    diverge = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                    None) for x, y in zip(res.token_ids, plain)]
    say(f"  (a) tinyllama-1.1b INT4 draft, k = {SPEC_K}, greedy, "
        f"{SPEC_NEW} new tokens at B = {B}: {len(log)} rounds, acceptance "
        f"{res.acceptance_rate:.4f} ({res.num_accepted}/{res.num_drafted});"
        f" generate wall {wall:.3f} s (prefill of both engines included), "
        f"rounds {round_s / len(log) * 1e3:.3f} ms a round (host clock, the "
        f"round's read included), {B * SPEC_NEW / wall:.1f} tok/s end to "
        f"end, {(B * SPEC_NEW - B) / round_s:.1f} tok/s over the rounds")
    say(f"  (a) ids equal to the target's plain greedy generate position by "
        f"position: {same}/{B * SPEC_NEW} ({same / (B * SPEC_NEW):.3f}); "
        f"first divergence per row {diverge} (printed only: the T = 1 and "
        f"T = 5 paths sum in another order)")
    # replayed rounds against eager rounds from the state generate left
    last = np.array([t[-1] for t in res.token_ids], np.int32)
    snap = spec_snapshot(spec)
    eager, eager_ms = spec_rounds(torch, spec, last, greedy, False,
                                  SPEC_ROUNDS, True)
    spec_restore(spec, snap)
    before = {k: f.launches for k, f in counters.items()}
    replayed, graph_ms = spec_rounds(torch, spec, last, greedy, False,
                                     SPEC_ROUNDS, False)
    per_round = {k: (f.launches - before[k]) / SPEC_ROUNDS
                 for k, f in counters.items() if f.launches - before[k]}
    spec_restore(spec, snap)
    prof = device_profile(torch, lambda: spec.run_round(
        last, np.ones(B, bool), greedy, False), 4)
    spec_restore(spec, snap)
    say(f"  (a) {SPEC_ROUNDS} replayed rounds == {SPEC_ROUNDS} eager rounds "
        f"(emitted, logprobs, n_acc): {replayed == eager}; wall eager / "
        f"replayed {eager_ms:.3f} / {graph_ms:.3f} ms a round; replayed "
        f"card busy {prof.busy:.3f} ms a round (idle "
        f"{1 - prof.busy / graph_ms:.3f}); by group: "
        f"{_groups(prof.per_kernel)}")
    # the draft's ingest of d_k, its own program: what replaying it every
    # round (the always-run form of the JAX round's lax.cond) would add
    spec._ingest[1].zero_()            # no row fully accepted: no write
    decode_graph.run(spec, "ingest", (spec._ingest,), spec._ingest[1])
    ingest_ms = time_ms(torch, spec._programs["ingest"].replay)
    spec_restore(spec, snap)
    say(f"  (a) launches per round: {per_round}; the ingest program "
        f"{ingest_ms:.4f} ms a replay (run only after a round in which a "
        f"row fully accepted; replayed every round it would add that)")
    if replayed != eager:
        failures.append("replayed greedy rounds differ from eager rounds")
    # a round: k draft forwards, the verify, and the draft's ingest of d_k
    # in the rounds where a row fully accepted
    ingests = sum(SPEC_K in na for _, _, na in replayed)
    layers = (SPEC_ROUNDS * (SPEC_K * draft.config.num_layers
                             + cfg.num_layers)
              + ingests * draft.config.num_layers)
    forwards = SPEC_ROUNDS * (SPEC_K + 1) + ingests
    want = dict(rmsnorm=forwards, add_residual_rmsnorm=2 * layers,
                silu_and_mul=layers, split_qkv_rope=layers)
    got = {k: round(per_round.get(k, 0) * SPEC_ROUNDS) for k in want}
    if got != want:
        failures.append(f"launches of A, B and J over {SPEC_ROUNDS} rounds "
                        f"{got}, want {want}")

    # (c) the sampled round, from the same state
    sampled = target._host_arrays(SamplingParams(temperature=0.8,
                                                 top_p=0.95))
    spec._gen.manual_seed(11)
    snap = spec_snapshot(spec)
    spec_rounds(torch, spec, last, sampled, True, 1, False)   # captures
    spec_restore(spec, snap)
    s_eager, _ = spec_rounds(torch, spec, last, sampled, True, 4, True)
    spec_restore(spec, snap)
    s_graph, s_ms = spec_rounds(torch, spec, last, sampled, True, 4, False)
    spec_restore(spec, snap)
    zero_t = (np.zeros(B, np.float32), *sampled[1:])
    t0_round, _ = spec_rounds(torch, spec, last, zero_t, True, 1, False)
    spec_restore(spec, snap)
    g_round, _ = spec_rounds(torch, spec, last, greedy, False, 1, False)
    spec_restore(spec, snap)
    acc = sum(sum(na) for _, _, na in s_graph) / (4 * B * SPEC_K)
    say(f"  (c) sampled rounds (temperature 0.8, top-p 0.95): 4 replayed == "
        f"4 eager from one generator state: {s_graph == s_eager}; "
        f"{s_ms:.3f} ms a round; acceptance {acc:.4f}; a round at "
        f"temperature 0 == the greedy round: {t0_round == g_round}")
    if s_graph != s_eager:
        failures.append("replayed sampled rounds differ from eager rounds")
    if t0_round != g_round:
        failures.append("the sampled round at temperature 0 differs from "
                        "the greedy round")
    del spec
    peak_a = torch.cuda.max_memory_allocated()

    # (b) self-draft: a second engine over the target's own tensors
    twin = InferenceEngine(cfg, eng_cfg, target.params, device=dev)
    spec = SpeculativeDecoder(target, twin, SPEC_K)
    log = instrumented(spec)
    res = spec.generate(prompts, SPEC_NEW, eos_token_id=None)
    del spec.run_round
    last = np.array([t[-1] for t in res.token_ids], np.int32)
    snap = spec_snapshot(spec)
    eager, _ = spec_rounds(torch, spec, last, greedy, False, 4, True)
    spec_restore(spec, snap)
    replayed, twin_ms = spec_rounds(torch, spec, last, greedy, False, 4,
                                    False)
    full = sum(SPEC_K in na for _, _, na in replayed)
    say(f"  (b) self-draft: 4 replayed rounds == 4 eager rounds: "
        f"{replayed == eager} ({full} with a fully accepted row, so the "
        f"ingest program ran); {twin_ms:.3f} ms a round")
    if replayed != eager or not full:
        failures.append("self-draft: replayed rounds differ from eager "
                        "rounds, or no ingest ran")
    events, done = [], [1] * B
    for n_acc, _ in log:
        for i in range(B):
            if done[i] >= SPEC_NEW:
                continue
            pos = done[i] + int(n_acc[i])
            if n_acc[i] < SPEC_K and pos < SPEC_NEW:
                events.append((prompts[i] + res.token_ids[i][:pos],
                               res.token_ids[i][pos]))
            done[i] += int(n_acc[i]) + 1
    ties = near_ties(torch, target, events)
    near = [t for t in ties if t[0] <= t[1]]
    say(f"  (b) self-draft: {len(log)} rounds, acceptance "
        f"{res.acceptance_rate:.4f} ({res.num_accepted}/{res.num_drafted}); "
        f"{len(events)} rejections, {len(near)} of them near-ties (verify "
        f"path top-1 minus top-2 <= max |verify - decode logits|); per "
        f"rejection (margin, noise, verify argmax, decode argmax): "
        f"{[(round(a, 4), round(b, 4), c, d) for a, b, c, d, _ in ties]}")
    if res.acceptance_rate < 0.9:
        failures.append(f"self-draft acceptance {res.acceptance_rate:.4f} "
                        "< 0.9")
    del spec, twin
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the server over SpeculativeScheduler
    target.reset()
    draft.reset()
    sched = SpeculativeScheduler(target, draft, eos_token_id=None,
                                 num_draft=SPEC_K)
    system = rng.integers(3, 32000, 64).tolist()
    entry = sched.register_prefix(system)
    sched.prefix_store.restore(B - 1, entry)
    exact = all(
        torch.equal(e.cache.k[:, B - 1, :s.padded_length], s.k)
        and torch.equal(e.cache.v[:, B - 1, :s.padded_length], s.v)
        and e._lengths[B - 1] == int(e.cache.lengths[B - 1]) == len(system)
        for e, s in ((target, entry.target), (draft, entry.draft)))
    target.reset()
    draft.reset()
    say(f"  (d) DualPrefixStore: a {len(system)}-token prefix restored into "
        f"slot {B - 1} of both engines; exact copies of both snapshots, "
        f"lengths equal: {exact}")
    if not exact:
        failures.append("the dual prefix restore is not an exact copy")
    requests = []
    submit = sched.submit

    def recording_submit(*a, **kw):
        requests.append(submit(*a, **kw))
        return requests[-1]
    sched.submit = recording_submit
    httpd, llm = make_server(sched, _IdTokenizer(cfg.vocab_size),
                             get_chat_template("plain"), "llama2-7b",
                             host="127.0.0.1", port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    addr = httpd.server_address
    bodies = [dict(prompt=system + rng.integers(3, 32000, n).tolist(),
                   max_tokens=SPEC_NEW // 2, temperature=0.0)
              for n in SPEC_TAILS]
    out = [None] * B

    def post(i):
        conn = http.client.HTTPConnection(*addr, timeout=300)
        conn.request("POST", "/v1/completions", json.dumps(bodies[i]),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out[i] = (resp.status, json.loads(resp.read()))
        conn.close()
    threads = [threading.Thread(target=post, args=(i,)) for i in range(B)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    llm.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}/metrics",
                                timeout=60) as r:
        metrics = r.read().decode()
    httpd.shutdown()
    httpd.server_close()
    llm.shutdown()
    server.join()
    gauge = next((ln for ln in metrics.splitlines()
                  if ln.startswith("llm_spec_acceptance_rate ")), None)
    bad = [s for s, resp in out if s != 200
           or resp["usage"]["completion_tokens"] != SPEC_NEW // 2]
    gen = sum(len(r.output_ids) for r in requests)
    say(f"  (d) server over SpeculativeScheduler: {len(requests)} requests "
        f"(a {len(system)}-token shared prefix + tails {list(SPEC_TAILS)}), "
        f"{gen} tokens in {wall:.3f} s ({gen / wall:.1f} tok/s); TTFT "
        f"p50/p90/p99 {_percentiles([r.ttft for r in requests])} s; e2e "
        f"p50/p90/p99 {_percentiles([r.e2e_latency for r in requests])} s; "
        f"acceptance {sched.acceptance_rate:.4f} ({sched.num_accepted}/"
        f"{sched.num_drafted}); /metrics: {gauge}; prefix tokens reused "
        f"{sum(r.reused_prefix_len for r in requests)}")
    if bad or gauge != (f"llm_spec_acceptance_rate "
                        f"{sched.acceptance_rate:.4f}"):
        failures.append(f"server: bad responses {bad} or gauge {gauge}")
    if sum(r.reused_prefix_len for r in requests) != B * len(system):
        failures.append("the server's requests did not reuse the prefix")
    del sched, draft
    gc.collect()
    torch.cuda.empty_cache()

    # (e) beam search
    prompt = rng.integers(3, 32000, BEAM_PROMPT).tolist()
    one = InferenceEngine(cfg, eng_cfg.replace(max_batch_size=1),
                          target.params, device=dev)
    want = one.generate([prompt], SamplingParams(
        greedy=True, max_new_tokens=BEAM_NEW), eos_token_id=None).token_ids
    del one
    b1 = beam_search(cfg, eng_cfg, target.params, prompt, 1, BEAM_NEW,
                     eos_token_id=None)
    bs = BeamSearch(cfg, eng_cfg, target.params, BEAMS)
    with run_eagerly(bs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = bs.search(prompt, BEAM_NEW, eos_token_id=None)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    got = bs.search(prompt, BEAM_NEW, eos_token_id=None)   # captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = bs.search(prompt, BEAM_NEW, eos_token_id=None)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    step = bs._programs["step"]
    step_ms = time_ms(torch, step.replay, iters=8)
    R = BEAM_PROMPT + BEAM_NEW
    gather = bs.gather_bytes()
    planes = bs._planes()
    parents = torch.tensor([3, 0, 0, 1], device=dev)
    gather_ms = time_ms(torch, lambda: [
        (torch.index_select(p[:, :, :R], 1, parents, out=s),
         p[:, :, :R].copy_(s)) for p, s in zip(planes, bs._scratch)])
    kv_read = gather // 4      # the live rows, read once by attention
    step_bound = bound_ms((param_bytes(target.params) + kv_read + gather,
                           0))[0]
    # the best beam's score against one forward over prompt + beam
    best = got.sequences[0]
    full = prompt + best
    cache = kvc.new_kv_cache(cfg.num_layers, 1, cfg.num_kv_heads, len(full),
                             cfg.head_dim, device=dev)
    logits, _ = llama.forward_all_logits(
        cfg, eng_cfg.replace(max_batch_size=1, max_seq_len=len(full)),
        target.params, torch.tensor([full], dtype=torch.int32, device=dev),
        cache, torch.zeros(1, dtype=torch.int32, device=dev),
        torch.tensor([len(full)], dtype=torch.int32, device=dev))
    logp = torch.log_softmax(logits[0], -1)
    forced = sum(logp[BEAM_PROMPT - 1 + i, t].item()
                 for i, t in enumerate(best)) / len(best)
    del cache, logits, logp
    say(f"  (e) beam_search, {BEAM_PROMPT}-token prompt, {BEAM_NEW} new: one "
        f"beam == generate at B = 1: {b1.sequences[0] == want[0]}; "
        f"{BEAMS} beams replayed == eager (sequences, scores): "
        f"{got == ref}; search {eager_s:.3f} s eager, {graph_s:.3f} s "
        f"replayed; best score {got.scores[0]:.5f}, teacher-forced "
        f"{forced:.5f} (a finding: bf16)")
    say(f"  (e) beam step (replay, CUDA events): {step_ms:.4f} ms; its "
        f"reorder of {R} rows a beam moves {gather} bytes ({gather / 4e9:.3f}"
        f" GB gathered, read and written twice through the scratch): "
        f"{gather_ms:.4f} ms alone, bound {bound_ms((gather, 0))[0]:.4f} ms;"
        f" the whole cache would be {4 * sum(p.nbytes for p in planes)}"
        f" bytes; step bound {step_bound:.4f} ms (weights + live K/V + "
        f"reorder, bytes)")
    if b1.sequences[0] != want[0]:
        failures.append("one beam differs from generate at B = 1")
    if got != ref:
        failures.append("replayed beam steps differ from the eager steps")
    del bs
    peak = max(peak_a, torch.cuda.max_memory_allocated())
    launches = {k: f.launches for k, f in counters.items()}
    say(f"  launches during 4l: {launches}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    expected, forbidden = MAIN_PATHS["int4"]
    missing = [n for n in expected if launches[n] <= 0]
    extra = [n for n in forbidden if launches[n]]
    if missing or extra:
        failures.append(f"kernels never launched {missing}; kernels that "
                        f"must not launch {extra}")
    del target
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("4l: " + "; ".join(failures))


# 4m: evals, calibration and the debugging utilities at llama2-7b's width
EVAL_WINDOW, EVAL_BATCH = 512, 4
EVAL_TOKENS = 8 * (EVAL_WINDOW - 1) + 1   # 4089: 8 windows, 4088 predicted
EVAL_CLI_LAYERS = 4       # depth of the CLI's and the quantizer's model
EVAL_CALIB = 512          # calibration tokens
EVAL_TAP_PROMPTS = (17, 40)
EVAL_TAP_NEW = 4
EVAL_NAN_LAYER = 5
# the JAX package's tap names (its models/llama.py), 3 layers kept
TAP_NAMES = {"embedding", "final_norm"} | {
    f"L{i}_{n}" for i in range(3)
    for n in ("attn_norm", "qkv_proj", "q_rope", "k_rope", "attn_ctx",
              "attn_out", "ffn_in", "ffn_act", "layer_out")}
# 4m's kernels: (must launch, must not)
EVAL_PATH = (NORM_ACT + ("kv_write", "kv_write_quant", "attention_prefill",
                         "attention_prefill_int8", "attention_decode",
                         "int4_matmul", "dequant_int4"),
             PAGED_ALL + ("int8_matmul", "attention_decode_int8"))


def eval_kernel_rows(torch, dev, results) -> None:
    """The kernels at the shapes scoring adds, each against its plain
    version with its time, bound and library call: G on the lm_head
    [4096, 32000] (bit for bit), the INT4 lm_head at m = 2048 with an f32
    output (``_large_m_linear``: G, then cuBLAS; library:
    ``_weight_int4pack_mm``, bf16 out), and D2's int8 slot mode at a
    scoring batch (B 4, T 512, q_start 0, kv_len 512)."""
    from llm_inference_engine_tpu_torch.ops import attention, quant
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2718)
    k, n, m = 4096, 32000, EVAL_BATCH * EVAL_WINDOW
    ts = quant_weights(torch, quant, dev, gen, "int4", k, n,
                       min_bytes=120_000_000)

    def g(t, kern):
        return quant.dequant_int4(t.q, t.scale, 128, kernels=kern)
    got, want = g(ts[0], "cuda"), g(ts[0], "torch")
    if not torch.equal(got, want):
        raise AssertionError("dequant_int4 on the lm_head: not bit-identical "
                             "to the plain dequant")
    check_close(torch, "dequant_int4", got, want, results,
                f"lm_head [{k // 2},{n}] -> bf16 [{k},{n}] (torch.equal)",
                (time_ms(torch, cycling(ts, lambda t: g(t, "cuda"))),
                 time_ms(torch, cycling(ts, lambda t: g(t, "torch")),
                         iters=3, warmup=1)),
                work=(ts[0].nbytes + k * n * 2, 2 * k * n))
    del got, want
    x = torch.randn(m, k, generator=gen, device=dev, dtype=bf16)

    def head(t, kern):
        return quant._large_m_linear(x, t, torch.float32, kern)
    check_close(torch, "dequant_int4", head(ts[0], "auto"),
                head(ts[0], "torch"), results,
                f"lm_head m{m} f32 out (G + cuBLAS)",
                (time_ms(torch, cycling(ts, lambda t: head(t, "auto")),
                         iters=5),
                 time_ms(torch, cycling(ts, lambda t: head(t, "torch")),
                         iters=3, warmup=1)),
                work=(ts[0].nbytes + x.numel() * 2 + m * n * 4, 2 * m * k * n),
                library=int4pack_ms(torch, quant, ts, x, bf16))
    del ts, x
    torch.cuda.empty_cache()
    B, T, H, K, D = EVAL_BATCH, EVAL_WINDOW, 32, 32, 128
    cache = kvc.new_kv_cache(1, B, K, T, D, device=dev, quantized=True)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    full = torch.full((B,), T, dtype=torch.int32, device=dev)
    kvc.update_cache_at_layer(cache, 0, *(torch.randn(
        B, T, K, D, generator=gen, device=dev, dtype=bf16) for _ in "kv"),
        zeros, full)
    q = torch.randn(B, T, H, D, generator=gen, device=dev, dtype=bf16)

    def run(kern):
        return attention.attention(q, cache.k, cache.v, zeros, full, layer=0,
                                   kernels=kern, k_scale=cache.k_scale,
                                   v_scale=cache.v_scale)
    check_close(torch, "attention_prefill_int8", run("cuda"), run("torch"),
                results, f"scoring B{B} T{T} q_start 0 kv_len {T}",
                (time_ms(torch, lambda: run("cuda"), iters=5),
                 time_ms(torch, lambda: run("torch"), iters=3, warmup=1)),
                work=attn_work([0] * B, [T] * B, T, H, K, D, kv_elem=1))
    del cache, q
    torch.cuda.empty_cache()


def param_format(params, prefix: str = "") -> dict:
    """{leaf name: its format}: a quantized leaf's mode, group and the
    shapes and dtypes of q and scale; a plain leaf's shape and dtype."""
    from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(param_format(v, prefix + k + "."))
        elif isinstance(v, QuantizedTensor):
            out[prefix + k] = (v.mode, v.group_size, tuple(v.q.shape),
                               v.q.dtype, tuple(v.scale.shape), v.scale.dtype)
        else:
            out[prefix + k] = (tuple(v.shape), v.dtype)
    return out


def dump_errors(dir_a: Path, dir_b: Path, valid: int) -> dict:
    """{tap name: [prefill, first decode step]}: the largest |a - b| over
    max |b| of that name's first two dumps in two dump directories (the
    prefill's over its first ``valid`` positions, which every row holds;
    later steps may follow other tokens)."""
    import numpy as np

    def index(d):
        out = {}
        for f in sorted(os.listdir(d)):
            out.setdefault(f.split("_", 1)[1][:-4], []).append(d / f)
        return out
    a, b = index(dir_a), index(dir_b)
    errs = {}
    for name in sorted(set(a) & set(b)):
        errs[name] = []
        for step, (fa, fb) in enumerate(zip(a[name][:2], b[name][:2])):
            x, y = np.load(fa), np.load(fb)
            if step == 0:
                x, y = x[:, :valid], y[:, :valid]
            if x.shape != y.shape:
                errs[name].append("shape")
                continue
            err = np.abs(x - y).max() / max(float(np.abs(y).max()), 1e-30)
            errs[name].append(float(f"{err:.3g}"))
    return errs


def phase_evals(torch, dev, results) -> None:
    """4m: the evals, calibration and debugging utilities on llama2-7b (32
    layers, full width), seed-0 dummy weights; the kernels at the shapes
    scoring adds first (``eval_kernel_rows``), then, with every launch
    counter set to 0, (a) the windowed Scorer (bf16, window 512, batch 4,
    4089 tokens = 8 windows): 4088 predictions, a zeroed lm_head gives
    ppl 32000, one window against ``forward_all_logits`` at B = 1, the
    kernel route against ``kernels="torch"``, and ``evals.ppl``'s CLI in a
    subprocess (INT4, 7B width at 4 layers) printing the in-process value;
    (b) a tapped ``generate`` at B = 2, kernel route and plain route: the
    JAX package's dump names for prefill and decode; (c) ``calibrate_act_sq``
    over 512 tokens and ``quantize_params_calibrated`` INT4 in
    ``quantize_params``' format, the quantizer's ``--calibrate random:512``
    over an HF directory (7B width, 4 layers) bit for bit the in-process
    run, its .npz served by ``create_engine``; (d) ``nan_guard`` over a
    forward, clean and with a NaN planted in layer 5's ``wo`` and in its
    ``ffn_norm``; printed only: (e) perplexities (dummy weights: no
    quality) and (f) tokens scored a second, card busy a batch by kernel
    group (``utils.profiling.trace``), calibration and clip-search seconds,
    peak memory."""
    import gc
    import math
    import shutil
    import tempfile

    import numpy as np

    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.evals import ppl
    from llm_inference_engine_tpu_torch.models import llama
    from llm_inference_engine_tpu_torch.models import weights as W
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    from llm_inference_engine_tpu_torch.tools import quantize
    from llm_inference_engine_tpu_torch.utils import (
        checks, debug, nan_guard, profiling)

    gc.collect()
    torch.cuda.empty_cache()
    eval_kernel_rows(torch, dev, results)
    cfg = get_config("llama2-7b")
    cfg4 = cfg.replace(num_layers=EVAL_CLI_LAYERS)
    W_, B_ = EVAL_WINDOW, EVAL_BATCH
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, cfg.vocab_size, EVAL_TOKENS).tolist()
    params = W.init_dummy_params(cfg, seed=0, device=dev)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="llm_evals_", dir=build))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _zero_counters()

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    def scored(p, eng=None, toks=tokens):
        """(NLL, predictions, seconds) of a fresh Scorer over ``toks``."""
        scorer = ppl.Scorer(cfg, p, eng, window=W_, batch=B_)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nll, n = scorer.score(toks)
        return nll, n, time.perf_counter() - t0

    def rel(a, b):
        return abs(a - b) / abs(b)
    try:
        # (a) scoring
        nll, n, _ = scored(params)
        nll2, n2, s_bf16 = scored(params)
        say(f"  (a) bf16 Scorer (window {W_}, batch {B_}, {len(tokens)} "
            f"tokens): {n} predicted, NLL {nll:.6f}, mean {nll / n:.6f}, "
            f"ppl {math.exp(nll / n):.4f}; a second run {s_bf16:.3f} s, "
            f"{n / s_bf16:.1f} tokens/s, NLL equal bit for bit: "
            f"{nll2 == nll}")
        if n != EVAL_TOKENS - 1 or n2 != n or not math.isfinite(nll):
            raise AssertionError(f"4m (a): {n} predictions (want "
                                 f"{EVAL_TOKENS - 1}), NLL {nll}")
        zero_head = dict(params, lm_head=torch.zeros_like(params["lm_head"]))
        p0 = ppl.perplexity(cfg, zero_head, tokens, window=W_, batch=B_)
        del zero_head
        say(f"  (a) zeroed lm_head: ppl {p0:.6f} (vocab {cfg.vocab_size}, "
            f"rel {rel(p0, cfg.vocab_size):.2e})")
        if rel(p0, cfg.vocab_size) > 1e-5:
            raise AssertionError(f"4m (a): a zeroed lm_head gives ppl {p0}")
        win = tokens[:W_]
        one, n1, _ = scored(params, toks=win)
        cache = kvc.new_kv_cache(cfg.num_layers, 1, cfg.num_kv_heads, W_,
                                 cfg.head_dim, dtype=cfg.dtype, device=dev)
        ids = ints([win])
        logits, _ = llama.forward_all_logits(
            cfg, EngineConfig(max_batch_size=1, max_seq_len=W_), params, ids,
            cache, ints([0]), ints([W_]))
        lp = torch.log_softmax(logits[0, :-1].double(), -1).gather(
            -1, ids[0, 1:, None].long())
        direct = -lp.sum().item()
        del cache, logits, lp
        say(f"  (a) one window (B = {B_}, 3 rows empty) {one:.6f} against "
            f"forward_all_logits at B = 1 {direct:.6f}: rel "
            f"{rel(one, direct):.2e} ({n1} predictions)")
        if n1 != W_ - 1 or rel(one, direct) > 1e-3:
            raise AssertionError("4m (a): one window disagrees with the "
                                 "direct forward")
        nll_t, n_t, s_t = scored(params, EngineConfig(kernels="torch"))
        say(f"  (a) kernels='torch': mean NLL {nll_t / n_t:.6f} against "
            f"{nll / n:.6f} (rel {rel(nll / n, nll_t / n_t):.2e}); "
            f"{s_t:.3f} s")
        if n_t != n or rel(nll / n, nll_t / n_t) > 2e-2:
            raise AssertionError("4m (a): the kernel route's mean NLL is off "
                                 "the plain route's")
        cfg_json = tmp / f"llama2-7b-{EVAL_CLI_LAYERS}l.json"
        cfg_json.write_text(json.dumps(dataclasses.asdict(cfg4)))
        data = tmp / "tokens.npy"
        np.save(data, np.asarray(tokens, np.int32))
        p4 = W.init_dummy_params(cfg4, seed=0, device=dev)
        want = ppl.perplexity(cfg4, W.quantize_params(p4, "int4", 128),
                              tokens, window=W_, batch=B_)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "llm_inference_engine_tpu_torch.evals.ppl",
             "--model", str(cfg_json), "--dummy-weights", "--data",
             str(data), "--quant", "int4"], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        cli = (json.loads(proc.stdout.strip().splitlines()[-1])
               if proc.returncode == 0 else {})
        say(f"  (a) python -m llm_inference_engine_tpu_torch.evals.ppl "
            f"--quant int4 (llama2-7b width, {EVAL_CLI_LAYERS} layers, "
            f"dummy weights): exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.2f} s, {cli}; in process {want!r}")
        if not cli or cli["n_tokens"] != len(tokens) or rel(cli["ppl"],
                                                            want) > 1e-6:
            raise AssertionError(f"4m (a): the ppl CLI disagrees:\n"
                                 f"{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")

        # (b) taps
        prompts = [rng.integers(3, cfg.vocab_size, k).tolist()
                   for k in EVAL_TAP_PROMPTS]
        dumps = {}
        for kern in ("auto", "torch"):
            d = tmp / f"taps-{kern}"
            debug.set_dump_dir(str(d))
            try:
                engine = InferenceEngine(cfg, EngineConfig(
                    max_batch_size=2, max_seq_len=256, kernels=kern), params,
                    device=dev)
                t0 = time.perf_counter()
                got = engine.generate(prompts, SamplingParams(
                    greedy=True, max_new_tokens=EVAL_TAP_NEW),
                    eos_token_id=None).token_ids
                s_tap = time.perf_counter() - t0
            finally:
                debug.set_dump_dir(None)
            del engine
            files = sorted(os.listdir(d))
            names = {f.split("_", 1)[1][:-4] for f in files}
            norms = [np.load(d / f).shape for f in files
                     if f.endswith("_L0_attn_norm.npy")]
            say(f"  (b) tapped generate, kernels={kern!r}: ids {got}; "
                f"{len(files)} dumps of {len(names)} names in {s_tap:.2f} s; "
                f"L0_attn_norm shapes {norms}")
            # the prefill's dumps (T > 1), then decode steps' (T = 1)
            if (names != TAP_NAMES or norms[0][1] < 2
                    or not any(shape[1] == 1 for shape in norms)):
                raise AssertionError(f"4m (b): dump names or forwards: "
                                     f"{sorted(names ^ TAP_NAMES)}, {norms}")
            dumps[kern] = d
        bad = debug.compare_dumps(str(dumps["auto"]), str(dumps["torch"]))
        say(f"  (b) compare_dumps(kernels, torch) at 1e-3: "
            f"{len(bad)} names differ, none missing: "
            f"{not any(b.startswith('missing:') for b in bad)}")
        say("  (b) largest |kernels - torch| / max |torch| per name "
            "[prefill's first {} positions, first decode step]: ".format(
                min(EVAL_TAP_PROMPTS))
            + json.dumps(dump_errors(dumps["auto"], dumps["torch"],
                                     min(EVAL_TAP_PROMPTS))))
        if any(b.startswith("missing:") for b in bad):
            raise AssertionError(f"4m (b): the two routes dump other names: "
                                 f"{bad}")
        for d in dumps.values():
            shutil.rmtree(d)

        # (c) calibration
        calib = rng.integers(0, cfg.vocab_size, (1, EVAL_CALIB)).astype(
            np.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act_sq = W.calibrate_act_sq(cfg, params, [calib])
        torch.cuda.synchronize()
        s_cal = time.perf_counter() - t0
        t0 = time.perf_counter()
        qcal = W.quantize_params_calibrated(params, act_sq, "int4", 128)
        torch.cuda.synchronize()
        s_clip = time.perf_counter() - t0
        t0 = time.perf_counter()
        rtn = W.quantize_params(params, "int4", 128)
        torch.cuda.synchronize()
        s_rtn = time.perf_counter() - t0
        stats = {k: (tuple(v.shape), f"{v.min().item():.3e}",
                     f"{v.max().item():.3e}") for k, v in act_sq.items()}
        moved = [int((qcal["layers"][k].scale != rtn["layers"][k].scale).sum())
                 / rtn["layers"][k].scale.numel()
                 for k in ("wqkv", "wo", "w_gate_up", "w_down")]
        say(f"  (c) calibrate_act_sq over {EVAL_CALIB} tokens: {s_cal:.3f} s "
            f"(shape, min, max: {stats}); quantize_params_calibrated int4 "
            f"(clip search): {s_clip:.3f} s, quantize_params: {s_rtn:.3f} s; "
            f"share of scale blocks clipped (wqkv, wo, gate|up, down): "
            f"{[round(x, 4) for x in moved]}")
        if param_format(qcal) != param_format(rtn) or not all(
                bool(torch.isfinite(v).all()) and v.min().item() >= 0
                for v in act_sq.values()):
            raise AssertionError("4m (c): the calibrated format differs from "
                                 "quantize_params', or act_sq is not finite")
        hf = tmp / "hf"
        hf.mkdir()
        write_hf_checkpoint(cfg4, p4, hf)
        npz = tmp / "calibrated-int4.npz"
        t0 = time.perf_counter()
        if quantize.main(["--model", str(cfg_json), "--checkpoint", str(hf),
                          "--mode", "int4", "--calibrate",
                          f"random:{EVAL_CALIB}", "--out", str(npz)]) != 0:
            raise AssertionError("4m (c): tools/quantize --calibrate failed")
        s_tool = time.perf_counter() - t0
        shutil.rmtree(hf)
        toks4 = np.random.default_rng(0).integers(
            0, cfg4.vocab_size, size=(1, EVAL_CALIB)).astype(np.int32)
        want4 = W.quantize_params_calibrated(
            p4, W.calibrate_act_sq(cfg4, p4, [toks4]), "int4", 128)
        bad = unequal_leaves(torch, W.load_saved_params(str(npz), dev), want4)
        say(f"  (c) tools/quantize --calibrate random:{EVAL_CALIB} over an HF "
            f"directory ({EVAL_CLI_LAYERS} layers): {s_tool:.2f} s; leaves "
            f"unlike the in-process run: {bad}")
        if bad:
            raise AssertionError(f"4m (c): the calibrated .npz differs in "
                                 f"{bad}")
        del want4, p4
        before = {k: f.launches for k, f in counters.items()}
        engine = create_engine(str(cfg_json), str(npz), EngineConfig(
            quant_mode="int4", max_batch_size=2, max_seq_len=256), device=dev)
        got = engine.generate(prompts, SamplingParams(
            greedy=True, max_new_tokens=8), eos_token_id=None).token_ids
        ran = {k: counters[k].launches - before[k]
               for k in ("int4_matmul", "attention_decode")}
        del engine
        say(f"  (c) create_engine over the .npz: ids {got}; launches {ran}")
        if min(ran.values()) <= 0 or any(len(r) != 8 for r in got):
            raise AssertionError("4m (c): the calibrated engine did not run "
                                 "E and D")

        # (d) nan_guard
        ids = ints([tokens[:32]])

        def forward():
            c = kvc.new_kv_cache(cfg.num_layers, 1, cfg.num_kv_heads, 64,
                                 cfg.head_dim, dtype=cfg.dtype, device=dev)
            return llama.forward_all_logits(
                cfg, EngineConfig(max_batch_size=1, max_seq_len=64), params,
                ids, c, ints([0]), ints([32]))[0]
        t0 = time.perf_counter()
        guarded = nan_guard(forward)()
        s_guard = time.perf_counter() - t0
        same = torch.equal(guarded, forward())
        say(f"  (d) nan_guard over a clean forward (B 1, T 32): passed in "
            f"{s_guard:.3f} s, logits equal to the unguarded forward's: "
            f"{same}")
        if not same:
            raise AssertionError("4m (d): the guard changed the forward")
        layers = params["layers"]
        for leaf, want_op in (("wo", "aten.mm"),
                              ("ffn_norm", "kernel add_residual_rmsnorm")):
            w = layers[leaf][EVAL_NAN_LAYER].view(-1)
            keep = w[3].clone()
            w[3] = float("nan")
            try:
                nan_guard(forward)()
                msg = None
            except checks.NonFiniteError as e:
                msg = str(e)
            finally:
                w[3] = keep
            say(f"  (d) a NaN planted in layer {EVAL_NAN_LAYER}'s {leaf}: "
                f"{msg}")
            if msg is None or f"NaN generated by {want_op}" not in msg:
                raise AssertionError(f"4m (d): the guard did not name "
                                     f"{want_op}: {msg}")

        # (e) perplexities (printed): dummy weights say nothing of quality
        t0 = time.perf_counter()
        report = ppl.quant_ppl_report(cfg, params, tokens, group_size=128,
                                      window=W_, batch=B_)
        s_rep = time.perf_counter() - t0
        nll_c, _, s_int4c = scored(qcal)
        nll_r, _, s_int4 = scored(rtn)
        nll_k, _, s_kv8 = scored(params, EngineConfig(
            kv_cache_dtype_name="int8"))
        say(f"  (e) quant_ppl_report (group 128; {s_rep:.2f} s with two "
            f"quantizations): " + json.dumps(
                {k: float(f"{v:.6g}") for k, v in report.items()}))
        say(f"  (e) INT4 calibrated ppl {math.exp(nll_c / n):.6g} beside RTN "
            f"{math.exp(nll_r / n):.6g}; bf16 with an int8 KV cache "
            f"{math.exp(nll_k / n):.6g} beside bf16 {math.exp(nll / n):.6g}")

        # (f) cost
        say(f"  (f) tokens scored a second: bf16 {n / s_bf16:.1f}, INT4 "
            f"{n / s_int4:.1f} (calibrated {n / s_int4c:.1f}), bf16 + int8 "
            f"KV {n / s_kv8:.1f}, kernels='torch' {n / s_t:.1f}")
        batch = tokens[:B_ * (W_ - 1) + 1]          # one batch of 4 windows
        for label, p, eng in (("bf16", params, None), ("INT4", rtn, None),
                              ("bf16 + int8 KV", params, EngineConfig(
                                  kv_cache_dtype_name="int8"))):
            scorer = ppl.Scorer(cfg, p, eng, window=W_, batch=B_)
            scorer.score(batch)
            with profiling.trace(str(tmp / "trace")) as prof:
                scorer.score(batch)
            prof_ = profile_of(prof, 1)
            say(f"  (f) {label}, one batch ({B_} x {W_}): card busy "
                f"{prof_.busy:.3f} ms; by group: {_groups(prof_.per_kernel)}")
        del rtn, qcal
        say(f"  (f) calibration {s_cal:.3f} s, clip search {s_clip:.3f} s; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        launches = {k: f.launches for k, f in counters.items()}
        say(f"  4m launches: {_launch_counts(counters)}")
        must, must_not = EVAL_PATH
        missing = [k for k in must if launches[k] <= 0]
        extra = [k for k in must_not if launches[k]]
        if missing or extra:
            raise AssertionError(f"4m: kernels never launched {missing}; "
                                 f"kernels that must not launch {extra}")
    finally:
        debug.set_dump_dir(None)
        shutil.rmtree(tmp, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()


# 4n: a model rank's local shapes of llama2-7b under tp = 2: E and F's
# (k, n, halves), the column-sharded wqkv, gate|up and vocab, the
# row-sharded wo and down (k 5504: 43 groups, 21.5 decode stages of 256);
# 16 of the 32 heads
TP2_SHAPES = {"wqkv": (4096, 6144, 1), "wo": (2048, 4096, 1),
              "gate_up": (4096, 5504, 2), "down": (5504, 4096, 1),
              "lm_head": (4096, 16000, 1)}
TP2_HEADS = 16
# 4n (d)'s requests: prompts of one chunk, so that the paged scheduler runs
# (a)'s generate's steps (one prefill at one bucket, then decode)
TP2_SCHED_PROMPTS = (5, 17, 40, 64)


def tp2_kernel_rows(torch, dev, results) -> None:
    """4n (e): the kernels at a model rank's local shapes under tp = 2,
    every input at the head of a buffer whose tail holds NaN
    (``poisoned``) and every cache row past kv_len NaN, held against the
    plain versions (on clean copies) and timed beside them, with their
    bounds and library calls: E and F at m 8 and 512 on TP2_SHAPES, G
    on TP2_SHAPES (the m >= 1024 route of 4n's first prefill chunk), B at
    [8, 2 x 5504], C and I writing 4b's first chunk (8 x 512, ragged) at
    16 heads, D2 attending it, D's fused decode at 4b's decode contexts,
    and ``tp2_paged_rows``."""
    from llm_inference_engine_tpu_torch.ops import activations, attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import quant
    gen = torch.Generator(device=dev).manual_seed(2024)
    for mode in ("int4", "int8"):
        for m in (8, 512):
            for label in TP2_SHAPES:
                quant_case(torch, dev, gen, results, mode, m, label,
                           TP2_SHAPES, tag="tp2 ", poison=True)
    torch.cuda.empty_cache()

    def g(t, kern):
        return quant.dequant_int4(t.q, t.scale, 128, kernels=kern)
    for label, (k, n, halves) in TP2_SHAPES.items():
        ts = quant_weights(torch, quant, dev, gen, "int4", k, n, halves,
                           120_000_000)
        ts[0] = quant.QuantizedTensor(poisoned(torch, ts[0].q),
                                      poisoned(torch, ts[0].scale), "int4",
                                      128)
        got, want = g(ts[0], "cuda"), g(ts[0], "torch")
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"dequant_int4 tp2 {label}: not "
                                 "bit-identical to the plain dequant")
        check_close(torch, "dequant_int4", got, want, results,
                    f"tp2 {label} [{k // 2},{halves * n}] -> bf16 "
                    "(torch.equal), NaN past the tail",
                    (time_ms(torch, cycling(ts, lambda t: g(t, "cuda"))),
                     time_ms(torch, cycling(ts, lambda t: g(t, "torch")),
                             iters=3, warmup=1)),
                    work=(ts[0].nbytes + k * halves * n * 2,
                          2 * k * halves * n))
        del ts, got, want
    torch.cuda.empty_cache()
    nan = float("nan")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    gu = poisoned(torch, randn(8, 2 * 5504))
    check_close(torch, "silu_and_mul",
                activations.silu_and_mul(gu, kernels="cuda"),
                activations.silu_and_mul_torch(gu), results,
                "tp2 [8,11008] NaN past the tail", (
                    time_ms(torch, lambda: activations.silu_and_mul(
                        gu, kernels="cuda")),
                    time_ms(torch, lambda: activations.silu_and_mul_torch(
                        gu))),
                work=(3 * 8 * 5504 * 2, 5 * 8 * 5504))

    L, B, S, K, D, T = 2, 8, 2048, TP2_HEADS, 128, 512
    new_len_l = [min(n, T) for n in QUANT_PROMPTS]
    starts_l = [0] * B
    starts, new_len = ints(starts_l), ints(new_len_l)
    kv_len = starts + new_len
    kn, vn = poisoned(torch, randn(B, T, K, D)), poisoned(torch,
                                                          randn(B, T, K, D))
    rows, picked = slot_rows(starts_l, new_len_l, T, S)
    cache = kvc.new_kv_cache(L, B, K, S, D, device=dev)
    ref = kvc.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths)
    kvc.update_cache_at_layer(cache, 1, kn, vn, starts, new_len,
                              kernels="cuda")
    kvc.update_cache_at_layer_torch(ref, 1, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    if not (torch.equal(cache.k, ref.k) and torch.equal(cache.v, ref.v)):
        raise AssertionError("kv_write at 16 heads: cache differs from the "
                             "plain write")
    check_close(torch, "kv_write", cache.k[1], ref.k[1], results,
                "tp2 [8,512,16,128] 4b's first chunk, cold L2", (
                    time_ms(torch, lambda: kvc.update_cache_at_layer(
                        cache, 1, kn, vn, starts, new_len, kernels="cuda"),
                        cold=True),
                    time_ms(torch, lambda: kvc.update_cache_at_layer_torch(
                        ref, 1, kn, vn, starts, new_len))),
                work=write_work(len(rows), K, D),
                library=index_copy_ms(torch, (cache.k[1], cache.v[1]),
                                      (kn, vn), (ints(rows).long(),
                                                 ints(picked).long())),
                floor=floor_ms(torch, (kn, vn), picked, torch.bfloat16,
                               cold=True))
    c8 = kvc.new_kv_cache(L, B, K, S, D, device=dev, quantized=True,
                          snapped=True)
    ref8 = dataclasses.replace(c8, **{n: getattr(c8, n).clone() for n in (
        "k", "v", "k_scale", "v_scale")})
    kvc.update_cache_at_layer(c8, 1, kn, vn, starts, new_len, kernels="cuda")
    kvc.update_cache_at_layer_torch(ref8, 1, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    if not (torch.equal(c8.v, ref8.v) and torch.equal(c8.v_scale,
                                                      ref8.v_scale)):
        raise AssertionError("kv_write_quant at 16 heads: v differs")
    hold_int8_write(torch, "kv_write_quant", (c8.k, c8.k_scale),
                    (ref8.k, ref8.k_scale), results,
                    "tp2 [8,512,16,128] 4b's first chunk snapped, cold L2", (
                        time_ms(torch, lambda: kvc.update_cache_at_layer(
                            c8, 1, kn, vn, starts, new_len, kernels="cuda"),
                            cold=True),
                        time_ms(torch, lambda: kvc.update_cache_at_layer_torch(
                            ref8, 1, kn, vn, starts, new_len))),
                    work=write_work(len(rows), K, D, quant=True))
    del c8, ref8

    # D2 attends the chunk just written; rows past kv_len NaN
    for b, n in enumerate(new_len_l):
        cache.k[1, b, n:] = nan
        cache.v[1, b, n:] = nan
    q = poisoned(torch, randn(B, T, K, D))
    run = lambda: attention.attention(  # noqa: E731
        q, cache.k, cache.v, starts, kv_len, layer=1, kernels="cuda")
    plain = lambda: attention.attention_torch(  # noqa: E731
        q, ref.k, ref.v, starts, kv_len, layer=1)
    check_close(torch, "attention_prefill", run(), plain(), results,
                "tp2 B8 T512 H16 K16 4b's first chunk, NaN past kv_len",
                (time_ms(torch, run, iters=5),
                 time_ms(torch, plain, iters=3, warmup=1)),
                work=attn_work(starts_l, new_len_l, T, K, K, D),
                library=sdpa_ms(torch, q, ref.k[1], ref.v[1], starts,
                                kv_len))
    del cache, ref

    # D's fused decode at 4b's decode contexts; rows past kv_len NaN
    hist = [p + 16 + f + 16 for p, f in zip(QUANT_PROMPTS, QUANT_FOLLOW)]
    c = kvc.new_kv_cache(L, B, K, S, D, device=dev)
    c.k.copy_(randn(L, B, S, K, D))
    c.v.copy_(randn(L, B, S, K, D))
    ref = kvc.KVCache(c.k.clone(), c.v.clone(), c.lengths)
    for b, n in enumerate(hist):
        c.k[1, b, n + 1:] = nan
        c.v[1, b, n + 1:] = nan
    qs = ints(hist)
    kl = qs + 1
    qd = poisoned(torch, randn(B, 1, K, D))
    kn1, vn1 = poisoned(torch, randn(B, 1, K, D)), poisoned(torch,
                                                            randn(B, 1, K, D))
    run = lambda: attention.attention_decode_fused(  # noqa: E731
        qd, kn1, vn1, c.k, c.v, qs, kl, 1, kernels="cuda")[0]
    plain = lambda: attention.attention_decode_fused_torch(  # noqa: E731
        qd, kn1, vn1, ref.k, ref.v, qs, kl, 1)[0]
    got, want = run(), plain()
    torch.cuda.synchronize()
    b_idx = torch.arange(B, device=dev)
    for x, y in ((c.k, ref.k), (c.v, ref.v)):
        if not torch.equal(x[1, b_idx, qs.long()], y[1, b_idx, qs.long()]):
            raise AssertionError("attention_decode at 16 heads: the fused "
                                 "write differs from the plain write")
    say_plan(attention, "tp2 B8 H16 K16 D128", B, K, K, D)
    check_close(torch, "attention_decode", got, want, results,
                f"tp2 B8 H16 K16 4b contexts {min(hist)}-{max(hist)}, NaN "
                "past kv_len", (time_ms(torch, run),
                                time_ms(torch, plain, iters=3, warmup=1)),
                work=attn_work(hist, [h + 1 for h in hist], 1, K, K, D,
                               new_rows=B * 2 * K * D * 2 * 2),
                library=sdpa_ms(torch, qd, ref.k[1], ref.v[1], qs, kl),
                row_rel=DECODE_ROW_TOL)
    del c, ref
    torch.cuda.empty_cache()
    # J at a rank's local heads (K = 16): 4b's first chunk and its decode
    # step, and the step in graph replays
    for n, case in ((8 * 512, "tp2 prefill 8 x 512"), (8, "tp2 decode")):
        rope_case(torch, gen, results, case, n, TP2_HEADS, 1, 128)
    rope_replayed_rows(torch, dev, "tp2", TP2_HEADS, 1, 128)
    tp2_paged_rows(torch, dev, gen, results)


def tp2_paged_rows(torch, dev, gen, results) -> None:
    """4n (e), paged: H, D2's paged mode and D's paged decode at 16 heads
    over a pool of 4n (d)'s (pages of 64, 1 + 8 x 32 pages, B = 8), its
    table a random page permutation cut to each row's pages (entries past
    them at the scratch page 0, as the engine's): H writing 4n (d)'s
    prefill chunk (TP2_SCHED_PROMPTS in rows 0-3, four empty rows) and its
    last decode step's rows, each bit-identical to the plain write; D2
    attending the chunk and D the last decode step's contexts, every pool
    row no key below kv_len maps to NaN (the scratch page, the unused
    pages, the tails of the last used ones), held against the plain
    versions on a clean copy. Library calls: ``index_copy_`` for H, SDPA
    over the rows' pages gathered into a slot layout beforehand for D2
    and D."""
    from llm_inference_engine_tpu_torch.ops import attention
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    L, B, S, K, D, page = 2, 8, 2048, TP2_HEADS, 128, 64
    maxp = S // page
    P = 1 + B * maxp

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    perm = (torch.randperm(P - 1, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(B, maxp)

    def cut(kv_len):
        used = [-(-n // page) for n in kv_len]
        return torch.where(torch.arange(maxp, device=dev)[None, :]
                           < ints(used)[:, None], perm, 0).to(
            torch.int32).contiguous()

    def live_mask(table, kv_len):
        """Pool rows [P * page] that a key below kv_len maps to."""
        keep = torch.zeros(P * page, dtype=torch.bool, device=dev)
        for b, n in enumerate(kv_len):
            j = torch.arange(n, device=dev)
            keep[table[b, j // page].long() * page + j % page] = True
        return keep

    def gathered(pool, table):
        """A layer's pages of each row in a slot layout [B, S, K, D]."""
        return pool[table.long()].reshape(B, maxp * page, K, D)

    # 4n (d): prompts in rows 0-3 of 8; 16 decode steps after the prefill
    chunk = list(TP2_SCHED_PROMPTS) + [0] * (B - len(TP2_SCHED_PROMPTS))
    last = [n + 16 if n else 0 for n in chunk]       # the last step's kv_len
    k, v = randn(L, P, page, K, D), randn(L, P, page, K, D)
    cache = pkv.PagedKVCache(k, v, cut(chunk), ints([0] * B))
    ref = pkv.PagedKVCache(k[1:].clone(), v[1:].clone(), cache.block_table,
                           cache.lengths)

    # H: the prefill chunk (T 64), then the last decode step's rows
    kn, vn = poisoned(torch, randn(B, 64, K, D)), poisoned(torch,
                                                           randn(B, 64, K, D))
    starts, new_len = ints([0] * B), ints(chunk)
    pkv.paged_update_at_layer(cache, 1, kn, vn, starts, new_len,
                              kernels="cuda")
    pkv.paged_update_at_layer_torch(ref, 0, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    if not (torch.equal(cache.k[1], ref.k[0])
            and torch.equal(cache.v[1], ref.v[0])):
        raise AssertionError("paged_kv_write at 16 heads: the chunk's pool "
                             "differs from the plain write")
    table = cache.block_table.tolist()
    pos, picked = slot_rows([0] * B, chunk, 64, 0)
    flat = [table[i // 64][p // page] * page + p % page
            for p, i in zip(pos, picked)]
    check_close(torch, "paged_kv_write", cache.k[1], ref.k[0], results,
                f"tp2 B8 4n (d)'s chunk {list(TP2_SCHED_PROMPTS)} + 4 empty "
                "rows, page 64 cold L2",
                (time_ms(torch, lambda: pkv.paged_update_at_layer(
                    cache, 1, kn, vn, starts, new_len, kernels="cuda"),
                    cold=True),
                 time_ms(torch, lambda: pkv.paged_update_at_layer_torch(
                     ref, 0, kn, vn, starts, new_len))),
                work=write_work(len(pos), K, D),
                library=index_copy_ms(torch, (cache.k[1], cache.v[1]),
                                      (kn, vn), (ints(flat).long(),
                                                 ints(picked).long())),
                floor=floor_ms(torch, (kn, vn), picked, torch.bfloat16,
                               cold=True))
    cache.block_table.copy_(cut(last))
    kn1, vn1 = poisoned(torch, randn(B, 1, K, D)), poisoned(torch,
                                                            randn(B, 1, K, D))
    qs = [n - 1 if n else 0 for n in last]
    step = ints([1 if n else 0 for n in last])
    pkv.paged_update_at_layer(cache, 1, kn1, vn1, ints(qs), step,
                              kernels="cuda")
    pkv.paged_update_at_layer_torch(ref, 0, kn1, vn1, ints(qs), step)
    torch.cuda.synchronize()
    if not (torch.equal(cache.k[1], ref.k[0])
            and torch.equal(cache.v[1], ref.v[0])):
        raise AssertionError("paged_kv_write at 16 heads: the decode rows' "
                             "pool differs from the plain write")
    check_close(torch, "paged_kv_write", cache.k[1], ref.k[0], results,
                f"tp2 B8 4n (d)'s last decode step, kv_len {last}")

    # D2: the chunk, rows of kv_len 0 included
    clean_k, clean_v = ref.k[0], ref.v[0]
    table_c = cut(chunk)
    dead = ~live_mask(table_c, chunk)
    cache.k[1].view(P * page, K, D)[dead] = float("nan")
    cache.v[1].view(P * page, K, D)[dead] = float("nan")
    q = poisoned(torch, randn(B, 64, K, D))
    kv_len = ints(chunk)
    run = lambda: attention.attention(  # noqa: E731
        q, cache.k, cache.v, starts, kv_len, layer=1, table=table_c,
        kernels="cuda")
    plain = lambda: attention.attention(  # noqa: E731
        q, ref.k, ref.v, starts, kv_len, layer=0, table=table_c,
        kernels="torch")
    check_close(torch, "attention_prefill_paged", run(), plain(), results,
                f"tp2 B8 T64 H16 K16 4n (d)'s chunk page 64, NaN past kv_len",
                (time_ms(torch, run), time_ms(torch, plain, iters=3,
                                              warmup=1)),
                work=attn_work([0] * B, chunk, 64, K, K, D),
                library=sdpa_ms(torch, q, gathered(clean_k, table_c),
                                gathered(clean_v, table_c), starts, kv_len))

    # D: the last decode step's contexts, rows of kv_len 0 included
    cache.k[1].copy_(clean_k)
    cache.v[1].copy_(clean_v)
    table_d = cut(last)
    dead = ~live_mask(table_d, last)
    cache.k[1].view(P * page, K, D)[dead] = float("nan")
    cache.v[1].view(P * page, K, D)[dead] = float("nan")
    qd = poisoned(torch, randn(B, 1, K, D))
    q_start, kv_len = ints(qs), ints(last)
    say_plan(attention, "tp2 paged B8 H16 K16 D128 page 64", B, K, K, D,
             page=page, max_pages=maxp)
    run = lambda: attention.attention_decode(  # noqa: E731
        qd, cache.k, cache.v, q_start, kv_len, 1, table=table_d,
        kernels="cuda")
    plain = lambda: attention.attention_decode(  # noqa: E731
        qd, ref.k, ref.v, q_start, kv_len, 0, table=table_d,
        kernels="torch")
    # the empty rows give zeros; the row limit holds the others
    got, want = run(), plain()
    live = ints([b for b, n in enumerate(last) if n]).long()
    empty = ints([b for b, n in enumerate(last) if not n]).long()
    if got[empty].abs().max().item() or want[empty].abs().max().item():
        raise AssertionError("attention_decode_paged at 16 heads: a row of "
                             "kv_len 0 is not zero")
    check_close(torch, "attention_decode_paged", got[live], want[live],
                results, f"tp2 B8 H16 K16 4n (d)'s last step kv_len {last} "
                "(the 4 live rows held), NaN past kv_len",
                (time_ms(torch, run),
                           time_ms(torch, plain, iters=3, warmup=1)),
                work=attn_work(qs, last, 1, K, K, D),
                library=sdpa_ms(torch, qd, gathered(clean_k, table_d),
                                gathered(clean_v, table_d), q_start, kv_len),
                row_rel=DECODE_ROW_TOL)
    # D's fused paged decode of the same step (the engine's at tp = 2): it
    # writes the rows H wrote above again, so the pool keeps its bits and
    # the output is bit for bit the attend-only decode's
    before = [t[1].view(torch.int16).clone() for t in (cache.k, cache.v)]
    fused = lambda: attention.attention_decode_paged_fused(  # noqa: E731
        qd, kn1, vn1, cache.k, cache.v, q_start, kv_len, 1, table=table_d,
        kernels="cuda")[0]
    got_f = fused()
    torch.cuda.synchronize()
    if not (torch.equal(got_f, got) and all(
            torch.equal(t[1].view(torch.int16), b)
            for t, b in zip((cache.k, cache.v), before))):
        raise AssertionError("attention_decode_paged_fused at 16 heads: "
                             "pool or output differs from H then the "
                             "attend-only decode")
    check_close(torch, "attention_decode_paged_fused", got_f[live],
                want[live], results, f"tp2 B8 H16 K16 4n (d)'s last step "
                f"kv_len {last} (bits equal H + attend-only), NaN past "
                "kv_len and the new rows",
                (time_ms(torch, fused),
                 time_ms(torch, plain, iters=3, warmup=1)),
                work=attn_work(qs, last, 1, K, K, D,
                               new_rows=len(live) * 2 * K * D * 2 * 2),
                row_rel=DECODE_ROW_TOL)
    del cache, ref, k, v
    torch.cuda.empty_cache()


def mesh_steps(torch, engine, toks, active, tag: str, n: int = 16,
               beside: tuple = ("int4", "4b")) -> list:
    """A mesh engine's decode programs: n steps through the eager bodies
    and the same n through the CUDA-graph replays (twice, the first with
    the capture, whose warm-up launches count), from one state: ids, and
    the launch counts of the second replayed run, must equal the eager
    run's.
    Prints wall a step of each, the replayed step's card busy (union of
    intervals over 4 steps) and idle share, its device ms by group with
    the cross-rank sums split out of the torch glue (``glue_labels``), and
    the one-rank step beside it (``beside``: its DECODE key and label;
    4b's by default; None: none). Returns the eager ids."""
    from llm_inference_engine_tpu_torch.config import SamplingParams
    from llm_inference_engine_tpu_torch.runtime.decode_graph import (
        run_eagerly)
    B = engine.engine_config.max_batch_size
    snap = snapshot(engine)
    eager_ids, eager_ms, eager_l = _steps(torch, engine, toks, active, n,
                                          True)
    restore(engine, snap)
    graph_ids, _, _ = _steps(torch, engine, toks, active, n, False)
    restore(engine, snap)
    again, graph_ms, graph_l = _steps(torch, engine, toks, active, n, False)
    state = {}

    def step():
        state["toks"] = engine.decode_step(state["toks"], active,
                                           SamplingParams(greedy=True))
    restore(engine, snap)
    state["toks"] = toks
    prof = device_profile(torch, step, 4)
    restore(engine, snap)
    state["toks"] = toks
    with run_eagerly(engine), glue_labels():
        _, cpu_prof = device_profile(torch, step, 1, cpu_ops=True)
    glue = glue_map(cpu_prof)
    restore(engine, snap)
    groups = group_ms(prof.per_kernel, glue)
    cp_ms = label_ms(cpu_prof, prof.per_kernel, "CP")
    del cpu_prof
    one = DECODE.get(beside[0], {}) if beside else {}
    say(f"  {tag} decode, eager / graphs: wall {eager_ms:.3f} / "
        f"{graph_ms:.3f} ms/step ({B * 1e3 / graph_ms:.1f} tok/s replayed "
        f"at B={B}); replayed card busy {prof.busy:.3f} ms/step, idle "
        f"{1 - prof.busy / graph_ms:.3f}; cross-rank sums "
        f"{groups['sums']:.4f} ms/step of durations summed "
        f"{prof.summed:.3f}" + (
            f"; one-rank {beside[1]}: wall {one.get('graph_ms', 0):.3f}"
            f" ms/step, busy {min(one.get('graph_busy_ms', [0])):.3f}"
            if beside else ""))
    say(f"  {tag} replayed decode step, device ms by group: "
        f"{_groups(prof.per_kernel, glue)}; by kernel: "
        + "; ".join(f"{_short(name)} {ms:.4f}"
                    for ms, name in prof.per_kernel[:8]))
    if engine.cp > 1:
        say(f"  {tag} replayed decode step: the split-KV attention (torch "
            f"math, its matmuls included) {cp_ms:.4f} ms of durations "
            f"summed {prof.summed:.3f}")
    failures = []
    if graph_ids != eager_ids or again != eager_ids:
        failures.append("replayed steps differ from the eager steps")
    if graph_l != eager_l:
        failures.append(f"launches of {n} replays {graph_l} != of {n} eager "
                        f"steps {eager_l}")
    say(f"  {tag} {n} replayed steps == {n} eager steps: "
        f"{graph_ids == eager_ids and again == eager_ids}; launches equal: "
        f"{graph_l == eager_l}")
    if failures:
        raise AssertionError(f"{tag}: " + "; ".join(failures))
    DECODE[tag] = dict(B=B, eager_ms=eager_ms, graph_ms=graph_ms,
                       graph_busy_ms=[prof.busy],
                       graph_summed_ms=prof.summed,
                       graph_groups_ms=groups)
    if engine.cp > 1:
        DECODE[tag]["cp_attention_ms"] = cp_ms
    return eager_ids


def dropped_rank_logits(engine, prompts):
    """``engine``'s prefill logits (from empty slots) with model rank 1's
    partial product left out of every cross-rank sum: the fault that
    ``first_token_rule``'s distance limit must see (instrumentation of
    that check only; ``rank_sum`` is restored after)."""
    from llm_inference_engine_tpu_torch.parallel import sharding
    plain = sharding.rank_sum
    sharding.rank_sum = lambda parts, devices: plain(parts[:1], devices)
    try:
        engine.reset()
        return engine.prefill(prompts)
    finally:
        sharding.rank_sum = plain
        engine.reset()


def first_token_rule(tag: str, logits, ref_logits, ref_ids,
                     faulted) -> None:
    """A mesh engine's prefill logits against a one-rank engine's kernel
    path: their relative L2 distance at most TP_LOGIT_REL_L2, and that of
    ``faulted`` (``dropped_rank_logits``; None: no fault here) above it;
    then the tie rule of 4a-4j: a row's first token must equal the
    one-rank engine's, or lie in its top 2 where the one-rank top-1/top-2
    margin is below the largest logit difference between the two
    engines."""
    d, r = _logit_diff(logits, ref_logits)
    fr = None
    if faulted is not None:
        fd, fr = _logit_diff(faulted, ref_logits)
        say(f"  {tag} with model rank 1's partial left out of every sum "
            f"(planted): max abs {fd:.4e}, rel L2 {fr:.4e}; limit "
            f"{TP_LOGIT_REL_L2:.1e}")
    if r > TP_LOGIT_REL_L2:
        raise AssertionError(f"{tag}: prefill logits rel L2 {r:.4e} from the "
                             f"one-rank engine's, over {TP_LOGIT_REL_L2}")
    if fr is not None and fr <= TP_LOGIT_REL_L2:
        raise AssertionError(f"{tag}: the limit {TP_LOGIT_REL_L2} cannot see "
                             f"a partial product left out (rel L2 {fr:.4e})")
    top2, top2_ids = ref_logits.topk(2, dim=-1)
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    got = logits.argmax(-1).tolist()
    want = [ids[0] for ids in ref_ids]
    differ = [i for i in range(len(got)) if got[i] != want[i]]
    bad = [i for i in differ if margins[i] >= d
           or got[i] not in top2_ids[i].tolist()]
    say(f"  {tag} prefill logits against the one-rank engine: max abs "
        f"{d:.4e}, rel L2 {r:.4e}; first tokens {got}; rows that differ "
        f"{differ} (one-rank top-2 margins "
        f"{[round(margins[i], 4) for i in differ]})")
    if bad:
        raise AssertionError(f"{tag}: first tokens differ from the one-rank "
                             f"engine's outside the tie rule in rows {bad}")


def _path_launches(tag: str, counters, expected) -> dict:
    """Every kernel of ``expected`` launched since the counters were set
    to 0 (printed)."""
    launches = _launch_counts(counters)
    say(f"  launches during {tag}: {launches}")
    missing = [n for n in expected if not launches.get(n)]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched {missing}")
    return launches


def phase_parallel(torch, dev, results) -> None:
    """4n: tensor and data parallelism on one card, llama2-7b INT4 (4b's
    weights and prompts), B = 8, meshes of two ranks on cuda:0, every
    launch counter set to 0 just before each path and read just after:
    4b's seed-0 weights made again: (a) tp = 2: prefill logits within
    TP_LOGIT_REL_L2 of 4b's (and a partial product left out, beyond it),
    first tokens under the tie rule, 16 greedy tokens, ``mesh_steps``, and the launches of one decode
    step (A and B per rank); (b) dp = 2: 16 greedy ids identical to 4b's;
    (c) tp = 2 with the int8 slot cache: against 4g as (a) against 4b;
    (d) tp = 2 paged (pages of 64) through the scheduler: 4 requests whose
    ids must equal (a)'s engine's ``generate`` of the same prompts; (e)
    ``tp2_kernel_rows``."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_quantized_params)
    from llm_inference_engine_tpu_torch.parallel import make_mesh, sharding
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    from llm_inference_engine_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)

    base, kv8 = MAIN_RUNS["int4"], MAIN_RUNS["int4-kv8"]
    cfg = get_config("llama2-7b")
    L, B = cfg.num_layers, 8
    eng = EngineConfig(quant_mode="int4", max_batch_size=B, max_seq_len=2048)
    prompts = base["prompts"]
    greedy = SamplingParams(greedy=True, max_new_tokens=16)
    active = np.ones(B, bool)
    tp2 = make_mesh(1, 2, devices=[dev, dev])
    # 4b's weights (create_engine's for llama2-7b INT4, seed 0)
    params = init_dummy_quantized_params(cfg, "int4", eng.quant_group_size,
                                         seed=0, device=dev)
    sp = sharding.shard_params(params, tp2)

    def last(r):
        return torch.tensor([o[-1] for o in r.token_ids], device=dev,
                            dtype=torch.int32)

    # (a) tp = 2
    counters = _zero_counters()
    e = InferenceEngine(cfg, eng, sp)
    logits = e.prefill(prompts)
    first_token_rule("4n (a) tp=2", logits, base["logits"], base["ids"],
                     dropped_rank_logits(e, prompts))
    t0 = time.perf_counter()
    r = e.generate(prompts, greedy, eos_token_id=None)
    gen_s = time.perf_counter() - t0
    if [o[0] for o in r.token_ids] != logits.argmax(-1).tolist():
        raise AssertionError("4n (a): generate's first token is not the "
                             "prefill argmax")
    agree = sum(a == b for x, y in zip(r.token_ids, base["ids"])
                for a, b in zip(x, y))
    say(f"  4n (a) tp=2 generate of 16 greedy tokens {gen_s:.3f} s; tokens "
        f"agreeing with 4b position by position {agree}/{16 * B}; "
        f"tokens[0][:8] {r.token_ids[0][:8]}")
    mesh_steps(torch, e, last(r), active, "tp2 int4")
    rng = np.random.default_rng(3)
    sched_prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
                     for n in TP2_SCHED_PROMPTS]
    e.reset()
    sched_ref = e.generate(sched_prompts, greedy, eos_token_id=None).token_ids
    _path_launches("4n (a) tp=2", counters, MAIN_PATHS["int4"][0])
    _zero_counters()
    e.decode_step(last(r), active, SamplingParams(greedy=True))
    per_step = _launch_counts(counters)
    say(f"  4n (a) launches per tp=2 decode step (two ranks): {per_step}")
    check_norm_launches("4n tp=2 decode step", per_step, L, 2)
    del e
    torch.cuda.empty_cache()

    # (b) dp = 2: no row's arithmetic changes
    counters = _zero_counters()
    e = InferenceEngine(cfg, eng, params,
                        mesh=make_mesh(2, 1, devices=[dev, dev]))
    r = e.generate(prompts, greedy, eos_token_id=None)
    differ = [i for i in range(B) if r.token_ids[i] != base["ids"][i]]
    say(f"  4n (b) dp=2: 16 greedy ids identical to 4b's: {not differ}"
        + (f" (rows that differ: {differ})" if differ else ""))
    mesh_steps(torch, e, last(r), active, "dp2 int4")
    _path_launches("4n (b) dp=2", counters, MAIN_PATHS["int4"][0])
    del e, params
    torch.cuda.empty_cache()
    if differ:
        raise AssertionError(f"4n (b): dp=2 ids differ from 4b's in rows "
                             f"{differ}")

    # (c) tp = 2 with the int8 slot cache
    counters = _zero_counters()
    e = InferenceEngine(cfg, eng.replace(kv_cache_dtype_name="int8"), sp)
    snapped = [s.snapped for row in e.cache.shards for s in row]
    say(f"  4n (c) shards' int8 numerics snapped: {snapped}; KV "
        f"{sum(kv_bytes(s) for row in e.cache.shards for s in row) / 1e9:.2f}"
        " GB")
    logits = e.prefill(prompts)
    first_token_rule("4n (c) tp=2 int8 KV", logits, kv8["logits"],
                     kv8["ids"], dropped_rank_logits(e, prompts))
    r = e.generate(prompts, greedy, eos_token_id=None)
    mesh_steps(torch, e, last(r), active, "tp2 int4-kv8")
    _path_launches("4n (c) tp=2 int8 KV", counters, MAIN_PATHS["int4-kv8"][0])
    del e
    torch.cuda.empty_cache()

    # (d) tp = 2 paged, through the scheduler (its pure-decode steps
    # replayed), then again with the decode bodies run eagerly
    counters = _zero_counters()
    e = InferenceEngine(cfg, eng.replace(kv_layout="paged", page_size=64,
                                         max_prefill_len=64), sp)
    sched = ContinuousBatchingScheduler(e, eos_token_id=None)
    decode_steps = decode_phase_launches(sched, counters)
    reqs = [sched.submit(p, greedy) for p in sched_prompts]
    t0 = time.perf_counter()
    sched.run()
    wall = time.perf_counter() - t0
    ids = [q.output_ids for q in reqs]
    _check_paged_launches("4n (d) tp=2 paged scheduler", counters,
                          NORM_ACT + ("int4_matmul",) + BF16_PAGED)
    check_decode_step_launches("4n (d) tp=2 paged scheduler", decode_steps,
                               cfg.num_layers, ranks=2)
    from llm_inference_engine_tpu_torch.runtime.decode_graph import (
        run_eagerly)
    e.reset()
    sched = ContinuousBatchingScheduler(e, eos_token_id=None)
    with run_eagerly(e):
        eager = [sched.submit(p, greedy) for p in sched_prompts]
        sched.run()
    eager = [q.output_ids for q in eager]
    say(f"  4n (d) tp=2 paged scheduler: {len(reqs)} requests of "
        f"{list(TP2_SCHED_PROMPTS)} tokens, 16 greedy tokens each in "
        f"{wall:.3f} s; ids equal (a)'s engine's generate: "
        f"{ids == sched_ref}, equal with the decode bodies eager: "
        f"{ids == eager}; free pages after {e.free_pages}")
    del e, sched, sp
    MAIN_RUNS.clear()
    torch.cuda.empty_cache()
    if ids != sched_ref or ids != eager:
        raise AssertionError("4n (d): the paged tp=2 scheduler's ids differ "
                             "from the slot tp=2 engine's or from its "
                             "eager bodies'")

    # (e)
    tp2_kernel_rows(torch, dev, results)


# 4o: context parallelism at llama2-7b INT4 (4b's weights), B = 4, a
# context of 8192 (two seq logs of 4096 rows), chunks of 512: four
# prompts of 2 to 13 chunks
CP_ENGINE = dict(quant_mode="int4", max_batch_size=4, max_seq_len=8192,
                 max_prefill_len=512)
CP_PROMPTS = (1000, 2500, 4000, 6500)
# 4o: the prefill logits of a cp = 2 engine against the cp = 1 engine's on
# the same weights are held to TP_LOGIT_REL_L2: the two differ in bf16
# rounding only, in the attention arithmetic (the CP math in f32 against
# kernel D2's bf16 probabilities) and in where cuBLAS splits the
# projections (m 1024 a rank against 2048): 1.9e-4 (cp = 2), 1.8e-4 (int8
# log) and 4.4e-4 (cp = 2 x tp = 2) on an H100. The INT4 dummies' logits
# barely move with K/V (a ring that merges only each rank's own chunk
# moves them 9.3e-4), so the planted faults are held on the K rows
# instead (CP_FAULT_RATIO).
# 4o: layer 0's K rows written into the seq logs, put back in position
# order by kv_pos, against the cp = 1 cache's rows: the same projections
# of the same tokens through the same routing (G + cuBLAS at m 1024 and
# 2048), bit for bit on an H100 (a row at a wrong log tail or position is
# off by order 1)
CP_ROWS_REL_L2 = 0.0
# 4o: a planted fault (a ring of own chunks only; a model rank's partial
# left out of every sum) must move the last layer's K rows, against the
# cp = 1 cache, at least this many times as far as the clean path does
CP_FAULT_RATIO = 4.0


def _cp_rows_by_position(torch, engine, layer: int):
    """Layer ``layer``'s K rows of an engine in position order, f32
    [B, S, K, D] (an int8 cache dequantized; zeros where no row holds the
    position), and the count of rows placed: a cp engine's from every
    rank's log by kv_pos, a one-rank engine's as they lie."""
    cache, eng = engine.cache, engine.engine_config
    if engine.cp == 1:
        k = cache.k[layer].float()
        return (k if cache.k_scale is None
                else k * cache.k_scale[layer, ..., None]), None
    B, S = eng.max_batch_size, eng.max_seq_len
    k_local = engine.config.num_kv_heads // engine.mesh.tp
    out = torch.zeros((B, S, engine.config.num_kv_heads,
                       engine.config.head_dim), dtype=torch.float32,
                      device=engine.device)
    placed = 0
    for d, s, r, shard, kv_pos in cache.ranks():
        rows = range(cache.rows(d).start, cache.rows(d).stop)
        for b_local, b in enumerate(rows):
            n = int(engine._llen[b, s])
            k = shard.k[layer, b_local, :n].float()
            if shard.quantized:
                k = k * shard.k_scale[layer, b_local, :n, :, None]
            out[b, kv_pos[b_local, :n].long(),
                r * k_local:(r + 1) * k_local] = k.to(out.device)
            placed += n if r == 0 else 0
    return out, placed


def cp_rows_distance(torch, tag: str, engine, base, layer: int) -> float:
    """Rel L2 of ``engine``'s K rows of ``layer`` in position order
    against the cp = 1 engine ``base``'s over every valid position; the
    logs must hold as many rows as positions (a position held twice or
    missed leaves a zero row, and a distance of order 1)."""
    rows, placed = _cp_rows_by_position(torch, engine, layer)
    want, _ = _cp_rows_by_position(torch, base, layer)
    lengths = engine._lengths
    if placed != int(lengths.sum()):
        raise AssertionError(f"{tag}: the logs hold {placed} rows for "
                             f"{int(lengths.sum())} positions")
    num = den = 0.0
    for b, n in enumerate(lengths):
        num += (rows[b, :n] - want[b, :n]).pow(2).sum().item()
        den += want[b, :n].pow(2).sum().item()
    return (num / den) ** 0.5


@contextlib.contextmanager
def planted(module, name: str, make):
    """``module.name`` replaced by ``make(original)`` inside (a fault a
    check must see; put back after)."""
    plain = getattr(module, name)
    setattr(module, name, make(plain))
    try:
        yield
    finally:
        setattr(module, name, plain)


def ring_of_own_chunks(plain):
    """``seq_exchange`` whose ring hands each rank its own chunk at every
    position (the other ranks' chunks never merged)."""
    from llm_inference_engine_tpu_torch.parallel import context_parallel

    def exchange(requests, devices):
        replies = plain(requests, devices)
        if isinstance(requests[0], context_parallel.RingPass):
            return [[reply[i]] * len(reply)
                    for i, reply in enumerate(replies)]
        return replies
    return exchange


def cp_fault_probe(torch, tag: str, engine, base, prompts, fault) -> None:
    """The first 1024 tokens of each prompt through both engines from
    empty slots, clean and with ``fault()`` (a ``planted`` context) on
    ``engine``: the logits' and the last layer's K rows' rel L2 against
    the cp = 1 engine's printed; the fault must move the rows at least
    CP_FAULT_RATIO times as far as the clean path. Resets both engines."""
    short = [p[:1024] for p in prompts]
    last = engine.config.num_layers - 1
    base.reset()
    ref = base.prefill(short)
    out = []
    for ctx in (contextlib.nullcontext, fault):
        engine.reset()
        with ctx():
            logits = engine.prefill(short)
        out.append((_logit_diff(logits, ref)[1],
                    cp_rows_distance(torch, tag, engine, base, last)))
    engine.reset()
    base.reset()
    (lc, rc), (lf, rf) = out
    rc = max(rc, 1e-30)
    say(f"  {tag} on the prompts' first 1024 tokens, clean / planted fault: "
        f"logits rel L2 {lc:.4e} / {lf:.4e}; layer {last}'s K rows rel L2 "
        f"{rc:.4e} / {rf:.4e} ({rf / rc:.1f}x; at least {CP_FAULT_RATIO}x)")
    if rf < CP_FAULT_RATIO * rc:
        raise AssertionError(f"{tag}: the planted fault moves the K rows "
                             f"only {rf / rc:.2f}x as far as the clean path")


# kernels a cp engine's body must not launch: its attention is the CP
# torch math, and every rank writes its log with C (or I)
CP_ABSENT = ("attention_prefill", "attention_decode",
             "attention_prefill_int8", "attention_decode_int8")


def cp_launches(tag: str, engine, pre: dict, roll: dict, write: str) -> None:
    """A cp engine's own launches, counted from 0 over its prefill of
    CP_PROMPTS (``pre``) and then over its 15-step rollout (``roll``):
    every rank (data x seq x model) runs each forward's A and B
    (``check_norm_launches``) and ``write`` once a layer, in the prefill
    exactly ranks x chunks forwards, in the rollout a whole number of
    forwards of every rank; E on every path, G in the prefill (m 1024 a
    rank); the kernels of CP_ABSENT and the other log write never."""
    L = engine.config.num_layers
    mesh = engine.mesh
    ranks = mesh.dp * mesh.cp * mesh.tp
    chunks = -(-max(CP_PROMPTS) // engine.engine_config.max_prefill_len)
    say(f"  launches during {tag}'s prefill ({ranks} ranks x {chunks} "
        f"chunks): {pre}; during its rollout: {roll}")
    other = "kv_write" if write == "kv_write_quant" else "kv_write_quant"
    failures = []
    for what, counts, forwards in (("prefill", pre, ranks * chunks),
                                   ("rollout", roll, None)):
        try:
            check_norm_launches(f"{tag} {what}", counts, L, forwards)
        except AssertionError as e:
            failures.append(str(e))
        f = counts.get("rmsnorm", 0)
        if f % ranks or counts.get(write, 0) != L * f:
            failures.append(f"{what}: {counts.get(write, 0)} launches of "
                            f"{write} for {f} forwards of {L} layers over "
                            f"{ranks} ranks")
        for name in ("int4_matmul",) + (("dequant_int4",)
                                        if what == "prefill" else ()):
            if not counts.get(name):
                failures.append(f"{what}: {name} never launched")
        launched = [k for k in CP_ABSENT + (other,) if counts.get(k)]
        if launched:
            failures.append(f"{what}: launched {launched}")
    if failures:
        raise AssertionError(f"{tag}: " + "; ".join(failures))


def greedy_ids(torch, engine, logits, n: int) -> list:
    """The first token (the prefill logits' argmax) and n - 1 more from a
    replayed greedy decode_rollout, per row: generate's greedy ids
    without a second prefill."""
    first = logits.argmax(-1).to(torch.int32)
    rolled = engine.decode_rollout(first, n - 1).tolist()
    return [[int(first[i])] + [row[i] for row in rolled]
            for i in range(first.shape[0])]


def ids_or_ties(tag: str, ids, ref_ids, engine, base, prompts,
                ref: str = "cp=1") -> None:
    """Each row's ids equal the reference engine's (``base``, named
    ``ref``: the cp = 1 engine), or differ first at a near-tie: there
    both engines prefill the prompt and the reference ids before it, and
    the token must lie in the reference engine's top 2 with its
    top-1/top-2 margin below the largest logit difference between the
    two. The engines are reset after where a row differs."""
    differ, bad = [], []
    for i, (a, b) in enumerate(zip(ids, ref_ids)):
        if a == b:
            continue
        t = next(k for k in range(len(a)) if a[k] != b[k])
        lg = []
        for e in (engine, base):
            e.reset()
            lg.append(e.prefill([prompts[i] + b[:t]])[0])
        diff = (lg[0] - lg[1]).abs().max().item()
        top2, top2_ids = lg[1].topk(2)
        margin = (top2[0] - top2[1]).item()
        differ.append((i, t, round(margin, 4), round(diff, 4)))
        if margin >= diff or a[t] not in top2_ids.tolist():
            bad.append(i)
    say(f"  {tag} {len(ids[0])} greedy ids equal the {ref} engine's in "
        f"{len(ids) - len(differ)}/{len(ids)} rows; rows that differ (row, "
        f"first step, {ref} top-2 margin, logit difference there): "
        f"{differ}")
    if differ:
        engine.reset()
        base.reset()
    if bad:
        raise AssertionError(f"{tag}: ids differ from the {ref} engine's "
                             f"outside the tie rule in rows {bad}")


def cp_chunk_profile(torch, engine, chunk) -> dict:
    """One prefill chunk appended to every row, profiled with its CPU ops
    under ``glue_labels``: card busy, device ms by group, and the CP
    attention's ms (``label_ms``)."""
    with glue_labels():
        prof, cpu = device_profile(torch, lambda: engine.prefill(chunk), 1,
                                   cpu_ops=True)
    out = dict(busy=prof.busy, groups=group_ms(prof.per_kernel),
               cp=label_ms(cpu, prof.per_kernel, "CP"),
               top=prof.per_kernel[:6])
    del cpu
    return out


def first_layers(params: dict, n: int) -> dict:
    """``params`` with every per-layer stack cut to its first ``n`` layers
    (views: no copy)."""
    return {**params, "layers": {k: v[:n] for k, v in
                                 params["layers"].items()}}


def phase_context_parallel(torch, dev, results):
    """4o: context parallelism on one card, llama2-7b INT4 (4b's seed-0
    weights, their first DEPTH_CUT layers), B = 4, max_seq_len 8192,
    chunks of 512, prompts of CP_PROMPTS tokens, seq ranks on cuda:0,
    every launch counter set to 0 just before each path and read just
    after: (a) cp = 2 over a bf16 log
    against a cp = 1 engine on the same weights: a ring of own chunks
    planted (``cp_fault_probe``), prefill logits within TP_LOGIT_REL_L2
    and first tokens under the tie rule, layer 0's K rows in position
    order bit for bit the cp = 1 cache's (CP_ROWS_REL_L2), 16 greedy
    ids equal or ties only (``ids_or_ties``), the launches of the cp
    engine's prefill and rollout alone (``cp_launches``); (b)
    ``mesh_steps``: 16
    replayed steps equal to 16 eager ones, the step's wall, busy and
    idle, the split-KV math's ms; the cp = 1 engine's step at the same
    contexts (kernel D); one more 512-token chunk on both engines,
    profiled: the ring's ms against D2's; (c) the int8 log (snapped
    numerics) against the cp = 1 int8 slot cache, as (a); (d) cp = 2 x
    tp = 2, four ranks, against (a)'s cp = 1 engine, as (a) with a model
    rank's partial left out as the fault; (e) ``cp_write_rows``; the peak
    memory. Returns the full-depth weights (4p reuses them)."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_quantized_params)
    from llm_inference_engine_tpu_torch.parallel import (
        context_parallel, make_mesh, sharding)
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

    seven = get_config("llama2-7b")
    cfg = seven.replace(num_layers=DEPTH_CUT)
    eng = EngineConfig(**CP_ENGINE)
    B = eng.max_batch_size
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
               for n in CP_PROMPTS]
    active = np.ones(B, bool)
    torch.cuda.reset_peak_memory_stats()
    full = init_dummy_quantized_params(seven, "int4", eng.quant_group_size,
                                       seed=0, device=dev)
    params = first_layers(full, DEPTH_CUT)
    say(f"  4o: the first {DEPTH_CUT} of llama2-7b's {seven.num_layers} "
        "layers (a depth cut), full width")
    cp2 = make_mesh(1, 1, 2, devices=[dev, dev])
    t_phase = time.perf_counter()

    def ring_fault():
        return planted(context_parallel, "seq_exchange", ring_of_own_chunks)

    def elapsed(part):
        say(f"  4o {part} done at {time.perf_counter() - t_phase:.1f} s")

    def prefill(e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = e.prefill(prompts)
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t0

    def path(tag, e, b, fault, ref, write):
        """(a), (c), (d): the probe, the prompts through the cp = 1
        engine ``b`` where ``ref`` is None (its logits and ids become
        the reference), then through ``e``, whose own prefill and
        rollout ``cp_launches`` counts (``write``: its log's write
        kernel). Returns (ids, ref)."""
        cp_fault_probe(torch, tag, e, b, prompts, fault)
        if ref is None:
            ref_logits, seconds = prefill(b)
            ref = (ref_logits, greedy_ids(torch, b, ref_logits, 16))
            say(f"  {tag}: the cp=1 engine's prefill {seconds:.3f} s")
        counters = _zero_counters()
        logits, seconds = prefill(e)
        pre = _launch_counts(counters)
        say(f"  {tag} prefill of {list(CP_PROMPTS)} tokens (chunks of 512) "
            f"{seconds:.3f} s; logs' rows a rank {e._llen.tolist()}")
        _zero_counters()
        ids = greedy_ids(torch, e, logits, 16)
        roll = _launch_counts(counters)
        cp_launches(tag, e, pre, roll, write)
        first_token_rule(tag, logits, ref[0], ref[1], None)
        return ids, ref

    # (a) cp = 2, bf16 log
    base = InferenceEngine(cfg, eng, params)
    e = InferenceEngine(cfg, eng, params, mesh=cp2)
    say(f"  4o (a) seq ranks share their weights: "
        f"{e.params.shard(0, 0, 0) is e.params.shard(0, 1, 0)}")
    elapsed("set-up")
    ids, ref = path("4o (a) cp=2", e, base, ring_fault, None, "kv_write")
    layer0 = cp_rows_distance(torch, "4o (a)", e, base, 0)
    say(f"  4o (a) layer 0's K rows in position order (kv_pos) against "
        f"the cp=1 cache: rel L2 {layer0:.4e} (limit {CP_ROWS_REL_L2})")
    if layer0 > CP_ROWS_REL_L2:
        raise AssertionError(f"4o (a): layer 0's K rows rel L2 {layer0:.4e}")
    ids_or_ties("4o (a) cp=2", ids, ref[1], e, base, prompts)
    elapsed("(a)")

    # (b) the decode replays, the split-KV and ring times beside D's, D2's
    if e._lengths.sum() == 0:             # ids_or_ties reset the engines
        for x in (e, base):
            greedy_ids(torch, x, x.prefill(prompts), 16)
    last = torch.tensor([r[-1] for r in ref[1]], dtype=torch.int32,
                        device=dev)
    mesh_steps(torch, e, last, active, "cp2 int4", n=8)
    mesh_steps(torch, base, last, active, "cp1 int4 8k")
    ctx = e._lengths.tolist()
    chunk = [rng.integers(3, cfg.vocab_size, 512).tolist() for _ in range(B)]
    ring = cp_chunk_profile(torch, e, chunk)
    flat = cp_chunk_profile(torch, base, chunk)
    say(f"  4o (b) one 512-token chunk on every row at contexts {ctx}: cp=2 "
        f"card busy {ring['busy']:.3f} ms, ring attention (torch math, "
        f"both ranks, {DEPTH_CUT} layers) {ring['cp']:.3f} ms; cp=1 busy "
        f"{flat['busy']:.3f} ms, D2 {flat['groups']['D2']:.3f} ms")
    for tag, prof in (("cp=2", ring), ("cp=1", flat)):
        say(f"  4o (b) the chunk on {tag}, device ms by group: "
            + ", ".join(f"{g} {ms:.3f}" for g, ms in prof["groups"].items())
            + "; by kernel: " + "; ".join(f"{_short(name)} {ms:.3f}"
                                          for ms, name in prof["top"]))
    say(f"  4o (b) a replayed decode step at contexts {ctx}: cp=2 split-KV "
        f"{DECODE['cp2 int4']['cp_attention_ms']:.4f} ms, cp=1 D "
        f"{DECODE['cp1 int4 8k']['graph_groups_ms']['D']:.4f} ms")
    say(f"  4o (a)-(b) peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (KV 2 x "
        f"{kv_bytes(base.cache) / 2**30:.2f} GiB)")
    del e
    torch.cuda.empty_cache()
    elapsed("(b)")

    # (c) the int8 log against the cp = 1 int8 slot cache
    kv8 = eng.replace(kv_cache_dtype_name="int8")
    b8 = InferenceEngine(cfg, kv8, params)
    e = InferenceEngine(cfg, kv8, params, mesh=cp2)
    snapped = [log.snapped for *_, log, _ in e.cache.ranks()]
    say(f"  4o (c) int8 logs' numerics snapped: {snapped}")
    if not all(snapped):
        raise AssertionError("4o (c): an int8 log is not snapped")
    ids, ref8 = path("4o (c) cp=2 int8 log", e, b8, ring_fault, None,
                     "kv_write_quant")
    layer0 = cp_rows_distance(torch, "4o (c)", e, b8, 0)
    say(f"  4o (c) layer 0's K rows (dequantized) against the cp=1 int8 "
        f"cache: rel L2 {layer0:.4e} (limit {CP_ROWS_REL_L2})")
    if layer0 > CP_ROWS_REL_L2:
        raise AssertionError(f"4o (c): layer 0's K rows rel L2 {layer0:.4e}")
    ids_or_ties("4o (c) cp=2 int8 log", ids, ref8[1], e, b8, prompts)
    del e, b8
    torch.cuda.empty_cache()
    elapsed("(c)")

    # (d) cp = 2 x tp = 2
    e = InferenceEngine(cfg, eng, params,
                        mesh=make_mesh(1, 2, 2, devices=[dev] * 4))

    def rank_fault():
        return planted(sharding, "rank_sum", lambda plain: (
            lambda parts, devices: plain(parts[:1], devices)))
    ids, _ = path("4o (d) cp=2 x tp=2", e, base, rank_fault, ref,
                  "kv_write")
    say(f"  4o (d) peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ids_or_ties("4o (d) cp=2 x tp=2", ids, ref[1], e, base, prompts)
    del e, base
    torch.cuda.empty_cache()
    elapsed("(d)")

    # (e)
    cp_write_rows(torch, dev, results)
    elapsed("(e)")
    return full


def cp_write_rows(torch, dev, results) -> None:
    """4o (e): kernels C and I at the context-parallel write shapes, held
    against their plain versions bit for bit and timed beside them with
    their bounds: a rank's log of 4096 rows (two layers, 32 heads), the
    prefill sub-chunk of 4o (B 4, 256 rows a rank) at ragged log tails
    with counts 0 .. 256, and a decode token written by one rank of two
    (counts 0 and 1); the new rows past each count and the log rows past
    each tail hold NaN (int8 log: 127 and NaN scales), and must keep it."""
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    gen = torch.Generator(device=dev).manual_seed(2025)
    L, B, S, K, D = 2, 4, 4096, 32, 128
    nan = float("nan")

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else
                      torch.int32 if t.element_size() == 4 else torch.int8)

    cases = (("prefill rank 0", 256, [500, 1250, 2000, 3250],
              [256, 256, 256, 133]),
             ("prefill rank 1", 256, [244, 994, 1744, 2994],
              [0, 17, 256, 0]),
             ("decode", 1, [1262, 1631, 2005, 3257], [1, 0, 0, 1]))
    for quant in (False, True):
        for label, T, starts_l, counts_l in cases:
            starts, counts = ints(starts_l), ints(counts_l)
            new = [torch.randn((B, T, K, D), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in "kv"]
            for n in new:
                for b, c in enumerate(counts_l):
                    n[b, c:] = nan
            cache = kvc.new_kv_cache(L, B, K, S, D, device=dev,
                                     quantized=quant, snapped=True)
            for t in (cache.k, cache.v):
                t.fill_(127 if quant else nan)
            if quant:
                cache.k_scale.fill_(nan)
                cache.v_scale.fill_(nan)
            names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
            ref = dataclasses.replace(cache, **{n: getattr(cache, n).clone()
                                                for n in names})
            kvc.update_cache_at_layer(cache, 1, *new, starts, counts,
                                      kernels="cuda")
            kvc.update_cache_at_layer_torch(ref, 1, *new, starts, counts)
            torch.cuda.synchronize()
            for n in names:
                if not torch.equal(bits(getattr(cache, n)),
                                   bits(getattr(ref, n))):
                    raise AssertionError(f"{label}: {n} differs from the "
                                         "plain write (bits)")
            tail = cache.k[1, 0, starts_l[0] + counts_l[0]:]
            if (tail != 127).any() if quant else not tail.isnan().all():
                raise AssertionError(f"{label}: a row past the tail was "
                                     "written")
            rows = sum(counts_l)
            timed = (time_ms(torch, lambda: kvc.update_cache_at_layer(
                cache, 1, *new, starts, counts, kernels="cuda"), cold=True),
                time_ms(torch, lambda: kvc.update_cache_at_layer_torch(
                    ref, 1, *new, starts, counts)))
            case = (f"cp [4,{T},32,128] {label}, tails {starts_l}, counts "
                    f"{counts_l}, NaN past them (bits equal), cold L2")
            if quant:
                hold_int8_write(torch, "kv_write_quant",
                                (cache.k, cache.k_scale.nan_to_num()),
                                (ref.k, ref.k_scale.nan_to_num()), results,
                                case, timed,
                                work=write_work(rows, K, D, quant=True))
            else:
                sl = slot_rows(starts_l, counts_l, T, S)
                check_close(torch, "kv_write", cache.k[1].nan_to_num(),
                            ref.k[1].nan_to_num(), results, case, timed,
                            work=write_work(rows, K, D),
                            library=index_copy_ms(
                                torch, (cache.k[1], cache.v[1]), new,
                                (ints(sl[0]).long(), ints(sl[1]).long())),
                            floor=floor_ms(torch, new, sl[1], torch.bfloat16,
                                           cold=True))
            del cache, ref, new
    torch.cuda.empty_cache()


def phase_pipeline(torch, dev, params) -> None:
    """4p: the pipeline forward on one card at llama2-7b INT4 (4o's
    weights), B = 4, every launch counter set to 0 just before and read
    just after: pp = 2 (two stages of 16 layers, views of the weights) on
    cuda:0 against the one-rank forward over the same inputs (a ragged
    512-token chunk, then a decode step): logits and every K/V row of both
    stages bit for bit; pp = 2 x tp = 2 (four ranks) against the tp = 2
    forward (``make_sharded_forward``): logits and K/V rows bit for bit."""
    from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
    from llm_inference_engine_tpu_torch.models import llama
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.parallel import (
        make_mesh, pipeline, sharding)
    from llm_inference_engine_tpu_torch.runtime.engine import (
        add_decode_layouts)

    cfg = get_config("llama2-7b")
    B, T, S = 4, 512, 1024
    eng = EngineConfig(quant_mode="int4", max_batch_size=B, max_seq_len=S)
    # the references run the forwards themselves, not through an engine:
    # they build the fragment order E reads at m <= 16 as an engine would
    add_decode_layouts(cfg, eng, params, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    ids = torch.randint(3, cfg.vocab_size, (B, T), generator=gen,
                        device=dev, dtype=torch.int32)
    q0 = torch.zeros(B, dtype=torch.int32, device=dev)
    lens = torch.tensor([512, 300, 77, 5], dtype=torch.int32, device=dev)

    def new_cache():
        return kvc.new_kv_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                                cfg.head_dim, device=dev)

    def joined(caches, name):
        return torch.cat([torch.cat([torch.cat([getattr(sh, name)
                                                for sh in row], dim=3)
                                     for row in c.shards], dim=1)
                          for c in caches], dim=0)

    def two_steps(fwd, p, c):
        out1, c = fwd(p, c, ids, q0, lens)
        tok = out1.argmax(-1).to(torch.int32)[:, None]
        out2, c = fwd(p, c, tok, lens.clone(), lens + 1)
        torch.cuda.synchronize()
        return out1, out2, c

    for pp_tp in ((2, 1), (2, 2)):
        pp, tp = pp_tp
        counters = _zero_counters()
        mesh = pipeline.make_pp_mesh(pp, 1, tp, devices=[dev] * (pp * tp))
        sp = pipeline.shard_params_pp(params, mesh)
        fwd = pipeline.make_pp_forward(cfg, eng, mesh)
        t0 = time.perf_counter()
        got1, got2, caches = two_steps(
            fwd, sp, pipeline.shard_cache_pp(new_cache(), mesh))
        wall = time.perf_counter() - t0
        launches = _path_launches(f"4p pp={pp} tp={tp}", counters,
                                  NORM_ACT + ("kv_write", "int4_matmul",
                                              "dequant_int4",
                                              "attention_prefill",
                                              "attention_decode"))
        if tp == 1:
            views = (sp[1].shards[0][0]["layers"]["wo"].q.data_ptr()
                     == params["layers"]["wo"].q[cfg.num_layers // 2]
                     .data_ptr())

            def flat(p, c, i, qs, kl):
                return llama.forward_hidden(cfg, eng, p, i, c, qs, kl)
            want1, want2, ref = two_steps(flat, params, new_cache())
            k, v = ref.k, ref.v
            what = "the one-rank forward"
        else:
            views = None
            tp2 = make_mesh(1, 2, devices=[dev, dev])
            shards = sharding.shard_params(params, tp2)
            add_decode_layouts(cfg, eng, shards, dev)
            want1, want2, ref = two_steps(
                sharding.make_sharded_forward(cfg, eng, tp2), shards,
                sharding.shard_cache(new_cache(), tp2))
            k, v = joined([ref], "k"), joined([ref], "v")
            what = "the tp=2 forward"
        same = dict(logits=torch.equal(got1, want1)
                    and torch.equal(got2, want2),
                    k=torch.equal(joined(caches, "k"), k),
                    v=torch.equal(joined(caches, "v"), v))
        say(f"  4p pp={pp} x tp={tp} on cuda:0 ({pp * tp} ranks, stages of "
            f"{cfg.num_layers // pp} layers): a [4, 512] chunk and a decode "
            f"step in {wall:.3f} s; bit for bit against {what}: {same}"
            + (f"; stage weights are views: {views}" if views is not None
               else "") + f"; A launches {launches['rmsnorm']}")
        if not all(same.values()) or views is False:
            raise AssertionError(f"4p pp={pp} tp={tp}: differs from {what} "
                                 f"{same}")
        del sp, caches, ref, k, v
        torch.cuda.empty_cache()


# 4q: prefix snapshots, speculation and beam search on a tp = 2 mesh of two
# ranks on cuda:0: llama2-7b INT4 (4b's weights) with a tinyllama-1.1b INT4
# draft sharded over the same mesh. tinyllama's local shapes under tp = 2,
# (k, n, halves) of E's decode mode at the draft's m = 8: wqkv n 1280, wo
# k 1024, gate|up 2 x 2816, down k 2816 (22 groups), the lm_head's
# 16000-row vocab shard; 2 of its 4 kv heads a rank (G = 8, head_dim 64)
TINY_TP2_SHAPES = {"wqkv": (2048, 1280, 1), "wo": (1024, 2048, 1),
                   "gate|up": (2048, 2816, 2), "down": (2816, 2048, 1),
                   "lm_head": (2048, 16000, 1)}
TINY_TP2_HEADS, TINY_HEAD_DIM = (16, 2), 64
# 4q (a): the tails' prefill logits over a restored prefix against the full
# prompts', tp = 2, chunks of 1024 (every prompt whole): the same kernels at
# the same per-row arithmetic, bit for bit on an H100 (rel L2 0). The INT4
# dummies' logits barely move with K/V: another prompt's 320-token prefix
# moved them 8.1e-4 rel L2 (2.4e-2 abs) there, inside 4k's limits, so
# 4q's limits sit under it
PREFIX_TP2_LIMITS = (2e-3, 1e-4)
# 4l's one-rank replayed round (llama2-7b INT4 B = 8, the tinyllama-1.1b
# INT4 draft, k = 4) on an H100 SXM at 700 W, ms: the yardstick 4q prints
# its tp = 2 round beside
SPEC_ROUND_ONE_RANK_MS = 22.073


def write_case(torch, dev, results, gen, tag: str, B, T, K, D, new_len_l):
    """Kernel C writing a chunk of T rows a sequence (ragged: ``new_len_l``
    live rows each, from row 0) into a slot cache of K kv heads, the new
    rows at the head of buffers whose tails hold NaN: bit for bit the plain
    write, timed cold beside it, its bound, its floor and two
    ``index_copy_``."""
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    S = 2048
    starts_l = [0] * B

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)
    starts, new_len = ints(starts_l), ints(new_len_l)
    kn, vn = (poisoned(torch, torch.randn(B, T, K, D, generator=gen,
                                          device=dev, dtype=torch.bfloat16))
              for _ in "kv")
    rows, picked = slot_rows(starts_l, new_len_l, T, S)
    cache = kvc.new_kv_cache(2, B, K, S, D, device=dev)
    ref = kvc.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths)
    kvc.update_cache_at_layer(cache, 1, kn, vn, starts, new_len,
                              kernels="cuda")
    kvc.update_cache_at_layer_torch(ref, 1, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    if not (torch.equal(cache.k, ref.k) and torch.equal(cache.v, ref.v)):
        raise AssertionError(f"kv_write {tag}: cache differs from the plain "
                             "write")
    check_close(torch, "kv_write", cache.k[1], ref.k[1], results,
                f"{tag} [{B},{T},{K},{D}] NaN past the rows, cold L2", (
                    time_ms(torch, lambda: kvc.update_cache_at_layer(
                        cache, 1, kn, vn, starts, new_len, kernels="cuda"),
                        cold=True),
                    time_ms(torch, lambda: kvc.update_cache_at_layer_torch(
                        ref, 1, kn, vn, starts, new_len))),
                work=write_work(len(rows), K, D),
                library=index_copy_ms(torch, (cache.k[1], cache.v[1]),
                                      (kn, vn), (ints(rows).long(),
                                                 ints(picked).long())),
                floor=floor_ms(torch, (kn, vn), picked, torch.bfloat16,
                               cold=True))


def mesh_decoding_kernel_rows(torch, dev, results) -> None:
    """4q (d): the kernels at the local shapes the tp = 2 mesh's
    speculation and beams give them, every input at the head of a buffer
    whose tail holds NaN and every cache row past kv_len NaN, held against
    the plain versions (on clean copies) and timed beside them, with their
    bounds and library calls: E's prefill mode at the verify's m = 40 on
    llama2-7b's tp = 2 shards and its decode mode at m = 8 on tinyllama's;
    D2 at the verify (B 8, T 5, 16 heads, q_start 45-600); D's fused
    decode at the draft's rank (G = 8, 2 kv heads, head_dim 64); B at
    [8, 5632]; C into the beams' local cache (4 x 128 rows, 16 heads) and
    the draft's (a ragged 8 x 512 chunk, 2 heads)."""
    from llm_inference_engine_tpu_torch.ops import activations, attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    gen = torch.Generator(device=dev).manual_seed(2026)
    for label in TP2_SHAPES:
        quant_case(torch, dev, gen, results, "int4", 8 * (SPEC_K + 1), label,
                   TP2_SHAPES, tag="tp2 verify ", poison=True)
    for label in TINY_TP2_SHAPES:
        quant_case(torch, dev, gen, results, "int4", 8, label,
                   TINY_TP2_SHAPES, tag="tinyllama tp2 ", poison=True)
    torch.cuda.empty_cache()
    nan = float("nan")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    # D2 at the verify; rows past kv_len NaN
    B, T, K, D, S = 8, SPEC_K + 1, TP2_HEADS, 128, 2048
    starts = [n + 40 for n in QUANT_PROMPTS]
    qs, kl = ints(starts), ints([s + T for s in starts])
    kc, vc = randn(2, B, S, K, D), randn(2, B, S, K, D)
    ref_k, ref_v = kc.clone(), vc.clone()
    for b, s in enumerate(starts):
        kc[1, b, s + T:] = nan
        vc[1, b, s + T:] = nan
    q = poisoned(torch, randn(B, T, K, D))
    run = lambda: attention.attention(  # noqa: E731
        q, kc, vc, qs, kl, layer=1, kernels="cuda")
    plain = lambda: attention.attention_torch(  # noqa: E731
        q, ref_k, ref_v, qs, kl, layer=1)
    check_close(torch, "attention_prefill", run(), plain(), results,
                f"tp2 verify B{B} T{T} H{K} K{K} q_start {starts[0]}.."
                f"{starts[-1]}, NaN past kv_len",
                (time_ms(torch, run), time_ms(torch, plain, iters=3,
                                              warmup=1)),
                work=attn_work(starts, kl.tolist(), T, K, K, D),
                library=sdpa_ms(torch, q, ref_k[1], ref_v[1], qs, kl))
    del kc, vc, ref_k, ref_v

    # D's fused decode (WRITE_NEW) at the draft's rank; rows past kv_len NaN
    (H, K), D = TINY_TP2_HEADS, TINY_HEAD_DIM
    hist = [s + SPEC_K for s in starts]
    c = kvc.new_kv_cache(2, B, K, S, D, device=dev)
    c.k.copy_(randn(2, B, S, K, D))
    c.v.copy_(randn(2, B, S, K, D))
    ref = kvc.KVCache(c.k.clone(), c.v.clone(), c.lengths)
    for b, n in enumerate(hist):
        c.k[1, b, n + 1:] = nan
        c.v[1, b, n + 1:] = nan
    qs = ints(hist)
    kl = qs + 1
    qd = poisoned(torch, randn(B, 1, H, D))
    kn1, vn1 = poisoned(torch, randn(B, 1, K, D)), poisoned(torch,
                                                            randn(B, 1, K, D))
    run = lambda: attention.attention_decode_fused(  # noqa: E731
        qd, kn1, vn1, c.k, c.v, qs, kl, 1, kernels="cuda")[0]
    plain = lambda: attention.attention_decode_fused_torch(  # noqa: E731
        qd, kn1, vn1, ref.k, ref.v, qs, kl, 1)[0]
    got, want = run(), plain()
    torch.cuda.synchronize()
    b_idx = torch.arange(B, device=dev)
    for x, y in ((c.k, ref.k), (c.v, ref.v)):
        if not torch.equal(x[1, b_idx, qs.long()], y[1, b_idx, qs.long()]):
            raise AssertionError("attention_decode at the draft's rank: the "
                                 "fused write differs from the plain write")
    say_plan(attention, f"tinyllama tp2 B{B} H{H} K{K} D{D}", B, H, K, D)
    check_close(torch, "attention_decode", got, want, results,
                f"tinyllama tp2 B{B} H{H} K{K} D{D} contexts {min(hist)}-"
                f"{max(hist)}, NaN past kv_len",
                (time_ms(torch, run), time_ms(torch, plain, iters=3,
                                              warmup=1)),
                work=attn_work(hist, [h + 1 for h in hist], 1, H, K, D,
                               new_rows=B * 2 * K * D * 2 * 2),
                library=sdpa_ms(torch, qd, ref.k[1], ref.v[1], qs, kl),
                row_rel=DECODE_ROW_TOL)
    del c, ref
    paged_equals_slot(torch, dev, gen, "tinyllama tp2", B, H, K, D, hist)

    # B at tinyllama's gate|up a rank
    inter = TINY_TP2_SHAPES["gate|up"][1]
    gu = poisoned(torch, randn(8, 2 * inter))
    check_close(torch, "silu_and_mul",
                activations.silu_and_mul(gu, kernels="cuda"),
                activations.silu_and_mul_torch(gu), results,
                f"tinyllama tp2 [8,{2 * inter}] NaN past the tail", (
                    time_ms(torch, lambda: activations.silu_and_mul(
                        gu, kernels="cuda")),
                    time_ms(torch, lambda: activations.silu_and_mul_torch(
                        gu))),
                work=(3 * 8 * inter * 2, 5 * 8 * inter))

    # C into the beams' and the draft's local caches
    write_case(torch, dev, results, gen, "tp2 beams' prefill", BEAMS,
               BEAM_PROMPT, TP2_HEADS, 128, [BEAM_PROMPT] * BEAMS)
    write_case(torch, dev, results, gen, "tinyllama tp2 draft's chunk", B,
               512, TINY_TP2_HEADS[1], TINY_HEAD_DIM,
               [min(n, 512) for n in QUANT_PROMPTS])
    torch.cuda.empty_cache()


def exact_launches(tag: str, counts: dict, want: dict) -> None:
    """A path's launches over a known number of forwards against the count
    each forward makes on each rank (``want``); printed, and raising where
    they differ."""
    got = {k: counts.get(k, 0) for k in want}
    say(f"  {tag} launches: {got}" + ("" if got == want
                                        else f", want {want}"))
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, want {want}")


def forward_launches(ranks: int, forwards: int, layer_forwards: int,
                     **kernels) -> dict:
    """What ``forwards`` INT4 forwards of ``layer_forwards`` layers in all
    launch on each of ``ranks`` ranks: A once a forward plain and twice a
    layer with a residual, B and J once a layer, E four times a layer
    (wqkv, wo, gate|up, down) and once for the lm_head; ``kernels``: the
    attention and write kernels' counts on one rank."""
    return dict(rmsnorm=ranks * forwards,
                add_residual_rmsnorm=ranks * 2 * layer_forwards,
                silu_and_mul=ranks * layer_forwards,
                split_qkv_rope=ranks * layer_forwards,
                int4_matmul=ranks * (4 * layer_forwards + forwards),
                **{k: ranks * n for k, n in kernels.items()})


def phase_mesh_decoding(torch, dev, results, params) -> None:
    """4q: prefix snapshots, speculation and beam search on a tp = 2 mesh of
    two ranks on cuda:0, llama2-7b INT4 (4b's weights, ``params``), B = 8,
    chunks of 1024 (every prompt whole, 4k (c)'s rule): (a) the slot
    PrefixStore through the scheduler (``prefix_store_rows``: restored rows
    bit for bit on each rank, the tails' logits within PREFIX_TP2_LIMITS
    and the controls outside them, ids equal with and without the store,
    TTFT);
    (b) SpeculativeDecoder over a tinyllama-1.1b INT4 draft on the same
    mesh, k = 4: replayed rounds equal to eager rounds from one state, the
    greedy ids against the tp = 2 target's own ``generate`` (a divergence
    only at a near-tie, 4l's rule), a round's wall, busy and idle beside
    4l's one-rank round, the launches of A, B, C, D, D2 and E exact per
    forward; then the target drafting for itself, so that the draft's
    ingest program runs: acceptance >= 0.9, replayed rounds (the ingest
    among them) equal to eager, the launches exact; (c) ``beam_search`` with 4 beams over the sharded params:
    replayed equal to eager, the first expansion's log-probs within
    TP_LOGIT_REL_L2 of the one-rank search's, the step's ms and its
    reorder's bytes, the launches exact per forward; (d)
    ``mesh_decoding_kernel_rows``."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_quantized_params, param_bytes)
    from llm_inference_engine_tpu_torch.parallel import make_mesh, sharding
    from llm_inference_engine_tpu_torch.runtime.beam_search import (
        BeamSearch)
    from llm_inference_engine_tpu_torch.runtime.decode_graph import (
        run_eagerly)
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    from llm_inference_engine_tpu_torch.runtime.speculative import (
        SpeculativeDecoder)

    cfg, tiny = get_config("llama2-7b"), get_config("tinyllama-1.1b")
    L, Ld, B = cfg.num_layers, tiny.num_layers, 8
    eng = EngineConfig(quant_mode="int4", max_batch_size=B, max_seq_len=2048,
                       max_prefill_len=1024)
    tp2 = make_mesh(1, 2, devices=[dev, dev])
    torch.cuda.reset_peak_memory_stats()
    sp = sharding.shard_params(params, tp2)
    rng = np.random.default_rng(0)

    # (a) the slot PrefixStore
    counters = _zero_counters()
    target = InferenceEngine(cfg, eng, sp)
    prefix_store_rows(torch, target, prefix_prompts(rng), hold_ids=True,
                      tag="4q (a) tp=2 INT4", limits=PREFIX_TP2_LIMITS)
    _path_launches("4q (a)", counters, MAIN_PATHS["int4"][0])

    # (b) speculation: a tinyllama-1.1b INT4 draft on the same mesh
    counters = _zero_counters()
    draft = InferenceEngine(tiny, eng, init_dummy_quantized_params(
        tiny, "int4", eng.quant_group_size, seed=0, device=dev), mesh=tp2)
    spec = SpeculativeDecoder(target, draft, SPEC_K)
    prompts = [rng.integers(3, 32000, n).tolist() for n in QUANT_PROMPTS]
    plain = target.generate(prompts, SamplingParams(
        greedy=True, max_new_tokens=SPEC_NEW), eos_token_id=None).token_ids
    spec.generate(prompts, SPEC_NEW, eos_token_id=None)     # captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = spec.generate(prompts, SPEC_NEW, eos_token_id=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # both engines as generate left them: the rounds below start there
    state = spec_snapshot(spec)
    events = []
    for i, (a, b) in enumerate(zip(res.token_ids, plain)):
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is not None:
            events.append((prompts[i] + b[:t], a[t]))
    ties = near_ties(torch, target, events)
    not_tie = [k for k, tie in enumerate(ties) if tie[0] > tie[1]]
    say(f"  4q (b) tinyllama-1.1b INT4 draft at tp=2, k = {SPEC_K}, greedy, "
        f"{SPEC_NEW} new tokens at B = {B}: acceptance "
        f"{res.acceptance_rate:.4f} ({res.num_accepted}/{res.num_drafted}); "
        f"generate {wall:.3f} s; rows whose ids differ from the tp=2 "
        f"target's generate: {len(events)}; at the first divergence (verify "
        f"margin, max |verify - decode|, verify argmax, decode argmax): "
        f"{[(round(a, 4), round(b, 4), c, d) for a, b, c, d, _ in ties]}")
    if not_tie:
        raise AssertionError(f"4q (b): ids differ from the target's generate "
                             f"outside a near-tie at {not_tie}")
    if events:
        # near_ties prefilled the target: generate's last round once more
        # puts the rows back that the rounds below attend
        spec.generate(prompts, SPEC_NEW, eos_token_id=None)
        spec_restore(spec, state)
    last = np.array([t[-1] for t in res.token_ids], np.int32)
    greedy = target._host_arrays(SamplingParams(greedy=True))
    snap = spec_snapshot(spec)
    eager, eager_ms = spec_rounds(torch, spec, last, greedy, False,
                                  SPEC_ROUNDS, True)
    spec_restore(spec, snap)
    _zero_counters()
    replayed, graph_ms = spec_rounds(torch, spec, last, greedy, False,
                                     SPEC_ROUNDS, False)
    per_rounds = _launch_counts(counters)
    spec_restore(spec, snap)
    prof = device_profile(torch, lambda: spec.run_round(
        last, np.ones(B, bool), greedy, False), 4)
    spec_restore(spec, snap)
    say(f"  4q (b) {SPEC_ROUNDS} replayed rounds == {SPEC_ROUNDS} eager "
        f"rounds: {replayed == eager}; wall eager / replayed {eager_ms:.3f} "
        f"/ {graph_ms:.3f} ms a round (4l's one-rank round on an H100: "
        f"{SPEC_ROUND_ONE_RANK_MS} ms); replayed card busy {prof.busy:.3f} "
        f"ms a round (idle {1 - prof.busy / graph_ms:.3f}); by group: "
        f"{_groups(prof.per_kernel)}")
    if replayed != eager:
        raise AssertionError("4q (b): replayed rounds differ from eager "
                             "rounds")
    # a round on each rank: k draft decode steps (D), the verify (C, D2),
    # and the draft's ingest (D) after a round where a row fully accepted
    ingests = sum(SPEC_K in na for _, _, na in replayed)
    R = SPEC_ROUNDS
    exact_launches(
        f"4q (b) {R} replayed rounds ({ingests} with the ingest), 2 ranks",
        per_rounds, forward_launches(
            2, R * (SPEC_K + 1) + ingests,
            R * (SPEC_K * Ld + L) + ingests * Ld,
            attention_decode=(R * SPEC_K + ingests) * Ld,
            attention_prefill=R * L, kv_write=R * L, dequant_int4=0))
    del spec, draft

    # the ingest: the target drafting for itself (a second engine over the
    # same shards) accepts whole rounds, so the draft's ingest program runs
    twin = InferenceEngine(cfg, eng, sp)
    spec = SpeculativeDecoder(target, twin, SPEC_K)
    res = spec.generate(prompts, SPEC_NEW // 2, eos_token_id=None)
    last = np.array([t[-1] for t in res.token_ids], np.int32)
    snap = spec_snapshot(spec)
    eager, _ = spec_rounds(torch, spec, last, greedy, False, 4, True)
    spec_restore(spec, snap)
    _zero_counters()
    replayed, twin_ms = spec_rounds(torch, spec, last, greedy, False, 4,
                                    False)
    per_rounds = _launch_counts(counters)
    ingests = sum(SPEC_K in na for _, _, na in replayed)
    say(f"  4q (b) self-draft at tp=2: acceptance {res.acceptance_rate:.4f} "
        f"({res.num_accepted}/{res.num_drafted}); 4 replayed rounds == 4 "
        f"eager rounds: {replayed == eager} ({ingests} with the ingest); "
        f"{twin_ms:.3f} ms a round")
    if replayed != eager or not ingests or res.acceptance_rate < 0.9:
        raise AssertionError("4q (b): self-draft rounds replayed differ from "
                             "eager, no ingest ran, or acceptance < 0.9")
    exact_launches(
        f"4q (b) 4 replayed self-draft rounds ({ingests} with the ingest), "
        "2 ranks", per_rounds, forward_launches(
            2, 4 * (SPEC_K + 1) + ingests, (4 * (SPEC_K + 1) + ingests) * L,
            attention_decode=(4 * SPEC_K + ingests) * L,
            attention_prefill=4 * L, kv_write=4 * L, dequant_int4=0))
    del spec, twin
    target.reset()

    # (c) beam search over the sharded params
    prompt = rng.integers(3, 32000, BEAM_PROMPT).tolist()
    bs = BeamSearch(cfg, eng, sp, BEAMS)
    one = BeamSearch(cfg, eng, params, BEAMS)
    P = len(prompt)
    ids = torch.tensor([prompt] * BEAMS, dtype=torch.int32, device=dev)
    zero = torch.zeros(BEAMS, dtype=torch.int32, device=dev)
    logp = [torch.log_softmax(s._forward(ids, zero, zero + P).float(), -1)
            for s in (bs, one)]
    d, r = _logit_diff(logp[0], logp[1])
    want = one.search(prompt, BEAM_NEW, eos_token_id=None)
    del one
    with run_eagerly(bs):
        ref = bs.search(prompt, BEAM_NEW, eos_token_id=None)
    bs.search(prompt, BEAM_NEW, eos_token_id=None)          # captures
    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = bs.search(prompt, BEAM_NEW, eos_token_id=None)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    per_search = _launch_counts(counters)
    step_ms = time_ms(torch, bs._programs["step"].replay, iters=8)
    gather = bs.gather_bytes()
    step_bound = bound_ms((param_bytes(params) + gather // 4 + gather, 0))[0]
    say(f"  4q (c) beam_search at tp=2, {BEAMS} beams, {P}-token prompt, "
        f"{BEAM_NEW} new: replayed == eager (sequences, scores): "
        f"{got == ref}; first expansion's log-probs against the one-rank "
        f"search's: max abs {d:.4e}, rel L2 {r:.4e} (limit "
        f"{TP_LOGIT_REL_L2:.1e}); best beam equal to the one-rank search's: "
        f"{got.sequences[0] == want.sequences[0]} (printed only); search "
        f"{graph_s:.3f} s replayed; step {step_ms:.4f} ms (replay, CUDA "
        f"events), bound {step_bound:.4f} ms (weights + live K/V + reorder, "
        f"bytes); its reorder of {P + BEAM_NEW} rows a beam on both ranks "
        f"moves {gather} bytes")
    if got != ref:
        raise AssertionError("4q (c): replayed beam steps differ from the "
                             "eager steps")
    if r > TP_LOGIT_REL_L2:
        raise AssertionError(f"4q (c): first expansion's log-probs rel L2 "
                             f"{r:.4e} over {TP_LOGIT_REL_L2}")
    steps = BEAM_NEW - 1
    exact_launches(f"4q (c) one replayed search (a prefill, {steps} steps),"
                   " 2 ranks", per_search, forward_launches(
                       2, 1 + steps, L * (1 + steps),
                       attention_decode=L * steps, attention_prefill=L,
                       kv_write=L, dequant_int4=0))
    del bs, target, sp
    torch.cuda.empty_cache()
    say(f"  4q peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")

    # (d)
    mesh_decoding_kernel_rows(torch, dev, results)


# 4r: the quantization quality proxy (tools/quant_divergence.py of the
# port) at llama2-7b's width, 4 layers, B 4, T 512, group 128
QDIV_LAYERS = 4
QDIV_BATCH, QDIV_WINDOW, QDIV_GROUP, QDIV_CALIB = 4, 512, 128, 64
QDIV_MODES = ("int8", "int4", "int4cal")
QDIV_FAULT_LAYER = 2
# the kernel route's logits against kernels="torch" on the same variant,
# relative L2: 1.51e-2-1.54e-2 on an H100 for all four variants (the
# synthetic weights' outlier channels and bf16 sums in another order);
# the planted fault (one layer's wo scales doubled in the kernel route's
# copy of the int4 variant) landed at 1.04e-1
QDIV_REL_L2 = 3e-2


def qdiv_launches(layers: int, forwards: int, int4: bool,
                  int8: bool = False) -> dict:
    """Every counter's launches over ``forwards`` forwards at m = B x T >=
    1024 rows: A once plain and twice a layer with a residual, B, J, C
    and D2 once a layer, G (INT4) or G8 (INT8; ``int4`` False with
    ``int8``) once per weight half a layer (wqkv, wo, gate and up, down)
    and once for the lm_head, G8's epilogue once a weight (4 a layer and
    the lm_head); E, F and the decode and paged kernels never (the
    large-m route dequantizes, then cuBLAS)."""
    want = {name: 0 for name in _counters()}
    halves = (5 * layers + 1) * forwards
    want.update(rmsnorm=forwards, add_residual_rmsnorm=2 * layers * forwards,
                silu_and_mul=layers * forwards, kv_write=layers * forwards,
                split_qkv_rope=layers * forwards,
                attention_prefill=layers * forwards,
                dequant_int4=halves if int4 else 0,
                dequant_int8=halves if int8 else 0,
                int8_scale_cast=(4 * layers + 1) * forwards if int8 else 0)
    return want


def phase_quant_divergence(torch, dev) -> None:
    """4r: ``tools.quant_divergence``'s functions on the card, in this
    process: the JAX tool's synthetic weights (seed 0) at llama2-7b's width
    and QDIV_LAYERS layers, the fp, int8, int4 and int4cal variants built on
    the card (int4cal calibrated on the fp variant's bf16 params through
    the kernels). (a) layer 0's q and scales of every quantized variant
    built on the CPU from the same f32 weights (and the same act_sq) equal
    the card's bit for bit; (b) each variant's logits over B x T
    teacher-forced tokens, kernel route against ``kernels="torch"``, within
    QDIV_REL_L2, and a planted fault outside it; (c) the kernel route's
    launches exact per forward (``qdiv_launches``); (d) the report printed
    (not gated: synthetic weights)."""
    import gc

    import numpy as np

    from llm_inference_engine_tpu_torch.config import get_config
    from llm_inference_engine_tpu_torch.models import weights as W
    from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
    from llm_inference_engine_tpu_torch.tools import quant_divergence as qd

    cfg = get_config("llama2-7b").replace(num_layers=QDIV_LAYERS)
    L = cfg.num_layers
    t0 = time.perf_counter()
    p32 = qd.synth_params(cfg, 0, dev)
    torch.cuda.synchronize()
    s_syn = time.perf_counter() - t0
    variants, act, info, s_build, s_cal = qd.build_variants(
        cfg, p32, QDIV_MODES, QDIV_GROUP,
        qd.calib_tokens(cfg, 0, QDIV_CALIB), say=lambda m: say("  " + m))
    say(f"  synthesis {s_syn:.2f} s ({L} layers, host draws), variants built "
        f"in {s_build:.2f} s, calibration {s_cal:.2f} s")

    # (a) layer 0 built on the CPU from the same f32 weights, in a thread
    # while the card runs (b) and (c) (torch's CPU ops release the GIL)
    cpu = torch.device("cpu")
    one = dict(p32, layers={k: v[:1].to(cpu) for k, v in p32["layers"].items()})
    act0 = {k: v[:1].to(cpu) for k, v in act["int4cal"].items()}
    del p32

    def layer0_on_cpu():
        t0 = time.perf_counter()
        refs = {mode: (W.quantize_params_calibrated(
                    one, act0, "int4", QDIV_GROUP, quantize_lm_head=False)
                       if mode == "int4cal" else W.quantize_params(
                    one, mode, QDIV_GROUP, quantize_lm_head=False))
                for mode in QDIV_MODES}
        return refs, time.perf_counter() - t0
    pool = concurrent.futures.ThreadPoolExecutor(1)
    cpu_refs = pool.submit(layer0_on_cpu)

    # (b), (c)
    tokens = qd.eval_tokens(cfg, 0, QDIV_BATCH, QDIV_WINDOW)
    counters = _counters()

    def rel(a, b):
        return float(np.linalg.norm((a - b).astype(np.float64))
                     / np.linalg.norm(b.astype(np.float64)))
    kern, dist, failures = {}, {}, []
    for mode in ("fp",) + QDIV_MODES:
        for f in counters.values():
            f.launches = 0
        kern[mode], ms = qd.run_variant(cfg, variants[mode], tokens)
        got = {k: f.launches for k, f in counters.items()}
        want = qdiv_launches(L, 2, mode in ("int4", "int4cal"),
                             mode == "int8")
        plain, _ = qd.run_variant(cfg, variants[mode], tokens,
                                  kernels="torch", warmup=False)
        dist[mode] = rel(kern[mode], plain)
        say(f"  (b) {mode}: forward {ms:.3f} ms (B {QDIV_BATCH} x T "
            f"{QDIV_WINDOW}, CUDA events after a warm-up), kernel route vs "
            f"kernels='torch' rel L2 {dist[mode]:.4e}, finite "
            f"{bool(np.isfinite(kern[mode]).all())}")
        say(f"  (c) {mode} launches over 2 forwards: "
            f"{ {k: v for k, v in got.items() if v} }")
        if got != want:
            failures.append(f"{mode} launches {got}, want {want}")
        if dist[mode] > QDIV_REL_L2 or not np.isfinite(kern[mode]).all():
            failures.append(f"{mode}: rel L2 {dist[mode]:.4e} over "
                            f"{QDIV_REL_L2}")
        if mode == "int4":
            wo = variants[mode]["layers"]["wo"]
            scale = wo.scale.clone()
            scale[QDIV_FAULT_LAYER] *= 2
            faulty = dict(variants[mode], layers=dict(
                variants[mode]["layers"], wo=QuantizedTensor(
                    wo.q, scale, wo.mode, wo.group_size, wo.qd)))
            fault, _ = qd.run_variant(cfg, faulty, tokens, warmup=False)
            d = rel(fault, plain)
            say(f"  (b) planted fault (layer {QDIV_FAULT_LAYER}'s wo scales "
                f"doubled in the kernel route's int4 copy): rel L2 {d:.4e}")
            if d <= QDIV_REL_L2:
                failures.append(f"the planted fault's rel L2 {d:.4e} is "
                                f"within {QDIV_REL_L2}")
            del faulty, fault, scale
        del plain
    # (d)
    report = {mode: qd.divergence(kern["fp"], kern[mode])
              for mode in QDIV_MODES}
    say(f"  (d) report (kernel route, {L} layers, synthetic weights): "
        + json.dumps(report))
    refs, s_cpu = cpu_refs.result()
    pool.shutdown()
    unequal = [f"{mode} {name}.{part}" for mode in QDIV_MODES
               for name in ("wqkv", "wo", "w_gate_up", "w_down")
               for part in ("q", "scale")
               if not torch.equal(
                   getattr(variants[mode]["layers"][name], part)[0].cpu(),
                   getattr(refs[mode]["layers"][name], part)[0])]
    say(f"  (a) layer 0 built on the CPU ({s_cpu:.2f} s, beside (b) and (c)) "
        f"against the card: unequal {unequal}")
    if unequal:
        failures.append(f"(a) layer 0's storage differs between the card "
                        f"and the CPU: {unequal}")
    del one, refs
    say(f"  4r peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")
    del variants, act, kern
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("4r: " + "; ".join(failures))


# 4s: the example drivers (examples_torch/), each in this process on the
# card
EXAMPLES = ("run_attention_prefill", "run_attention_decode", "run_ffn",
            "run_decoder", "run_engine_generate", "run_quantized",
            "run_sharded_tp", "run_beam_search", "run_speculative",
            "run_context_parallel", "run_serving_stack")


def phase_examples(torch, dev) -> None:
    """4s: every driver of ``examples_torch`` run by its ``main`` on the
    card (its default device), in this process: each checks its kernel
    route against the plain versions and exits 1 on a failure, which is
    not caught here (the script then exits non-zero)."""
    import gc
    import importlib
    times = {}
    for name in EXAMPLES:
        say(f"  -- examples_torch.{name}")
        module = importlib.import_module(f"examples_torch.{name}")
        t0 = time.perf_counter()
        module.main([])
        torch.cuda.synchronize()
        times[name] = round(time.perf_counter() - t0, 2)
        gc.collect()
        torch.cuda.empty_cache()
    say(f"  4s seconds per driver: {json.dumps(times)}")


# ---------------------------------------------------------------------------
# 3f and 4t: the float instances (D2f and Df: csrc/attention_*_f16.cu and
# _f32.cu; Ef and Ff: csrc/quant_matmul_f16.cu and _f32.cu; If: kernel
# I's template in csrc/kv_write_quant.cu)
# ---------------------------------------------------------------------------

def scale_planes(cache, **kw) -> dict:
    """An int8 cache's scale planes as keyword arguments (with ``kw``), or
    none for a float cache."""
    if cache.k_scale is None:
        return {}
    return dict(k_scale=cache.k_scale, v_scale=cache.v_scale, **kw)


def float_held(torch, results, name, got, want, case, tag, timed=None,
               work=None, library=None) -> None:
    """Hold a float instance's output against its plain version's: finite,
    and max |got - want| within FLOAT_REL[tag] of max |want|; record it."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    rel = err / max(w.abs().max().item(), 1e-30)
    if not torch.isfinite(g).all() or rel > FLOAT_REL[tag]:
        raise AssertionError(f"{name} [{case}]: kernel disagrees with its "
                             f"plain version (max abs err {err}, relative "
                             f"{rel:.3e}, limit {FLOAT_REL[tag]})")
    record(name, err, results, f"{case} rel {rel:.2e}", timed, work, library)


def plant_nan(torch, cache, kv_len, page=None):
    """A clean copy of ``cache`` (the plain versions are not NaN-safe:
    0 * NaN), then NaN into every row no key below kv_len maps to (an int8
    cache: its scales): slot rows at or past kv_len; pool pages outside
    the table and the used pages' tails, table entries past the used
    pages pointed at page 0. Returns the clean copy (sharing the table)."""
    clean = dataclasses.replace(cache, **{
        n: getattr(cache, n).clone() for n in ("k", "v", "k_scale", "v_scale")
        if getattr(cache, n) is not None})
    names = ("k_scale", "v_scale") if cache.k_scale is not None else ("k", "v")
    if page is None:
        for name in names:
            for b, n in enumerate(kv_len.tolist()):
                getattr(cache, name)[:, b, n:] = float("nan")
        return clean
    table, dev = cache.block_table, kv_len.device
    used = (kv_len.long() + page - 1) // page
    cols = torch.arange(table.shape[1], device=dev)
    table[cols[None, :] >= used[:, None]] = 0
    keep = torch.zeros(cache.k.shape[1], page, dtype=torch.bool, device=dev)
    for b, n in enumerate(kv_len.tolist()):
        j = torch.arange(n, device=dev)
        keep[table[b, j // page].long(), j % page] = True
    for name in names:
        getattr(cache, name)[:, ~keep] = float("nan")
    return clean


def cache_copy(cache):
    """A copy of a cache or pool, its table and lengths included."""
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).clone()
        for f in dataclasses.fields(cache)
        if isinstance(getattr(cache, f.name), type(cache.k))})


def float_caches(torch, dev, gen, dtype, L, B, S, K, D, page=None):
    """A float slot cache [L, B, S, K, D] (or, with ``page``, a pool of
    B * S / page pages plus the scratch page 0, its table a random
    permutation of pages 1..) of random ``dtype`` rows, and its int8
    counterpart (snapped scales, quantized from the same rows)."""
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    if page is None:
        shape = (L, B, S, K, D)
        lengths = torch.zeros(B, device=dev, dtype=torch.int32)
    else:
        maxp = S // page
        P = 1 + B * maxp
        shape = (L, P, page, K, D)
        table = (torch.randperm(P - 1, generator=gen, device=dev) + 1).to(
            torch.int32).reshape(B, maxp)
    rows = [torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            for _ in range(2)]
    quant = [kvc.quantize_kv_snapped(r) for r in rows]
    if page is None:
        return (kvc.KVCache(*rows, lengths),
                kvc.KVCache(quant[0][0], quant[1][0], lengths.clone(),
                            quant[0][1], quant[1][1], snapped=True))
    lengths = torch.zeros(B, device=dev, dtype=torch.int32)
    return (pkv.PagedKVCache(*rows, table, lengths),
            pkv.PagedKVCache(quant[0][0], quant[1][0], table.clone(),
                             lengths.clone(), quant[0][1], quant[1][1]))


def float_int8pack_ms(torch, ts, x, out_dtype):
    """``int8pack_ms`` for a float16 or float32 x: None, with the reason
    printed, where this torch refuses the dtype."""
    try:
        return int8pack_ms(torch, ts, x, out_dtype)
    except (RuntimeError, NotImplementedError) as err:
        say(f"    _weight_int8pack_mm refuses {x.dtype}: "
            f"{str(err).splitlines()[0][:120]}")
        return None


def phase_float_kernels(torch, dev, results) -> None:
    """3f: the float instances against their plain versions at Llama2-7B
    widths (H = K = 32, D = 128), in float32 and float16, with NaN planted
    past kv_len, in every pool page outside the table and past the ends of
    x and of the scales: D2f at B4 T512 (slot, int8 slot) and at 3c's B16
    T64 mixed step over pools of page 64 (float and int8); Df's fused slot
    decode at B4 over 4a's contexts (float and int8, the write bit for
    bit), its fused paged decode (B16 at pages of 64 and 16, 4d's B8; pool
    and output bit for bit H then the attend-only decode) and its
    attend-only paged decode at B16; If at 8 x 512 (2254
    rows) in both numerics and through the table at 3c's mixed step, bit
    for bit; Ef / Ff at FLOAT_MATMUL_ROWS (m 8 and 512 on wqkv, down and
    gate|up); A, B and C on float rows; then head_dim 16 and 64 at small
    shapes. Each timed row: its time (CUDA events, cold L2), its bound
    (bytes at the HBM rate, operations at FLOAT_OPS_PER_S), its plain
    version's time, the time before the redesign (FLOAT_BEFORE_MS,
    FLOAT_MATMUL_BEFORE_MS) and, on a float cache, SDPA's (and
    ``_weight_int8pack_mm`` for Ff, ``_weight_int4pack_mm`` for Ef, or the
    words this torch refuses the dtype with). D2f, Df, Ef and Ff's plans
    print beside their rows."""
    import torch.nn.functional as F

    from llm_inference_engine_tpu_torch.ops import activations, attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    from llm_inference_engine_tpu_torch.ops import quant, rmsnorm
    from llm_inference_engine_tpu_torch.ops.paged_kv import gather_pages

    gen = torch.Generator(device=dev).manual_seed(1919)
    H, K, D, S = FLOAT_WIDTHS

    def ints(vals):
        return torch.tensor(vals, device=dev, dtype=torch.int32)

    for tag in FLOAT_DTYPE:
        dtype = getattr(torch, FLOAT_DTYPE[tag])
        esz, rate = dtype.itemsize, FLOAT_OPS_PER_S[tag]

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

        def held(name, got, want, case, timed=None, work=None, library=None):
            before = FLOAT_BEFORE_MS.get(name)
            if timed is not None and before is not None:
                case += f" [before: {before[list(FLOAT_DTYPE).index(tag)]}]"
            float_held(torch, results, f"{name}[{tag}]", got, want,
                       f"{tag} {case}", tag, timed,
                       None if work is None else (*work, rate), library)

        def timed(kernel, plain, iters=10):
            return (time_ms(torch, kernel, iters=iters, cold=True),
                    time_ms(torch, plain, iters=3, warmup=1))

        # A, B (they take every float dtype) and C (rows by bytes)
        for n in (8, 2048):
            x, r = randn(n, 4096), randn(n, 4096)
            w = randn(4096) * 0.1 + 1.0
            held("rmsnorm", rmsnorm.rmsnorm(x, w, kernels="cuda"),
                 rmsnorm.rmsnorm_torch(x, w), f"[{n},4096] cold L2", timed(
                     lambda: rmsnorm.rmsnorm(x, w, kernels="cuda"),
                     lambda: rmsnorm.rmsnorm_torch(x, w)),
                 ((2 * n + 1) * 4096 * esz, 4 * n * 4096),
                 time_ms(torch, lambda: F.rms_norm(x, (4096,), w, 1e-5),
                         cold=True))
            y, h = rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda")
            y0, h0 = rmsnorm.add_residual_rmsnorm_torch(x, r, w)
            if not torch.equal(h, h0):
                raise AssertionError(f"add_residual_rmsnorm {tag}: residual "
                                     "sum differs")
            held("add_residual_rmsnorm", y, y0, f"[{n},4096] with residual")
            gu = randn(n, 22016)
            held("silu_and_mul", activations.silu_and_mul(gu, kernels="cuda"),
                 activations.silu_and_mul_torch(gu), f"[{n},22016]", timed(
                     lambda: activations.silu_and_mul(gu, kernels="cuda"),
                     lambda: activations.silu_and_mul_torch(gu)),
                 (3 * n * 11008 * esz, 5 * n * 11008))
        T, st, nl = C_CHUNK
        starts, new_len = ints(st), ints(nl)
        kv_len = starts + new_len
        slot, slot8 = float_caches(torch, dev, gen, dtype, 1, 4, S, K, D)
        kn, vn = randn(4, T, K, D), randn(4, T, K, D)
        ref = dataclasses.replace(slot, k=slot.k.clone(), v=slot.v.clone())
        kvc.update_cache_at_layer(slot, 0, kn, vn, starts, new_len,
                                  kernels="cuda")
        kvc.update_cache_at_layer_torch(ref, 0, kn, vn, starts, new_len)
        torch.cuda.synchronize()
        if not (torch.equal(slot.k, ref.k) and torch.equal(slot.v, ref.v)):
            raise AssertionError(f"kv_write {tag}: differs from the plain "
                                 "write")
        live = sum(nl)
        record(f"kv_write[{tag}]", 0.0, results,
               f"{tag} [4,512,32,128] rows (bit for bit) cold L2", timed(
                   lambda: kvc.update_cache_at_layer(
                       slot, 0, kn, vn, starts, new_len, kernels="cuda"),
                   lambda: kvc.update_cache_at_layer_torch(
                       ref, 0, kn, vn, starts, new_len)),
               (live * 2 * K * D * esz * 2, 0, rate))
        del ref

        # D2f: B4 T512 over the slot cache (4a's chunk shape), float and
        # int8, NaN past kv_len
        for int8 in (False, True):
            say(f"  prefill plan {tag} D{D}{' int8' if int8 else ''}: "
                + str(attention.prefill_plan(D, int8=int8, dtype=dtype)))
        q = randn(4, T, H, D)
        for name, c in (("attention_prefill_float", cache_copy(slot)),
                        ("attention_prefill_float_int8", cache_copy(slot8))):
            clean = plant_nan(torch, c, kv_len)
            planes, cplanes = scale_planes(c), scale_planes(clean)

            def run(cc=c, pl=planes):
                return attention.attention(q, cc.k, cc.v, starts, kv_len,
                                           layer=0, kernels="cuda", **pl)

            def plain(cc=clean, pl=cplanes):
                return attention.attention(q, cc.k, cc.v, starts, kv_len,
                                           layer=0, kernels="torch", **pl)
            held(name, run(), plain(), f"B4 T512 H32 K32 qs{st} NaN past "
                 "kv_len", timed(run, plain, 5),
                 attn_work(st, kv_len.tolist(), T, H, K, D,
                           kv_elem=1 if planes else esz, q_elem=esz),
                 None if planes else sdpa_ms(torch, q, clean.k[0],
                                             clean.v[0], starts, kv_len))
            del c, clean

        # Df: the fused slot decode at B4 over 4a's contexts, the write
        # bit for bit; NaN from q_start on (the write must land first)
        qs = ints([7, 129, 384, 700])
        dkv = qs + 1
        say_plan(attention, f"{tag} slot B4 H{H} K{K} D{D}", 4, H, K, D,
                 dtype=dtype)
        q1, k1, v1 = randn(4, 1, H, D), randn(4, 1, K, D), randn(4, 1, K, D)
        for name, c in (("attention_decode_float", slot),
                        ("attention_decode_float_int8", slot8)):
            clean = plant_nan(torch, c, qs)   # the last use of slot(8)
            planes = scale_planes(c, snapped=True)
            cplanes = scale_planes(clean, snapped=True)

            def run(cc=c, pl=planes):
                return attention.attention_decode_fused(
                    q1, k1, v1, cc.k, cc.v, qs, dkv, 0, kernels="cuda",
                    **pl)[0]

            def plain(cc=clean, pl=cplanes):
                return attention.attention_decode_fused_torch(
                    q1, k1, v1, cc.k, cc.v, qs, dkv, 0, **pl)[0]
            got, want = run(), plain()
            torch.cuda.synchronize()
            for part in ("k", "v", "k_scale", "v_scale"):
                a, b = getattr(c, part), getattr(clean, part)
                if a is not None and not all(
                        torch.equal(a[0, i, :n], b[0, i, :n])
                        for i, n in enumerate(dkv.tolist())):
                    raise AssertionError(f"{name} {tag}: the fused write of "
                                         f"{part} differs from the plain one")
            held(name, got, want, "B4 H32 K32 4a contexts (write bit for "
                 "bit)", timed(run, plain),
                 attn_work(qs.tolist(), dkv.tolist(), 1, H, K, D,
                           kv_elem=1 if planes else esz, q_elem=esz,
                           new_rows=4 * 2 * K * D * (esz + (
                               1 if planes else esz))),
                 None if planes else sdpa_ms(torch, q1, clean.k[0],
                                             clean.v[0], qs, dkv))
            del c, clean
        del slot, slot8

        # If: 8 x 512 (2254 live rows) into the int8 slot cache, both
        # numerics, bit for bit; NaN in the new rows past new_len
        T8, st8, nl8 = I_CHUNKS[0]
        s8, n8 = ints(st8), ints(nl8)
        for snapped in (True, False):
            cache = kvc.new_kv_cache(1, 8, K, S, D, device=dev,
                                     quantized=True, snapped=snapped)
            kn, vn = randn(8, T8, K, D), randn(8, T8, K, D)
            for b, n in enumerate(nl8):
                kn[b, n:] = float("nan")
                vn[b, n:] = float("nan")
            ref = dataclasses.replace(cache, **{
                p: getattr(cache, p).clone()
                for p in ("k", "v", "k_scale", "v_scale")})
            kvc.update_cache_at_layer(cache, 0, kn, vn, s8, n8,
                                      kernels="cuda")
            kvc.update_cache_at_layer_torch(ref, 0, kn, vn, s8, n8)
            torch.cuda.synchronize()
            for p in ("k", "v", "k_scale", "v_scale"):
                if not torch.equal(getattr(cache, p), getattr(ref, p)):
                    raise AssertionError(f"kv_write_quant_float {tag} "
                                         f"{'snapped' if snapped else 'absmax'}"
                                         f": {p} differs from the plain write")
            rows = sum(nl8)
            hold_int8_write(
                torch, f"kv_write_quant_float[{tag}]", (cache.k, cache.k_scale),
                (ref.k, ref.k_scale), results,
                f"{tag} 8x512 ({rows} rows) "
                f"{'snapped' if snapped else 'absmax'} warm [before: "
                + str(IF_BEFORE_MS["slot snapped" if snapped else
                                   "slot absmax"][list(FLOAT_DTYPE).index(tag)])
                + "]",
                (time_ms(torch, lambda: kvc.update_cache_at_layer(
                    cache, 0, kn, vn, s8, n8, kernels="cuda")),
                 time_ms(torch, lambda: kvc.update_cache_at_layer_torch(
                     ref, 0, kn, vn, s8, n8), iters=3, warmup=1)),
                (rows * 2 * (K * D * esz + K * (D + 4)), rows * 2 * K * D * 4,
                 rate))
            del cache, ref

        # 3c's B16 T64 mixed step over pools of page 64: If through the
        # table (H_STARTS / H_NEW_LEN), then D2f (MIXED_START / MIXED_LEN)
        pool, pool8 = float_caches(torch, dev, gen, dtype, 1, 16, S, K, D,
                                   page=64)
        hs, hn = ints(H_STARTS), ints(H_NEW_LEN)
        kn, vn = randn(16, 64, K, D), randn(16, 64, K, D)
        w8, ref = cache_copy(pool8), cache_copy(pool8)
        pkv.paged_update_at_layer(w8, 0, kn, vn, hs, hn, kernels="cuda")
        pkv.paged_update_at_layer_torch(ref, 0, kn, vn, hs, hn)
        torch.cuda.synchronize()
        for p in ("k", "v", "k_scale", "v_scale"):
            if not torch.equal(getattr(w8, p), getattr(ref, p)):
                raise AssertionError(f"paged_kv_write_quant_float {tag}: {p} "
                                     "differs from the plain write")
        rows = sum(H_NEW_LEN)
        hold_int8_write(
            torch, f"paged_kv_write_quant_float[{tag}]",
            (w8.k, w8.k_scale), (ref.k, ref.k_scale), results,
            f"{tag} B16 mixed step ({rows} rows) page 64 warm [before: "
            f"{IF_BEFORE_MS['pool'][list(FLOAT_DTYPE).index(tag)]}]",
            (time_ms(torch, lambda: pkv.paged_update_at_layer(
                w8, 0, kn, vn, hs, hn, kernels="cuda")),
             time_ms(torch, lambda: pkv.paged_update_at_layer_torch(
                 ref, 0, kn, vn, hs, hn), iters=3, warmup=1)),
            (rows * 2 * (K * D * esz + K * (D + 4)), rows * 2 * K * D * 4,
             rate))
        del w8, ref
        ms, ml = ints(MIXED_START), ints(MIXED_LEN)
        mkv = ms + ml
        qm = randn(16, 64, H, D)
        for name, c in (("attention_prefill_paged_float", cache_copy(pool)),
                        ("attention_prefill_paged_float_int8",
                         cache_copy(pool8))):
            clean = plant_nan(torch, c, mkv, 64)
            planes, cplanes = scale_planes(c), scale_planes(clean)

            def run(cc=c, pl=planes):
                return attention.attention(qm, cc.k, cc.v, ms, mkv, layer=0,
                                           table=cc.block_table,
                                           kernels="cuda", **pl)

            def plain(cc=clean, pl=cplanes):
                return attention.attention(qm, cc.k, cc.v, ms, mkv, layer=0,
                                           table=cc.block_table,
                                           kernels="torch", **pl)
            library = None
            if not planes:
                dk = gather_pages(clean.k, 0, clean.block_table)
                dv = gather_pages(clean.v, 0, clean.block_table)
                library = sdpa_ms(torch, qm, dk, dv, ms, mkv)
                del dk, dv
            held(name, run(), plain(), "B16 T64 mixed step page 64 NaN "
                 "outside the table", timed(run, plain, 5),
                 attn_work(MIXED_START, mkv.tolist(), 64, H, K, D,
                           kv_elem=1 if planes else esz, q_elem=esz),
                 library)
            del c, clean

        # Df's fused paged decode (a float pool's decode step): B16 at
        # kv_len 2-2048 over pages of 64 (the server's shape: the JSON row)
        # and 16, and 4d's B8 at 4b's contexts over pages of 64; NaN in
        # every pool row no key below kv_len maps to; the pool and the
        # output bit for bit kernel H then the attend-only decode on a copy,
        # the output against the plain version on a clean copy
        hist = [p + 16 + f + 16 for p, f in zip(QUANT_PROMPTS, QUANT_FOLLOW)]
        for B, page, starts in ((16, 64, DECODE_WRITE_STARTS),
                                (16, 16, DECODE_WRITE_STARTS),
                                (8, 64, hist)):
            fp, _ = float_caches(torch, dev, gen, dtype, 1, B, S, K, D,
                                 page=page)
            fq = ints(starts)
            fkv = fq + 1
            clean = plant_nan(torch, fp, fkv, page)
            split = cache_copy(fp)
            tbl = fp.block_table
            q16, kn, vn = randn(B, 1, H, D), randn(B, 1, K, D), \
                randn(B, 1, K, D)
            say_plan(attention, f"{tag} paged B{B} H{H} K{K} D{D} page "
                     f"{page}", B, H, K, D, page=page,
                     max_pages=tbl.shape[1], dtype=dtype)

            def fused(fp=fp, q16=q16, kn=kn, vn=vn, fq=fq, fkv=fkv, tbl=tbl):
                return attention.attention_decode_paged_fused(
                    q16, kn, vn, fp.k, fp.v, fq, fkv, 0, table=tbl,
                    kernels="cuda")[0]

            def write_then_attend(split=split, q16=q16, kn=kn, vn=vn, fq=fq,
                                  fkv=fkv, tbl=tbl):
                pkv.paged_update_at_layer(split, 0, kn, vn, fq,
                                          torch.ones_like(fq),
                                          kernels="cuda")
                return attention.attention_decode(
                    q16, split.k, split.v, fq, fkv, 0, table=tbl,
                    kernels="cuda")

            def plain(clean=clean, q16=q16, kn=kn, vn=vn, fq=fq, fkv=fkv,
                      tbl=tbl):
                return attention.attention_decode_paged_fused_torch(
                    q16, kn, vn, clean.k, clean.v, fq, fkv, 0, table=tbl)[0]
            got, want = fused(), write_then_attend()
            torch.cuda.synchronize()
            bits = lambda t: t.view(  # noqa: E731
                torch.int16 if esz == 2 else torch.int32)
            if not (torch.equal(bits(fp.k), bits(split.k))
                    and torch.equal(bits(fp.v), bits(split.v))
                    and torch.equal(bits(got), bits(want))):
                raise AssertionError(f"attention_decode_paged_fused_float "
                                     f"{tag} B{B} page {page}: pool or "
                                     "output differs from H then the "
                                     "attend-only decode")
            two = time_ms(torch, write_then_attend, cold=True)
            alone = time_ms(torch, lambda: attention.attention_decode(
                q16, split.k, split.v, fq, fkv, 0, table=tbl,
                kernels="cuda"), cold=True)
            dk = gather_pages(clean.k, 0, tbl)
            dv = gather_pages(clean.v, 0, tbl)
            library = sdpa_ms(torch, q16, dk, dv, fq, fkv)
            del dk, dv
            held("attention_decode_paged_fused_float", got, plain(),
                 f"B{B} H{H} K{K} page {page} kv_len {min(starts) + 1}-"
                 f"{max(starts) + 1} NaN outside the table (bits equal H + "
                 f"attend-only, {two:.4f} ms; attend-only alone "
                 f"{alone:.4f} ms)", timed(fused, plain),
                 attn_work(starts, fkv.tolist(), 1, H, K, D, kv_elem=esz,
                           q_elem=esz, new_rows=B * 2 * K * D * esz * 2),
                 library)
            del fp, clean, split
        torch.cuda.empty_cache()

        # Df's attend-only paged decode at B16 (the pool holds the token):
        # a float pool's reference order (the engine fuses its write), and
        # the int8 pool's decode after If
        dq = ints(DECODE_WRITE_STARTS)
        dk_len = dq + 1
        q16 = randn(16, 1, H, D)
        for name, c in (("attention_decode_paged_float", pool),
                        ("attention_decode_paged_float_int8", pool8)):
            clean = plant_nan(torch, c, dk_len, 64)   # the last use
            planes, cplanes = scale_planes(c), scale_planes(clean)

            def run(cc=c, pl=planes):
                return attention.attention_decode(
                    q16, cc.k, cc.v, dq, dk_len, 0, table=cc.block_table,
                    kernels="cuda", **pl)

            def plain(cc=clean, pl=cplanes):
                return attention.attention_paged_torch(
                    q16, cc.k, cc.v, dq, dk_len, 0, cc.block_table, **pl)
            library = None
            if not planes:
                dk = gather_pages(clean.k, 0, clean.block_table)
                dv = gather_pages(clean.v, 0, clean.block_table)
                library = sdpa_ms(torch, q16, dk, dv, dq, dk_len)
                del dk, dv
            held(name, run(), plain(), "B16 H32 K32 page 64 kv_len 2-2048 "
                 "NaN outside the table", timed(run, plain),
                 attn_work(DECODE_WRITE_STARTS, dk_len.tolist(), 1, H, K, D,
                           kv_elem=1 if planes else esz, q_elem=esz),
                 library)
            del c, clean
        del pool, pool8

        # Df's fused decode over an int8 pool (a decode step's If write and
        # attend in one launch): B16 at pages of 64 (the JSON row) and 4d's
        # B8 at 4b's contexts; bit for bit If then the attend-only decode
        for B, starts in ((16, DECODE_WRITE_STARTS), (8, hist)):
            c = int8_fused_decode_case(torch, dev, gen, dtype, B, 64, starts)
            held("attention_decode_paged_fused_float_int8", c["got"],
                 c["plain"], f"B{B} H{H} K{K} page 64 kv_len "
                 f"{min(starts) + 1}-{max(starts) + 1} NaN outside the "
                 f"table (bits equal If + attend-only, {c['two']:.4f} ms; "
                 f"attend-only alone {c['alone']:.4f} ms)", c["timed"],
                 c["work"])
            del c
        torch.cuda.empty_cache()

        # Ef / Ff at m 8 and 512 on wqkv, down and gate|up (group 128),
        # weights cycled through 120 MB; NaN past the ends of x and of the
        # first weight's scales (garbage past its q); the time of the
        # simple instances they replaced in brackets where it was taken
        for mode in ("int4", "int8"):
            name = f"{mode}_matmul_float"
            for m, label in FLOAT_MATMUL_ROWS:
                k, n, halves = QUANT_SHAPES[label]
                ts = quant_weights(torch, quant, dev, gen, mode, k, n, halves,
                                   120_000_000)
                ts[0] = poisoned_weight(torch, quant, ts[0])
                x = poisoned(torch, randn(m, k))
                got = fused_matmul(quant, ts[0], x, dtype, "cuda")
                want = fused_matmul(quant, ts[0], x, dtype, "torch")
                before = FLOAT_MATMUL_BEFORE_MS.get((mode, m, label))
                case = f"m{m} {label} NaN past x and scales" + (
                    "" if before is None else
                    f" [before: {before[list(FLOAT_DTYPE).index(tag)]}]")
                n_out = halves * n
                held(name, got, want, case,
                     (time_ms(torch, cycling(ts, lambda t: fused_matmul(
                         quant, t, x, dtype, "cuda"))),
                      time_ms(torch, cycling(ts, lambda t: fused_matmul(
                          quant, t, x, dtype, "torch")), iters=3, warmup=1)),
                     (ts[0].nbytes + m * k * esz + m * n_out * esz,
                      2 * m * k * n_out),
                     None if halves == 2 else
                     float_int8pack_ms(torch, ts, x, dtype) if mode == "int8"
                     else int4pack_ms(torch, quant, ts, x, dtype))
                say("    plan: " + str(quant.quant_matmul_plan_native(
                    m, k, n, halves, int4=mode == "int4", dtype=dtype)))
                del ts
        torch.cuda.empty_cache()

        # head_dim 16 (the debug preset's) and 64 at small shapes: D2f in
        # the four modes, Df's two decodes, If both ways
        for d in (16, 64):
            Ls, Bs, Ss, Ks, G = 2, 3, 96, 2, 2
            qs3, nl3 = ints([0, 5, 60]), ints([37, 20, 1])
            kl3 = qs3 + nl3
            qd = randn(Bs, 37, Ks * G, d)
            for page in (None, 16):
                fc, ic = float_caches(torch, dev, gen, dtype, Ls, Bs, Ss, Ks,
                                      d, page)
                names = (("attention_prefill_float",
                          "attention_prefill_float_int8") if page is None
                         else ("attention_prefill_paged_float",
                               "attention_prefill_paged_float_int8"))
                for name, c in zip(names, (fc, ic)):
                    clean = plant_nan(torch, c, kl3, page)
                    tbl = {} if page is None else dict(table=c.block_table)
                    pl, cpl = scale_planes(c), scale_planes(clean)
                    held(name, attention.attention(
                        qd, c.k, c.v, qs3, kl3, layer=1, window=20,
                        kernels="cuda", **tbl, **pl), attention.attention(
                        qd, clean.k, clean.v, qs3, kl3, layer=1, window=20,
                        kernels="torch", **tbl, **cpl),
                        f"D{d} B3 T37 G2 window 20"
                        + ("" if page is None else " page 16"))
                    # the decode row of each sequence at kl3 - 1
                    q1d = randn(Bs, 1, Ks * G, d)
                    if page is None:
                        kd, vd = randn(Bs, 1, Ks, d), randn(Bs, 1, Ks, d)
                        snap = dict(snapped=True) if pl else {}
                        got = attention.attention_decode_fused(
                            q1d, kd, vd, c.k, c.v, kl3, kl3 + 1, 1,
                            kernels="cuda", **pl, **snap)[0]
                        want = attention.attention_decode_fused_torch(
                            q1d, kd, vd, clean.k, clean.v, kl3, kl3 + 1, 1,
                            **cpl, **snap)[0]
                        dname = ("attention_decode_float_int8" if pl
                                 else "attention_decode_float")
                    else:
                        got = attention.attention_decode(
                            q1d, c.k, c.v, kl3 - 1, kl3, 1, kernels="cuda",
                            **tbl, **pl)
                        want = attention.attention_paged_torch(
                            q1d, clean.k, clean.v, kl3 - 1, kl3, 1,
                            c.block_table, **cpl)
                        dname = ("attention_decode_paged_float_int8" if pl
                                 else "attention_decode_paged_float")
                    held(dname, got, want, f"D{d} B3 G2 decode"
                         + ("" if page is None else " page 16"))
                    del clean
                # If at this head_dim (into a fresh cache: the decode
                # above left NaN past its rows)
                fc, ic = float_caches(torch, dev, gen, dtype, Ls, Bs, Ss, Ks,
                                      d, page)
                kn3, vn3 = randn(Bs, 37, Ks, d), randn(Bs, 37, Ks, d)
                ref = cache_copy(ic)
                if page is None:
                    kvc.update_cache_at_layer(ic, 1, kn3, vn3, qs3, nl3,
                                              kernels="cuda")
                    kvc.update_cache_at_layer_torch(ref, 1, kn3, vn3, qs3,
                                                    nl3)
                else:
                    pkv.paged_update_at_layer(ic, 1, kn3, vn3, qs3, nl3,
                                              kernels="cuda")
                    pkv.paged_update_at_layer_torch(ref, 1, kn3, vn3, qs3,
                                                    nl3)
                torch.cuda.synchronize()
                if not all(torch.equal(getattr(ic, p), getattr(ref, p))
                           for p in ("k", "v", "k_scale", "v_scale")):
                    raise AssertionError(f"If {tag} D{d}: differs from the "
                                         "plain write")
                say(f"  If {tag} D{d} B3 T37{'' if page is None else ' paged'}"
                    " bit for bit")
                del fc, ic, ref
        torch.cuda.empty_cache()
    # J's float16 and float32 instances: 7B widths at a prefill chunk and
    # a decode step, then head_dim 16 and 64 at GQA groups, ragged counts
    jgen = torch.Generator(device=dev).manual_seed(1616)
    for tag, dtype in (("f32", torch.float32), ("f16", torch.float16)):
        for n, case in ((8 * 512, f"3f {tag} prefill"),
                        (8, f"3f {tag} decode")):
            rope_case(torch, jgen, results, case, n, 32, 1, 128, dtype)
        for n, K, G, d in ((40, 4, 2, 16), (7, 2, 4, 16), (37, 8, 4, 64),
                           (5, 4, 8, 64)):
            rope_case(torch, jgen, results, f"3f {tag}", n, K, G, d, dtype,
                      timed=False)


def params_to(params, device):
    """A params tree (dense tensors or QuantizedTensors) on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


def float_path_launches(label, counters, tag, engine_tag, expected,
                        results) -> dict:
    """The launches of a 4t engine's run: every kernel of ``expected``
    launched, no bf16-only kernel; the float rows whose main path this
    engine is (PATH_OF) take their launch counts from it."""
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    say(f"  {label} launches: {launches}")
    missing = [n for n in expected if not launches.get(n)]
    extra = [n for n in BF16_ONLY if launches.get(n)]
    if missing or extra:
        raise AssertionError(f"{label}: kernels never launched {missing}; "
                             f"bf16 kernels that launched {extra}")
    for name in FLOAT_INSTANCES:
        row = f"{name}[{tag}]"
        if PATH_OF[row] == f"{tag} {engine_tag}":
            results.setdefault(row, {})["launches"] = launches.get(name, 0)
    return launches


def float_first_token(torch, label, logits, logits_ref):
    """4a's rule for the first greedy token, with the reference's own
    top-1 / top-2 margin: a row may pick another token than the reference
    only where that margin is below the largest logit difference and the
    pick is the reference's second. Returns the rows that differ."""
    d = (logits - logits_ref).abs().max().item()
    top2, ids2 = logits_ref.topk(2, dim=-1)
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    got, want = logits.argmax(-1).tolist(), ids2[:, 0].tolist()
    differ = [i for i in range(len(got)) if got[i] != want[i]]
    bad = [i for i in differ if margins[i] >= d
           or got[i] != ids2[i, 1].item()]
    say(f"  {label}: first greedy tokens {got}, reference {want}; rows that "
        f"differ {differ} (margins {[round(m, 5) for m in margins]}, max "
        f"logit difference {d:.3e})")
    if bad:
        raise AssertionError(f"{label}: first greedy token differs from the "
                             f"reference in rows {bad}")
    return differ


def float_paged_step(torch, engine, label, prompts, layers, kv8):
    """The launches of one pure-decode step (eager) of a paged float
    engine: Df's fused paged decode a layer (over an int8 pool its int8
    instance) and no H, If or attend-only decode."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import SamplingParams
    from llm_inference_engine_tpu_torch.runtime.decode_graph import (
        run_eagerly)
    engine.reset()
    toks = engine.prefill(prompts).argmax(-1).to(torch.int32)
    counters = _zero_counters()
    with run_eagerly(engine):
        engine.decode_step(toks, np.ones(len(prompts), bool),
                           SamplingParams(greedy=True))
    step = _launch_counts(counters)
    engine.reset()
    want = ({"attention_decode_paged_fused_float_int8": layers} if kv8
            else {"attention_decode_paged_fused_float": layers})
    bad = {k: step.get(k, 0) for k in want if step.get(k, 0) != want[k]}
    h = sum(step.get(k, 0) for k in (
        "paged_kv_write", "paged_kv_write_quant_float",
        "attention_decode_paged_float", "attention_decode_paged_float_int8"))
    say(f"  {label}: launches a pure-decode step {step} (kernel H, If and "
        f"the attend-only decodes: {h})")
    if bad or h:
        raise AssertionError(f"{label}: a decode step launched {bad} "
                             f"(want {want}) and H, If or an attend-only "
                             f"decode {h} times")


def float_paged_vs_slot(torch, dev, label, cfg, eng, params, prompts,
                        greedy, page=None):
    """A paged float engine (D2f through the table, Df's fused paged
    decode) against the slot engine of the same params and chunking on
    the card: prefill logits and greedy ids bit for bit."""
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    kw = dict(kv_layout="paged") if page is None else dict(
        kv_layout="paged", page_size=page)
    paged = InferenceEngine(cfg, eng.replace(**kw), params, device=dev)
    slot = InferenceEngine(cfg, eng.replace(kv_layout="slot"), params,
                           device=dev)
    lp, ls = paged.prefill(prompts), slot.prefill(prompts)
    paged.reset()
    slot.reset()
    rp = paged.generate(prompts, greedy, eos_token_id=None).token_ids
    rs = slot.generate(prompts, greedy, eos_token_id=None).token_ids
    same = torch.equal(lp, ls)
    say(f"  {label} paged == slot (page {paged.cache.k.shape[2]}): prefill "
        f"logits torch.equal {same} (max abs diff "
        f"{(lp - ls).abs().max().item():.3e}); greedy ids equal {rp == rs}")
    del paged, slot
    torch.cuda.empty_cache()
    if not same or rp != rs:
        raise AssertionError(f"{label}: the paged engine differs from the "
                             "slot engine")


def debug_engine_check(torch, dev, results, tag, cfg, etag, eng, cpu_params,
                       prompts, greedy):
    """4t (a): one debug-preset engine on the card against the same engine
    on the CPU (device "cpu", the plain route), same params: prefill logits
    within FLOAT_LOGIT_REL_L2, greedy ids equal (f16: where they part, the
    card's token is one of the CPU's top two at that step, teacher-forced),
    the decode replays equal the eager bodies (graph_checks on a slot
    engine; a paged engine serves through the scheduler, replayed against
    eager)."""
    import numpy as np

    from llm_inference_engine_tpu_torch.runtime.decode_graph import (
        run_eagerly)
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    from llm_inference_engine_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)

    counters = _zero_counters()
    card = InferenceEngine(cfg, eng, params_to(cpu_params, dev), device=dev)
    cpu = InferenceEngine(cfg, eng, cpu_params, device="cpu")
    lc, lr = card.prefill(prompts), cpu.prefill(prompts)
    rel = ((lc.cpu() - lr).norm() / lr.norm()).item()
    card.reset()
    cpu.reset()
    if eng.kv_layout == "paged":
        def serve(engine, eager=False):
            sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
            with run_eagerly(engine) if eager else contextlib.nullcontext():
                reqs = [sched.submit(p, greedy) for p in prompts]
                sched.run()
            engine.reset()
            return [r.output_ids for r in reqs]
        got, want = serve(card), serve(cpu)
        eager = serve(card, True)
        replays = f"scheduler replayed == eager: {got == eager}"
        if got != eager:
            raise AssertionError(f"4t {tag} {etag}: the scheduler's replayed "
                                 "ids differ from its eager bodies'")
    else:
        got = card.generate(prompts, greedy, eos_token_id=None).token_ids
        want = cpu.generate(prompts, greedy, eos_token_id=None).token_ids
        toks = torch.tensor([o[-1] for o in got], device=dev,
                            dtype=torch.int32)
        graph_checks(torch, card, f"4t {tag} debug {etag}", toks,
                     np.ones(len(prompts), bool), prompts)
        replays = "graph_checks passed"
    paged, kv8 = eng.kv_layout == "paged", bool(eng.kv_cache_dtype_name)
    expected = NORM_ACT + tuple(
        n for n, (_, e) in FLOAT_INSTANCES.items()
        if e == f"debug {etag}" or (e == "7b" and not paged and not kv8))
    expected += (() if kv8 else ("paged_kv_write",) if paged
                 else ("kv_write",))
    float_path_launches(f"4t (a) {tag} debug {etag}", counters, tag,
                        f"debug {etag}", expected, results)
    if paged:
        float_paged_step(torch, card, f"4t (a) {tag} debug {etag}", prompts,
                         cfg.num_layers, kv8)
    if paged and not kv8:
        float_paged_vs_slot(torch, dev, f"4t (a) {tag} debug", cfg, eng,
                            card.params, prompts, greedy)
    agree = sum(a == b for x, y in zip(got, want) for a, b in zip(x, y))
    say(f"  4t (a) {tag} debug {etag}: prefill logits rel L2 card vs CPU "
        f"{rel:.3e} (limit {FLOAT_LOGIT_REL_L2[tag]}); greedy ids equal: "
        f"{got == want} ({agree}/{sum(map(len, want))}); {replays}")
    if rel > FLOAT_LOGIT_REL_L2[tag]:
        raise AssertionError(f"4t {tag} {etag}: prefill logits rel L2 {rel}")
    if got != want:
        if tag == "f32":
            raise AssertionError(f"4t f32 {etag}: greedy ids differ from the "
                                 f"CPU's: {got} vs {want}")
        for i, (a, b) in enumerate(zip(got, want)):
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if j is None:
                continue
            cpu.reset()
            ref = cpu.prefill([prompts[i] + b[:j]])[0]
            top2 = ref.topk(2).indices.tolist()
            say(f"    row {i} parts at step {j}: card {a[j]}, CPU {b[j]}, "
                f"the CPU's top two there {top2}")
            if a[j] not in top2:
                raise AssertionError(f"4t f16 {etag}: row {i}'s token at step "
                                     f"{j} is not one of the CPU's top two")
    del card, cpu
    torch.cuda.empty_cache()


def float_7b(torch, dev, results, tag, label, engine_tag, cfg, eng, params,
             prompt_lens, greedy_tokens, page=None):
    """4t (b) / (c): llama2-7b at full width in a float dtype through the
    float instances (over an int8 cache where ``eng`` names one): prefill
    logits and the first greedy token held to kernels="torch" on the card
    (float_first_token), ``greedy_tokens`` greedy tokens, the launches per
    prefill and per decode step (no bf16 kernel, no plain version),
    graph_checks (replayed step wall and card busy ms by group, tok/s).
    With ``page``, then a paged engine of the same params (pages of
    ``page``): paged == slot bit for bit, its launches a decode step (Df's
    fused paged decode, no H or If) and its graph_checks. Returns the
    params."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import SamplingParams
    from llm_inference_engine_tpu_torch.models.weights import param_bytes
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

    counters = _zero_counters()
    B = eng.max_batch_size
    engine = InferenceEngine(cfg, eng, params, device=dev)
    say(f"  {label}: weights {param_bytes(params) / 1e9:.2f} GB, cache "
        f"{kv_bytes(engine.cache) / 1e9:.2f} GB, B={B}, max_seq_len "
        f"{eng.max_seq_len}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, n).tolist() for n in prompt_lens]
    engine.prefill(prompts)                   # cold: first use of shapes
    engine.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = engine.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    engine.reset()
    r = engine.generate(prompts, SamplingParams(
        greedy=True, max_new_tokens=greedy_tokens), eos_token_id=None)
    if (r.num_generated != [greedy_tokens] * B
            or not np.isfinite(np.asarray(r.logprobs)).all()):
        raise AssertionError(f"{label}: tokens {r.num_generated} or "
                             "non-finite logprobs")
    toks = torch.tensor([o[-1] for o in r.token_ids], device=dev,
                        dtype=torch.int32)
    active = np.ones(B, bool)
    graph_checks(torch, engine, f"4t {tag} {engine_tag}", toks, active,
                 prompts)
    kv8 = eng.kv_cache_dtype_name == "int8"
    expected = NORM_ACT + (
        ("kv_write_quant_float", "attention_prefill_float_int8",
         "attention_decode_float_int8") if kv8 else
        ("kv_write", "attention_prefill_float", "attention_decode_float")) + (
        ("int4_matmul_float", "dequant_int4") if eng.quant_mode == "int4"
        else ())
    float_path_launches(f"4t {label}", counters, tag, engine_tag, expected,
                        results)
    engine.reset()
    _zero_counters()
    engine.prefill(prompts)
    per_prefill = _launch_counts(counters)
    _zero_counters()
    engine.decode_step(toks, active, SamplingParams(greedy=True))
    per_step = _launch_counts(counters)
    say(f"  {label}: launches per prefill of the {B} prompts: {per_prefill}; "
        f"per decode step: {per_step}")
    check_norm_launches(f"4t {label} prefill", per_prefill, cfg.num_layers)
    check_norm_launches(f"4t {label} decode step", per_step, cfg.num_layers,
                        1)
    ref = InferenceEngine(cfg, eng.replace(kernels="torch"), engine.params,
                          device=dev)
    logits_t = ref.prefill(prompts)
    del ref
    d, rel = _logit_diff(logits, logits_t)
    say(f"  {label}: prefill of {sum(prompt_lens)} tokens warm "
        f"{prefill_s:.3f} s; logits kernels vs torch max abs {d:.4e}, rel "
        f"L2 {rel:.4e}; round 1 tokens[0][:8] {r.token_ids[0][:8]}")
    if rel > LOGIT_REL_L2 or not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: prefill logits disagree with the "
                             "plain path")
    float_first_token(torch, f"{label} first token", logits, logits_t)
    if [o[0] for o in r.token_ids] != logits.argmax(-1).tolist():
        raise AssertionError(f"{label}: generate's first token is not the "
                             "prefill argmax")
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    if page is None:
        return params
    greedy = SamplingParams(greedy=True, max_new_tokens=greedy_tokens)
    float_paged_vs_slot(torch, dev, f"4t {label}", cfg, eng, params, prompts,
                        greedy, page)
    paged = InferenceEngine(cfg, eng.replace(kv_layout="paged",
                                             page_size=page), params,
                            device=dev)
    counters = _zero_counters()
    r = paged.generate(prompts, SamplingParams(
        greedy=True, max_new_tokens=greedy_tokens), eos_token_id=None)
    toks = torch.tensor([o[-1] for o in r.token_ids], device=dev,
                        dtype=torch.int32)
    graph_checks(torch, paged, f"4t {tag} {engine_tag} paged", toks, active,
                 prompts)
    if kv8:
        float_path_launches(
            f"4t {label} paged", counters, tag, f"{engine_tag.split()[0]} "
            "paged-kv8", NORM_ACT + ("paged_kv_write_quant_float",
                                     "attention_prefill_paged_float_int8",
                                     "attention_decode_paged_fused_float_int8"),
            results)
    float_paged_step(torch, paged, f"4t {label} paged", prompts,
                     cfg.num_layers, kv8)
    del paged
    torch.cuda.empty_cache()
    return params




def phase_float_models(torch, dev, results) -> None:
    """4t: float32 and float16 models end to end through the float
    instances. (a) the debug preset as shipped (float32, head_dim 16, 2
    layers) and in float16: params from seed 0 made on the CPU and copied
    to the card; engines slot, paged (page 16, through the scheduler), an
    int8 slot cache, an int8 pool, INT4 weights (group 64) and INT8
    weights, each against the same engine on the CPU (debug_engine_check);
    (b) llama2-7b in float16 cut to its first DEPTH_CUT layers at full
    width, B 4 on 4a's prompts, 32 greedy tokens, then INT4 weights at B 8
    on 4b's prompts (Ef at m 8 and 512, G and cuBLAS at m >= 1024); (c)
    llama2-7b in float32 cut the same way, B 2, max_seq_len 1024,
    prompts of 7 and 700 tokens, 16 greedy tokens (float_7b); (b) also
    runs (b)'s float16 weights over an int8 cache, slot at B 4 and paged
    over pages of 64, each held to kernels="torch" as (b) is."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.models import weights as W

    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 256, n).tolist() for n in (5, 23, 61)]
    greedy = SamplingParams(greedy=True, max_new_tokens=16)
    base = dict(max_batch_size=3, max_seq_len=128)
    engines = (("slot", {}), ("paged", dict(kv_layout="paged", page_size=16)),
               ("kv8", dict(kv_cache_dtype_name="int8")),
               ("paged-kv8", dict(kv_layout="paged", page_size=16,
                                  kv_cache_dtype_name="int8")),
               ("int4", dict(quant_mode="int4", quant_group_size=64)),
               ("int8w", dict(quant_mode="int8")))
    for tag in FLOAT_DTYPE:
        cfg = get_config("debug").replace(dtype_name=FLOAT_DTYPE[tag])
        dense = W.init_dummy_params(cfg, seed=0, device="cpu")
        for etag, kw in engines:
            mode = kw.get("quant_mode")
            cpu_params = dense if mode is None else \
                W.init_dummy_quantized_params(cfg, mode, 64, seed=0,
                                              device="cpu")
            t0 = time.perf_counter()
            debug_engine_check(torch, dev, results, tag, cfg, etag,
                               EngineConfig(**base, **kw), cpu_params,
                               prompts, greedy)
            say(f"    ({time.perf_counter() - t0:.1f} s)")

    seven = get_config("llama2-7b")
    cfg = seven.replace(dtype_name="float16", num_layers=DEPTH_CUT)
    cut = f"{DEPTH_CUT} of 32 layers"
    b4 = EngineConfig(max_batch_size=4, max_seq_len=2048)
    params = float_7b(torch, dev, results, "f16", f"(b) llama2-7b float16, "
                      f"{cut}", "7b", cfg, b4,
                      W.init_dummy_params(cfg, seed=0, device=dev),
                      (7, 129, 384, 700), 32, page=64)
    torch.cuda.empty_cache()
    float_7b(torch, dev, results, "f16", f"(b) llama2-7b float16 int8 KV, "
             f"{cut}", "7b kv8", cfg, b4.replace(kv_cache_dtype_name="int8"),
             params, (7, 129, 384, 700), 32, page=64)
    del params
    torch.cuda.empty_cache()
    float_7b(torch, dev, results, "f16", f"(b) llama2-7b float16 INT4, {cut}",
             "7b int4", cfg, EngineConfig(quant_mode="int4", max_batch_size=8,
                                          max_seq_len=2048),
             W.init_dummy_quantized_params(cfg, "int4", 128, seed=0,
                                           device=dev), QUANT_PROMPTS, 16)
    torch.cuda.empty_cache()
    cfg = seven.replace(dtype_name="float32", num_layers=DEPTH_CUT)
    float_7b(torch, dev, results, "f32", f"(c) llama2-7b float32, {cut}",
             "7b", cfg,
             EngineConfig(max_batch_size=2, max_seq_len=1024),
             W.init_dummy_params(cfg, seed=0, device=dev), (7, 700), 16)
    torch.cuda.empty_cache()


# 4u: the model families beside Llama-2 (config.py's presets), at full
# width and depth: per family (path tag, engine fields, prompt and
# follow-up lengths, greedy tokens) for its bf16 path (B = 4) and its INT4
# path (group 128, the benchmark format), and its control: the feature
# switched off in the bf16 path ((what, config fields, rows held)).
# Llama-3.1's and Qwen2's paths take 4a's and 4b's prompts; Mistral's
# prompts pass its window of 4096 in three rows of four (prefill, decode,
# graph_checks' capacity row), its control held on the two rows whose
# prompts pass it
B4_PROMPTS = (7, 129, 384, 700)
B4_FOLLOW = (5, 17, 33, 64)
MISTRAL_PROMPTS = (700, 3000, 4500, 6100)
FAMILIES = {
    "llama3.1-8b": dict(
        bf16=(dict(max_batch_size=4, max_seq_len=2048), B4_PROMPTS,
              B4_FOLLOW, 32),
        int4=(dict(quant_mode="int4", max_batch_size=8, max_seq_len=2048),
              QUANT_PROMPTS, QUANT_FOLLOW, 16),
        control=("Llama-3 RoPE scaling off", dict(rope_scaling=None),
                 None)),
    "mistral-7b": dict(
        bf16=(dict(max_batch_size=4, max_seq_len=8192), MISTRAL_PROMPTS,
              B4_FOLLOW, 32),
        int4=(dict(quant_mode="int4", max_batch_size=4, max_seq_len=8192),
              MISTRAL_PROMPTS, B4_FOLLOW, 16),
        control=("no sliding window", dict(sliding_window=None), [2, 3])),
    "qwen2-7b": dict(
        bf16=(dict(max_batch_size=4, max_seq_len=2048), B4_PROMPTS,
              B4_FOLLOW, 32),
        int4=(dict(quant_mode="int4", max_batch_size=8, max_seq_len=2048),
              QUANT_PROMPTS, QUANT_FOLLOW, 16),
        control=("no qkv bias", dict(attention_bias=False), None)),
}
MAIN_PATHS.update({f"{model} {kind}": MAIN_PATHS[kind]
                   for model in FAMILIES for kind in ("bf16", "int4")})


def rank_config(cfg, tp: int):
    """The shapes one model rank of ``tp`` computes with: ``cfg`` with its
    heads, FFN and vocabulary split (the columns of wqkv, gate|up and the
    lm_head, the rows of wo and down), so that ``family_shapes`` of it are
    the rank's projections."""
    if tp == 1:
        return cfg
    return cfg.replace(num_heads=cfg.num_heads // tp,
                       num_kv_heads=cfg.num_kv_heads // tp,
                       intermediate_size=cfg.intermediate_size // tp,
                       vocab_size=cfg.vocab_size // tp)


def family_shapes(cfg) -> dict:
    """(k, n, halves) of a model's quantized projections, as QUANT_SHAPES
    holds Llama-2-7B's."""
    return {"wqkv": (cfg.hidden_size, cfg.qkv_size, 1),
            "wo": (cfg.q_size, cfg.hidden_size, 1),
            "gate|up": (cfg.hidden_size, cfg.intermediate_size, 2),
            "down": (cfg.intermediate_size, cfg.hidden_size, 1),
            "lm_head": (cfg.hidden_size, cfg.vocab_size, 1)}


def norm_act_rows(torch, dev, gen, results, tag: str, Hd: int,
                  I: int) -> None:
    """A and B at a prefill chunk's 2048 rows of a model's widths (cold:
    A's set fits the L2; NaN past every tail), then at decode shape in
    graph replays (``decode_shape_rows``)."""
    import torch.nn.functional as F

    from llm_inference_engine_tpu_torch.ops import activations, rmsnorm

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    x, r = poisoned(torch, randn(2048, Hd)), poisoned(torch, randn(2048, Hd))
    w = poisoned(torch, randn(Hd) * 0.1 + 1.0)
    check_close(torch, "rmsnorm", rmsnorm.rmsnorm(x, w, kernels="cuda"),
                rmsnorm.rmsnorm_torch(x, w), results,
                f"{tag}[2048,{Hd}] cold L2, NaN past the tails", (
                    time_ms(torch, lambda: rmsnorm.rmsnorm(
                        x, w, kernels="cuda"), cold=True),
                    time_ms(torch, lambda: rmsnorm.rmsnorm_torch(x, w))),
                work=((2 * 2048 + 1) * Hd * 2, 4 * 2048 * Hd),
                library=time_ms(torch, lambda: F.rms_norm(
                    x, (Hd,), w, 1e-5), cold=True))
    y, h = rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda")
    y0, h0 = rmsnorm.add_residual_rmsnorm_torch(x, r, w)
    if not torch.equal(h, h0):
        raise AssertionError(f"add_residual_rmsnorm {tag}[2048,{Hd}]: "
                             "residual sum differs")
    check_close(torch, "add_residual_rmsnorm", y, y0, results,
                f"{tag}[2048,{Hd}] with residual, cold L2", (
                    time_ms(torch, lambda: rmsnorm.add_residual_rmsnorm(
                        x, r, w, kernels="cuda"), cold=True),
                    time_ms(torch, lambda: rmsnorm.add_residual_rmsnorm_torch(
                        x, r, w))),
                work=((4 * 2048 + 1) * Hd * 2, 5 * 2048 * Hd))
    gu = poisoned(torch, randn(2048, 2 * I))
    check_close(torch, "silu_and_mul",
                activations.silu_and_mul(gu, kernels="cuda"),
                activations.silu_and_mul_torch(gu), results,
                f"{tag}[2048,{2 * I}] NaN past the tail", (
                    time_ms(torch, lambda: activations.silu_and_mul(
                        gu, kernels="cuda")),
                    time_ms(torch, lambda: activations.silu_and_mul_torch(
                        gu))),
                work=(3 * 2048 * I * 2, 5 * 2048 * I))
    del x, r, gu, y, h, y0, h0
    decode_shape_rows(torch, dev, Hd, I)


def family_kernel_rows(torch, dev, results, model: str,
                       seen: set, tp: int = 1) -> None:
    """4u's kernels at a family's shapes, every input at the head of a
    buffer whose tail is NaN and every cache row past kv_len (and, paged,
    every pool row outside the table) NaN, held against the plain versions
    and timed beside them with their bounds and library calls: E at the
    INT4 path's decode m (B) on the five projections and at its prefill
    mode's m (the 8 x 64 tail; Mistral: the paged check's 4 x 64 chunk) on
    four, G on the four (bit for bit), A at [2048, hidden] and B at
    [2048, 2 I] (and both at decode shape in graph replays), J at the
    bf16 path's first chunk and a decode step (Qwen2: its bias mode; in
    graph replays too), C writing the bf16 path's first chunk, D2
    attending it and D's fused decode at the INT4 path's contexts (Mistral:
    a chunk and contexts of 3600-6150 under its window of 4096, and D's
    fused paged decode and H through a table at those contexts). ``seen``
    holds the G and A/B shapes an earlier family held (Mistral's equal
    Llama-3.1's): they run once. With ``tp`` > 1, the same at one model
    rank's shapes (``rank_config``: the heads, the FFN and the vocabulary
    split), C and D2 at the INT4 path's first chunk, and every family's
    paged rows (4w (d))."""
    from llm_inference_engine_tpu_torch.config import get_config
    from llm_inference_engine_tpu_torch.ops import attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import quant
    cfg = rank_config(get_config(model), tp)
    Hd, I, H, K, D = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim)
    G, W = H // K, cfg.sliding_window
    spec = MODEL_PATHS[model]
    mistral = W is not None
    B8 = spec["int4"][0]["max_batch_size"]
    shapes = family_shapes(cfg)
    gen = torch.Generator(device=dev).manual_seed(2025)
    tag = f"{model} " if tp == 1 else f"{model} tp{tp} "
    nan = float("nan")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    # E: the INT4 path's decode step, and its prefill mode's rows
    m_pre = 4 * 64 if mistral else 8 * 64
    for m, labels in ((B8, shapes), (m_pre, list(shapes)[:4])):
        for label in labels:
            quant_case(torch, dev, gen, results, "int4", m, label, shapes,
                       tag=tag, poison=True)
        torch.cuda.empty_cache()
    # G: the first chunk's m >= 1024 route

    def g(t, kern):
        return quant.dequant_int4(t.q, t.scale, 128, kernels=kern)
    for label in list(shapes)[:4]:
        k, n, halves = shapes[label]
        if ("G", k, n, halves) in seen:
            continue
        seen.add(("G", k, n, halves))
        ts = quant_weights(torch, quant, dev, gen, "int4", k, n, halves,
                           120_000_000)
        ts[0] = quant.QuantizedTensor(poisoned(torch, ts[0].q),
                                      poisoned(torch, ts[0].scale), "int4",
                                      128)
        got, want = g(ts[0], "cuda"), g(ts[0], "torch")
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"dequant_int4 {model} {label}: not "
                                 "bit-identical to the plain dequant")
        check_close(torch, "dequant_int4", got, want, results,
                    f"{tag}{label} [{k // 2},{halves * n}] -> bf16 "
                    "(torch.equal), NaN past the tail",
                    (time_ms(torch, cycling(ts, lambda t: g(t, "cuda"))),
                     time_ms(torch, cycling(ts, lambda t: g(t, "torch")),
                             iters=3, warmup=1)),
                    work=(ts[0].nbytes + k * halves * n * 2,
                          2 * k * halves * n))
        del ts, got, want
    torch.cuda.empty_cache()

    if ("A/B", Hd, I) not in seen:
        seen.add(("A/B", Hd, I))
        norm_act_rows(torch, dev, gen, results, tag, Hd, I)

    # J: the bf16 path's first chunk (4 x 512) and a decode step (B8)
    bias = cfg.attention_bias
    for n, case in ((4 * 512, "prefill 4 x 512"), (B8, "decode")):
        rope_case(torch, gen, results, f"{tag}{case}", n, K, G, D, bias=bias)
    rope_replayed_rows(torch, dev, tag.strip(), K, G, D, n=B8, bias=bias)

    # C and D2: the bf16 path's first chunk, at a rank the INT4 path's
    # (Mistral: a chunk deep in its context, the window cutting every
    # row's keys)
    L, T = 2, 512
    if mistral:
        B, S, starts_l, new_len_l = 4, 8192, [3584, 4096, 5120, 5632], [
            512, 512, 512, 468]
    else:
        first = spec["bf16" if tp == 1 else "int4"][1]
        B, S, starts_l = len(first), 2048, [0] * len(first)
        new_len_l = [min(n, T) for n in first]
    starts, new_len = ints(starts_l), ints(new_len_l)
    kv_len_l = [s + n for s, n in zip(starts_l, new_len_l)]
    kv_len = ints(kv_len_l)
    kn, vn = poisoned(torch, randn(B, T, K, D)), poisoned(torch,
                                                          randn(B, T, K, D))
    cache = kvc.new_kv_cache(L, B, K, S, D, device=dev)
    cache.k[1], cache.v[1] = randn(B, S, K, D), randn(B, S, K, D)
    ref = kvc.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths)
    kvc.update_cache_at_layer(cache, 1, kn, vn, starts, new_len,
                              kernels="cuda")
    kvc.update_cache_at_layer_torch(ref, 1, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    if not (torch.equal(cache.k, ref.k) and torch.equal(cache.v, ref.v)):
        raise AssertionError(f"kv_write {model}: cache differs from the "
                             "plain write")
    rows, picked = slot_rows(starts_l, new_len_l, T, S)
    check_close(torch, "kv_write", cache.k[1], ref.k[1], results,
                f"{tag}[{B},512,{K},{D}] at {starts_l}, new {new_len_l}, "
                "cold L2", (
                    time_ms(torch, lambda: kvc.update_cache_at_layer(
                        cache, 1, kn, vn, starts, new_len, kernels="cuda"),
                        cold=True),
                    time_ms(torch, lambda: kvc.update_cache_at_layer_torch(
                        ref, 1, kn, vn, starts, new_len))),
                work=write_work(len(rows), K, D),
                library=index_copy_ms(torch, (cache.k[1], cache.v[1]),
                                      (kn, vn), (ints(rows).long(),
                                                 ints(picked).long())),
                floor=floor_ms(torch, (kn, vn), picked, torch.bfloat16,
                               cold=True))
    for b, n in enumerate(kv_len_l):
        cache.k[1, b, n:] = nan
        cache.v[1, b, n:] = nan
    q = poisoned(torch, randn(B, T, H, D))
    run = lambda: attention.attention(  # noqa: E731
        q, cache.k, cache.v, starts, kv_len, layer=1, window=W,
        kernels="cuda")
    plain = lambda: attention.attention_torch(  # noqa: E731
        q, ref.k, ref.v, starts, kv_len, layer=1, window=W)
    check_close(torch, "attention_prefill", run(), plain(), results,
                f"{tag}B{B} T512 H{H} K{K} qs {starts_l} window {W}, NaN "
                "past kv_len", (time_ms(torch, run, iters=5),
                           time_ms(torch, plain, iters=3, warmup=1)),
                work=attn_work(starts_l, kv_len_l, T, H, K, D, window=W),
                library=sdpa_ms(torch, q, ref.k[1], ref.v[1], starts, kv_len,
                                window=W))
    del cache, ref, kn, vn, q
    torch.cuda.empty_cache()

    # D: the fused decode at the INT4 path's step (Mistral: contexts past
    # the window)
    hist = ([3600, 4095, 5200, 6150] if mistral else
            [p + 16 + f + 16 for p, f in zip(QUANT_PROMPTS, QUANT_FOLLOW)])
    B = len(hist)
    c = kvc.new_kv_cache(L, B, K, S, D, device=dev)
    c.k.copy_(randn(L, B, S, K, D))
    c.v.copy_(randn(L, B, S, K, D))
    ref = kvc.KVCache(c.k.clone(), c.v.clone(), c.lengths)
    for b, n in enumerate(hist):
        c.k[1, b, n + 1:] = nan
        c.v[1, b, n + 1:] = nan
    qs = ints(hist)
    kl = qs + 1
    qd = poisoned(torch, randn(B, 1, H, D))
    kn1, vn1 = poisoned(torch, randn(B, 1, K, D)), poisoned(torch,
                                                            randn(B, 1, K, D))
    run = lambda: attention.attention_decode_fused(  # noqa: E731
        qd, kn1, vn1, c.k, c.v, qs, kl, 1, window=W, kernels="cuda")[0]
    plain = lambda: attention.attention_decode_fused_torch(  # noqa: E731
        qd, kn1, vn1, ref.k, ref.v, qs, kl, 1, window=W)[0]
    got, want = run(), plain()
    torch.cuda.synchronize()
    b_idx = torch.arange(B, device=dev)
    for x, y in ((c.k, ref.k), (c.v, ref.v)):
        if not torch.equal(x[1, b_idx, qs.long()], y[1, b_idx, qs.long()]):
            raise AssertionError(f"attention_decode {model}: the fused "
                                 "write differs from the plain write")
    say_plan(attention, f"{tag}B{B} H{H} K{K} D{D}", B, H, K, D)
    check_close(torch, "attention_decode", got, want, results,
                f"{tag}B{B} H{H} K{K} contexts {min(hist)}-{max(hist)} "
                f"window {W}, NaN past kv_len",
                (time_ms(torch, run), time_ms(torch, plain, iters=3,
                                              warmup=1)),
                work=attn_work(hist, [n + 1 for n in hist], 1, H, K, D,
                               new_rows=B * 2 * K * D * 2 * 2, window=W),
                library=sdpa_ms(torch, qd, ref.k[1], ref.v[1], qs, kl,
                                window=W),
                row_rel=DECODE_ROW_TOL)
    if mistral or tp > 1:
        family_paged_rows(torch, dev, gen, results, tag.strip(), cfg,
                          c.k[1], c.v[1], hist)
    del c, ref
    torch.cuda.empty_cache()


def family_paged_rows(torch, dev, gen, results, model, cfg, k_slot,
                      v_slot, hist) -> None:
    """A family's paged rows (the paged check's kernels at its widths, or
    at a rank's heads: ``cfg``; ``model`` tags the rows): the slot rows
    ``k_slot`` / ``v_slot`` [B, S, K, D] (NaN past each row's history)
    laid into a pool of pages of 64 through a random page permutation,
    every pool row outside the table NaN; H writes a B x 64 chunk at
    page-aligned histories (Mistral's past the window), bit for bit the
    plain write; D's fused paged decode at ``hist`` (under the window)
    writes the token through the table and attends, bit for bit the slot
    decode on the same rows and within the row limit of the plain
    version."""
    from llm_inference_engine_tpu_torch.ops import attention
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    H, K, D, W = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                  cfg.sliding_window)
    B, S = k_slot.shape[:2]
    page = 64
    maxp = S // page
    P = 1 + B * maxp

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    table = (torch.randperm(P - 1, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(B, maxp)
    k = torch.full((2, P, page, K, D), float("nan"), device=dev,
                   dtype=torch.bfloat16)
    v = torch.full_like(k, float("nan"))
    k[1][table.long()] = k_slot.view(B, maxp, page, K, D)
    v[1][table.long()] = v_slot.view(B, maxp, page, K, D)
    cache = pkv.PagedKVCache(k.clone(), v.clone(), table, ints([0] * B))
    ref = pkv.PagedKVCache(k.clone(), v.clone(), table, cache.lengths)
    # H: a B x 64 prefill chunk at page-aligned histories
    starts_l = [(n // page) * page for n in hist]
    new_len_l = ([64, 64, 64, 37] * 2)[:B]
    starts, new_len = ints(starts_l), ints(new_len_l)
    kn, vn = poisoned(torch, randn(B, 64, K, D)), poisoned(torch,
                                                           randn(B, 64, K, D))
    pkv.paged_update_at_layer(cache, 1, kn, vn, starts, new_len,
                              kernels="cuda")
    pkv.paged_update_at_layer_torch(ref, 1, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in ((cache.k, ref.k), (cache.v, ref.v)))
    if not same:
        raise AssertionError(f"paged_kv_write {model}: the pool differs "
                             "from the plain write")
    tl = table.tolist()
    pos, picked = slot_rows(starts_l, new_len_l, 64, 0)
    flat = [tl[i // 64][p // page] * page + p % page
            for p, i in zip(pos, picked)]
    check_close(torch, "paged_kv_write", torch.nan_to_num(cache.k[1]),
                torch.nan_to_num(ref.k[1]), results,
                f"{model} B{B} chunk {B} x 64 at {starts_l}, new "
                f"{new_len_l}, page 64 cold L2, bits equal the plain write",
                (time_ms(torch, lambda: pkv.paged_update_at_layer(
                    cache, 1, kn, vn, starts, new_len, kernels="cuda"),
                    cold=True),
                 time_ms(torch, lambda: pkv.paged_update_at_layer_torch(
                     ref, 1, kn, vn, starts, new_len))),
                work=write_work(len(picked), K, D),
                library=index_copy_ms(torch, (cache.k[1], cache.v[1]),
                                      (kn, vn), (ints(flat).long(),
                                                 ints(picked).long())),
                floor=floor_ms(torch, (kn, vn), picked, torch.bfloat16,
                               cold=True))
    # D: the fused paged decode on the slot rows (the pool restored; the
    # plain version's copy clean)
    cache.k.copy_(k)
    cache.v.copy_(v)
    ref.k.copy_(k.nan_to_num())
    ref.v.copy_(v.nan_to_num())
    qs = ints(hist)
    kl = qs + 1
    qd = poisoned(torch, randn(B, 1, H, D))
    kn1, vn1 = poisoned(torch, randn(B, 1, K, D)), poisoned(torch,
                                                            randn(B, 1, K, D))
    run = lambda: attention.attention_decode_paged_fused(  # noqa: E731
        qd, kn1, vn1, cache.k, cache.v, qs, kl, 1, table=table, window=W,
        kernels="cuda")[0]
    plain = lambda: attention.attention_decode_paged_fused_torch(  # noqa: E731
        qd, kn1, vn1, ref.k, ref.v, qs, kl, 1, table=table, window=W)[0]
    got, want = run(), plain()
    ks, vs = k_slot.clone(), v_slot.clone()
    slot = attention.attention_decode_fused(
        qd, kn1, vn1, ks[None], vs[None], qs, kl, 0, window=W,
        kernels="cuda")[0]
    torch.cuda.synchronize()
    say_plan(attention, f"{model} paged B{B} H{H} K{K} D{D} page 64", B, H,
             K, D, page=page, max_pages=maxp)
    if not torch.equal(got, slot):
        raise AssertionError(f"attention_decode_paged_fused {model}: not "
                             "bit for bit the slot decode on the same rows")
    check_close(torch, "attention_decode_paged_fused", got, want, results,
                f"{model} B{B} H{H} K{K} page 64 contexts {min(hist)}-"
                f"{max(hist)} window {W} (bits equal the slot decode), NaN "
                "outside the table and past kv_len",
                (time_ms(torch, run), time_ms(torch, plain, iters=3,
                                              warmup=1)),
                work=attn_work(hist, [n + 1 for n in hist], 1, H, K, D,
                               new_rows=B * 2 * K * D * 2 * 2, window=W),
                row_rel=DECODE_ROW_TOL)
    del cache, ref, k, v, ks, vs
    torch.cuda.empty_cache()


def phase_model_families(torch, dev, results) -> None:
    """4u: each family of FAMILIES at full width and depth, one sub-phase
    a family: its kernels at its shapes (``family_kernel_rows``), its bf16
    path with its control and its INT4 path through ``phase_main_path``
    (the JSON ``kernels`` line keeps phase 3's rows), and for Mistral the
    paged engine (pages of 64, chunks of 64) against the slot engine over
    its 8192-token context: prefill logits bit for bit, greedy ids equal,
    every decode step a fused paged decode a layer under the window.
    DEPTH_CUT_PATHS cuts the depth of Mistral's bf16 path and paged
    check."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
    seen: set = set()
    for sub, (model, spec) in zip("abc", FAMILIES.items()):
        t0 = time.perf_counter()
        say(f"  -- 4u ({sub}) {model}")
        family_kernel_rows(torch, dev, results, model, seen)
        for kind in ("bf16", "int4"):
            eng, lens, follow, n = spec[kind]
            phase_main_path(torch, dev, results, f"{model} {kind}",
                            EngineConfig(**eng), lens, follow, n,
                            model=model,
                            control=spec["control"] if kind == "bf16"
                            else None, plain_generate=False)
            torch.cuda.empty_cache()
        if get_config(model).sliding_window is not None:
            eng, lens, _, _ = spec["int4"]
            rng = np.random.default_rng(0)
            prompts = [rng.integers(3, get_config(model).vocab_size,
                                    n).tolist() for n in lens]
            phase_paged_vs_slot(torch, dev, model, dict(quant_mode="int4"),
                                prompts, 32, max_seq_len=eng["max_seq_len"],
                                tag=f"{model} paged int4")
            torch.cuda.empty_cache()
        say(f"  4u ({sub}) {model}: {time.perf_counter() - t0:.1f} s")


# 4v: the paths the port had not run on the card. (a) Llama-2-13B
# (config.py's llama2-13b: hidden 5120, 40 heads, no GQA, 40 layers) at
# full width and depth, bf16 B = 4 on 4a's prompts and INT4 B = 8 on 4b's,
# as the families' paths (it has no family feature: no control); (c)
# Mistral-7B with INT8 weights over an int8 slot cache, B = 4, prompts of
# 700-6100 in 8192 (4j's route under its window of 4096)
LARGE = {
    "llama2-13b": dict(
        bf16=(dict(max_batch_size=4, max_seq_len=2048), B4_PROMPTS,
              B4_FOLLOW, 32),
        int4=(dict(quant_mode="int4", max_batch_size=8, max_seq_len=2048),
              QUANT_PROMPTS, QUANT_FOLLOW, 16),
        control=None)}
MODEL_PATHS = {**FAMILIES, **LARGE}
WINDOW_INT8 = ("mistral-7b int8-kv8",
               dict(quant_mode="int8", max_batch_size=4, max_seq_len=8192,
                    kv_cache_dtype_name="int8"), MISTRAL_PROMPTS, B4_FOLLOW,
               16)
MAIN_PATHS.update({f"{model} {kind}": MAIN_PATHS[kind]
                   for model in LARGE for kind in ("bf16", "int4")})
MAIN_PATHS[WINDOW_INT8[0]] = MAIN_PATHS["int8-kv8"]
# 4v (b): the server over Llama-3.1-8B (G 4, a vocabulary of 128256)
SERVED_MODEL = "llama3.1-8b"
# the INT4 prefill's m >= 1024 route (G, then cuBLAS): the projections
# [k, n] of 4b's, the families', 13B's, tinyllama's (4l's draft) and
# Llama-2-7B's tp = 2 local shapes (4n), at their first chunk's rows (8 x
# 512; Mistral's B 4: 4 x 512), and at LARGE_M_ROWS, rows a chunk leaves
# live (shorter prompts, the scheduler's mixed steps)
LARGE_M_SHAPES = {"llama2-7b": 4096, "llama3.1-8b": 4096,
                  "mistral-7b": 2048, "qwen2-7b": 4096, "llama2-13b": 4096,
                  "tinyllama-1.1b": 4096, "llama2-7b tp2": 4096}
LARGE_M_ROWS = (1024, 1100, 1536, 3000)


def large_m_projections(name: str) -> dict:
    """(k, n, halves) of the four projections of LARGE_M_SHAPES' ``name``:
    a preset's, or with `` tp2`` one rank's shard at tp = 2 (wqkv and
    gate|up split by columns, wo and down by rows)."""
    from llm_inference_engine_tpu_torch.config import get_config
    model, _, tp2 = name.partition(" ")
    shapes = dict(list(family_shapes(get_config(model)).items())[:4])
    if tp2:
        rows = ("wo", "down")
        shapes = {label: ((k // 2, n, h) if label in rows else (k, n // 2, h))
                  for label, (k, n, h) in shapes.items()}
    return shapes


def bf16_out_mm_rows(torch, dev) -> None:
    """The INT4 prefill's product at m >= 1024: ``quant._large_m_linear``'s
    kernel route takes one cuBLAS call with a bf16 result (``_mm_bf16``)
    where the plain route and the JAX package cast an f32 product
    (``_mm_f32``, then ``.to(bfloat16)``), so the two must be bit for bit
    at each projection of LARGE_M_SHAPES at its first chunk's rows and at
    LARGE_M_ROWS (bf16 weights and activations drawn from a seed); both
    routes timed in turns at the first chunk's rows."""
    from llm_inference_engine_tpu_torch.ops import quant
    gen = torch.Generator(device=dev).manual_seed(1024)
    bf16 = torch.bfloat16
    equal = True
    for name, m in LARGE_M_SHAPES.items():
        shapes = large_m_projections(name)
        for label, (k, n, halves) in shapes.items():
            w = torch.randn(k, halves * n, generator=gen, device=dev,
                            dtype=bf16) * 0.02
            x = torch.randn(m, k, generator=gen, device=dev, dtype=bf16)
            odd = [rows for rows in LARGE_M_ROWS
                   if not torch.equal(quant._mm_f32(x[:rows], w).to(bf16),
                                      quant._mm_bf16(x[:rows], w))]

            def cast():
                return quant._mm_f32(x, w).to(bf16)

            def one():
                return quant._mm_bf16(x, w)
            same = torch.equal(cast(), one()) and not odd
            equal &= same
            turns = {"cast": [], "one": []}
            for r in ("cast", "one", "one", "cast"):
                turns[r].append(time_ms(torch, cast if r == "cast" else one,
                                        iters=5))
            say(f"  bf16-out mm {name} m{m} {label} [{k},{halves * n}]: "
                f"bit for bit the f32 product cast {same} (also at m "
                f"{', '.join(map(str, LARGE_M_ROWS))}"
                + (f"; differs at {odd}" if odd else "") + "); in turns f32 "
                f"+ cast {sum(turns['cast']) / 2:.4f} ms, bf16 out (the "
                f"route) {sum(turns['one']) / 2:.4f} ms")
            del w, x
        torch.cuda.empty_cache()
    say(f"  bf16-out mm: every shape bit for bit {equal}")
    if not equal:
        raise AssertionError("the INT4 prefill's bf16-out product is not "
                             "bit for bit the f32 product cast")


def int8_window_rows(torch, dev, results, model: str = "mistral-7b") -> None:
    """4v (c)'s kernels at Mistral's shapes, held against their plain
    versions and timed beside them with their bounds: F at the decode
    step's m 4 on the five projections (``_weight_int8pack_mm`` beside);
    G8 and its epilogue at the first chunk's 2048 rows on the four
    (``g8_cases``); I writing a 4 x 512 chunk at histories 3584-5632 of
    8192 (snapped numerics, the card's), bit for bit; D2's ``INT8`` mode
    attending that chunk under the window (kv_len to 6144); D's fused int8
    decode (``INT8``, ``WRITE_NEW``) at B 4, contexts 3600-6150 under the
    window, and at Qwen2's G 7 (28 heads, K 4) at B 8 on 4b's contexts
    without one, its write bit for bit. Inputs lie at the head of buffers
    whose tails are NaN; every scale past kv_len and left of every row's
    window is NaN (keys there must not be read, nor their scales enter a
    sum); the plain versions run on clean copies."""
    from llm_inference_engine_tpu_torch.config import get_config
    from llm_inference_engine_tpu_torch.ops import attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import quant
    cfg = get_config(model)
    shapes = family_shapes(cfg)
    gen = torch.Generator(device=dev).manual_seed(2026)
    tag = f"{model} "
    nan = float("nan")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    # F: the decode step (B 4)
    B = WINDOW_INT8[1]["max_batch_size"]
    for label in shapes:
        quant_case(torch, dev, gen, results, "int8", B, label, shapes,
                   tag=tag, poison=True)
    torch.cuda.empty_cache()
    # G8 and its epilogue: the first chunk (4 x 512 rows)
    m = 4 * 512
    for label in list(shapes)[:4]:
        k, n, halves = shapes[label]
        ts = quant_weights(torch, quant, dev, gen, "int8", k, n, halves,
                           120_000_000)
        g8_cases(torch, dev, gen, results, ts, label, k, halves * n, m,
                 tag=f"{tag}m{m} ")
        del ts
        torch.cuda.empty_cache()

    def int8_cache(L, B, K, S, D):
        c = kvc.new_kv_cache(L, B, K, S, D, device=dev, quantized=True,
                             snapped=True)
        for t in (c.k, c.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=dev, dtype=torch.int8))
        for t in (c.k_scale, c.v_scale):
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02
                    + 0.005)
        return c

    def clone(c):
        return dataclasses.replace(c, **{n: getattr(c, n).clone() for n in
                                         ("k", "v", "k_scale", "v_scale")})

    def poison_scales(c, lo, hi):
        """NaN scales of layer 1 left of ``lo[b]`` and from ``hi[b]``."""
        for b, (a, z) in enumerate(zip(lo, hi)):
            for t in (c.k_scale, c.v_scale):
                t[1, b, :max(a, 0)] = nan
                t[1, b, z:] = nan

    def planes(c):
        return dict(k_scale=c.k_scale, v_scale=c.v_scale)

    H, K, D, W = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.sliding_window
    S, T = WINDOW_INT8[1]["max_seq_len"], 512
    # I: a 4 x 512 chunk deep in the context, ragged
    starts_l, new_len_l = [3584, 4096, 5120, 5632], [512, 512, 300, 512]
    starts, new_len = ints(starts_l), ints(new_len_l)
    cache = int8_cache(2, 4, K, S, D)
    kn, vn = poisoned(torch, randn(4, T, K, D)), poisoned(torch,
                                                          randn(4, T, K, D))
    ref = clone(cache)
    kvc.update_cache_at_layer(cache, 1, kn, vn, starts, new_len,
                              kernels="cuda")
    kvc.update_cache_at_layer_torch(ref, 1, kn, vn, starts, new_len)
    torch.cuda.synchronize()
    timed = (time_ms(torch, lambda: kvc.update_cache_at_layer(
        cache, 1, kn, vn, starts, new_len, kernels="cuda")),
        time_ms(torch, lambda: kvc.update_cache_at_layer_torch(
            ref, 1, kn, vn, starts, new_len), iters=3, warmup=1))
    for side in ("k", "v"):
        hold_int8_write(
            torch, "kv_write_quant",
            (getattr(cache, side)[1], getattr(cache, f"{side}_scale")[1]),
            (getattr(ref, side)[1], getattr(ref, f"{side}_scale")[1]),
            results, f"{tag}4x512 rows ({sum(new_len_l)} live) K{K} at "
            f"{starts_l} snapped, NaN past the tails {side}", timed,
            write_work(sum(new_len_l), K, D, quant=True),
            floor_ms(torch, (kn, vn), slot_rows(starts_l, new_len_l, T,
                                                S)[1], torch.int8,
                     cold=False))
    # D2's INT8 mode attending the chunk under the window
    kv_len_l = [s + n for s, n in zip(starts_l, new_len_l)]
    kv_len = ints(kv_len_l)
    clean = clone(cache)
    poison_scales(cache, [s - W + 1 for s in starts_l], kv_len_l)
    q = poisoned(torch, randn(4, T, H, D))
    run = lambda: attention.attention(  # noqa: E731
        q, cache.k, cache.v, starts, kv_len, layer=1, window=W,
        kernels="cuda", **planes(cache))
    plain = lambda: attention.attention_torch(  # noqa: E731
        q, clean.k, clean.v, starts, kv_len, layer=1, window=W,
        **planes(clean))
    check_close(torch, "attention_prefill_int8", run(), plain(), results,
                f"{tag}B4 T512 H{H} K{K} qs {starts_l} kv_len to "
                f"{max(kv_len_l)} window {W}, scales NaN past kv_len and "
                "left of the window",
                (time_ms(torch, run, iters=5),
                 time_ms(torch, plain, iters=3, warmup=1)),
                work=attn_work(starts_l, kv_len_l, T, H, K, D, kv_elem=1,
                               window=W))
    del cache, clean, ref, kn, vn, q
    torch.cuda.empty_cache()
    # D's fused int8 decode: Mistral under its window; Qwen2's G 7
    qwen = get_config("qwen2-7b")
    for name, Hh, Kk, win, hist, SS in (
            (model, H, K, W, [3600, 4095, 5200, 6150], S),
            ("qwen2-7b", qwen.num_heads, qwen.num_kv_heads, None,
             [p + 16 + f + 16 for p, f in zip(QUANT_PROMPTS, QUANT_FOLLOW)],
             2048)):
        Bd = len(hist)
        c = int8_cache(2, Bd, Kk, SS, D)
        ref = clone(c)
        poison_scales(c, [n - win + 1 if win else 0 for n in hist],
                      [n + 1 for n in hist])
        qs = ints(hist)
        kl = qs + 1
        q1 = poisoned(torch, randn(Bd, 1, Hh, D))
        k1, v1 = (poisoned(torch, randn(Bd, 1, Kk, D)),
                  poisoned(torch, randn(Bd, 1, Kk, D)))
        run = lambda: attention.attention_decode_fused(  # noqa: E731
            q1, k1, v1, c.k, c.v, qs, kl, 1, window=win, kernels="cuda",
            snapped=True, **planes(c))[0]
        plain = lambda: attention.attention_decode_fused_torch(  # noqa: E731
            q1, k1, v1, ref.k, ref.v, qs, kl, 1, window=win, snapped=True,
            **planes(ref))[0]
        got, want = run(), plain()
        torch.cuda.synchronize()
        b_idx, rows = torch.arange(Bd, device=dev), qs.long()
        for x, y in ((c.k, ref.k), (c.v, ref.v), (c.k_scale, ref.k_scale),
                     (c.v_scale, ref.v_scale)):
            if not torch.equal(x[1, b_idx, rows], y[1, b_idx, rows]):
                raise AssertionError(f"attention_decode_int8 {name}: the "
                                     "in-kernel write differs from the "
                                     "plain write")
        say_plan(attention, f"int8 {name} B{Bd} H{Hh} K{Kk} D{D}", Bd, Hh,
                 Kk, D, int8=True)
        check_close(torch, "attention_decode_int8", got, want, results,
                    f"{name} B{Bd} H{Hh} K{Kk} contexts {min(hist)}-"
                    f"{max(hist)} window {win} snapped (write bit for bit), "
                    "scales NaN past kv_len"
                    + (" and left of the window" if win else ""),
                    (time_ms(torch, run), time_ms(torch, plain, iters=3,
                                                  warmup=1)),
                    work=attn_work(hist, [n + 1 for n in hist], 1, Hh, Kk, D,
                                   kv_elem=1, new_rows=Bd * 2 * Kk * (
                                       D * 2 + D + 4), window=win),
                    row_rel=DECODE_ROW_TOL)
        del c, ref
        torch.cuda.empty_cache()


def weight_bound_line(tag: str) -> None:
    """A replayed decode step of ``tag`` (DECODE) beside the least time
    the weights it reads take at the HBM rate."""
    d = DECODE[tag]
    weight_bytes = d["weight_bytes"]
    bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    busy = sum(d["graph_busy_ms"]) / len(d["graph_busy_ms"])
    say(f"  {tag}: replayed step wall {d['graph_ms']:.3f} ms, busy "
        f"{busy:.3f} ms ({d['B'] * 1e3 / d['graph_ms']:.1f} tok/s) against "
        f"the weight bytes' bound {bound:.3f} ms "
        f"({weight_bytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} "
        f"TB/s): {bound / busy:.2f} of it")


def phase_llama2_13b(torch, dev, results) -> None:
    """4v (a): Llama-2-13B at full width and depth: its kernels at its
    shapes (``family_kernel_rows``: E at m 8 on the five projections and
    its prefill mode at m 512, G, A at [2048, 5120] and B at
    [2048, 27648] and both at decode shape in replays, J at K 40 G 1, C,
    D2 and D over 40 heads, NaN past every tail; the library's E plans
    equal their mirror); bf16 B = 4 and INT4 B = 8 through
    ``phase_main_path`` (4b's tie rule), each replayed step beside its
    weight bytes' bound; then paged == slot at INT4 B = 8, chunks of 64."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
    model = "llama2-13b"
    cfg = get_config(model)
    spec = LARGE[model]
    family_kernel_rows(torch, dev, results, model, set())
    for kind in ("bf16", "int4"):
        eng, lens, follow, n = spec[kind]
        phase_main_path(torch, dev, results, f"{model} {kind}",
                        EngineConfig(**eng), lens, follow, n, model=model,
                        control=spec["control"], plain_generate=False)
        torch.cuda.empty_cache()
        weight_bound_line(f"{model} {kind}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
               for n in QUANT_PROMPTS]
    phase_paged_vs_slot(torch, dev, model, dict(quant_mode="int4"), prompts,
                        32, tag=f"{model} paged int4")
    torch.cuda.empty_cache()


def phase_family_server(torch, dev, results) -> None:
    """4v (b): the serving path over SERVED_MODEL (INT4 weights): its
    paged == slot check (4d's) makes the weights, then 4e's server (193
    pages of 64, waves 1 and 2, the automatic prefix cache, every
    request's ids equal to an eager rerun, admissions that wait for
    pages), 4f's preemption on its engine, and 4i's wave 1 over an int8
    pool of the same bytes (D's fused int8 paged decode and I's ``PAGED``
    instance at G 4 under a scheduler), each wave beside 4e's and 4i's
    llama2-7b figures of this run."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import get_config
    model = SERVED_MODEL
    cfg = get_config(model)
    int4 = dict(quant_mode="int4")
    int4_kv8 = dict(quant_mode="int4", kv_cache_dtype_name="int8")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
               for n in QUANT_PROMPTS]
    params = phase_paged_vs_slot(torch, dev, model, int4, prompts, 32,
                                 tag=f"{model} paged int4")
    engine = phase_server(torch, dev, results, model, int4, params)
    phase_preemption(torch, dev, model, engine)
    del engine
    torch.cuda.empty_cache()
    engine = phase_server(torch, dev, results, model, int4_kv8, params,
                          int8_pool_pages(cfg), 24, 0, False)
    del engine, params
    torch.cuda.empty_cache()
    for kv in ("int4", "int4-kv8"):
        ours = SERVED.get(f"{model} {kv}", {})
        theirs = SERVED.get(f"llama2-7b {kv}", {})
        for wave, (tps, p50, p99) in ours.items():
            seven = theirs.get(wave)
            say(f"  4v (b) {model} {kv} {wave}: {tps:.1f} tok/s, TTFT p50 / "
                f"p99 {p50:.3f} / {p99:.3f} s"
                + (f"; llama2-7b in this run {seven[0]:.1f} tok/s, "
                   f"{seven[1]:.3f} / {seven[2]:.3f} s" if seven else ""))


def phase_int8_window(torch, dev, results) -> None:
    """4v (c): Mistral-7B with INT8 weights over an int8 slot cache
    (WINDOW_INT8: B 4, prompts of 700-6100 in 8192, past its window of
    4096): its kernels at its shapes (``int8_window_rows``), then the path
    through ``phase_main_path`` (4j's checks but the planted faults,
    which off MUST_SEE_FAULTS are only printed; 4b's tie rule)."""
    from llm_inference_engine_tpu_torch.config import EngineConfig
    int8_window_rows(torch, dev, results)
    path, eng, lens, follow, n = WINDOW_INT8
    phase_main_path(torch, dev, results, path, EngineConfig(**eng), lens,
                    follow, n, model="mistral-7b", plain_generate=False)
    torch.cuda.empty_cache()


def phase_last_paths(torch, dev, results) -> None:
    """4v: (a) ``phase_llama2_13b``, (b) ``phase_family_server``, (c)
    ``phase_int8_window``, each timed; before them the INT4 prefill's
    bf16-out product held bit for bit its f32 product cast
    (``bf16_out_mm_rows``)."""
    t0 = time.perf_counter()
    bf16_out_mm_rows(torch, dev)
    say(f"  4v bf16-out mm: {time.perf_counter() - t0:.1f} s")
    for sub, what, fn in (("a", "llama2-13b", phase_llama2_13b),
                          ("b", f"the server over {SERVED_MODEL}",
                           phase_family_server),
                          ("c", "mistral-7b INT8 + int8 KV",
                           phase_int8_window)):
        t0 = time.perf_counter()
        say(f"  -- 4v ({sub}) {what}")
        fn(torch, dev, results)
        say(f"  4v ({sub}) {what}: {time.perf_counter() - t0:.1f} s")


# 4w: the model families under tensor parallelism, meshes of two ranks of
# cuda:0 (as 4n), through each family's INT4 path of FAMILIES: per family
# (sub-phase, the scheduler's prompt lengths). Qwen2-7B keeps its full
# depth (G 7, one kv head a rank, J's bias mode, a vocabulary shard of
# 76032) and is held against 4u's one-rank INT4 path (MAIN_RUNS);
# Llama-3.1-8B and Mistral-7B run their first DEPTH_CUT layers at full
# width (DEPTH_CUT_PATHS) beside a one-rank engine at the same cut built
# in the phase. Mistral's scheduler prompts pass its window of 4096
MISTRAL_SCHED_PROMPTS = (4200, 4300, 4400, 4500)
FAMILIES_TP = {"qwen2-7b": ("a", TP2_SCHED_PROMPTS),
               "llama3.1-8b": ("b", TP2_SCHED_PROMPTS),
               "mistral-7b": ("c", MISTRAL_SCHED_PROMPTS)}


def family_tp2_path(torch, dev, results, model: str) -> None:
    """4w (a)-(c): ``model``'s INT4 path (FAMILIES: its engine fields,
    prompts and greedy tokens; seed-0 weights, cut in depth where
    ``preset`` says so) on a mesh of two ranks of cuda:0, every launch
    counter set to 0 just before each engine and read just after: the
    prefill logits within TP_LOGIT_REL_L2 of the one-rank engine's (a
    partial product left out, beyond it) and first tokens under the tie
    rule (``first_token_rule``); ``generate``'s greedy ids (against the
    one-rank engine's under ``ids_or_ties`` where it is built here,
    else their agreement printed, as 4n's); ``mesh_steps``; the launches
    of one decode step (A, B and J per rank); a warm prefill's card
    busy; then a paged tp = 2 engine (pages of 64) through the scheduler,
    whose ids must equal the slot mesh engine's ``generate`` of the same
    prompts, each pure-decode step one fused paged decode a layer a rank
    and no H. Prints the replayed step, the warm prefill's busy and the
    peak memory (the one-rank engine freed first: the weights, their
    shards and the tp = 2 engines) beside the one-rank path's."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_quantized_params, param_bytes)
    from llm_inference_engine_tpu_torch.parallel import make_mesh, sharding
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    from llm_inference_engine_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)

    sub, sched_lens = FAMILIES_TP[model]
    tag = f"4w ({sub}) {model} tp=2"
    cfg = preset(model, f"{model} tp2 int4")
    cfg = get_config(cfg) if isinstance(cfg, str) else cfg
    eng_kw, prompt_lens, _, n_new = FAMILIES[model]["int4"]
    eng = EngineConfig(**eng_kw)
    B, L, V = eng.max_batch_size, cfg.num_layers, cfg.vocab_size
    greedy = SamplingParams(greedy=True, max_new_tokens=n_new)
    active = np.ones(B, bool)
    gib = 2 ** 30

    def last(r):
        return torch.tensor([o[-1] for o in r.token_ids], device=dev,
                            dtype=torch.int32)

    # the one-rank path's weights (create_engine's, seed 0); the peaks
    # count from them on, as phase_main_path's count from its engine on
    params = init_dummy_quantized_params(cfg, "int4", eng.quant_group_size,
                                         seed=0, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    weight_bytes = (param_bytes(params)
                    - param_bytes({"embed": params["embed"]}))
    cut = L != get_config(model).num_layers
    if not cut:
        one = MAIN_RUNS.pop(f"{model} int4")
        prompts, ref_logits, ref_ids = (one["prompts"], one["logits"],
                                        one["ids"])
        one_busy, one_peak = one["prefill_busy"], one["peak"] / gib
        beside = (f"{model} int4", f"4u {model} INT4")
    else:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(3, V, n).tolist() for n in prompt_lens]
        one_tag = f"{model} int4 ({L} layers)"
        base = InferenceEngine(cfg, eng, params, device=dev)
        ref_logits = base.prefill(prompts)
        base.reset()
        r = base.generate(prompts, greedy, eos_token_id=None)
        ref_ids = r.token_ids
        mesh_steps(torch, base, last(r), active, one_tag, beside=None)
        base.reset()
        one_busy = device_profile(torch, lambda: base.prefill(prompts),
                                  1).busy
        one_peak = torch.cuda.max_memory_allocated() / gib
        beside = (one_tag, f"{model} INT4, {L} layers")
        del base
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    say(f"  {tag}: {cfg.num_heads // 2} heads over {cfg.num_kv_heads // 2} "
        f"kv heads a rank, {L} of {get_config(model).num_layers} layers, "
        f"B={B}, max_seq_len {eng.max_seq_len}, prompts of "
        f"{min(prompt_lens)}-{max(prompt_lens)} tokens; weights "
        f"{param_bytes(params) / 1e9:.2f} GB")

    tp2 = make_mesh(1, 2, devices=[dev, dev])
    sp = sharding.shard_params(params, tp2)
    counters = _zero_counters()
    e = InferenceEngine(cfg, eng, sp)
    logits = e.prefill(prompts)
    first_token_rule(tag, logits, ref_logits, ref_ids,
                     dropped_rank_logits(e, prompts))
    t0 = time.perf_counter()
    r = e.generate(prompts, greedy, eos_token_id=None)
    gen_s = time.perf_counter() - t0
    if [o[0] for o in r.token_ids] != logits.argmax(-1).tolist():
        raise AssertionError(f"{tag}: generate's first token is not the "
                             "prefill argmax")
    agree = sum(a == b for x, y in zip(r.token_ids, ref_ids)
                for a, b in zip(x, y))
    say(f"  {tag} generate of {n_new} greedy tokens {gen_s:.3f} s; tokens "
        f"agreeing with the one-rank path position by position "
        f"{agree}/{n_new * B}; tokens[0][:8] {r.token_ids[0][:8]}")
    if cut:
        # the one-rank engine again only where a row's ids differ
        base = (None if r.token_ids == ref_ids else
                InferenceEngine(cfg, eng, params, device=dev))
        ids_or_ties(tag, r.token_ids, ref_ids, e, base, prompts,
                    ref="one-rank")
        del base
    mesh_steps(torch, e, last(r), active, tag, beside=beside)
    rng = np.random.default_rng(3)
    sched_prompts = [rng.integers(3, V, n).tolist() for n in sched_lens]
    e.reset()
    sched_ref = e.generate(sched_prompts, greedy, eos_token_id=None).token_ids
    _path_launches(tag, counters, MAIN_PATHS["int4"][0])
    _zero_counters()
    e.decode_step(last(r), active, SamplingParams(greedy=True))
    per_step = _launch_counts(counters)
    say(f"  {tag} launches per decode step (two ranks): {per_step}")
    check_norm_launches(f"{tag} decode step", per_step, L, 2)
    e.reset()
    prefill = device_profile(torch, lambda: e.prefill(prompts), 1)
    say(f"  {tag} warm prefill of {sum(prompt_lens)} tokens: card busy "
        f"{prefill.busy:.3f} ms (one-rank {one_busy:.3f}); by group: "
        f"{_groups(prefill.per_kernel)}")
    del e
    torch.cuda.empty_cache()

    # the paged tp = 2 engine through the scheduler
    counters = _zero_counters()
    pe = InferenceEngine(cfg, eng.replace(kv_layout="paged", page_size=64,
                                          max_prefill_len=64), sp)
    sched = ContinuousBatchingScheduler(pe, eos_token_id=None)
    decode_steps = decode_phase_launches(sched, counters)
    reqs = [sched.submit(p, greedy) for p in sched_prompts]
    t0 = time.perf_counter()
    sched.run()
    wall = time.perf_counter() - t0
    ids = [q.output_ids for q in reqs]
    _check_paged_launches(f"{tag} paged scheduler", counters,
                          NORM_ACT + ("int4_matmul",) + BF16_PAGED)
    check_decode_step_launches(f"{tag} paged scheduler", decode_steps, L,
                               ranks=2)
    say(f"  {tag} paged scheduler: {len(reqs)} requests of "
        f"{list(sched_lens)} tokens in chunks of 64, {n_new} greedy "
        f"tokens each in {wall:.3f} s; ids equal the slot tp=2 engine's "
        f"generate: {ids == sched_ref}; free pages after {pe.free_pages}")
    del pe, sched, sp, params
    torch.cuda.empty_cache()
    d = DECODE[tag]
    o = DECODE[beside[0]]
    say(f"  {tag} beside {beside[1]}: replayed step wall / busy "
        f"{d['graph_ms']:.3f} / {d['graph_busy_ms'][0]:.3f} ms "
        f"({B * 1e3 / d['graph_ms']:.1f} tok/s), one rank "
        f"{o['graph_ms']:.3f} / {min(o['graph_busy_ms']):.3f} ms "
        f"({B * 1e3 / o['graph_ms']:.1f} tok/s); weight bytes' bound "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
        f"({weight_bytes / 1e9:.2f} GB, the same on both); warm prefill "
        f"busy {prefill.busy:.3f} / {one_busy:.3f} ms; peak "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB (one rank "
        f"{one_peak:.2f})")
    if ids != sched_ref:
        raise AssertionError(f"{tag}: the paged tp=2 scheduler's ids differ "
                             "from the slot tp=2 engine's generate")


def phase_qwen2_tp2(torch, dev, results) -> None:
    """4w (a): qwen2-7b INT4, B = 8, full width and depth, at tp = 2."""
    family_tp2_path(torch, dev, results, "qwen2-7b")


def phase_llama31_tp2(torch, dev, results) -> None:
    """4w (b): llama3.1-8b INT4, B = 8, full width, DEPTH_CUT layers, at
    tp = 2 (a rank's lm_head of 64128 columns, sampling over the gathered
    128256)."""
    family_tp2_path(torch, dev, results, "llama3.1-8b")


def phase_mistral_tp2(torch, dev, results) -> None:
    """4w (c): mistral-7b INT4, B = 4, max_seq_len 8192, full width,
    DEPTH_CUT layers, at tp = 2 over MISTRAL_PROMPTS (4 kv heads a rank
    under the window of 4096)."""
    family_tp2_path(torch, dev, results, "mistral-7b")


def families_tp2_kernel_rows(torch, dev, results) -> None:
    """4w (d): ``family_kernel_rows`` at each family's rank shapes under
    tp = 2 (E at the INT4 path's m and its prefill mode's, its plan equal
    to the library's with the cluster's K ranges printed; G; A and B at
    the rank's [2048, 2 I] and [B, 2 I]; J (Qwen2's bias mode at K 2, G
    7); C and D2 at the INT4 path's first chunk; D's fused decode; H and
    D's fused paged decode through a table), NaN past every tail."""
    seen: set = set()
    for model in FAMILIES_TP:
        family_kernel_rows(torch, dev, results, model, seen, tp=2)


def phase_families_tp(torch, dev, results) -> None:
    """4w: the model families under tensor parallelism on one card, each
    sub-phase timed: (a) ``phase_qwen2_tp2``, (b) ``phase_llama31_tp2``,
    (c) ``phase_mistral_tp2``, (d) ``families_tp2_kernel_rows``."""
    for sub, fn in zip("abcd", (phase_qwen2_tp2, phase_llama31_tp2,
                                phase_mistral_tp2,
                                families_tp2_kernel_rows)):
        t0 = time.perf_counter()
        say(f"  -- 4w ({sub}) {fn.__name__}")
        fn(torch, dev, results)
        gc.collect()      # an engine's captured programs hold it in cycles
        torch.cuda.empty_cache()
        say(f"  4w ({sub}) {fn.__name__}: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import numpy as np
    import torch

    start = time.perf_counter()
    # 1. card check
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on "
                         "the card")
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton"))
    from llm_inference_engine_tpu_torch.ops import _native
    import triton

    dev = torch.device("cuda", 0)
    # the f32 reference runs in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_native.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say("== 1. card")
    say(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, triton "
        f"{triton.__version__}, nvcc: {nvcc[-1]}")

    # 2. build
    say("== 2. build")
    path, seconds = _native.build()
    _native.library()
    say(f"  {path.relative_to(ROOT)} built in {seconds:.2f} s")

    def phase(tag: str, title: str, fn, *args):
        say(f"== {tag}. {title}")
        t0 = time.perf_counter()
        out = fn(*args)
        say(f"  phase time {time.perf_counter() - t0:.1f} s")
        return out

    # 3. kernels vs plain
    results: dict = {}
    phase("3", "kernels vs plain versions (7B shapes, bf16)", phase_kernels,
          torch, dev, results)
    phase("3b", "quantized matmul kernels vs plain versions (7B shapes)",
          phase_quant_kernels, torch, dev, results)
    phase("3c", "paged kernels vs plain versions (7B widths, pages of 64 "
          "and 16)", phase_paged_kernels, torch, dev, results)
    phase("3d", "int8 KV kernels vs plain versions (7B widths, both scale "
          "numerics, pages of 64 and 16)", phase_kv_int8_kernels, torch, dev,
          results)
    phase("3e", "kernels A, B and J at decode shape (B = 8), timed in "
          "CUDA-graph replays", lambda: (decode_shape_rows(torch, dev),
                                         rope_replayed_rows(torch, dev, "7b",
                                                            32, 1, 128)))
    phase("3f", "the float instances (float32, float16) vs plain versions "
          "(7B widths; head_dim 16 and 64 small)", phase_float_kernels,
          torch, dev, results)

    # 4. main paths
    from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
    # 8 ragged prompts: the first chunk (8 x 512 rows) prefills through
    # kernel G, the second (8 x 64 rows, the 560-token prompt's tail)
    # through kernel E
    int4_slot = EngineConfig(quant_mode="int4", max_batch_size=8,
                             max_seq_len=2048)
    main_paths = [
        ("4a", "main path: llama2-7b bf16, B=4", "bf16",
         EngineConfig(max_batch_size=4, max_seq_len=2048),
         (7, 129, 384, 700), (5, 17, 33, 64), 32),
        ("4b", "main path: llama2-7b INT4, B=8", "int4", int4_slot,
         QUANT_PROMPTS, QUANT_FOLLOW, 16),
        ("4c", "main path: llama2-7b INT8, B=8", "int8",
         EngineConfig(quant_mode="int8", max_batch_size=8, max_seq_len=2048),
         QUANT_PROMPTS, QUANT_FOLLOW, 16),
        ("4g", "main path: llama2-7b INT4 + int8 KV cache (slot), B=8",
         "int4-kv8", int4_slot.replace(kv_cache_dtype_name="int8"),
         QUANT_PROMPTS, QUANT_FOLLOW, 16),
        # the INT4 dummies' logits barely move with K/V (4g's planted
        # faults show it); the INT8 dummies' do, so this path holds the
        # int8 attention end to end
        ("4j", "main path: llama2-7b INT8 + int8 KV cache (slot), B=8",
         "int8-kv8", EngineConfig(quant_mode="int8", max_batch_size=8,
                                  max_seq_len=2048,
                                  kv_cache_dtype_name="int8"),
         QUANT_PROMPTS, QUANT_FOLLOW, 16)]
    logits = {}
    for tag, title, path, eng_cfg, lens, follow, greedy_tokens in main_paths:
        logits[path] = phase(
            tag, title + ": generate x2 + steady decode + reference",
            phase_main_path, torch, dev, results, path, eng_cfg, lens,
            follow, greedy_tokens)
    for tags, kv8, kv16 in (("4g vs 4b", "int4-kv8", "int4"),
                            ("4j vs 4c", "int8-kv8", "int8")):
        d, r = _logit_diff(logits[kv8], logits[kv16])
        say(f"  {tags} (int8 vs bf16 KV, same weights, both kernel paths): "
            f"prefill logits max abs {d:.4e}, rel L2 {r:.4e} (quantization "
            "noise, not a check)")
    phase("4n", "tensor and data parallelism: llama2-7b INT4 (4b's weights), "
          "B=8, two ranks on cuda:0: tp=2, dp=2, tp=2 with the int8 slot "
          "cache, tp=2 paged through the scheduler; the kernels at the "
          "tp=2 local shapes", phase_parallel, torch, dev, results)
    params = phase("4o", f"context parallelism: llama2-7b INT4 (4b's "
                   f"weights, the first {DEPTH_CUT} layers), B=4, "
                   "max_seq_len 8192, prompts of 1000-6500 "
                   "tokens, seq ranks on cuda:0: cp=2 over a bf16 log, its "
                   "replays, the int8 log, cp=2 x tp=2; C and I at the CP "
                   "write shapes", phase_context_parallel, torch, dev,
                   results)
    phase("4p", "pipeline: llama2-7b INT4, pp=2 and pp=2 x tp=2 on cuda:0, "
          "bit for bit against the forward without the pipe axis",
          phase_pipeline, torch, dev, params)
    phase("4q", "prefix snapshots, speculation and beams on a mesh: "
          "llama2-7b INT4 (4b's weights) at tp=2 on cuda:0, the slot "
          "PrefixStore, a tinyllama-1.1b INT4 draft on the same mesh, "
          "beam_search; the kernels at the local shapes these give them",
          phase_mesh_decoding, torch, dev, results, params)
    del params

    # the paged serving path, INT4 weights (the JAX package's benchmark
    # format, bench.py)
    int4 = dict(quant_mode="int4")
    int4_kv8 = dict(quant_mode="int4", kv_cache_dtype_name="int8")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, n).tolist() for n in QUANT_PROMPTS]
    params = phase("4d", "paged == slot: llama2-7b INT4, B=8, chunks of 64",
                   phase_paged_vs_slot, torch, dev, "llama2-7b", int4,
                   prompts, 32)
    engine = phase("4e", "serving path: HTTP server + scheduler + paged "
                   "llama2-7b INT4", phase_server, torch, dev, results,
                   "llama2-7b", int4, params)
    phase("4f", "recompute preemption on the server's engine",
          phase_preemption, torch, dev, "llama2-7b", engine)
    del engine, params
    params = phase("4h", "paged == slot with the int8 KV cache: llama2-7b "
                   "INT4, B=8, chunks of 64", phase_paged_vs_slot, torch,
                   dev, "llama2-7b", int4_kv8, prompts, 32)
    # 4i: an int8 pool of 4e's pool bytes (a page's values at 1 byte and
    # its scales at 4 bytes per (token, head), against 2 bytes a value)
    int8_pages = int8_pool_pages(get_config("llama2-7b"))
    engine = phase("4i", f"serving path over an int8 pool of 4e's bytes "
                   f"({int8_pages} pages of 64): wave 1", phase_server, torch,
                   dev, results, "llama2-7b", int4_kv8, params, int8_pages,
                   24, 0, False)
    del engine, params
    phase("4k", f"a checkpoint on disk: llama2-7b ({CKPT_LAYERS} layers, full "
          "width) written as an HF directory, loaded INT4, the quantizer and "
          "the chat CLI, the slot PrefixStore at B=8, a 3-round "
          "ChatSession", phase_checkpoint, torch, dev)
    phase("4l", "speculative decoding and beam search: llama2-7b INT4 "
          "target, tinyllama-1.1b INT4 draft, B=8, k=4; the server over "
          "SpeculativeScheduler; beam_search", phase_speculative, torch, dev,
          results)
    phase("4m", "evals, calibration and the debugging utilities: llama2-7b "
          "(32 layers), the windowed Scorer, the taps, calibrate_act_sq and "
          "--calibrate, nan_guard", phase_evals, torch, dev, results)
    phase("4r", "the quantization quality proxy: tools.quant_divergence at "
          "llama2-7b width (4 layers), fp/int8/int4/int4cal built on the card "
          "against the CPU, kernel route vs kernels='torch', B=4 T=512",
          phase_quant_divergence, torch, dev)
    phase("4s", "the example drivers (examples_torch), each on the card",
          phase_examples, torch, dev)
    phase("4t", "float32 and float16 models end to end: the debug preset "
          "(6 engines each) against the CPU, llama2-7b float16 (B=4; over an "
          f"int8 cache, slot B=4 and paged; INT4 B=8) and float32 (B=2), "
          f"each its first {DEPTH_CUT} layers",
          phase_float_models, torch, dev, results)
    phase("4u", "the model families at full width and depth: llama3.1-8b "
          "(GQA G=4, Llama-3 RoPE scaling), mistral-7b (sliding window "
          "4096, prompts to 6100 in 8192) and qwen2-7b (qkv bias, G=7), "
          "each bf16 B=4 with its feature-off control and INT4; Mistral's "
          "paged == slot; their kernels at their shapes",
          phase_model_families, torch, dev, results)
    phase("4v", "the last paths: llama2-13b at full width and depth (bf16 "
          "B=4, INT4 B=8, paged == slot), the HTTP server over llama3.1-8b "
          "(bf16 and int8 pools, preemption), mistral-7b INT8 weights over "
          "an int8 KV cache under its window; their kernels at their "
          "shapes", phase_last_paths, torch, dev, results)
    phase("4w", "the model families under tensor parallelism, two ranks on "
          "cuda:0: qwen2-7b INT4 B=8 (full depth), llama3.1-8b INT4 B=8 and "
          f"mistral-7b INT4 B=4 in 8192 (the first {DEPTH_CUT} layers), each "
          "against its one-rank path, paged through the scheduler; the "
          "kernels at their rank shapes", phase_families_tp, torch, dev,
          results)
    say("  decode per step, eager bodies against graph replays (wall and "
        "card busy ms): " + json.dumps(DECODE))

    # 5. results
    kernels = []
    for name in REPLACES:
        if PATH_OF[name] is None:         # on no main path
            continue
        r = results[name]
        bound, bound_by = bound_ms(r["work"])
        kernels.append(dict(
            name=name, route=SOURCES[name][0], source=SOURCES[name][1],
            replaces=REPLACES[name], launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=bound, bound_by=bound_by,
            library_ms=r["library_ms"]))
    say(json.dumps({"kernels": kernels}))
    say(f"== total {time.perf_counter() - start:.1f} s")
    say(smi)
    say(json.dumps({"ok": True,
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

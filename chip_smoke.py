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
   (CUDA events, after warm-up): A-C, kernel D2 (the prefill modes:
   B4 T512, GQA with and without a window, G = 8 against kv_len 2048)
   and kernel D's fused decode (split-KV over a cluster; B4, then the
   engine's B8, kv_len of one tile and one tile + 1, G = 7 with a
   window), then E and F (fused dequant-matmul, INT4 and INT8: the
   decode mode at m = 8 on every projection and the lm_head and at m =
   16 on wo and down, each with its plan; the prefill mode at m = 512 on
   the four projections beside G + cuBLAS; library calls
   ``_weight_int4pack_mm`` and ``_weight_int8pack_mm``) and G (INT4
   dequantize, bit-identical), then (3c) H (the paged write) and
   D2's paged mode (a B=16, T=64 mixed step, then 8 x 512) and D's
   attend-only paged decode over a pool of page 64 with a random page
   permutation, the mixed step and the decode case again at page 16, and
   a G = 7 paged decode, then both bf16 decode modes at G = 4, 7 and 8
   at the engine's B8, timed; every decode row prints kernel D's split
   plan (blocks a cluster, tile, stages, shared memory, blocks an SM
   holds), and D2's tiling of every head dim is printed; the decode rows
   are held per row (DECODE_ROW_TOL); every K/V row write (C, H, H's
   int8 mode, I) prints its floor (floor_ms: one ``copy_`` of the same
   live rows under the same warm or cold method), and H and its int8
   mode are also timed at decode shape (B = 8 and 16, one token each at
   odd in-page offsets, DECODE_WRITE_STARTS), I at 8 x 64 as well as
   8 x 512; (3e) A, A with residual and B at decode shape (B = 8) held
   against and timed beside their plain versions and ``F.rms_norm``, 64
   calls captured in one CUDA graph: CUDA events around its replays, and
   the union of the kernels' intervals under the profiler;
4. the main paths, each through ``create_engine`` with dummy weights (seed
   0) at full width and depth, with every launch counter set to 0 just
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
      ``graph_checks``, decode through E (lm_head included);
   c. llama2-7b INT8, B=8: the same through F;
   d. paged == slot: llama2-7b INT4, B=8, the prompts of 4b, chunks of
      64: a paged engine (page 64) and a slot engine give bit-identical
      prefill logits and the same 32 greedy tokens; the paged engine
      launches H and D's paged modes and never kernel C or the fused
      decode; ``graph_checks`` on the paged engine, and a warm paged
      prefill profiled (card busy by kernel group);
   e. the serving path: the port's HTTP server in-process on
      127.0.0.1:0 over the continuous-batching scheduler and a paged
      INT4 engine (B=16, 193 pages of 64 = 12288 tokens, automatic prefix
      cache): 24 concurrent greedy completions (wave 1, admission gated
      by pages), then 8 multi-turn resends (wave 2, prefix reuse); the
      scheduler's pure-decode steps (replays) and mixed steps (eager)
      counted and timed;
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
   h. paged == slot with the int8 cache: as 4d, bit-identical logits and
      ids, through H's and D's int8 paged modes only;
   i. the server over a paged INT4 engine with an int8 pool of 4e's pool
      bytes (~2x the pages): 4e's wave 1;
   k. a checkpoint on disk (after 4i, every earlier engine freed): the
      seed-0 bf16 dummy weights of llama2-7b written as an HF directory
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
      projections and its f32 lm_head; D2 at T = 5 in chunk mode; at
      tinyllama-1.1b's widths, B = 8: E's decode mode, D's fused decode
      at G = 8 and head_dim 64, A and B), each against its plain
      version with its time, bound and library call; then llama2-7b
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
   (3d, before 4: kernel I, H's int8 mode, D2's and D's int8 modes
   against their plain versions at 7B widths, in both scale numerics, the
   decode modes held per row; then at head_dim 80, 96
   and 256, at small shapes, D's four decode modes, D2's four prefill
   modes and I's two writes; 4j runs after 4g, before 4d); every
   profiled step and prefill prints its device time by kernel group
   (KERNEL_GROUPS, the writes and kernels A and B among them; a decode
   step's torch glue split into RoPE, casts, sampling and other by the
   ops that launch it, GLUE); card busy is the union of the card's
   activity intervals (kernels A, B and E's decode mode are programmatic
   dependents and overlap their neighbours); every forward's launches of
   A and B are counted (``check_norm_launches``);
5. one JSON line of kernel results (each with its time, its plain
   version's, its bound from this run's inputs and, where one PyTorch call
   computes the same function, that call's time), the nvidia-smi line,
   and as the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    "kv_write_quant": "llm_inference_engine_tpu/ops/kv_cache.py:289",
    "attention_prefill_int8": "llm_inference_engine_tpu/ops/attention.py:135",
    "attention_decode_int8": "llm_inference_engine_tpu/ops/attention.py:569",
    "paged_kv_write_int8": "llm_inference_engine_tpu/ops/paged_kv.py:169",
    "attention_prefill_paged_int8":
        "llm_inference_engine_tpu/ops/attention.py:135",
    "attention_decode_paged_int8":
        "llm_inference_engine_tpu/ops/attention.py:356",
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
    "paged_kv_write": ("cuda", "llm_inference_engine_tpu_torch/csrc/paged_kv_write.cu"),
    "attention_prefill_paged": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_prefill.cu"),
    "attention_decode_paged": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_decode.cu"),
    "kv_write_quant": ("cuda", "llm_inference_engine_tpu_torch/csrc/kv_write_quant.cu"),
    "attention_prefill_int8": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_prefill.cu"),
    "attention_decode_int8": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_decode.cu"),
    "paged_kv_write_int8": ("cuda", "llm_inference_engine_tpu_torch/csrc/kv_write_quant.cu"),
    "attention_prefill_paged_int8": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_prefill.cu"),
    "attention_decode_paged_int8": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention_decode.cu"),
}
# the main path whose launch count each kernel reports
PATH_OF = {name: "bf16" for name in REPLACES}
PATH_OF.update(int4_matmul="int4", dequant_int4="int4", int8_matmul="int8",
               paged_kv_write="server", attention_prefill_paged="server",
               attention_decode_paged="server", kv_write_quant="int4-kv8",
               attention_prefill_int8="int4-kv8",
               attention_decode_int8="int4-kv8",
               paged_kv_write_int8="server-kv8",
               attention_prefill_paged_int8="server-kv8",
               attention_decode_paged_int8="server-kv8")
NORM_ACT = ("rmsnorm", "add_residual_rmsnorm", "silu_and_mul")
BF16_SLOT = ("kv_write", "attention_prefill", "attention_decode")
INT8_SLOT = ("kv_write_quant", "attention_prefill_int8",
             "attention_decode_int8")
BF16_PAGED = ("paged_kv_write", "attention_prefill_paged",
              "attention_decode_paged")
INT8_PAGED = ("paged_kv_write_int8", "attention_prefill_paged_int8",
              "attention_decode_paged_int8")
# each slot main path: (kernels that must launch, kernels that must not)
MAIN_PATHS = {
    "bf16": (NORM_ACT + BF16_SLOT, INT8_SLOT + BF16_PAGED + INT8_PAGED),
    "int4": (NORM_ACT + BF16_SLOT + ("int4_matmul", "dequant_int4"),
             INT8_SLOT + BF16_PAGED + INT8_PAGED),
    "int8": (NORM_ACT + BF16_SLOT + ("int8_matmul",),
             INT8_SLOT + BF16_PAGED + INT8_PAGED),
    "int4-kv8": (NORM_ACT + INT8_SLOT + ("int4_matmul", "dequant_int4"),
                 BF16_SLOT + BF16_PAGED + INT8_PAGED),
    "int8-kv8": (NORM_ACT + INT8_SLOT + ("int8_matmul",),
                 BF16_SLOT + BF16_PAGED + INT8_PAGED),
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
# per main path: decode wall and card busy per step, eager bodies against
# graph replays (graph_checks), printed as one line at the end of phase 4
DECODE: dict = {}


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
    moved, each input read once and each output written once; operations)
    at the H100's HBM rate and bf16 tensor-core rate."""
    t_bytes = work[0] / HBM_BYTES_PER_S * 1e3
    t_ops = work[1] / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def record(name, err, results, case, timed=None, work=None, library=None,
           floor=None):
    """Record a kernel's check; the first timed case is the main path's
    shape, and its time, work and library time go into the JSON line. A
    write row's ``floor`` (floor_ms) is printed beside its time."""
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
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


def attn_work(q_start, kv_len, T, H, K, D, kv_elem=2, new_rows=0):
    """(bytes, operations) of kernel D over this run's rows: every query
    row t < T of sequence b sees min(kv_len[b], q_start[b] + t + 1) keys
    (no window in the timed cases); q and out are read and written once,
    each sequence's kv_len keys once (k and v, int8 with a 4-byte scale per
    head, or bf16), plus ``new_rows`` bytes of a fused write. Operations:
    QK^T and PV, 2 per multiply-add each."""
    qs, kl = [int(x) for x in q_start], [int(x) for x in kv_len]
    pairs = sum(min(l, s + t + 1) for s, l in zip(qs, kl) for t in range(T))
    per_key = K * (D * kv_elem + (4 if kv_elem == 1 else 0)) * 2
    return (2 * len(qs) * T * H * D * 2 + sum(kl) * per_key + new_rows,
            4 * D * H * pairs)


def write_work(rows, K, D, quant=False):
    """(bytes, operations) of a K/V row write: bf16 rows read (k and v),
    bf16 rows or int8 rows with a 4-byte scale per head written."""
    out = K * (D + 4) if quant else K * D * 2
    return rows * 2 * (K * D * 2 + out), (rows * 2 * K * D * 4 if quant
                                          else 0)


def sdpa_ms(torch, q, k_layer, v_layer, q_start, kv_len):
    """Time of torch's scaled_dot_product_attention over the slot layer's
    view (q [B, T, H, D]; k/v [B, S, K, D]) with an explicit causal and
    length mask and enable_gqa: the library yardstick of kernel D's bf16
    slot modes (the port never calls it)."""
    import torch.nn.functional as F
    B, T = q.shape[:2]
    S = k_layer.shape[1]
    pos = q_start.long()[:, None] + torch.arange(T, device=q.device)[None]
    j = torch.arange(S, device=q.device)
    mask = ((j[None, None, :] < kv_len.long()[:, None, None])
            & (j[None, None, :] <= pos[:, :, None]))[:, None]
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

    def replayed_ms(fn):
        """(events, union) ms a call"""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(64):
                fn()
        graph.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize()
        start.record()
        for _ in range(4):
            graph.replay()
        end.record()
        end.synchronize()
        return (start.elapsed_time(end) / 4 / 64,
                device_profile(torch, graph.replay, 4).busy / 64)

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
        (k_ev, k_union), (p_ev, _) = replayed_ms(kern), replayed_ms(plain)
        row = rows[name] = dict(
            kernel=k_ev, kernel_union=k_union, plain=p_ev,
            library=replayed_ms(library)[0] if library else None,
            bound=bound_ms((nbytes, 0))[0])
        say(f"  {name:22s} decode shape [8, {hidden}], graph replays, held "
            f"against plain: "
            f"kernel {k_ev * 1e3:.3f} us a call (events; union of kernel "
            f"intervals {k_union * 1e3:.3f} us), plain {p_ev * 1e3:.3f} us"
            + (f", F.rms_norm {row['library'] * 1e3:.3f} us"
               if library else "")
            + f"; bound {row['bound'] * 1e3:.4f} us (bytes)")
    return rows


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
# lm_head at the engine's m = 8, the server's B = 16 step (wo and down,
# the n = 4096 projections), and the 8 x 64 prefill tail (m = 512)
QUANT_SHAPES = {"wqkv": (4096, 12288, 1), "wo": (4096, 4096, 1),
                "gate|up": (4096, 11008, 2), "down": (11008, 4096, 1),
                "lm_head": (4096, 32000, 1)}
QUANT_ROWS = ([(8, p) for p in QUANT_SHAPES] + [(16, "wo"), (16, "down")]
              + [(512, p) for p in ("wqkv", "wo", "gate|up", "down")])


def write_rows(torch, dev) -> dict:
    """Kernel ms of the K/V row writes, no checks: C at C_CHUNK, H and its
    int8 mode at 3c's mixed step (520 rows) and at decode shape (B = 8 and
    16), cold; I at I_CHUNKS, warm (snapped); each beside its floor, and
    the 520-row rows and their floors again under a clean flush
    (time_ms's ``clean``). ``tools/chip_kernel_ab.py --rows writes`` times
    another tree's kernels through this function, so it calls only the
    wrappers every tree has."""
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
    return out


def prefill_rows(torch, dev) -> dict:
    """Card busy ms of one warm prefill of 4b's prompts (llama2-7b INT4,
    B = 8) and the K/V writes' share of it, no checks: paged with a bf16
    pool (4d) and an int8 pool (4h), pages and chunks of 64, and slot with
    an int8 cache (4g). ``tools/chip_kernel_ab.py --rows prefill`` times
    another tree through this function, so it calls only what every tree
    has."""
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
        return quant.QuantizedTensor(q, s * (0.02 / (7 if int4 else 127)),
                                     mode, 128)
    first = one()
    return [first] + [one() for _ in range(
        max(1, -(-min_bytes // first.nbytes)) - 1)]


def fused_matmul(quant, t, x, out, kern):
    """Kernel E or F (or its plain version) through the wrapper every tree
    has."""
    if t.mode == "int4":
        return quant.int4_matmul(x, t.q, t.scale, 128, out, kernels=kern)
    return quant.int8_matmul(x, t.q, t.scale, out, kernels=kern)


def cycling(ts, fn):
    """A thunk that calls ``fn`` on the next of ``ts`` each time."""
    it = [0]

    def run():
        it[0] += 1
        return fn(ts[it[0] % len(ts)])
    return run


def quant_rows(torch, dev) -> dict:
    """Kernel ms of E and F at QUANT_ROWS (weights cycled as in 3b), no
    checks: ``tools/chip_kernel_ab.py`` times another tree's kernels
    through this function, so it calls only the wrappers every tree
    has."""
    from llm_inference_engine_tpu_torch.ops import quant
    gen = torch.Generator(device=dev).manual_seed(4321)
    out = {}
    for mode, name in (("int4", "int4_matmul"), ("int8", "int8_matmul")):
        for m, label in QUANT_ROWS:
            k, n, halves = QUANT_SHAPES[label]
            dt = torch.float32 if label == "lm_head" else torch.bfloat16
            ts = quant_weights(torch, quant, dev, gen, mode, k, n, halves,
                               120_000_000)
            x = torch.randn(m, k, generator=gen, device=dev,
                            dtype=torch.bfloat16)
            out[f"{name} m{m} {label}"] = time_ms(torch, cycling(
                ts, lambda t: fused_matmul(quant, t, x, dt, "cuda")))
            del ts
        torch.cuda.empty_cache()
    return out


def quant_case(torch, dev, gen, results, mode, m, label,
               shapes=QUANT_SHAPES, tag=""):
    """Kernel E (``mode`` int4) or F (int8) for x [m, k] times the
    ``label`` weight of ``shapes`` (k, n, halves; an f32 output for the
    lm_head), random weights cycled through 120 MB: held against its plain
    version and timed beside it, with its bound, its library call (one
    weight with a bf16 output: ``_weight_int4pack_mm`` /
    ``_weight_int8pack_mm``) and its plan. Returns (kernel ms, the
    weights, x, the output dtype)."""
    from llm_inference_engine_tpu_torch.ops import quant
    bf16 = torch.bfloat16
    name = f"{mode}_matmul"
    k, n, halves = shapes[label]
    out = torch.float32 if label == "lm_head" else bf16
    ts = quant_weights(torch, quant, dev, gen, mode, k, n, halves,
                       120_000_000)
    x = torch.randn(m, k, generator=gen, device=dev, dtype=bf16)
    ms = time_ms(torch, cycling(ts, lambda t: fused_matmul(quant, t, x, out,
                                                           "cuda")))
    plain_ms = time_ms(torch, cycling(ts, lambda t: fused_matmul(
        quant, t, x, out, "torch")), iters=3, warmup=1)
    gbs = ts[0].nbytes / ms / 1e6     # weight bytes read per second
    n_out = halves * n
    library = None
    if halves == 1 and out == bf16:
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
    say(f"    plan: {plan}")
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
    yardstick (the port never calls it). Its distance to kernel E's
    output is printed (its scales are bf16, E's f32). None, with the
    reason printed, where this torch refuses it."""
    try:
        packed = []
        for t in ts:
            u = (quant._unpack_int4(t.q).to(torch.int32) + 8).t()  # [n, k]
            w = ((u[:, 0::2] << 4) | u[:, 1::2]).to(torch.uint8)
            sz = torch.stack([t.scale.to(torch.bfloat16),
                              torch.zeros_like(t.scale, dtype=torch.bfloat16)],
                             dim=-1).contiguous()                 # [k/g, n, 2]
            packed.append((torch._convert_weight_to_int4pack(
                w.contiguous(), 8), sz))
        got = torch._weight_int4pack_mm(x, packed[0][0], 128, packed[0][1])
        want = quant.int4_matmul(x, ts[0].q, ts[0].scale, 128, x.dtype)
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
    per_kernel = sorted(((e.self_device_time_total / 1e3 / reps, e.key)
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0
                         and e.device_type == DeviceType.CUDA), reverse=True)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
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


# device time by group of kernels (profiler names, first match wins):
# kernel D2 (the prefill modes), kernel D (the decode modes), E/F, G,
# cuBLAS, the K/V row writes C, H, I (kv_write_kernel,
# paged_kv_write_kernel, kv_write_quant_kernel), kernels A and B
KERNEL_GROUPS = (("D2", ("attention_prefill_kernel",)),
                 ("D", ("attention_decode_kernel",)),
                 ("E/F", ("quant_matmul_decode", "quant_matmul_prefill")),
                 ("G", ("dequant_int4_kernel",)),
                 ("cuBLAS", ("nvjet", "gemm", "cutlass", "xmma")),
                 ("writes", ("kv_write",)),
                 ("A", ("rmsnorm_kernel",)),
                 ("B", ("silu_mul_kernel",)))
# the torch glue of a decode step (the kernels outside KERNEL_GROUPS), by
# where the eager body launched them: RoPE (ops/rope.py's rope_cos_sin and
# rotate), sampling (ops/sampling.py's functions the engine calls), casts
# (aten::to / copy_ elsewhere), other
GLUE = ("RoPE", "casts", "sampling", "other")


@contextlib.contextmanager
def glue_labels():
    """Run the RoPE and sampling functions that the decoder and the engine
    call under ``record_function("glue:RoPE")`` / ``("glue:sampling")``,
    so that a profile names the ops they launch (instrumentation of this
    check only; the functions are put back after)."""
    import torch
    from llm_inference_engine_tpu_torch.models import llama
    from llm_inference_engine_tpu_torch.runtime import engine
    patches = [(llama, n, "RoPE") for n in ("rope_cos_sin", "rotate")] + [
        (engine, n, "sampling") for n in ("apply_penalties", "greedy_sample",
                                          "sample_tokens", "token_logprobs")]
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


def _logit_diff(x, ref):
    d = (x - ref).abs().max().item()
    return d, ((x - ref).norm() / ref.norm()).item()


def _counters():
    from llm_inference_engine_tpu_torch.ops import activations, attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
    from llm_inference_engine_tpu_torch.ops import quant, rmsnorm
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
        "kv_write_quant": kvc.kv_write_quant,
        "attention_prefill_int8": attention.attention_int8,
        "attention_decode_int8": attention.attention_decode_fused_int8,
        "paged_kv_write_int8": pkv.paged_kv_write_quant,
        "attention_prefill_paged_int8":
            attention.attention_prefill_paged_int8,
        "attention_decode_paged_int8": attention.attention_decode_int8,
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
    before's output) and B once a layer; ``forwards``: how many forwards
    ``counts`` covers, where known."""
    f = counts.get("rmsnorm", 0)
    want = dict(rmsnorm=f, add_residual_rmsnorm=2 * layers * f,
                silu_and_mul=layers * f)
    got = {k: counts.get(k, 0) for k in want}
    if f == 0 or got != want or forwards not in (None, f):
        raise AssertionError(f"{label}: launches of A and B {got}, want "
                             f"{want} for {forwards or 'some'} forward(s)")


def snapshot(engine):
    """What a decode run changes besides K/V rows past the lengths: the
    lengths, both count planes, the generator. Restoring it replays the
    same run on the same state (the rows it rewrites are rewritten with
    the same values before they are read)."""
    return (engine._lengths.copy(), engine._counts_ctx.clone(),
            engine._counts_gen.clone(), engine._gen.get_state())


def restore(engine, snap) -> None:
    lengths, ctx, gen, rng = snap
    engine._set_lengths(lengths)
    engine._counts_ctx.copy_(ctx)
    engine._counts_gen.copy_(gen)
    engine._gen.set_state(rng)


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


def phase_main_path(torch, dev, results, path: str, eng_cfg, prompt_lens,
                    follow_lens, greedy_tokens: int):
    """One slot main path of llama2-7b: ``path`` names its MAIN_PATHS row,
    the kernels that must launch and those that must not. Returns the
    kernel path's prefill logits."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import SamplingParams, get_config
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.models.weights import (
        param_bytes, param_count)
    from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

    counters = _counters()
    expected, forbidden = MAIN_PATHS[path]
    B = eng_cfg.max_batch_size
    cfg = get_config("llama2-7b")
    engine = create_engine("llama2-7b", None, eng_cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    say(f"  engine: llama2-7b {path}, {param_count(engine.params) / 1e9:.3f} "
        f"G stored elements ({param_bytes(engine.params) / 1e9:.2f} GB), "
        f"B={B}, KV cache {kv_bytes(engine.cache) / 1e9:.2f} GB"
        + (f" (int8 values {2 * engine.cache.k.numel() / 1e9:.2f} GB + "
           f"scale planes {8 * engine.cache.k_scale.numel() / 1e9:.2f} GB, "
           f"{'snapped' if engine.cache.snapped else 'absmax'} scales; a "
           f"bf16 cache: {4 * engine.cache.k.numel() / 1e9:.2f} GB)"
           if engine.cache.quantized else ""))

    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, n).tolist() for n in prompt_lens]
    follow = [rng.integers(3, 32000, n).tolist() for n in follow_lens]
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
    if logits.shape != (B, 32000) or not torch.isfinite(logits).all():
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
    say(f"  peak memory {peak / 2**30:.2f} GiB")
    say(f"  warm prefill: card busy {prefill.busy:.3f} ms (kernel durations "
        f"summed {prefill.summed:.3f}); by group: "
        f"{_groups(prefill.per_kernel)}; by kernel: "
        + "; ".join(f"{_short(name)} {ms:.3f}"
                    for ms, name in prefill.per_kernel[:8]))

    # reference: round 1 again through the plain versions, same weights
    ref = InferenceEngine(cfg, eng_cfg.replace(kernels="torch"),
                          engine.params, device=dev)
    logits_t = ref.prefill(prompts)
    ref.reset()
    r1_ref = ref.generate(prompts, greedy, eos_token_id=None)
    # int8 KV paths: the plain prefill again with a fault planted in its
    # int8 attention, for each of INT8_FAULTS (instrumentation of this
    # check only; the plain attention is restored after each)
    planted = {}
    if engine.cache.quantized:
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
    # arbiter: the plain path in f32 on the same (upcast) weights;
    # quantized weights stay as they are (their plain versions take f32)
    def up(v):
        return v if isinstance(v, QuantizedTensor) else v.float()
    params32 = {k: ({n: up(w) for n, w in v.items()}
                    if isinstance(v, dict) else up(v))
                for k, v in engine.params.items()}
    ref32 = InferenceEngine(cfg.replace(dtype_name="float32"),
                            eng_cfg.replace(kernels="torch"), params32,
                            device=dev)
    logits_32 = ref32.prefill(prompts)
    del ref32, params32, engine
    torch.cuda.empty_cache()

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
    ties = [] if path == "bf16" else [
        i for i in range(B) if margins[i] < d_kt]
    differ = [i for i in range(B) if first["kernels"][i] != first["torch"][i]]
    bad = [i for i in differ if i not in ties
           or first["kernels"][i] not in top2_ids[i].tolist()]
    say(f"  tie rows (f32 margin < {d_kt:.4f}): {ties}; rows whose first "
        f"token differs from the plain path: {differ}")
    total = B * greedy_tokens
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
    if bad:
        failures.append(f"first greedy token differs from the reference in "
                        f"rows {bad}")
    if [o[0] for o in r1.token_ids] != first["kernels"]:
        failures.append("generate's first token is not the prefill argmax")
    if failures:
        raise AssertionError(f"{path} path: " + "; ".join(failures))
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
    (printed only: the JSON line keeps each row's first timed case). Its
    rows come from a generator of its own, so the phase's later cases
    draw what they drew before."""
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
                        timed, work=work, floor=floor)
        del ref


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
        B = cache.block_table.shape[0]
        kv_len = torch.cat([ints([1, S]), torch.randint(
            2, S, (B - 2,), generator=gen, device=dev, dtype=torch.int32)])
        table = cut(cache.block_table, kv_len, page)
        q = randn(B, 1, 32, D)
        say_plan(attention, f"paged B{B} H32 K32 D128 page {page}", B, 32, K,
                 D, page=page, max_pages=table.shape[1])
        run = lambda kern: attention.attention_decode(  # noqa: E731
            q, cache.k, cache.v, kv_len - 1, kv_len, 31, table=table,
            kernels=kern)
        ms = time_ms(torch, lambda: run("cuda"))
        plain_ms = time_ms(torch, lambda: run("torch"), iters=3, warmup=1)
        kv_bytes = int(kv_len.sum()) * K * D * 2 * 2
        check_close(torch, "attention_decode_paged", run("cuda"), run("torch"),
                    results, f"B{B} page {page} {tag} "
                    f"{kv_bytes / ms / 1e6:.0f} GB/s", (ms, plain_ms),
                    work=attn_work((kv_len - 1).tolist(), kv_len.tolist(), 1,
                                   32, K, D),
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
    # D attend-only paged decode: B = 16, kv_len 1-2048
    decode_case(cache, 64, "kv_len 1-2048")
    del cache, kn, vn, q
    torch.cuda.empty_cache()
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
    for head_dim in (80, 96, 256):
        head_dim_kernels(torch, dev, results, head_dim, gen, fill)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def head_dim_kernels(torch, dev, results, D, gen, fill) -> None:
    """Kernel D's four decode modes, D2's four prefill modes and kernel
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
    other KV dtype."""
    launches = {k: f.launches for k, f in counters.items()}
    say(f"  launches during {label}: {launches}")
    missing = [n for n in expected if launches[n] <= 0]
    other = INT8_PAGED if "paged_kv_write" in expected else BF16_PAGED
    extra = [n for n in BF16_SLOT + INT8_SLOT + other if launches[n]]
    if missing or extra:
        raise AssertionError(f"{label}: kernels never launched {missing}; "
                             f"kernels that must not launch {extra}")
    return launches


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
    ids of 4b's and 4c's ``generate`` and steps. ``tools/chip_kernel_ab.py
    --rows norm`` times another tree through this function, so it calls
    only what every tree has."""

    def checksum(values) -> float:
        """Position-weighted sum of integers (bf16 bit patterns, ids)."""
        v = torch.cat([t.reshape(-1).to(torch.int64) for t in values])
        weights = torch.arange(v.numel(), device=v.device) % 65521 + 1
        return float((v * weights).sum().item())
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
    out["A, A with residual, B outputs checksum"] = checksum(
        t.view(torch.int16) for t in (
            rmsnorm.rmsnorm(x, w, kernels="cuda"),
            *rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda"),
            activations.silu_and_mul(gu, kernels="cuda")))
    del x, r, gu
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, n).tolist() for n in QUANT_PROMPTS]
    for tag, quant in (("4b", "int4"), ("4c", "int8")):
        engine = create_engine("llama2-7b", None, EngineConfig(
            quant_mode=quant, max_batch_size=8, max_seq_len=2048), seed=0,
            device=dev)
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
        out[f"{tag} greedy ids checksum"] = checksum(
            [torch.tensor(res.token_ids, device=dev), *ids])
        out[f"{tag} replayed step activities"] = device_profile(
            torch, lambda: engine.decode_step(toks, active, sp), 1).activities
        del engine
        torch.cuda.empty_cache()
    return out


def paged_kernels(quant: dict) -> tuple:
    """The kernels a paged INT4 engine launches, by its KV dtype."""
    kv = INT8_PAGED if quant.get("kv_cache_dtype_name") else BF16_PAGED
    return NORM_ACT + ("int4_matmul",) + kv


def phase_paged_vs_slot(torch, dev, model: str, quant: dict, prompts,
                        greedy_tokens: int):
    """4d (4h with an int8 cache): a paged engine (page 64) and a slot
    engine, same kernels, same weights, chunks of 64: bit-identical prefill
    logits and the same greedy ids. Returns the paged engine's params for
    the phases after it."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

    cfg = get_config(model)
    base = EngineConfig(max_batch_size=len(prompts), max_seq_len=2048,
                        max_prefill_len=64, **quant)
    greedy = SamplingParams(greedy=True, max_new_tokens=greedy_tokens)
    paged = create_engine(model, None, base.replace(kv_layout="paged",
                                                    page_size=64),
                          seed=0, device=dev)
    B = len(prompts)
    say(f"  paged engine: {model} {quant}, B={B}, {paged.cache.num_pages} "
        f"pages of 64, pool {kv_bytes(paged.cache) / 1e9:.2f} GB")
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
    graph_checks(torch, paged, f"paged {kv}", toks, active, prompts)
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
    check_norm_launches(f"paged {kv} prefill", per_prefill, L)
    check_norm_launches(f"paged {kv} decode step", per_step, L, 1)
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
    requests that finished last. 4i runs wave 1 alone over an int8 pool
    of the same bytes (``num_pages`` ~2x), where admission need not wait
    for pages. Returns the engine."""
    import http.client
    import threading

    import numpy as np

    from llm_inference_engine_tpu_torch.cli import _IdTokenizer
    from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
    from llm_inference_engine_tpu_torch.runtime.chat_template import (
        get_chat_template)
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
    for name in expected[-3:]:            # the paged write and attention
        results.setdefault(name, {})["launches"] = launches[name]
    ap = sched.auto_prefix
    reused = [r.reused_prefix_len for r in requests[len(wave1):]]
    for tag, reqs, wall in waves:
        gen = sum(len(r.output_ids) for r in reqs)
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
CKPT_FREE_GB = 24     # 13.5 GB of shards and a 3.7 GB .npz, with room


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
    """4k: llama2-7b (32 layers, full width) from a checkpoint on disk;
    (a) seed-0 bf16 dummy weights written as an HF directory and loaded
    INT4 through ``create_engine``: bit for bit ``quantize_params`` of the
    same weights, and the in-memory engine's greedy ids on 4b's prompts;
    (b) the offline quantizer's .npz, and the chat CLI over it in a
    subprocess; (c) and (d) on the loaded engine, and (c) again on an INT8
    engine loaded from the same directory."""
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
    cfg = get_config("llama2-7b")
    eng_cfg = EngineConfig(quant_mode="int4", max_batch_size=8,
                           max_seq_len=2048)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, n).tolist() for n in QUANT_PROMPTS]
    greedy = SamplingParams(greedy=True, max_new_tokens=16)
    tmp = ckpt_dir()
    try:
        # (a) write, the in-memory reference, load
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
            engine = create_engine("llama2-7b", str(ckpt), eng_cfg,
                                   device=dev)
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
            "llama2-7b", str(ckpt),
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
        if quantize.main(["--model", "llama2-7b", "--checkpoint", str(ckpt),
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
             "--model", "llama2-7b", "--checkpoint", str(npz),
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
             "--model", "llama2-7b", "--checkpoint", str(npz),
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


def prefix_store_rows(torch, engine, prefix: dict, hold_ids: bool) -> None:
    """4k (c): a 320-token system prompt registered through the scheduler
    (the slot PrefixStore) on a loaded engine, then 8 requests that share
    it. The restore must be an exact byte copy; the tails' prefill logits
    must agree with the full prompts' within LOGIT_ATOL / LOGIT_REL_L2,
    and first tokens under the tie rule (the full prompts' top two within
    the largest logit difference). Two controls prefill the same tails
    over a wrong prefix (its K/V zeroed; another prompt's K/V): each must
    leave the limits, or the limits could not see a tail prefill that
    ignores the restored rows. The scheduler's greedy ids with and
    without the store are compared position by position; with
    ``hold_ids`` (an engine whose chunks take every prompt whole) they
    must be equal."""
    from llm_inference_engine_tpu_torch.config import SamplingParams
    from llm_inference_engine_tpu_torch.runtime.prefix_cache import (
        restore_prefix, snapshot_prefix)
    from llm_inference_engine_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)

    system, tails = prefix["system"], prefix["tails"]
    prompts = [system + t for t in tails]
    B = len(prompts)
    tag = "(c) " + engine.engine_config.quant_mode.upper()
    engine.reset()
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    entry = sched.register_prefix(system)
    store = sched.prefix_store
    # the restore: an exact copy, then its time against the copy bound
    store.restore(B - 1, entry)
    c = engine.cache
    tpad = entry.padded_length
    exact = (torch.equal(c.k[:, B - 1, :tpad], entry.k)
             and torch.equal(c.v[:, B - 1, :tpad], entry.v)
             and int(c.lengths[B - 1]) == engine._lengths[B - 1]
             == SYSTEM_LEN)
    ms = time_ms(torch, lambda: restore_prefix(c, B - 1, entry), iters=20)
    kv = entry.k.nbytes + entry.v.nbytes
    moved = 2 * kv                                    # read + write
    bound = moved / HBM_BYTES_PER_S * 1e3
    say(f"  {tag}: restore of {SYSTEM_LEN} tokens ({kv} bytes of K/V, "
        f"padded to {tpad}): exact copy {exact}; {ms:.4f} ms, "
        f"{moved / ms / 1e6:.1f} GB/s read + write; bound {bound:.4f} ms "
        f"(bytes, {bound / ms:.2f} of it)")
    if not exact:
        raise AssertionError("4k: the restored rows differ from the "
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
                    engine.cache.k[:, s, :tpad].zero_()
                    engine.cache.v[:, s, :tpad].zero_()
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
        f"logits max abs {d:.4e}, rel L2 {r:.4e} (limits {LOGIT_ATOL}, "
        f"{LOGIT_REL_L2}); first tokens that differ {differ}, outside the "
        f"tie rule {bad}")
    if d > LOGIT_ATOL or r > LOGIT_REL_L2 or bad:
        raise AssertionError("4k: prefix reuse moved the logits past the "
                             "limits or a first token outside the tie rule")
    controls = {name: _logit_diff(prefill_over(e, zero)(), lg_full)
                for name, e, zero in (("prefix K/V zeroed", entry, True),
                                      ("another prompt's prefix", other,
                                       False))}
    blind = [k for k, (dc, rc) in controls.items()
             if dc <= LOGIT_ATOL and rc <= LOGIT_REL_L2]
    say(f"  {tag}: controls, the tails over a wrong prefix against the full "
        f"prompts (max abs / rel L2): " + "; ".join(
            f"{k} {dc:.4e} / {rc:.4e}" for k, (dc, rc) in controls.items())
        + f"; inside the limits: {blind}")
    if blind:
        raise AssertionError(f"4k: the logit limits cannot see a wrong "
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
        raise AssertionError(f"4k: {skipped} prefix tokens reused, want "
                             f"{SYSTEM_LEN * B}")
    if hold_ids and same != B:
        raise AssertionError(f"4k: greedy ids with the store differ from "
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
                       tag="verify ")
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
    rows = decode_shape_rows(torch, dev, hidden=2048, inter=5632)
    say("  tinyllama A/B at decode shape (ms a call): " + json.dumps(rows))
    torch.cuda.empty_cache()


def near_ties(torch, engine, events) -> list:
    """For each rejection ``(context, draft token)`` of a self-draft run:
    the target's logits at the end of ``context`` through the verify path
    (a T = 5 forward after the first len - 5 tokens, as a round runs) and
    through the decode path (a T = 1 forward after the first len - 1),
    8 contexts a batch. Returns [(top-1 minus top-2 of the verify logits,
    max |verify - decode|, verify argmax, decode argmax, draft token)]."""
    from llm_inference_engine_tpu_torch.models import llama
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
            lg, _ = llama.forward_all_logits(
                engine.config, engine.engine_config, engine.params, ids,
                engine.cache, q, q + T)
            logits.append(lg[:, -1])
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
                silu_and_mul=layers)
    got = {k: round(per_round.get(k, 0) * SPEC_ROUNDS) for k in want}
    if got != want:
        failures.append(f"launches of A and B over {SPEC_ROUNDS} rounds "
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
             BF16_PAGED + INT8_PAGED + ("int8_matmul",
                                        "attention_decode_int8"))


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


def main() -> int:
    import numpy as np
    import torch

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
    phase("3e", "kernels A and B at decode shape (B = 8), timed in CUDA-graph "
          "replays", decode_shape_rows, torch, dev)

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
    cfg = get_config("llama2-7b")
    page_heads = 2 * cfg.num_layers * 64 * cfg.num_kv_heads
    int8_pages = 193 * page_heads * cfg.head_dim * 2 // (
        page_heads * (cfg.head_dim + 4))
    engine = phase("4i", f"serving path over an int8 pool of 4e's bytes "
                   f"({int8_pages} pages of 64): wave 1", phase_server, torch,
                   dev, results, "llama2-7b", int4_kv8, params, int8_pages,
                   24, 0, False)
    del engine, params
    phase("4k", "a checkpoint on disk: llama2-7b (32 layers) written as an "
          "HF directory, loaded INT4, the quantizer and the chat CLI, the "
          "slot PrefixStore at B=8, a 3-round ChatSession", phase_checkpoint,
          torch, dev)
    phase("4l", "speculative decoding and beam search: llama2-7b INT4 "
          "target, tinyllama-1.1b INT4 draft, B=8, k=4; the server over "
          "SpeculativeScheduler; beam_search", phase_speculative, torch, dev,
          results)
    phase("4m", "evals, calibration and the debugging utilities: llama2-7b "
          "(32 layers), the windowed Scorer, the taps, calibrate_act_sq and "
          "--calibrate, nan_guard", phase_evals, torch, dev, results)
    say("  decode per step, eager bodies against graph replays (wall and "
        "card busy ms): " + json.dumps(DECODE))

    # 5. results
    kernels = []
    for name in REPLACES:
        r = results[name]
        bound, bound_by = bound_ms(r["work"])
        kernels.append(dict(
            name=name, route=SOURCES[name][0], source=SOURCES[name][1],
            replaces=REPLACES[name], launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=bound, bound_by=bound_by,
            library_ms=r["library_ms"]))
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True,
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

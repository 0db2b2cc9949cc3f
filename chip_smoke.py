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
   (CUDA events, after warm-up): A-D, then E and F (fused dequant-matmul,
   INT4 and INT8) and G (INT4 dequantize, bit-identical);
4. the main paths, each through ``create_engine`` with dummy weights (seed
   0) at full width and depth, with every launch counter set to 0 just
   before the path and read just after, and a rerun of round 1 with
   ``kernels="torch"`` on the same weights as the reference:
   a. llama2-7b bf16, B=4: two ``generate`` rounds (greedy, then sampled)
      over four ragged prompts, then 16 steady decode steps;
   b. llama2-7b INT4 (group 128), B=8: eight ragged prompts whose prefill
      runs through G (1024+ rows) and E, the same two rounds, 16 steady
      decode steps through E (lm_head included);
   c. llama2-7b INT8, B=8: the same through F;
5. one JSON line of kernel results, the nvidia-smi line, and as the last
   line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

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
}
_TRITON = ("triton", "llm_inference_engine_tpu_torch/ops/_triton_kernels.py")
SOURCES = {
    "rmsnorm": _TRITON,
    "add_residual_rmsnorm": _TRITON,
    "silu_and_mul": _TRITON,
    "kv_write": ("cuda", "llm_inference_engine_tpu_torch/csrc/kv_write.cu"),
    "attention_prefill": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention.cu"),
    "attention_decode": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention.cu"),
    "int4_matmul": ("cuda", "llm_inference_engine_tpu_torch/csrc/quant_matmul.cu"),
    "int8_matmul": ("cuda", "llm_inference_engine_tpu_torch/csrc/quant_matmul.cu"),
    "dequant_int4": _TRITON,
}
# the main path whose launch count each kernel reports
PATH_OF = {name: "bf16" for name in REPLACES}
PATH_OF.update(int4_matmul="int4", dequant_int4="int4", int8_matmul="int8")


def say(*parts) -> None:
    print(*parts, flush=True)


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches.

    A ~30 ms device-side sleep is queued first, so the host has enqueued
    every launch before the first one runs (a case is at most a few
    hundred launches, well inside the card's launch queue): the CUDA
    events then time the kernels, not Python's launch overhead. A plain
    version that synchronises with the host inside cannot run ahead; its
    time is its real cost. Inputs that fit the 50 MB L2 stay there
    across repeats."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(torch, name, got, want, results, case, timed=None):
    """Hold a kernel's result against the plain version's; record it."""
    err = (got.float() - want.float()).abs().max().item()
    bad = not torch.allclose(got.float(), want.float(), **KERNEL_TOL)
    if bad or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} [{case}]: kernel disagrees with its "
                             f"plain version (max abs err {err})")
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    line = f"  {name:22s} {case:44s} max_abs_err {err:.3e}"
    if timed is not None:
        ms, plain_ms = timed
        r.setdefault("ms", ms)            # first case = main-path shape
        r.setdefault("plain_ms", plain_ms)
        line += f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
    say(line)


def phase_kernels(torch, dev, results) -> None:
    from llm_inference_engine_tpu_torch.ops import activations, attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import rmsnorm

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf16)

    def ints(vals):
        return torch.tensor(vals, device=dev, dtype=torch.int32)

    # A: rmsnorm / add_residual_rmsnorm at prefill (B*T = 4*512) and
    # decode (B = 4) token counts, hidden 4096
    for n in (2048, 4):
        x, r = randn(n, 4096), randn(n, 4096)
        w = randn(4096) * 0.1 + 1.0
        got = rmsnorm.rmsnorm(x, w, kernels="cuda")
        check_close(torch, "rmsnorm", got, rmsnorm.rmsnorm_torch(x, w),
                    results, f"[{n},4096]", (
                        time_ms(torch, lambda: rmsnorm.rmsnorm(
                            x, w, kernels="cuda")),
                        time_ms(torch, lambda: rmsnorm.rmsnorm_torch(x, w))))
        y, h = rmsnorm.add_residual_rmsnorm(x, r, w, kernels="cuda")
        y0, h0 = rmsnorm.add_residual_rmsnorm_torch(x, r, w)
        if not torch.equal(h, h0):
            raise AssertionError("add_residual_rmsnorm: residual sum differs")
        check_close(torch, "add_residual_rmsnorm", y, y0, results,
                    f"[{n},4096] with residual", (
                        time_ms(torch, lambda: rmsnorm.add_residual_rmsnorm(
                            x, r, w, kernels="cuda")),
                        time_ms(torch, lambda: rmsnorm.add_residual_rmsnorm_torch(
                            x, r, w))))

    # B: silu_and_mul over the packed gate|up [N, 2*11008]
    for n in (2048, 4):
        gu = randn(n, 22016)
        check_close(torch, "silu_and_mul",
                    activations.silu_and_mul(gu, kernels="cuda"),
                    activations.silu_and_mul_torch(gu), results,
                    f"[{n},22016]", (
                        time_ms(torch, lambda: activations.silu_and_mul(
                            gu, kernels="cuda")),
                        time_ms(torch, lambda: activations.silu_and_mul_torch(gu))))

    # C: a 512-token prefill chunk into the full 7B cache at layer 31
    L, B, S, K, D, T = 32, 4, 2048, 32, 128, 512
    starts = ints([0, 100, 1000, 1535])
    new_len = ints([512, 300, 1, 0])
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
    check_close(torch, "kv_write", cache.k[31], ref.k[31], results,
                "[4,512,32,128] -> [32,4,2048,32,128] @31", (
                    time_ms(torch, lambda: kvc.update_cache_at_layer(
                        cache, 31, kn, vn, starts, new_len, kernels="cuda")),
                    time_ms(torch, lambda: kvc.update_cache_at_layer_torch(
                        ref, 31, kn, vn, starts, new_len))))
    del ref

    # D prefill: the chunk above attends its random history + itself
    q = randn(B, T, 32, D)
    q_start = starts
    kv_len = starts + new_len
    run = lambda kern: attention.attention(  # noqa: E731
        q, cache.k, cache.v, q_start, kv_len, layer=31, kernels=kern)
    check_close(torch, "attention_prefill", run("cuda"), run("torch"),
                results, "B4 T512 H32 K32 qs[0,100,1000,1535]", (
                    time_ms(torch, lambda: run("cuda"), iters=5),
                    time_ms(torch, lambda: run("torch"), iters=5)))

    # D decode: row 0 has no history, row 2 is inactive
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
                        q1, k1, v1, kc, vc, dq_start, dkv_len, 31))))
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
                    f"B4 H32 {tag}")
    del kc, vc, kc2, vc2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_quant_kernels(torch, dev, results) -> None:
    """E and F at the decode projections of Llama2-7B (m = 8), at ragged m,
    and G at two weight shapes. Each timed case cycles through enough
    copies of its weight (>= 120 MB) that the 50 MB L2 holds none of them
    between uses, as in a decode step."""
    from llm_inference_engine_tpu_torch.ops import quant

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(4321)

    def qweight(mode, k, n, halves=1):
        # the dummy model's magnitudes: scale ~0.02 / qmax per value step
        lead = (2,) if halves == 2 else ()
        int4 = mode == "int4"
        q = torch.randint(-128 if int4 else -127, 128,
                          (*lead, k // 2 if int4 else k, n), generator=gen,
                          dtype=torch.int8, device=dev)
        s = torch.rand((*lead, k // 128 if int4 else 1, n), generator=gen,
                       device=dev) + 0.5
        return quant.QuantizedTensor(q, s * (0.02 / (7 if int4 else 127)),
                                     mode, 128)

    def copies(mode, k, n, halves=1):
        first = qweight(mode, k, n, halves)
        count = max(1, -(-120_000_000 // first.nbytes))
        return [first] + [qweight(mode, k, n, halves)
                          for _ in range(count - 1)]

    def fused(t, x, out, kern):
        if t.mode == "int4":
            return quant.int4_matmul(x, t.q, t.scale, 128, out, kernels=kern)
        return quant.int8_matmul(x, t.q, t.scale, out, kernels=kern)

    def cycling(ts, fn):
        it = [0]

        def run():
            it[0] += 1
            return fn(ts[it[0] % len(ts)])
        return run

    # (label, k, n, halves, out dtype): a decode layer's projections and
    # the lm_head
    shapes = [("wqkv 4096->12288", 4096, 12288, 1, bf16),
              ("wo 4096->4096", 4096, 4096, 1, bf16),
              ("gate|up 4096->2x11008", 4096, 11008, 2, bf16),
              ("down 11008->4096", 11008, 4096, 1, bf16),
              ("lm_head 4096->32000 f32", 4096, 32000, 1, f32)]
    for mode, name in (("int4", "int4_matmul"), ("int8", "int8_matmul")):
        layer_ms = layer_plain = 0.0
        for label, k, n, halves, out in shapes:
            ts = copies(mode, k, n, halves)
            x = torch.randn(8, k, generator=gen, device=dev, dtype=bf16)
            ms = time_ms(torch, cycling(ts, lambda t: fused(t, x, out,
                                                            "cuda")))
            plain_ms = time_ms(torch, cycling(ts, lambda t: fused(
                t, x, out, "torch")), iters=3, warmup=1)
            if not label.startswith("lm_head"):
                layer_ms, layer_plain = layer_ms + ms, layer_plain + plain_ms
            gbs = ts[0].nbytes / ms / 1e6     # weight bytes read per second
            check_close(torch, name, fused(ts[0], x, out, "cuda"),
                        fused(ts[0], x, out, "torch"), results,
                        f"m8 {label} {gbs:.0f} GB/s", (ms, plain_ms))
            del ts
        say(f"  {name} one decode layer (4 projections, m=8): kernel "
            f"{layer_ms:.4f} ms, plain {layer_plain:.4f} ms")
        # ragged m, the structured stack and the down projection's K
        for m in (5, 300, 1023):
            for label, k, n, halves, out in (shapes[2], shapes[3]):
                t = qweight(mode, k, n, halves)
                x = torch.randn(m, k, generator=gen, device=dev, dtype=bf16)
                timed = None
                if m == 1023 and halves == 1:
                    timed = (time_ms(torch, lambda: fused(t, x, out, "cuda"),
                                     iters=5),
                             time_ms(torch, lambda: fused(t, x, out, "torch"),
                                     iters=2, warmup=1))
                check_close(torch, name, fused(t, x, out, "cuda"),
                            fused(t, x, out, "torch"), results,
                            f"m{m} {label}", timed)
        torch.cuda.empty_cache()

    # G: bit-identical to its plain version
    for k, n in ((4096, 12288), (11008, 4096)):
        ts = copies("int4", k, n)
        got = quant.dequant_int4(ts[0].q, ts[0].scale, 128, kernels="cuda")
        want = quant.dequant_int4(ts[0].q, ts[0].scale, 128, kernels="torch")
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"dequant_int4 [{k},{n}]: not bit-identical "
                                 "to the plain dequant")
        check_close(torch, "dequant_int4", got, want, results,
                    f"[{k // 2},{n}] -> bf16 [{k},{n}] (torch.equal)", (
                        time_ms(torch, cycling(ts, lambda t: quant.dequant_int4(
                            t.q, t.scale, 128, kernels="cuda"))),
                        time_ms(torch, cycling(ts, lambda t: quant.dequant_int4(
                            t.q, t.scale, 128, kernels="torch")), iters=3,
                            warmup=1)))
        del ts, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def device_profile(torch, fn, reps: int):
    """(busy ms per rep, [(ms per rep, kernel name)] by time) of ``reps``
    calls of ``fn`` under torch.profiler: the card's busy time is the sum
    of its kernels' durations."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_kernel = sorted(((e.self_device_time_total / 1e3 / reps, e.key)
                         for e in prof.key_averages()), reverse=True)
    return sum(ms for ms, _ in per_kernel), per_kernel


def _logit_diff(x, ref):
    d = (x - ref).abs().max().item()
    return d, ((x - ref).norm() / ref.norm()).item()


def _counters():
    from llm_inference_engine_tpu_torch.ops import activations, attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
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
    }


def phase_main_path(torch, dev, results, path: str, eng_cfg, prompt_lens,
                    follow_lens, greedy_tokens: int) -> None:
    """One main path of llama2-7b: ``path`` is "bf16", "int4" or "int8"
    (``eng_cfg.quant_mode``). Every kernel whose PATH_OF is ``path`` must
    launch, and so must A-D."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import SamplingParams, get_config
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.models.weights import (
        param_bytes, param_count)
    from llm_inference_engine_tpu_torch.ops.quant import QuantizedTensor
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

    counters = _counters()
    expected = [name for name in counters
                if PATH_OF[name] in ("bf16", path)]
    B = eng_cfg.max_batch_size
    cfg = get_config("llama2-7b")
    engine = create_engine("llama2-7b", None, eng_cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    say(f"  engine: llama2-7b {path}, {param_count(engine.params) / 1e9:.3f} "
        f"G stored elements ({param_bytes(engine.params) / 1e9:.2f} GB), "
        f"B={B}, cache {2 * engine.cache.k.numel() * 2 / 1e9:.2f} GB")

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
    # steady decode: 16 more greedy steps on all slots
    active = np.ones(B, bool)
    toks = torch.tensor([o[-1] for o in r2.token_ids], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        toks = engine.decode_step(toks, active, SamplingParams(greedy=True))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 16 * 1e3
    # the same steps under the profiler: the card's busy time per step is
    # the sum of its kernels' durations; the rest of the wall time above
    # is the card waiting for the host
    state = {"toks": toks}

    def step():
        state["toks"] = engine.decode_step(state["toks"], active,
                                           SamplingParams(greedy=True))
    busy_ms, per_kernel = device_profile(torch, step, 4)
    peak = torch.cuda.max_memory_allocated()
    lengths = engine.cache.lengths.tolist()
    # one more warm prefill of the same prompts into fresh slots, profiled
    engine.reset()
    prefill_busy, prefill_kernels = device_profile(
        torch, lambda: engine.prefill(prompts), 1)
    launches = {k: f.launches for k, f in counters.items()}
    say(f"  launches during the {path} path: {launches}")
    for name in expected:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 f"{path} path")
        if PATH_OF[name] == path:
            results[name]["launches"] = launches[name]
    for rnd, res, n in (("round 1", r1, greedy_tokens), ("round 2", r2, 16)):
        if res.num_generated != [n] * B:
            raise AssertionError(f"{rnd}: tokens per row {res.num_generated}")
        if not all(np.isfinite(res.logprobs[i]).all() for i in range(B)):
            raise AssertionError(f"{rnd}: non-finite logprobs")
    say(f"  round 1 greedy  tokens[0][:8] {r1.token_ids[0][:8]}")
    say(f"  round 2 sampled tokens[0][:8] {r2.token_ids[0][:8]}")
    say(f"  slot lengths after both rounds + 20 steps: {lengths}")
    say(f"  prefill of {B} prompts ({sum(prompt_lens)} tokens): cold "
        f"{walls[0]:.4f} s, warm {walls[1]:.4f} s; round 1 generate "
        f"{gen1_s:.3f} s")
    say(f"  decode: {step_ms:.3f} ms/step at B={B}, "
        f"{B * 1e3 / step_ms:.1f} tok/s; card busy {busy_ms:.3f} ms/step "
        f"(idle {1 - busy_ms / step_ms:.3f} of the step); peak memory "
        f"{peak / 2**30:.2f} GiB")
    say("  decode step, device ms by kernel: " + "; ".join(
        f"{name[:40]} {ms:.3f}" for ms, name in per_kernel[:8]))
    say(f"  warm prefill: card busy {prefill_busy:.3f} ms; by kernel: "
        + "; ".join(f"{name[:40]} {ms:.3f}"
                    for ms, name in prefill_kernels[:8]))

    # reference: round 1 again through the plain versions, same weights
    ref = InferenceEngine(cfg, eng_cfg.replace(kernels="torch"),
                          engine.params, device=dev)
    logits_t = ref.prefill(prompts)
    ref.reset()
    r1_ref = ref.generate(prompts, greedy, eos_token_id=None)
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
    if r_k32 > KERNEL_VS_F32 * r_t32:
        failures.append("kernel path is further from f32 than the plain path")
    if bad:
        failures.append(f"first greedy token differs from the reference in "
                        f"rows {bad}")
    if [o[0] for o in r1.token_ids] != first["kernels"]:
        failures.append("generate's first token is not the prefill argmax")
    if failures:
        raise AssertionError(f"{path} path: " + "; ".join(failures))


def main() -> int:
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

    # 3. kernels vs plain
    say("== 3. kernels vs plain versions (7B shapes, bf16)")
    results: dict = {}
    t0 = time.perf_counter()
    phase_kernels(torch, dev, results)
    say(f"  phase time {time.perf_counter() - t0:.1f} s")

    say("== 3b. quantized matmul kernels vs plain versions (7B shapes)")
    t0 = time.perf_counter()
    phase_quant_kernels(torch, dev, results)
    say(f"  phase time {time.perf_counter() - t0:.1f} s")

    # 4. main paths
    from llm_inference_engine_tpu_torch.config import EngineConfig
    # 8 ragged prompts: the first chunk (8 x 512 rows) prefills through
    # kernel G, the second (8 x 64 rows, the 560-token prompt's tail)
    # through kernel E
    quant_prompts = (5, 40, 130, 200, 333, 420, 512, 560)
    quant_follow = (3, 9, 17, 33, 5, 64, 12, 40)
    for label, path, eng_cfg, lens, follow, greedy_tokens in (
            ("4a. main path: llama2-7b bf16, B=4", "bf16",
             EngineConfig(max_batch_size=4, max_seq_len=2048),
             (7, 129, 384, 700), (5, 17, 33, 64), 32),
            ("4b. main path: llama2-7b INT4, B=8", "int4",
             EngineConfig(quant_mode="int4", max_batch_size=8,
                          max_seq_len=2048), quant_prompts, quant_follow, 16),
            ("4c. main path: llama2-7b INT8, B=8", "int8",
             EngineConfig(quant_mode="int8", max_batch_size=8,
                          max_seq_len=2048), quant_prompts, quant_follow, 16)):
        say(f"== {label}: generate x2 + steady decode + reference")
        t0 = time.perf_counter()
        phase_main_path(torch, dev, results, path, eng_cfg, lens, follow,
                        greedy_tokens)
        say(f"  phase time {time.perf_counter() - t0:.1f} s")

    # 5. results
    kernels = [dict(name=name, route=SOURCES[name][0],
                    source=SOURCES[name][1], replaces=REPLACES[name],
                    launches=results[name]["launches"],
                    max_abs_err=results[name]["max_abs_err"],
                    ms=results[name]["ms"],
                    plain_ms=results[name]["plain_ms"])
               for name in REPLACES]
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

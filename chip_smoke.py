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
   (CUDA events, after warm-up);
4. the main path: ``create_engine("llama2-7b")`` with dummy bf16 weights
   at full width, two ``generate`` rounds (greedy, then sampled) over four
   ragged prompts, the kernels' launch counters read around that run,
   and a rerun of round 1 with ``kernels="torch"`` on the same weights as
   the reference;
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
}
SOURCES = {
    "rmsnorm": ("triton", "llm_inference_engine_tpu_torch/ops/_triton_kernels.py"),
    "add_residual_rmsnorm": ("triton", "llm_inference_engine_tpu_torch/ops/_triton_kernels.py"),
    "silu_and_mul": ("triton", "llm_inference_engine_tpu_torch/ops/_triton_kernels.py"),
    "kv_write": ("cuda", "llm_inference_engine_tpu_torch/csrc/kv_write.cu"),
    "attention_prefill": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention.cu"),
    "attention_decode": ("cuda", "llm_inference_engine_tpu_torch/csrc/attention.cu"),
}


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


def _logit_diff(x, ref):
    d = (x - ref).abs().max().item()
    return d, ((x - ref).norm() / ref.norm()).item()


def phase_main_path(torch, dev, results) -> None:
    import numpy as np

    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.models.weights import (
        param_bytes, param_count)
    from llm_inference_engine_tpu_torch.ops import activations, attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    from llm_inference_engine_tpu_torch.ops import rmsnorm
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

    counters = {
        "rmsnorm": rmsnorm.rmsnorm,
        "add_residual_rmsnorm": rmsnorm.add_residual_rmsnorm,
        "silu_and_mul": activations.silu_and_mul,
        "kv_write": kvc.update_cache_at_layer,
        "attention_prefill": attention.attention,
        "attention_decode": attention.attention_decode_fused,
    }
    cfg = get_config("llama2-7b")
    eng_cfg = EngineConfig(max_batch_size=4, max_seq_len=2048)
    engine = create_engine("llama2-7b", None, eng_cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    say(f"  engine: llama2-7b bf16, {param_count(engine.params) / 1e9:.3f} G "
        f"params ({param_bytes(engine.params) / 1e9:.2f} GB), cache "
        f"{2 * engine.cache.k.numel() * 2 / 1e9:.2f} GB")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, n).tolist() for n in (7, 129, 384, 700)]
    follow = [rng.integers(3, 32000, n).tolist() for n in (5, 17, 33, 64)]
    greedy = SamplingParams(greedy=True, max_new_tokens=32)
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
    if logits.shape != (4, 32000) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits bad: {tuple(logits.shape)}")
    # the two generate rounds on the same slots
    engine.reset()
    t0 = time.perf_counter()
    r1 = engine.generate(prompts, greedy, eos_token_id=None)
    gen1_s = time.perf_counter() - t0
    r2 = engine.generate(follow, sampled, eos_token_id=None)
    # steady decode: 16 more greedy steps on all four slots
    active = np.ones(4, bool)
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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            toks = engine.decode_step(toks, active,
                                      SamplingParams(greedy=True))
        torch.cuda.synchronize()
    per_kernel = sorted(((e.self_device_time_total / 4e3, e.key)
                         for e in prof.key_averages()), reverse=True)
    busy_ms = sum(ms for ms, _ in per_kernel)
    peak = torch.cuda.max_memory_allocated()
    launches = {k: f.launches for k, f in counters.items()}
    say(f"  launches during the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")
        results[name]["launches"] = n
    for rnd, res, n in (("round 1", r1, 32), ("round 2", r2, 16)):
        if res.num_generated != [n] * 4:
            raise AssertionError(f"{rnd}: tokens per row {res.num_generated}")
        if not all(np.isfinite(res.logprobs[i]).all() for i in range(4)):
            raise AssertionError(f"{rnd}: non-finite logprobs")
    say(f"  round 1 greedy  tokens[0][:8] {r1.token_ids[0][:8]}")
    say(f"  round 2 sampled tokens[0][:8] {r2.token_ids[0][:8]}")
    say(f"  slot lengths after both rounds + 20 steps: "
        f"{engine.cache.lengths.tolist()}")
    say(f"  prefill of 4 prompts (1220 tokens; chunks of 512+256 padded "
        f"rows): cold {walls[0]:.4f} s, warm {walls[1]:.4f} s; round 1 "
        f"generate {gen1_s:.3f} s")
    say(f"  decode: {step_ms:.3f} ms/step at B=4, "
        f"{4 * 1e3 / step_ms:.1f} tok/s; card busy {busy_ms:.3f} ms/step "
        f"(idle {1 - busy_ms / step_ms:.3f} of the step); peak memory "
        f"{peak / 2**30:.2f} GiB")
    say("  decode step, device ms by kernel: " + "; ".join(
        f"{name[:40]} {ms:.3f}" for ms, name in per_kernel[:8]))

    # reference: round 1 again through the plain versions, same weights
    ref = InferenceEngine(cfg, eng_cfg.replace(kernels="torch"),
                          engine.params, device=dev)
    logits_t = ref.prefill(prompts)
    ref.reset()
    r1_ref = ref.generate(prompts, greedy, eos_token_id=None)
    del ref
    # arbiter: the plain path in f32 on the same (upcast) weights
    params32 = {k: ({n: w.float() for n, w in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in engine.params.items()}
    ref32 = InferenceEngine(cfg.replace(dtype_name="float32"),
                            eng_cfg.replace(kernels="torch"), params32,
                            device=dev)
    logits_32 = ref32.prefill(prompts)
    del ref32, params32
    torch.cuda.empty_cache()

    d_kt, r_kt = _logit_diff(logits, logits_t)
    d_k32, r_k32 = _logit_diff(logits, logits_32)
    d_t32, r_t32 = _logit_diff(logits_t, logits_32)
    say(f"  prefill logits (std {logits_t.std().item():.3f}): max abs / rel "
        f"L2 kernels vs torch-bf16 {d_kt:.4e} / {r_kt:.4e}; kernels vs "
        f"torch-f32 {d_k32:.4e} / {r_k32:.4e}; torch-bf16 vs torch-f32 "
        f"{d_t32:.4e} / {r_t32:.4e}")
    top2 = logits_32.topk(2, dim=-1).values
    say(f"  f32 top-1 minus top-2 margin per row: "
        f"{[round(m, 4) for m in (top2[:, 0] - top2[:, 1]).tolist()]}")
    first = {name: lg.argmax(-1).tolist() for name, lg in
             (("kernels", logits), ("torch-bf16", logits_t),
              ("torch-f32", logits_32))}
    agree = sum(a == b for x, y in zip(r1.token_ids, r1_ref.token_ids)
                for a, b in zip(x, y))
    say(f"  first greedy tokens {first}; round-1 greedy tokens agreeing "
        f"with torch-bf16 position by position: {agree}/128 "
        f"({agree / 128:.3f})")
    failures = []
    if d_kt > LOGIT_ATOL or r_kt > LOGIT_REL_L2:
        failures.append("prefill logits disagree with the torch-bf16 path")
    if r_k32 > KERNEL_VS_F32 * r_t32:
        failures.append("kernel path is further from f32 than torch-bf16")
    if first["kernels"] != first["torch-bf16"]:
        failures.append("first greedy token differs from the reference")
    if [o[0] for o in r1.token_ids] != first["kernels"]:
        failures.append("generate's first token is not the prefill argmax")
    if failures:
        raise AssertionError("; ".join(failures))


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

    # 4. main path
    say("== 4. main path: llama2-7b generate x2 + reference")
    t0 = time.perf_counter()
    phase_main_path(torch, dev, results)
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

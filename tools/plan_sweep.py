#!/usr/bin/env python3
"""Sweep the split plans of kernel D (decode attention at G > 1) and kernel
E/F (the quantized matmuls' decode mode) on one CUDA card (an H100).

    python3 tools/plan_sweep.py [--only residency|d|e|modes|families]

The kernels are built from this checkout's sources with ``-DPLAN_SWEEP``,
which adds entry points that force a plan (``attention_decode_force_plan``,
``quant_matmul_force_plan``, ``quant_matmul_force_fragment``); the
engine's build has none. Then, each
timed with CUDA events as ``chip_smoke.py`` times its rows and held
against its plain version:

- residency: the clusters of n = 1 .. 8 blocks that the card holds at once
  for D's R = 4 and R = 8 slot instances, every dtype, head_dim and cache
  (the numbers D's plan reads; ``ops.attention.H100_DECODE_CLUSTERS``);
- d: kernel D's fused slot decode at tinyllama-1.1b's draft shape (B 8, 32
  q heads over 4 kv heads, head_dim 64; its tp = 2 rank, 16 over 2) and
  at ``chip_smoke.GQA_WIDTHS`` (head_dim 128), chip_smoke 4l's contexts,
  at every (R, nsplit) and at the plan's choice, beside SDPA;
- e: E and F at m 40 (the verify's 48-row tiles) at clusters 1, 2, 4, 8
  and the plan's, on the narrow projections the plan runs in the decode
  mode; F at m 8 at every cluster on tinyllama's projections and their
  tp = 2 shards;
- modes: E and F at m 17, 24, 32, 40 and 48 in the decode mode against the
  prefill mode, in turns, on llama2-7b's projections, its tp = 2 shards
  and tinyllama's, beside the mode the plan takes;
- families: kernel E's fragment mode (INT4 at m <= 16) at every
  arrangement its plan may take (column groups a block wc 1, 2, 4 by
  blocks a cluster cs 1, 2, 4, 8, where the K slices stay whole groups
  and shared memory fits; ``quant_matmul_force_fragment``) and at the
  plan's, beside ``_weight_int4pack_mm``: mistral-7b's projections at m 4
  (its B 4 decode step), llama2-7b's, llama3.1-8b's, qwen2-7b's and
  llama2-13b's at m 8, llama2-7b's wo and down at m 16, tinyllama's and
  the tp = 2 shards' at m 8.

It prints one line a case and, last, one JSON object with every number.
It fails where there is no card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (label, k, n, halves)
TINY = (("wqkv", 2048, 2560, 1), ("wo", 2048, 2048, 1),
        ("gate|up", 2048, 5632, 2), ("down", 5632, 2048, 1))
TINY_TP2 = (("tp2 wqkv", 2048, 1280, 1), ("tp2 wo", 1024, 2048, 1),
            ("tp2 gate|up", 2048, 2816, 2), ("tp2 down", 2816, 2048, 1))
SEVEN_B = (("7b wqkv", 4096, 12288, 1), ("7b wo", 4096, 4096, 1),
           ("7b gate|up", 4096, 11008, 2), ("7b down", 11008, 4096, 1))
SEVEN_B_TP2 = (("7b tp2 wqkv", 4096, 6144, 1), ("7b tp2 wo", 2048, 4096, 1),
               ("7b tp2 gate|up", 4096, 5504, 2),
               ("7b tp2 down", 5504, 4096, 1))
WIDE_SHARDS = (("7b tp2 wo", 2048, 4096, 1), ("qwen2 wo", 3584, 3584, 1))
NARROW_7B = (("7b wo", 4096, 4096, 1), ("7b down", 11008, 4096, 1),
             ("7b tp2 wqkv", 4096, 6144, 1), ("7b tp2 wo", 2048, 4096, 1),
             ("7b tp2 down", 5504, 4096, 1), ("qwen2 wo", 3584, 3584, 1))
TINY_NARROW = (("wqkv", 2048, 2560, 1), ("wo", 2048, 2048, 1),
               ("down", 5632, 2048, 1))
TINY_TP2_NARROW = (("tp2 wqkv", 2048, 1280, 1), ("tp2 wo", 1024, 2048, 1),
                   ("tp2 down", 2816, 2048, 1))
# the decode steps of chip_smoke 4u's Mistral (B 4) and 4v's 13B (B 8)
MISTRAL = (("mistral wqkv", 4096, 6144, 1), ("mistral wo", 4096, 4096, 1),
           ("mistral gate|up", 4096, 14336, 2),
           ("mistral down", 14336, 4096, 1))
LLAMA_13B = (("13b wqkv", 5120, 15360, 1), ("13b wo", 5120, 5120, 1),
             ("13b gate|up", 5120, 13824, 2), ("13b down", 13824, 5120, 1))
# the fragment mode's decode steps beside Mistral's and 13B's: the
# lm_heads (f32 out) and the other families
LM_HEADS = (("7b lm_head", 4096, 32000, 1), ("13b lm_head", 5120, 32000, 1),
            ("llama3.1 lm_head", 4096, 128256, 1),
            ("qwen2 lm_head", 3584, 152064, 1))
LLAMA31 = (("llama3.1 wqkv", 4096, 6144, 1),
           ("llama3.1 gate|up", 4096, 14336, 2))
QWEN2 = (("qwen2 wqkv", 3584, 4608, 1), ("qwen2 wo", 3584, 3584, 1),
         ("qwen2 gate|up", 3584, 18944, 2), ("qwen2 down", 18944, 3584, 1))
# (wc, cs) the fragment plan chooses among
ARRANGEMENTS = tuple((wc, c) for c in (1, 2, 4, 8) for wc in (4, 2, 1))


def main(argv) -> int:
    only = argv[1] if len(argv) == 2 and argv[0] == "--only" else None
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("plan_sweep: no CUDA device")
    from llm_inference_engine_tpu_torch.ops import _native
    _native.NVCC_FLAGS.append("-DPLAN_SWEEP")
    lib = _native.library()
    lib.attention_decode_force_plan.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.attention_decode_force_plan.restype = None
    lib.quant_matmul_force_plan.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.quant_matmul_force_plan.restype = None
    lib.quant_matmul_force_fragment.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.quant_matmul_force_fragment.restype = None
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    out = {"card": smi}
    if only in (None, "residency"):
        out["residency"] = residency(torch)
    if only in (None, "d"):
        out["d"] = sweep_d(torch, dev, cs, lib)
    if only in (None, "e"):
        out["e"] = sweep_e(torch, dev, cs, lib)
    if only in (None, "modes"):
        out["modes"] = sweep_modes(torch, dev, cs, lib)
    if only in (None, "families"):
        out["families"] = sweep_fragment(
            torch, dev, cs, lib,
            [(4, shape) for shape in MISTRAL]
            + [(8, shape) for shape in SEVEN_B + LLAMA_13B + LLAMA31 + QWEN2
               + LM_HEADS + TINY + TINY_TP2 + SEVEN_B_TP2]
            + [(16, shape) for shape in SEVEN_B[1::2]])
    print(json.dumps(out))
    return 0


def residency(torch) -> dict:
    from llm_inference_engine_tpu_torch.ops import _native, attention
    rows = {}
    for dtype, dims in ((torch.bfloat16, _native.HEAD_DIMS),
                        (torch.float16, _native.FLOAT_HEAD_DIMS),
                        (torch.float32, _native.FLOAT_HEAD_DIMS)):
        for D in dims:
            for int8 in (False, True):
                r = attention.decode_residency(D, int8=int8, dtype=dtype)
                key = f"{str(dtype).split('.')[-1]} D{D} int8 {int8}"
                rows[key] = {str(k): list(v) for k, v in r.items()}
                print(f"  residency {key}: R4 {r[4]}  R8 {r[8]}", flush=True)
    return rows


def sweep_d(torch, dev, cs, lib) -> dict:
    from llm_inference_engine_tpu_torch.ops import attention
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    gen = torch.Generator(device=dev).manual_seed(4242)
    S = 2048
    short = [n + 40 for n in cs.QUANT_PROMPTS]
    long = [1000 + 60 * i for i in range(16)]
    shapes = [("tinyllama", 32, 4, 64, short),
              ("tinyllama tp2", 16, 2, 64, short)] + [
        (f"G{H // K}", H, K, 128, short) for H, K in cs.GQA_WIDTHS] + [
        ("G4 B16 long", 32, 8, 128, long),
        ("tinyllama B16 long", 32, 4, 64, long)]
    rows = {}
    for tag, H, K, D, starts in shapes:
        G = H // K
        B = len(starts)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16)
        cache = kvc.new_kv_cache(2, B, K, S, D, device=dev)
        cache.k.copy_(randn(2, B, S, K, D))
        cache.v.copy_(randn(2, B, S, K, D))
        q, kn, vn = randn(B, 1, H, D), randn(B, 1, K, D), randn(B, 1, K, D)
        qs = torch.tensor(starts, dtype=torch.int32, device=dev)
        kl = qs + 1

        def run(kern="cuda"):
            if kern == "torch":
                return attention.attention_decode_fused_torch(
                    q, kn, vn, cache.k, cache.v, qs, kl, 1)[0]
            return attention.attention_decode_fused(
                q, kn, vn, cache.k, cache.v, qs, kl, 1, kernels="cuda")[0]
        want = run("torch").float()
        sdpa = cs.sdpa_ms(torch, q, cache.k[1], cache.v[1], qs, kl)
        plan = attention.decode_plan(B, H, K, D)
        cands = [(0, 0)] + [(R, n) for R in ((4,) if G <= 4 else (8, 4))
                            for n in range(1, 9)]
        row = {"sdpa": sdpa, "plan": plan}
        for R, n in cands:
            lib.attention_decode_force_plan(R, n)
            got = run().float()
            err = (got - want).abs().max().item()
            ms = cs.time_ms(torch, run, iters=20)
            name = "plan" if R == 0 else f"R{R} n{n}"
            row[name] = ms
            print(f"  D {tag} B{B} H{H} K{K} D{D} {name:8s} {ms:.4f} ms "
                  f"(err {err:.2e}; SDPA {sdpa:.4f})", flush=True)
            if err > 0.05:
                raise AssertionError(f"D {tag} {name}: err {err}")
        lib.attention_decode_force_plan(0, 0)
        print(f"  D {tag} plan {plan}", flush=True)
        rows[tag] = row
        del cache
    return rows


def sweep_e(torch, dev, cs, lib, cases=None) -> dict:
    """E / F's decode mode at forced clusters: ``cases`` of (mode, m,
    (label, k, n, halves), clusters; 0 is the plan's)."""
    from llm_inference_engine_tpu_torch.ops import quant
    gen = torch.Generator(device=dev).manual_seed(4321)
    rows = {}
    if cases is None:
        # m 8: clusters 1-8 at the draft's widths; m 40 (the verify's
        # 48-row tiles): clusters 1-8, INT4 and INT8, on the projections
        # the plan runs in the decode mode
        cases = [("int8", 8, shape, (0, 1, 2, 4, 8))
                 for shape in TINY + TINY_TP2]
        cases += [(mode, 40, shape, (0, 1, 2, 4, 8))
                  for mode in ("int4", "int8")
                  for shape in NARROW_7B + TINY_NARROW + TINY_TP2_NARROW]
    for mode, m, (label, k, n, halves), clusters in cases:
        ts = cs.quant_weights(torch, quant, dev, gen, mode, k, n, halves,
                              120_000_000)
        x = torch.randn(m, k, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        want = cs.fused_matmul(quant, ts[0], x, torch.bfloat16,
                               "torch").float()
        row = {"plan": quant.quant_matmul_plan_native(
            m, k, n, halves, int4=mode == "int4")}
        if halves == 1 and m <= 8 and mode == "int4":
            row["library"] = cs.int4pack_ms(torch, quant, ts, x,
                                            torch.bfloat16)
        for c in clusters:
            lib.quant_matmul_force_plan(c, 2 if c else 0)
            got = cs.fused_matmul(quant, ts[0], x, torch.bfloat16,
                                  "cuda").float()
            err = (got - want).abs().max().item()
            if err > 0.1:
                raise AssertionError(f"{mode} {label} m{m} c{c}: err {err}")
            ms = cs.time_ms(torch, cs.cycling(ts, lambda t: (
                cs.fused_matmul(quant, t, x, torch.bfloat16, "cuda"))),
                iters=20)
            row[f"c{c}" if c else "plan ms"] = ms
        lib.quant_matmul_force_plan(0, 0)
        rows[f"{mode} m{m} {label}"] = row
        print(f"  {mode} m{m} {label} (k {k}, n {n}x{halves}): " + ", ".join(
            f"{k2} {v:.4f}" for k2, v in row.items()
            if isinstance(v, float)) + f"; plan cluster "
            f"{row['plan']['cluster']}",
            flush=True)
        del ts
        torch.cuda.empty_cache()
    return rows


def sweep_fragment(torch, dev, cs, lib, cases) -> dict:
    """E's fragment mode at every arrangement (wc, cs) its plan may take
    and at the plan's, each held against the plain version and timed with
    its weights cycled through 120 MB, beside ``_weight_int4pack_mm``
    (bf16 out; the lm_heads f32): ``cases`` of (m, (label, k, n,
    halves))."""
    from llm_inference_engine_tpu_torch.ops import quant
    gen = torch.Generator(device=dev).manual_seed(4323)
    rows = {}
    for m, (label, k, n, halves) in cases:
        out = torch.float32 if "lm_head" in label else torch.bfloat16
        ts = cs.quant_weights(torch, quant, dev, gen, "int4", k, n, halves,
                              120_000_000)
        x = torch.randn(m, k, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        want = cs.fused_matmul(quant, ts[0], x, out, "torch").float()
        plan = quant.quant_matmul_plan_native(m, k, n, halves)
        row = {"plan": f"wc {plan['cols'] // 64} cs {plan['cluster']}"}
        if halves == 1:
            row["library"] = cs.int4pack_ms(torch, quant, ts, x,
                                            torch.bfloat16)
        for wc, c in ((0, 0),) + ARRANGEMENTS:
            lib.quant_matmul_force_fragment(wc, c)
            got_plan = quant.quant_matmul_plan_native(m, k, n, halves)
            if wc and (got_plan["cols"] // 64, got_plan["cluster"]) != (wc,
                                                                       c):
                continue   # not an arrangement of whole groups that fits
            got = cs.fused_matmul(quant, ts[0], x, out, "cuda").float()
            err = (got - want).abs().max().item()
            if err > 0.1 * max(1.0, want.abs().max().item()):
                raise AssertionError(f"fragment {label} m{m} wc{wc} cs{c}: "
                                     f"err {err}")
            row[f"wc{wc} cs{c}" if wc else "plan ms"] = cs.time_ms(
                torch, cs.cycling(ts, lambda t: cs.fused_matmul(
                    quant, t, x, out, "cuda")), iters=20)
        lib.quant_matmul_force_fragment(0, 0)
        best = min((v, key) for key, v in row.items()
                   if isinstance(v, float) and key not in ("library",))
        rows[f"int4 m{m} {label}"] = row
        print(f"  fragment m{m} {label} (k {k}, n {n}x{halves}): plan "
              f"{row['plan']} {row['plan ms']:.4f} ms, fastest {best[1]} "
              f"{best[0]:.4f}; library {row.get('library')}; " + ", ".join(
                  f"{key} {v:.4f}" for key, v in row.items()
                  if isinstance(v, float) and key.startswith("wc")),
              flush=True)
        del ts
        torch.cuda.empty_cache()
    return rows


def sweep_modes(torch, dev, cs, lib) -> dict:
    from llm_inference_engine_tpu_torch.ops import quant
    gen = torch.Generator(device=dev).manual_seed(4322)
    rows = {}
    for mode in ("int4", "int8"):
        for label, k, n, halves in SEVEN_B + SEVEN_B_TP2 + (
                ("7b lm_head", 4096, 32000, 1),) + TINY:
            out = torch.float32 if "lm_head" in label else torch.bfloat16
            ts = cs.quant_weights(torch, quant, dev, gen, mode, k, n, halves,
                                  120_000_000)
            for m in (17, 24, 32, 40, 48):
                x = torch.randn(m, k, generator=gen, device=dev,
                                dtype=torch.bfloat16)
                want = cs.fused_matmul(quant, ts[0], x, out, "torch").float()
                times = {}
                # forced decode (the plan's cluster), forced prefill, in turns
                for forced in (2, 1, 1, 2):
                    lib.quant_matmul_force_plan(0, forced)
                    got = cs.fused_matmul(quant, ts[0], x, out,
                                          "cuda").float()
                    err = (got - want).abs().max().item()
                    if err > 0.1:
                        raise AssertionError(f"{mode} {label} m{m} "
                                             f"mode {forced}: err {err}")
                    times.setdefault(forced, []).append(cs.time_ms(
                        torch, cs.cycling(ts, lambda t: cs.fused_matmul(
                            quant, t, x, out, "cuda")), iters=20))
                lib.quant_matmul_force_plan(0, 0)
                dec, pre = (sum(times[i]) / 2 for i in (2, 1))
                pick = quant.quant_matmul_plan(m, k, n, halves,
                                               int4=mode == "int4")
                rows[f"{mode} m{m} {label}"] = {"decode": dec, "prefill": pre,
                                                "plan": pick["mode"]}
                print(f"  {mode} m{m} {label}: decode {dec:.4f} ms (cluster "
                      f"{pick['cluster'] if pick['mode'] == 'decode' else '-'}"
                      f"), prefill {pre:.4f} ms, decode / prefill "
                      f"{dec / pre:.3f}; the plan takes {pick['mode']}",
                      flush=True)
            del ts
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

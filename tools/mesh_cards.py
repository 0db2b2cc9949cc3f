#!/usr/bin/env python3
"""Meshes over several CUDA cards (two or four H100s of one host).

    python3 tools/mesh_cards.py

llama2-7b INT4 (group 128, seed-0 dummy weights), B = 8, the prompts of
``chip_smoke.py``'s phase 4b, 16 greedy tokens, through
``InferenceEngine`` on these meshes:

- one rank on cuda:0 (the reference), and tp = 2, dp = 2 (and, with
  four cards, dp = 2 x tp = 2) with every rank on cuda:0 (decode as
  CUDA-graph replays, as chip_smoke's 4n runs it);
- tp = 2 over cuda:0 and cuda:1, and dp = 2 over cuda:0 and cuda:1;
- with four cards, dp = 2 x tp = 2 over cuda:0-3.

A mesh of several cards runs its decode bodies eagerly (a CUDA graph is
one device's). Every rank's kernels launch on its own card, and the
cross-rank sums copy each partial product to model rank 0's card and the
sum back. Checks, each raising on failure: a mesh over several cards
gives bit for bit the prefill logits, and the ids, of the same mesh with
every rank on cuda:0 (the same kernels at the same shapes, summed in the
same order: a partial lost, misordered or stale on its way between cards
shows in the logits); dp = 2 over two cards gives the one-rank engine's
ids, and dp = 2 x tp = 2 the tp = 2 ids. Prints each engine's prefill
seconds, its decode wall a step (host clock around 16 steps,
synchronized) and peak memory per card, the largest logit difference of
each mesh from the one-rank engine, the card names and power limits,
then one JSON line. Exits non-zero with fewer than two cards.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def steps_ms(torch, engine, toks, n: int = 16) -> float:
    """Wall ms a greedy decode step over ``n`` steps (the first step,
    which may capture the graphs, run before the clock starts)."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import SamplingParams
    active = np.ones(engine.engine_config.max_batch_size, bool)
    sp = SamplingParams(greedy=True)
    toks = engine.decode_step(toks, active, sp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        toks = engine.decode_step(toks, active, sp)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def main() -> int:
    import numpy as np
    import torch

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        raise SystemExit(f"mesh_cards: {n_cards} CUDA device(s); this check "
                         "needs two or four")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_quantized_params)
    from llm_inference_engine_tpu_torch.ops import _native
    from llm_inference_engine_tpu_torch.parallel import make_mesh
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"cards: {smi}", flush=True)
    _native.build()
    _native.library()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    cfg = get_config("llama2-7b")
    eng = EngineConfig(quant_mode="int4", max_batch_size=8, max_seq_len=2048)
    params = init_dummy_quantized_params(cfg, "int4", 128, seed=0,
                                         device=cards[0])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
               for n in cs.QUANT_PROMPTS]
    greedy = SamplingParams(greedy=True, max_new_tokens=16)

    meshes = [("one rank, cuda:0", None),
              ("tp=2 on cuda:0", make_mesh(1, 2, devices=[cards[0]] * 2)),
              ("dp=2 on cuda:0", make_mesh(2, 1, devices=[cards[0]] * 2)),
              ("tp=2 over cuda:0-1", make_mesh(1, 2, devices=cards[:2])),
              ("dp=2 over cuda:0-1", make_mesh(2, 1, devices=cards[:2]))]
    if n_cards >= 4:
        meshes += [("dp=2 x tp=2 on cuda:0", make_mesh(
                       2, 2, devices=[cards[0]] * 4)),
                   ("dp=2 x tp=2 over cuda:0-3", make_mesh(
                       2, 2, devices=cards[:4]))]
    out = {}
    for tag, mesh in meshes:
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        engine = InferenceEngine(cfg, eng, params, device=cards[0],
                                 mesh=mesh)
        engine.prefill(prompts)
        engine.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = engine.prefill(prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        engine.reset()
        r = engine.generate(prompts, greedy, eos_token_id=None)
        last = torch.tensor([o[-1] for o in r.token_ids], device=cards[0],
                            dtype=torch.int32)
        ms = steps_ms(torch, engine, last)
        peak = [round(torch.cuda.max_memory_allocated(d) / 2**30, 2)
                for d in cards]
        replays = engine._programs is not None
        out[tag] = dict(ids=r.token_ids, logits=logits.cpu(),
                        prefill_s=prefill_s, step_ms=ms, replays=replays,
                        peak_gib=peak)
        print(f"{tag}: prefill of 8 prompts {prefill_s:.4f} s; decode "
              f"{ms:.3f} ms/step ({8e3 / ms:.1f} tok/s at B=8, "
              f"{'replays' if replays else 'eager'}); peak GiB per card "
              f"{peak}; tokens[0][:6] {r.token_ids[0][:6]}", flush=True)
        del engine
        torch.cuda.empty_cache()

    def same(a, b):
        return (out[a]["ids"] == out[b]["ids"]
                and torch.equal(out[a]["logits"], out[b]["logits"]))
    checks = {
        "tp=2 over two cards == tp=2 on one card, logits bit for bit":
            same("tp=2 over cuda:0-1", "tp=2 on cuda:0"),
        "dp=2 over two cards == dp=2 on one card, logits bit for bit":
            same("dp=2 over cuda:0-1", "dp=2 on cuda:0"),
        "dp=2 over two cards == one rank, ids":
            out["dp=2 over cuda:0-1"]["ids"] == out["one rank, cuda:0"]["ids"],
    }
    if n_cards >= 4:
        checks["dp=2 x tp=2 over four cards == on one card, logits bit for "
               "bit"] = same("dp=2 x tp=2 over cuda:0-3",
                             "dp=2 x tp=2 on cuda:0")
        checks["dp=2 x tp=2 == tp=2 on one card, ids"] = (
            out["dp=2 x tp=2 over cuda:0-3"]["ids"]
            == out["tp=2 on cuda:0"]["ids"])
    ref = out["one rank, cuda:0"]["logits"]
    for tag, d in out.items():
        d["logits_max_abs_vs_one_rank"] = (d.pop("logits") - ref).abs().max(
            ).item()
        print(f"{tag}: prefill logits max abs from the one-rank engine's "
              f"{d['logits_max_abs_vs_one_rank']:.4e}", flush=True)
    for name, ok in checks.items():
        print(f"{name}: {ok}", flush=True)
    print(json.dumps({"cards": smi, "checks": checks,
                      "runs": {k: {n: v for n, v in d.items() if n != "ids"}
                               for k, d in out.items()}}))
    if not all(checks.values()):
        raise SystemExit("mesh_cards: a check failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

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

Then prefix snapshots, speculation and beams (``chip_smoke.py``'s 4q
(a)-(c)) on tp = 2 over cuda:0 and cuda:1 against tp = 2 on cuda:0,
with chunks of 1024: the scheduler's greedy ids with a slot
``PrefixStore`` holding a 320-token prefix, the snapshot's rows of
each rank, and a restore of them into the last slot, exact; a
``SpeculativeDecoder`` over a tinyllama-1.1b INT4 draft (seed 0) on the
same mesh, k = 4: 64 greedy tokens and the drafted and accepted counts;
``beam_search`` with 4 beams over the sharded params: sequences and
scores. Each must be equal bit for bit across the two meshes (the rounds
and beam steps replay CUDA graphs on one card and run eagerly over two).
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


def decoding(torch, cs, params, draft_params, mesh) -> dict:
    """4q (a)-(c) on ``mesh``: the prefix store's ids and snapshot (on the
    host), the speculative ids and counts, the beams; with each path's
    wall seconds."""
    import numpy as np

    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams, get_config)
    from llm_inference_engine_tpu_torch.runtime.beam_search import (
        beam_search)
    from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
    from llm_inference_engine_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)
    from llm_inference_engine_tpu_torch.runtime.speculative import (
        SpeculativeDecoder)
    cfg, tiny = get_config("llama2-7b"), get_config("tinyllama-1.1b")
    eng = EngineConfig(quant_mode="int4", max_batch_size=8, max_seq_len=2048,
                       max_prefill_len=1024)
    rng = np.random.default_rng(0)
    prefix = cs.prefix_prompts(rng)
    out, wall = {}, {}
    target = InferenceEngine(cfg, eng, params, mesh=mesh)

    t0 = time.perf_counter()
    sched = ContinuousBatchingScheduler(target, eos_token_id=None)
    entry = sched.register_prefix(prefix["system"])
    reqs = [sched.submit(prefix["system"] + t, SamplingParams(
        greedy=True, max_new_tokens=16)) for t in prefix["tails"]]
    sched.run()
    torch.cuda.synchronize()
    wall["prefix"] = time.perf_counter() - t0
    target.reset()
    sched.prefix_store.restore(7, entry)
    out["prefix ids"] = [r.output_ids for r in reqs]
    out["snapshot"] = [(part.k.cpu(), part.v.cpu()) for part in entry.parts]
    out["restored exactly"] = cs.restored_exactly(torch, target.cache, 7,
                                                  entry)
    target.reset()
    del sched, entry

    draft = InferenceEngine(tiny, eng, draft_params, mesh=mesh)
    spec = SpeculativeDecoder(target, draft, cs.SPEC_K)
    prompts = [rng.integers(3, 32000, n).tolist() for n in cs.QUANT_PROMPTS]
    t0 = time.perf_counter()
    res = spec.generate(prompts, cs.SPEC_NEW, eos_token_id=None)
    torch.cuda.synchronize()
    wall["speculative"] = time.perf_counter() - t0
    out["speculative"] = (res.token_ids, res.num_drafted, res.num_accepted)
    del spec, draft

    prompt = rng.integers(3, 32000, cs.BEAM_PROMPT).tolist()
    t0 = time.perf_counter()
    beams = beam_search(cfg, eng, target.params, prompt, cs.BEAMS,
                        cs.BEAM_NEW, eos_token_id=None)
    torch.cuda.synchronize()
    wall["beams"] = time.perf_counter() - t0
    out["beams"] = (beams.sequences, beams.scores)
    return out, wall


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
    # prefix snapshots, speculation and beams at tp = 2: two cards against
    # one
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_quantized_params as dummies)
    draft_params = dummies(get_config("tinyllama-1.1b"), "int4", 128, seed=0,
                           device=cards[0])
    dec = {}
    for tag, devices in (("tp=2 on cuda:0", [cards[0]] * 2),
                         ("tp=2 over cuda:0-1", cards[:2])):
        got, wall = decoding(torch, cs, params, draft_params,
                             make_mesh(1, 2, devices=devices))
        dec[tag] = got
        print(f"{tag}: prefix store, speculation, beams: wall s "
              f"{ {k: round(v, 3) for k, v in wall.items()} }; acceptance "
              f"{got['speculative'][2]}/{got['speculative'][1]}; restored "
              f"exactly {got['restored exactly']}", flush=True)
        out[tag]["decoding_wall_s"] = wall
        torch.cuda.empty_cache()
    one, two = dec["tp=2 on cuda:0"], dec["tp=2 over cuda:0-1"]
    snaps = all(torch.equal(a, b) for pa, pb in zip(one["snapshot"],
                                                    two["snapshot"])
                for a, b in zip(pa, pb))
    checks.update({
        "tp=2 over two cards == on one card: prefix store ids and snapshot "
        "bit for bit, restores exact": (
            one["prefix ids"] == two["prefix ids"] and snaps
            and one["restored exactly"] and two["restored exactly"]),
        "tp=2 over two cards == on one card: speculative ids and counts":
            one["speculative"] == two["speculative"],
        "tp=2 over two cards == on one card: beam sequences and scores":
            one["beams"] == two["beams"]})
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

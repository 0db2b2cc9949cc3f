#!/usr/bin/env python3
"""Greedy ids of chip_smoke's 4a, 4b, 4d, 4h and 4i main paths, in one or
more trees of the port, on the card.

    python3 tools/main_path_ids.py [TREE ...]

For each tree (default: this checkout; another tree is a directory
unpacked with ``git archive``, e.g. ``build/parent``) a child process
builds that tree's kernels and runs, through its ``create_engine`` with
seed-0 dummy weights and chip_smoke's prompts (numpy seed 0):

- 4a: llama2-7b bf16, B 4, prompts of 7, 129, 384 and 700 tokens, 32
  greedy tokens;
- 4b: INT4 weights (group 128), B 8, prompts of 5-560 tokens, 16 greedy
  tokens;
- 4d: INT4 weights over the paged pool (pages of 64, chunks of 64), B 8,
  the same prompts, 32 greedy tokens;
- 4h: the same over an int8 pool;
- 4i: the scheduler over 4h's engine config at 4i's pool (2x 4e's pages
  less the scale planes' share: 374 pages of 64), 24 requests (4b's
  prompts three times), 16 greedy tokens each, eos none.

It prints a sha256 of each path's ids per tree. Where the first tree (the
reference, e.g. the parent) and a later one disagree on a row of 4b, 4d
or 4h (the INT4 paths through ``generate``; a kernel that sums in another
order may move a near-tie), both trees prefill that row's prompt and the
reference ids up to the first step that differs, and the row is
explained by 4b's tie rule: the later tree's token lies in the
reference's top two, whose margin is below the largest logit difference
between the two trees there (the bf16 noise of the path). It prints each
such row (row, step, margin, difference) and exits 1 where 4a (bf16)
differs, where such a row falls outside the rule, or where 4i (the
scheduler) differs without 4b, 4d or 4h differing. The children run one
after the other (each holds a 7B model on the card)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import hashlib, json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
from llm_inference_engine_tpu_torch.config import EngineConfig, SamplingParams
from llm_inference_engine_tpu_torch.models.registry import create_engine
from llm_inference_engine_tpu_torch.ops import _native
_native.library()
quant_prompts = (5, 40, 130, 200, 333, 420, 512, 560)
paths = {
    "4a": (EngineConfig(max_batch_size=4, max_seq_len=2048),
           (7, 129, 384, 700), 32),
    "4b": (EngineConfig(quant_mode="int4", max_batch_size=8,
                        max_seq_len=2048), quant_prompts, 16),
    "4d": (EngineConfig(quant_mode="int4", max_batch_size=8,
                        max_seq_len=2048, max_prefill_len=64,
                        kv_layout="paged", page_size=64), quant_prompts, 32),
    "4h": (EngineConfig(quant_mode="int4", max_batch_size=8,
                        max_seq_len=2048, max_prefill_len=64,
                        kv_layout="paged", page_size=64,
                        kv_cache_dtype_name="int8"), quant_prompts, 32),
    "4i": (EngineConfig(quant_mode="int4", max_batch_size=16,
                        max_seq_len=2048, max_prefill_len=64,
                        kv_layout="paged", page_size=64, num_pages=374,
                        kv_cache_dtype_name="int8"), quant_prompts * 3, 16),
}
# argv: "ids", or "logits" and a JSON file {path: [[row, prefix ids]]}:
# the f32 logits of each row's prompt + prefix, prefilled alone
job = sys.argv[1]
want = json.load(open(sys.argv[2])) if job == "logits" else None
out = {}
for name, (eng, lens, n) in paths.items():
    if want is not None and name not in want:
        continue
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, k).tolist() for k in lens]
    engine = create_engine("llama2-7b", None, eng, seed=0, device="cuda")
    sp = SamplingParams(greedy=True, max_new_tokens=n)
    if want is not None:
        rows = []
        for row, prefix in want[name]:
            engine.reset()
            rows.append(engine.prefill([prompts[row] + prefix])[0]
                        .float().cpu().tolist())
        out[name] = rows
    elif name == "4i":
        from llm_inference_engine_tpu_torch.runtime.scheduler import (
            ContinuousBatchingScheduler)
        sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
        reqs = [sched.submit(p, sp) for p in prompts]
        sched.run()
        ids = [r.output_ids for r in reqs]
    else:
        ids = engine.generate(prompts, sp, eos_token_id=None).token_ids
    if want is None:
        out[name] = dict(sha256=hashlib.sha256(json.dumps(ids).encode())
                         .hexdigest()[:16], first=[r[:4] for r in ids[:2]],
                         ids=ids)
    del engine
    torch.cuda.empty_cache()
print(json.dumps(out))
"""

TIE_PATHS = ("4b", "4d", "4h")   # INT4 through generate: the tie rule


def child(tree: Path, *args) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, *args], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
        raise SystemExit(proc.returncode)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def ties(ref: Path, tree: Path, ref_ids: dict, ids: dict) -> list:
    """[(path, row, step, reference top-2 margin, logit difference, in
    the rule)] for each row of TIE_PATHS whose ids differ."""
    import tempfile
    import numpy as np
    firsts = {}
    for p in TIE_PATHS:
        for row, (a, b) in enumerate(zip(ref_ids[p]["ids"], ids[p]["ids"])):
            if a != b:
                t = next(k for k in range(len(a)) if a[k] != b[k])
                firsts.setdefault(p, []).append((row, t, a[:t], b[t]))
    if not firsts:
        return []
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False,
                                     dir=ROOT / "build") as f:
        json.dump({p: [[row, prefix] for row, _, prefix, _ in rows]
                   for p, rows in firsts.items()}, f)
    try:
        la, lb = child(ref, "logits", f.name), child(tree, "logits", f.name)
    finally:
        Path(f.name).unlink()
    out = []
    for p, rows in firsts.items():
        for (row, t, _, tok), a, b in zip(rows, la[p], lb[p]):
            a, b = np.asarray(a), np.asarray(b)
            top2 = np.argsort(a)[::-1][:2]
            margin = float(a[top2[0]] - a[top2[1]])
            diff = float(np.abs(a - b).max())
            out.append((p, row, t, round(margin, 4), round(diff, 4),
                        tok in top2.tolist() and margin < diff))
    return out


def main(argv) -> int:
    trees = [Path(t).resolve() for t in argv] or [ROOT]
    digests = {}
    for tree in trees:
        digests[tree] = child(tree, "ids")
        print(f"{tree}: " + json.dumps({p: {k: v for k, v in d.items()
                                            if k != "ids"}
                                        for p, d in digests[tree].items()}),
              flush=True)
    differ = [p for p in ("4a", "4b", "4d", "4h", "4i")
              if len({d[p]["sha256"] for d in digests.values()}) > 1]
    rows = []
    for tree in trees[1:]:
        rows += ties(trees[0], tree, digests[trees[0]], digests[tree])
    for p, row, t, margin, diff, ok in rows:
        print(f"  {p} row {row} differs first at step {t}: reference top-2 "
              f"margin {margin}, logit difference {diff}: "
              f"{'a near-tie (the tie rule)' if ok else 'OUTSIDE the tie rule'}",
              flush=True)
    print(json.dumps({"paths_that_differ": differ,
                      "rows_outside_the_tie_rule": [
                          r[:3] for r in rows if not r[5]]}))
    bad = ("4a" in differ or any(not r[5] for r in rows)
           or ("4i" in differ and not set(differ) & set(TIE_PATHS)))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

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

It prints a sha256 of each path's ids per tree and exits 1 when two trees
disagree on a path. The children run one after the other (each holds a
7B model on the card)."""

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
out = {}
for name, (eng, lens, n) in paths.items():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, k).tolist() for k in lens]
    engine = create_engine("llama2-7b", None, eng, seed=0, device="cuda")
    sp = SamplingParams(greedy=True, max_new_tokens=n)
    if name == "4i":
        from llm_inference_engine_tpu_torch.runtime.scheduler import (
            ContinuousBatchingScheduler)
        sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
        reqs = [sched.submit(p, sp) for p in prompts]
        sched.run()
        ids = [r.output_ids for r in reqs]
    else:
        ids = engine.generate(prompts, sp, eos_token_id=None).token_ids
    out[name] = dict(sha256=hashlib.sha256(json.dumps(ids).encode())
                     .hexdigest()[:16], first=[r[:4] for r in ids[:2]])
    del engine
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main(argv) -> int:
    trees = [Path(t).resolve() for t in argv] or [ROOT]
    digests = {}
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
            return proc.returncode
        digests[str(tree)] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{tree}: {json.dumps(digests[str(tree)])}", flush=True)
    differ = [p for p in ("4a", "4b", "4d", "4h", "4i")
              if len({d[p]["sha256"] for d in digests.values()}) > 1]
    print(json.dumps({"paths_that_differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

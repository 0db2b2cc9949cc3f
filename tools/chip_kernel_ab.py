#!/usr/bin/env python3
"""Time kernel rows of ``chip_smoke.py`` in two checkouts, in turns, on one
CUDA card (an H100).

    python3 tools/chip_kernel_ab.py
        [--rows attention|quant|writes|prefill|norm|float|spec|rope|bias]
        PARENT_ROOT
        [CHANGE_ROOT]

PARENT_ROOT and CHANGE_ROOT (default: this checkout) are roots of the
repository, e.g. a parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists. For each root in the order parent,
change, change, parent, a fresh process builds that root's kernels from
its own sources into its own build directory and runs that root's
``chip_smoke.py`` kernel phases 3, 3c and 3d: every kernel is held against
its plain version there and timed with CUDA events at the main path's
shapes. Then the same process times that root's kernel D at GQA widths
through this checkout's ``chip_smoke.gqa_decode_cases`` (bf16 fused and
paged decode at G = 4, 7 and 8, B = 8; the same cases for both roots,
which the parent's chip_smoke may lack). The script prints each run's
attention rows (kernel ms of the first timed case of each row, as in the
``kernels`` line of ``chip_smoke.py``, and the GQA rows), then one JSON
line with every run's times and, per row, the mean of the change's runs
over the mean of the parent's. It fails where there is no card.

``--rows quant`` times kernels E and F instead, and only them: each run
builds its root's kernels and times them at ``QUANT_ROWS`` (the decode
projections and lm_head at m = 8, wo and down at m = 16, the four
projections at m = 512, weights cycled past the L2 as in phase 3b), then
E at every model's m <= 16 decode shapes (``chip_smoke.e_decode_rows``:
the families, llama2-13b, the tp = 2 ranks, tinyllama), through this
checkout's ``chip_smoke.quant_rows``, which calls only the wrappers every
tree has.

``--rows writes`` times the K/V row writes instead, and only them: kernel
C at phase 3's chunk, H and its int8 mode at 3c's mixed step (520 rows,
cold, then under a clean flush) and at decode shape (B = 8 and 16, cold),
I at the 8 x 512 and 8 x 64 chunks (warm), If (float16 and float32
rows) at 8 x 512 into the slot cache and at the 520-row mixed step
through the table (warm), each beside its floor (one ``copy_`` of the
same live rows), through this checkout's ``chip_smoke.write_rows``. The floors run the same code in both trees,
so their change / parent ratios show the noise.

``--rows prefill`` times one warm prefill of llama2-7b INT4 (4b's
prompts) paged over a bf16 pool (4d) and an int8 pool (4h), chunks and
pages of 64, and slot over an int8 cache (4g): the card's busy ms and the
K/V writes' ms of it (torch.profiler); then slot at INT4 (4b) and INT8
(4c), chunks of 512: busy ms and the ms of kernels J, G, G8, cuBLAS and
the rest, through this checkout's ``chip_smoke.prefill_rows``.

``--rows rope`` times each tree's QKV split with RoPE as its
``models.llama`` calls it (kernel J, or the split, two rotations and v's
copy that J replaced), through this checkout's ``chip_smoke.rope_rows``:
at 4b's, tinyllama's and a tp = 2 rank's decode step in CUDA-graph
replays, at a prefill chunk and the verify's 8 x 5, with a checksum of
its outputs; and the replayed decode step of 4a, 4b, 4n (tp = 2 on one
card) and 4t (float16): wall, card busy, J's ms, the RoPE glue's ms and
the ids' checksum.

``--rows bias`` times qwen2-7b's replayed decode step (INT4 at B 8 on
4b's prompts, bf16 at B 4 on 4a's; llama2-7b's shapes are not touched)
and kernel J at its decode step, through this checkout's
``chip_smoke.bias_rows``: busy, wall, J's ms and the elementwise adds'
ms a step, where a tree that adds Qwen2's qkv bias apart from J (the
parent of J's bias mode) pays for the add, and the ids' checksum.

``--rows float`` times the float16 and float32 instances D2f, Df, Ef and
Ff instead, and only them, at phase 3f's shapes (the prefill over the
slot cache and through the table, the fused slot decode, the attend-only
paged decode; a decode step's K/V work over an int8 pool at B 16 in
float16, float32 and bf16 by the route each tree's engine takes; Ef and
Ff at m 8 and 512 on wqkv and down), through this checkout's
``chip_smoke.float_attention_rows`` and
``chip_smoke.float_matmul_rows``, which call only the wrappers every tree
has.

``--rows norm`` times kernels A (plain and with a residual) and B at
decode shape ([8, 4096], [8, 22016]: 64 calls in a CUDA graph, CUDA
events over its replays) and at prefill shape ([2048, 4096] cold,
[2048, 22016]), and the wall and card busy of 4b's, 4c's, 4d's and 4h's
replayed decode step (llama2-7b INT4 and INT8, B = 8; 4d: INT4 over a
bf16 pool of pages of 64; 4h: over an int8 pool) with its kernels'
durations a step (all, kernel D's and the K/V writes'), through this
checkout's ``chip_smoke.norm_rows``, with the count of the card's
activities in one replayed step; it also prints whether checksums of
A's and B's outputs and of 4b's, 4c's, 4d's and 4h's greedy ids are
equal in every run.

``--rows spec`` times the speculative round's kernels and the round,
through this checkout's ``chip_smoke.spec_rows``: kernel D's fused decode
at the draft's shapes (4l: tinyllama B 8, G 8, head_dim 64; 4q: its tp =
2 rank) and at GQA_WIDTHS, E and F at the verify's m 40 on llama2-7b's
projections and E at the draft's m 8 on tinyllama's and its tp = 2
shards, and 4l (a)'s replayed round (wall, the card's busy ms and its
kernel groups); it prints whether D's outputs at the G = 1 shapes of 4a,
4b, 4d and 4h are bit for bit equal in every run.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def one(root: Path, rows: str = "attention") -> dict:
    """Run the kernel phases of ``root``'s chip_smoke.py in this process;
    return {row: kernel ms} of its attention rows (``rows="quant"``: of
    kernels E and F at QUANT_ROWS; ``rows="writes"``: of the K/V row
    writes and their floors; ``rows="prefill"``: warm prefills;
    ``rows="norm"``: kernels A and B and 4b's, 4c's and 4d's replayed
    step; ``rows="float"``: the float instances D2f, Df, Ef, Ff;
    ``rows="spec"``: the speculative round's kernels and the round;
    ``rows="rope"``: the QKV split with RoPE and the replayed steps;
    ``rows="bias"``: qwen2-7b's replayed steps and J)."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_ab: no CUDA device")
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from llm_inference_engine_tpu_torch.ops import _native
    if Path(_native.__file__).resolve().parents[2] != root:
        raise SystemExit(f"chip_kernel_ab: imported {_native.__file__}, "
                         f"not the package of {root}")
    _native.library()
    dev = torch.device("cuda", 0)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", HERE / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    if rows == "quant":
        return here.quant_rows(torch, dev)
    if rows == "writes":
        return here.write_rows(torch, dev)
    if rows == "prefill":
        return here.prefill_rows(torch, dev)
    if rows == "norm":
        return here.norm_rows(torch, dev)
    if rows == "float":
        return {**here.float_attention_rows(torch, dev),
                **here.float_matmul_rows(torch, dev)}
    if rows == "spec":
        return here.spec_rows(torch, dev)
    if rows == "rope":
        return here.rope_rows(torch, dev)
    if rows == "bias":
        return here.bias_rows(torch, dev)
    results: dict = {}
    for fn in (smoke.phase_kernels, smoke.phase_paged_kernels,
               smoke.phase_kv_int8_kernels):
        fn(torch, dev, results)
    gqa = here.gqa_decode_cases(torch, dev, {})
    return {**{name: r["ms"] for name, r in results.items()
               if name.startswith("attention") and "ms" in r}, **gqa}


def main(argv) -> int:
    rows = "attention"
    if len(argv) >= 2 and argv[0] == "--rows":
        rows, argv = argv[1], argv[2:]
    if rows not in ("attention", "quant", "writes", "prefill", "norm",
                    "float", "spec", "rope", "bias"):
        raise SystemExit(__doc__)
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps(one(Path(argv[1]).resolve(), rows)), flush=True)
        return 0
    if len(argv) not in (1, 2):
        raise SystemExit(__doc__)
    parent = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) == 2 else HERE
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    runs = []
    for tag, root in (("parent", parent), ("change", change),
                      ("change", change), ("parent", parent)):
        proc = subprocess.run([sys.executable, __file__, "--rows", rows,
                               "--one", str(root)],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"chip_kernel_ab: the {tag} run failed")
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((tag, ms))
        print(f"{tag} ({root}): " + "; ".join(
            f"{k} {v:.0f}" if k.endswith(("checksum", "activities"))
            else f"{k} {v:.4f} ms"
            for k, v in ms.items()), flush=True)
    ratio = {}
    for name in runs[0][1]:
        mean = {tag: sum(ms[name] for t, ms in runs if t == tag) / 2
                for tag in ("parent", "change")}
        ratio[name] = (mean["change"] / mean["parent"] if mean["parent"]
                       else float("nan"))
        if name.endswith("checksum"):
            same = len({ms[name] for _, ms in runs}) == 1
            print(f"  {name:30s} equal in every run: {same}", flush=True)
            continue
        if name.endswith("activities"):
            print(f"  {name:30s} parent {mean['parent']:.1f}, change "
                  f"{mean['change']:.1f}", flush=True)
            continue
        print(f"  {name:30s} parent {mean['parent']:.4f} ms, change "
              f"{mean['change']:.4f} ms, change / parent "
              f"{ratio[name]:.4f}", flush=True)
    print(json.dumps({"card": smi, "runs": runs, "change_over_parent": ratio}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

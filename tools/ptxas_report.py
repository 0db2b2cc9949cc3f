#!/usr/bin/env python3
"""Registers, spills and shared memory of every kernel instance in the
port's CUDA sources, as ptxas reports them for sm_90a.

    python3 tools/ptxas_report.py [SOURCE ...]

Runs ``nvcc -Xptxas -v -c`` (the flags of ``ops/_native.py``) on each
``llm_inference_engine_tpu_torch/csrc/*.cu`` (or the sources named), one
process per source, all started together, and prints one line per kernel
instance: registers a thread, spill stores and loads (bytes) and static
shared memory, after any warning ptxas gives (a wgmma serialized, a
setmaxnreg ignored). Kernels D and D2 take dynamic shared memory, which ptxas
does not see: the sources report it (``ops.attention.decode_plan`` and
``prefill_plan``, printed by ``chip_smoke.py``). Needs nvcc (the machine
with the card).
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def parse(text: str):
    """[(mangled name, registers, spill stores, spill loads, smem)]"""
    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill,
                         int(m.group(2) or 0)))
            name = None
    return rows


def main(argv) -> int:
    from llm_inference_engine_tpu_torch.ops import _native
    sources = ([Path(a).resolve() for a in argv] if argv
               else sorted(_native.CSRC.glob("*.cu")))
    nvcc = _native.nvcc_path()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, *_native.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / f"{src.stem}.o"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources]
        failed = False
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                print(out)
                failed = True
                continue
            for line in out.splitlines():   # e.g. wgmma serialized
                if ("warning" in line.lower()
                        or "Performance Loss" in line):
                    print(f"{src.name}: {line.strip()}", flush=True)
            rows = parse(out)
            names = demangle([r[0] for r in rows])
            for (_, regs, st, ld, smem), name in sorted(
                    zip(rows, names), key=lambda x: x[1]):
                short = re.sub(r"\((int|bool)\)|void |(\(anonymous "
                               r"namespace\)|<unnamed>)::", "", name)
                short = short[:short.rfind("(")] if "(" in short else short
                print(f"{src.name}: {short}: {regs} registers, spill "
                      f"{st}/{ld} bytes, static smem {smem}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

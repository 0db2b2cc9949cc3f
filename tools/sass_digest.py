#!/usr/bin/env python3
"""A digest of each kernel's machine code (SASS) in the port's CUDA
sources, with its count of tensor-core instructions, per checkout.

    python3 tools/sass_digest.py [--match REGEX] [--sources NAME,...]
        [ROOT ...]

For each ROOT (a root of the repository; default: this checkout) every
``llm_inference_engine_tpu_torch/csrc/*.cu`` (or the sources named, e.g.
``quant_matmul.cu,quant_matmul_f16.cu``) is compiled by its own ``nvcc
-cubin`` process with the flags of ``ops/_native.py``, all started
together, and ``cuobjdump -sass`` lists each kernel's instructions. A
kernel's digest is the SHA-256 of its instructions with the addresses,
encodings and branch-label numbers taken out (labels renumbered in order
of appearance), so the same code gives the same digest whatever file or
template holds it. One line a kernel whose name matches ``--match``:
digest, instructions, HMMA (``mma.sync``) and HGMMA (``wgmma``)
instructions, name (demangled, up to its parameters).

With two or more roots, the kernels are paired by name with
``__nv_bfloat16, `` taken out of their template arguments (a kernel
that became a template over its element type keeps its bf16 instance's
key), and the script exits 1 where a key in the first root has another
digest, or none, in a later one. Needs nvcc and cuobjdump (the machine
with the card).
"""

from __future__ import annotations

import hashlib
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def short_name(full: str) -> str:
    """A demangled kernel name without its parameter list (the balanced
    parentheses at its end; template arguments may hold "(bool)1")."""
    if full.endswith(")"):
        depth = 0
        for i in range(len(full) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(full[i], 0)
            if depth == 0:
                full = full[:i]
                break
    for prefix in ("void ", "(anonymous namespace)::", "<unnamed>::"):
        full = full.replace(prefix, "")
    return full


def tool_path(name: str) -> str:
    from llm_inference_engine_tpu_torch.ops import _native
    found = shutil.which(name)
    if found:
        return found
    return str(Path(_native.nvcc_path()).parent / name)


def kernels_of(sass: str) -> dict:
    """{mangled name: [normalized instruction]} of one cuobjdump listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        if name is None:
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m:
            out[name].append(m.group(1))
        elif re.match(r"\s*\.L_x_\d+:", line):
            out[name].append(line.strip())
    return out


def normalized(insts: list) -> str:
    labels: dict = {}

    def label(m):
        return labels.setdefault(m.group(0), f".L{len(labels)}")
    return "\n".join(re.sub(r"\.L_x_\d+", label, i) for i in insts)


def digests(root: Path, sources, pattern) -> dict:
    """{short name: (digest, instructions, HMMA, HGMMA)} of ``root``."""
    from llm_inference_engine_tpu_torch.ops import _native
    csrc = root / "llm_inference_engine_tpu_torch" / "csrc"
    srcs = ([csrc / s for s in sources] if sources
            else sorted(csrc.glob("*.cu")))
    flags = [f for f in _native.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    nvcc, cuobjdump = _native.nvcc_path(), tool_path("cuobjdump")
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, *flags, "-cubin", "-o", str(Path(tmp) / f"{src.stem}.cubin"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)) for src in srcs]
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed on {src}:\n{out}")
            sass = subprocess.run(
                [cuobjdump, "-sass", str(Path(tmp) / f"{src.stem}.cubin")],
                capture_output=True, text=True, check=True).stdout
            found = kernels_of(sass)
            names = demangle(list(found))
            for mangled, full in zip(found, names):
                short = short_name(full)
                if not re.search(pattern, short):
                    continue
                insts = found[mangled]
                rows[f"{src.name}: {short}"] = (
                    hashlib.sha256(normalized(insts).encode()).hexdigest()[:16],
                    len(insts),
                    sum(re.search(r"\bHMMA\b", i) is not None for i in insts),
                    sum(re.search(r"\bHGMMA\b", i) is not None
                        for i in insts))
    return rows


def key(name: str) -> str:
    """A kernel's name without its source and its bf16 template argument."""
    return name.split(": ", 1)[1].replace("__nv_bfloat16, ", "")


def main(argv) -> int:
    pattern, sources, roots = ".", None, []
    while argv:
        arg = argv.pop(0)
        if arg == "--match":
            pattern = argv.pop(0)
        elif arg == "--sources":
            sources = argv.pop(0).split(",")
        else:
            roots.append(Path(arg).resolve())
    roots = roots or [HERE]
    tables = []
    for root in roots:
        rows = digests(root, sources, pattern)
        print(f"== {root}", flush=True)
        for name, (digest, n, hmma, hgmma) in sorted(rows.items()):
            print(f"{digest} {n:6d} insts HMMA {hmma:4d} HGMMA {hgmma:4d}  "
                  f"{name}", flush=True)
        tables.append({key(k): v[0] for k, v in rows.items()})
    if len(tables) < 2:
        return 0
    first, failed = tables[0], False
    for other, root in zip(tables[1:], roots[1:]):
        bad = [k for k in sorted(first) if other.get(k) != first[k]]
        for k in bad:
            print(f"DIFFERS in {root}: {k} ({first[k]} -> {other.get(k)})")
        print(f"{root}: {len(first) - len(bad)} of {len(first)} kernels "
              f"equal to {roots[0]}", flush=True)
        failed |= bool(bad)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

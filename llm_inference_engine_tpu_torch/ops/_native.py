"""Build and load the hand-written CUDA kernels; import Triton lazily.

The CUDA sources (``llm_inference_engine_tpu_torch/csrc/*.cu``) expose a
plain C interface. They are compiled with one ``nvcc`` call into a shared
library under ``build/torch_kernels/`` at the repository root, at first
use, and loaded with ``ctypes``; a library whose name carries the hash of
the sources is reused. Pointers and the CUDA stream travel as
``c_void_p``; every entry point returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0.

A failed build raises: there is no plain fallback on a CUDA tensor.
Nothing here runs at import time, so the module imports on machines
without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signatures of csrc/*.cu, in argument order
_SIGNATURES = {
    # k_new, v_new, k_cache, v_cache, starts, new_len,
    # layer, B, T, S, row_bytes, stream
    "kv_write": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k_cache, v_cache, out, q_start, kv_len,
    # layer, B, T, H, K, S, D, sm_scale, window, stream
    "attention_prefill": [_P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k_new, v_new, k_cache, v_cache, out, q_start, kv_len,
    # layer, B, H, K, S, D, sm_scale, window, stream
    "attention_decode": [_P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # x, q, scale, out, m, k, n, halves, q_half, s_half, group, out_f32,
    # stream
    "int4_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _P],
    # x, q, scale, out, m, k, n, halves, q_half, s_half, out_f32, stream
    "int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return str(path)


def build() -> tuple[Path, float]:
    """Compile the CUDA sources unless a library of the same source hash
    exists. Returns (library path, seconds spent compiling)."""
    digest = hashlib.sha256()
    sources = sorted(CSRC.glob("*.cu"))
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libtorch_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)     # atomic: a concurrent loader never sees half
    return lib, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def triton():
    """Import Triton, keeping its compile cache inside the build
    directory of the checkout (set only when the caller has not)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton as _triton
    return _triton

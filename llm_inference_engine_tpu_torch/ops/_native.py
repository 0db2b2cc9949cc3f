"""Build and load the hand-written CUDA kernels; import Triton lazily.

The CUDA sources (``llm_inference_engine_tpu_torch/csrc/*.cu``, with the
headers ``*.cuh`` they share) expose a plain C interface. At first use
each ``.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library under
``build/torch_kernels/`` at the repository root, loaded with ``ctypes``;
a library whose name carries the hash of the sources and headers is
reused. Pointers and the CUDA stream travel as
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
              "-O3", "-Xcompiler", "-fPIC"]

# head_dim of every bf16 attention and int8-write kernel instance (the
# ``switch (D)`` of each bf16 source; a test holds them equal)
HEAD_DIMS = (64, 80, 96, 128, 256)
# head_dim of the float16 and float32 instances (the ``switch (D)`` of
# csrc/attention_*_f16.cu and _f32.cu, and the float one of
# csrc/kv_write_quant.cu): the debug preset's 16 and every bf16 head dim
FLOAT_HEAD_DIMS = (16,) + HEAD_DIMS

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
    # k_new, v_new, k_cache, v_cache, k_scale, v_scale, starts, new_len,
    # layer, B, T, K, S, D, snapped, stream
    "kv_write_quant": [_P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k_cache, v_cache, k_scale, v_scale, out, q_start, kv_len,
    # layer, B, T, H, K, S, D, sm_scale, window, stream
    "attention_prefill_int8": [_P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, out, q_start,
    # kv_len, layer, B, H, K, S, D, sm_scale, window, snapped, stream
    "attention_decode_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # k_new, v_new, k_pool, v_pool, starts, new_len, table,
    # layer, B, T, P, page, max_pages, row_bytes, stream
    "paged_kv_write": [_P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P],
    # k_new, v_new, k_pool, v_pool, k_scale, v_scale, starts, new_len,
    # table, layer, B, T, K, P, page, max_pages, D, stream
    "paged_kv_write_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k_pool, v_pool, out, q_start, kv_len, table,
    # layer, B, T, H, K, P, page, max_pages, D, sm_scale, window, stream
    "attention_prefill_paged": [_P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                _P],
    # q, k_pool, v_pool, out, q_start, kv_len, table,
    # layer, B, H, K, P, page, max_pages, D, sm_scale, window, stream
    "attention_decode_paged": [_P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k_new, v_new, k_pool, v_pool, out, q_start, kv_len, table,
    # layer, B, H, K, P, page, max_pages, D, sm_scale, window, stream
    "attention_decode_paged_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                     _I, _P],
    # q, k_pool, v_pool, k_scale, v_scale, out, q_start, kv_len, table,
    # layer, B, T, H, K, P, page, max_pages, D, sm_scale, window, stream
    "attention_prefill_paged_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _F, _I, _P],
    # q, k_pool, v_pool, k_scale, v_scale, out, q_start, kv_len, table,
    # layer, B, H, K, P, page, max_pages, D, sm_scale, window, stream
    "attention_decode_paged_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                    _P],
    # q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, out, q_start,
    # kv_len, table, layer, B, H, K, P, page, max_pages, D, sm_scale,
    # window, stream
    "attention_decode_paged_fused_int8": [_P, _P, _P, _P, _P, _P, _P, _P,
                                          _P, _P, _P, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _F, _I, _P],
    # B, T, row_bytes, out[6]
    "kv_write_plan": [_I, _I, _I, _P],
    # B, T, K, D, out[5]
    "kv_write_quant_plan": [_I, _I, _I, _I, _P],
    # B, H, K, D, int8, page, max_pages, out[7]
    "attention_decode_plan": [_I, _I, _I, _I, _I, _I, _I, _P],
    # D, int8, out[16]
    "attention_decode_clusters": [_I, _I, _P],
    # D, int8, out[3]
    "attention_prefill_plan": [_I, _I, _P],
    # x, q, qd (q in fragment order, or null), scale, out, m, k, n,
    # halves, q_half, s_half, group, out_f32, stream
    "int4_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _P],
    # x, q, scale, out, m, k, n, halves, q_half, s_half, out_f32, stream
    "int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _P],
    # m, k, n, halves, int4, group, out[8]
    "quant_matmul_plan": [_I, _I, _I, _I, _I, _I, _P],
    # x, residual (or null), weight, y, h (or null), n, hidden, dtype, eps,
    # stream
    "rmsnorm": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    # gate_up, out, n, inter, dtype, stream
    "silu_and_mul": [_P, _P, _I, _I, _I, _P],
    # qkv, bias (or null), cos, sin, q, k, v, n, kv_heads, group,
    # head_dim, dtype, stream
    "split_qkv_rope": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
# the float16 and float32 instances of kernels D2 and D
# (csrc/attention_{prefill,decode}_{f16,f32}.cu): the bf16 entry points'
# signatures, the name suffixed with the dtype's (ATTENTION_SUFFIX)
ATTENTION_ENTRIES = (
    "attention_prefill", "attention_prefill_paged", "attention_prefill_int8",
    "attention_prefill_paged_int8", "attention_prefill_plan",
    "attention_decode", "attention_decode_paged_fused",
    "attention_decode_paged", "attention_decode_int8",
    "attention_decode_paged_int8", "attention_decode_paged_fused_int8",
    "attention_decode_plan", "attention_decode_clusters")
ATTENTION_SUFFIX = {"bfloat16": "", "float16": "_f16", "float32": "_f32"}
# the float16 and float32 instances of kernels E and F, Ef and Ff
# (csrc/quant_matmul_f16.cu, _f32.cu): the same suffixes
QUANT_ENTRIES = ("int4_matmul", "int8_matmul", "quant_matmul_plan")
# the float16 and float32 instances of kernel I, If
# (csrc/kv_write_quant.cu): the same suffixes
WRITE_QUANT_ENTRIES = ("kv_write_quant", "paged_kv_write_quant",
                       "kv_write_quant_plan")
for _name in ATTENTION_ENTRIES + QUANT_ENTRIES + WRITE_QUANT_ENTRIES:
    for _suffix in ("_f16", "_f32"):
        _SIGNATURES[_name + _suffix] = _SIGNATURES[_name]


def entry_name(name: str, dtype) -> str:
    """The C entry point ``name`` of kernel D2, D, E, F or I for tensors
    of ``dtype``: the bf16 instance's name, or the float16 / float32 one's
    (suffixed, ATTENTION_SUFFIX)."""
    return name + ATTENTION_SUFFIX[str(dtype).split(".")[-1]]


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
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libtorch_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        runs = [(cmd, *proc.communicate(), proc.returncode)
                for cmd, proc in zip(compiles, procs)]
        for run in runs:
            _check_nvcc(*run)
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, proc.stdout, proc.stderr, proc.returncode)
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib, time.perf_counter() - t0


def _check_nvcc(cmd, out: str, err: str, returncode: int) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{out}\n{err}")


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


def dtype_code(dtype) -> int:
    """The dtype code of ``csrc/norm_act.cu``'s entry points (bf16 0, f16
    1, f32 2)."""
    import torch
    return {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}[dtype]


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

"""ctypes bindings + on-demand build of the port's native C++ library.

Port of ``llm_inference_engine_tpu/native.py`` over the port's own copies
of the host-side C++ sources (``llm_inference_engine_tpu_torch/csrc/``):

- ``tokenizer.cc`` — trie + score-ordered-heap BPE encode/decode
  (``tokenizer/native.py``);
- ``weight_loader.cc`` — parallel pread + threaded dtype cast and
  [out, in] -> [in, out] transpose (``runtime/native_io.py``).

The library is built with g++ at first use into ``build/native/`` at the
repository root, under a name that carries the hash of the sources and
flags, so the port never shares (or races on) the JAX package's
``csrc/build/libllm_native.so``, and an edited source builds a new
library. ``LLM_NATIVE=0`` (or no toolchain, or a failed build) leaves
every consumer on its pure-Python path, which has the same semantics.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load_native", "native_available", "library_path", "DT_F32",
           "DT_F16", "DT_BF16", "DT_I8", "dtype_code"]

DT_F32, DT_F16, DT_BF16, DT_I8 = 0, 1, 2, 3

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
_SOURCES = ("tokenizer.cc", "weight_loader.cc")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_lib_path = None
_load_failed = False


def dtype_code(dtype) -> int:
    """torch dtype (or its name) -> the native dtype code."""
    name = str(dtype).replace("torch.", "")
    codes = {"float32": DT_F32, "float16": DT_F16, "bfloat16": DT_BF16,
             "int8": DT_I8}
    if name not in codes:
        raise ValueError(f"unsupported native dtype {dtype}")
    return codes[name]


def _build() -> str | None:
    """Compile the sources unless a library of their hash exists; None
    when there is no toolchain or the build fails."""
    srcs = [_CSRC / s for s in _SOURCES]
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libllm_native_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return str(lib)
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *_FLAGS, "-o", str(tmp), *map(str, srcs), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        os.replace(tmp, lib)   # atomic: a concurrent loader never sees half
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return str(lib)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.llm_tok_new.restype = c.c_void_p
    lib.llm_tok_new.argtypes = [c.c_int32] * 4
    lib.llm_tok_free.argtypes = [c.c_void_p]
    lib.llm_tok_add_piece.argtypes = [c.c_void_p, c.c_char_p, c.c_int32,
                                      c.c_int32, c.c_float]
    lib.llm_tok_encode.restype = c.c_int32
    lib.llm_tok_encode.argtypes = [c.c_void_p, c.c_char_p, c.c_int32,
                                   c.c_int32, c.c_int32,
                                   c.POINTER(c.c_int32), c.c_int32]
    lib.llm_tok_decode.restype = c.c_int32
    lib.llm_tok_decode.argtypes = [c.c_void_p, c.POINTER(c.c_int32),
                                   c.c_int32, c.c_char_p, c.c_int32]
    lib.llm_read_file.restype = c.c_int32
    lib.llm_read_file.argtypes = [c.c_char_p, c.c_int64, c.c_int64,
                                  c.c_void_p]
    lib.llm_cast.argtypes = [c.c_void_p, c.c_int32, c.c_void_p, c.c_int32,
                             c.c_int64]
    lib.llm_transpose_cast.argtypes = [c.c_void_p, c.c_int32, c.c_void_p,
                                       c.c_int32, c.c_int64, c.c_int64]
    return lib


def load_native() -> ctypes.CDLL | None:
    """The shared library, building it on first use. None if unavailable
    (no toolchain / build failed / LLM_NATIVE=0)."""
    global _lib, _lib_path, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("LLM_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = _build()
        if path is None:
            _load_failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(path))
        except OSError:
            _load_failed = True
            return None
        _lib_path = path
    return _lib


def native_available() -> bool:
    return load_native() is not None


def library_path() -> str | None:
    """The file the loaded library came from (None before a load)."""
    return _lib_path

"""Native checkpoint IO: safetensors / raw-.bin reading through the C++
loader (``csrc/weight_loader.cc``, the port's copy) — parallel pread and
threaded dtype cast and transpose.

Port of ``llm_inference_engine_tpu/runtime/native_io.py``. The
safetensors container is parsed here (8-byte little-endian header length,
JSON header, raw data section); the byte movement and numeric conversion
run in C++ worker threads, or in numpy when the native library is
unavailable. Tensors are torch tensors on the CPU. The JAX package reads
BF16 through ``ml_dtypes``; the port has no such dependency: BF16 bytes
are viewed as ``torch.bfloat16`` directly, and the pure-Python path casts
through uint16 bit patterns with the rounding (nearest even) and the NaN
rule of ``ml_dtypes``, so each path gives the JAX package's bits.

``READ_BYTES`` counts the bytes each reader moved (``"native"``: the
C++ pread; ``"python"``: the file-object fallback).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

import numpy as np
import torch

from llm_inference_engine_tpu_torch.native import dtype_code, load_native

__all__ = ["SafeTensorsFile", "read_bin_tensor", "write_safetensors",
           "cast_array", "transpose_cast", "READ_BYTES"]

_ST_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "I32": torch.int32, "I64": torch.int64,
    "U8": torch.uint8, "BOOL": torch.bool,
}

_ST_NAMES = {dt: name for name, dt in _ST_DTYPES.items()}

READ_BYTES = {"native": 0, "python": 0}


def _read_bytes(path: str, offset: int, nbytes: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nbytes`` at ``offset`` of ``path`` as a uint8 CPU tensor (the
    first ``nbytes`` of ``out`` when given: a reusable, e.g. pinned,
    staging buffer)."""
    if out is None:
        buf = torch.empty(nbytes, dtype=torch.uint8)
    else:
        if out.dtype != torch.uint8 or out.device.type != "cpu" \
                or not out.is_contiguous() or out.numel() < nbytes:
            raise ValueError(f"staging buffer too small or not a contiguous "
                             f"uint8 CPU tensor ({nbytes} bytes needed)")
        buf = out[:nbytes]
    lib = load_native()
    if lib is not None and lib.llm_read_file(
            os.fsencode(path), offset, nbytes, buf.data_ptr()) == 0:
        READ_BYTES["native"] += nbytes
        return buf
    with open(path, "rb") as f:
        f.seek(offset)
        got = f.readinto(memoryview(buf.numpy()))
    if got != nbytes:
        raise OSError(f"{path}: read {got} of {nbytes} bytes at {offset}")
    READ_BYTES["python"] += nbytes
    return buf


def _f32_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns, rounded to nearest even; a NaN becomes
    the quiet NaN of its sign (``ml_dtypes``' rule)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        out = ((bits + np.uint32(0x7FFF) + ((bits >> 16) & 1)) >> 16)
    out = out.astype(np.uint16)
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    out[nan] = ((bits[nan] >> 16) & 0x8000).astype(np.uint16) | 0x7FC0
    return out


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy; bf16 widens exactly to f32."""
    if t.dtype == torch.bfloat16:
        bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return (bits.astype(np.uint32) << 16).view(np.float32)
    return t.numpy()


def _cast_py(src: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The pure-Python cast (numpy's conversions; bf16 by bit patterns)."""
    if src.dtype == out_dtype:
        return src.contiguous()
    a = _as_numpy(src)
    if out_dtype == torch.bfloat16:
        bits = _f32_to_bf16_bits(a.astype(np.float32, copy=False))
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    np_dtype = torch.empty((), dtype=out_dtype).numpy().dtype
    out = np.ascontiguousarray(a).astype(np_dtype)
    if src.dtype == torch.bfloat16 and out_dtype == torch.float16:
        # ml_dtypes gives a bf16 NaN the quiet f16 NaN of its sign
        bits = out.view(np.uint16)
        nan = np.isnan(out)
        bits[nan] = (bits[nan] & 0x8000) | 0x7E00
    return torch.from_numpy(out)


def _codes(src: torch.Tensor, out_dtype: torch.dtype):
    try:
        return dtype_code(src.dtype), dtype_code(out_dtype)
    except ValueError:
        return None


def cast_array(src: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """dtype conversion via the threaded native caster (numpy fallback)."""
    if src.dtype == out_dtype:
        return src
    lib, codes = load_native(), _codes(src, out_dtype)
    if lib is None or codes is None or not src.is_contiguous():
        return _cast_py(src, out_dtype)
    out = torch.empty(src.shape, dtype=out_dtype)
    lib.llm_cast(src.data_ptr(), codes[0], out.data_ptr(), codes[1],
                 src.numel())
    return out


def transpose_cast(src: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[rows, cols] -> contiguous [cols, rows] with optional dtype cast —
    the HF [out, in] -> engine [in, out] canonicalization, done blocked and
    multithreaded in C++."""
    if src.dim() != 2:
        raise ValueError(f"transpose_cast takes a 2-D tensor, got "
                         f"{tuple(src.shape)}")
    out_dtype = out_dtype or src.dtype
    lib, codes = load_native(), _codes(src, out_dtype)
    if lib is None or codes is None or not src.is_contiguous():
        return _cast_py(src.T.contiguous(), out_dtype)
    rows, cols = src.shape
    out = torch.empty((cols, rows), dtype=out_dtype)
    lib.llm_transpose_cast(src.data_ptr(), codes[0], out.data_ptr(),
                           codes[1], rows, cols)
    return out


class SafeTensorsFile:
    """Minimal safetensors reader (header parsed in Python, data moved by
    the native loader). API: names, info(name) -> (dtype, shape),
    raw(name, out=None), get(name, dtype=None, transpose=False)."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            hlen = struct.unpack("<Q", head)[0] if len(head) == 8 else -1
            if not 0 < hlen <= size - 8:
                raise ValueError(f"{path}: not a safetensors file ({size} "
                                 "bytes, no valid header length)")
            header = json.loads(f.read(hlen))
        self._data_start = 8 + hlen
        self._entries: dict = {}
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            start, end = meta["data_offsets"]
            self._entries[name] = (
                _ST_DTYPES[meta["dtype"]], tuple(meta["shape"]), start, end)

    @property
    def names(self):
        return set(self._entries)

    def info(self, name: str):
        dt, shape, _, _ = self._entries[name]
        return dt, shape

    def nbytes(self, name: str) -> int:
        _, _, start, end = self._entries[name]
        return end - start

    def raw(self, name: str, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
        """The tensor as stored (its file dtype), read into ``out`` (a
        uint8 staging buffer) when given."""
        dt, shape, start, end = self._entries[name]
        buf = _read_bytes(self.path, self._data_start + start, end - start,
                          out)
        return buf.view(dt).reshape(shape)

    def get(self, name: str, dtype: Optional[torch.dtype] = None,
            transpose: bool = False) -> torch.Tensor:
        arr = self.raw(name)
        if transpose:
            return transpose_cast(arr, dtype or arr.dtype)
        if dtype is not None:
            return cast_array(arr, dtype)
        return arr


def read_bin_tensor(path: str, shape, src_dtype=torch.float32,
                    out_dtype: Optional[torch.dtype] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Read one raw little-endian tensor file (the reference's per-tensor
    .bin checkpoint format) with native IO; ``out`` as in
    :meth:`SafeTensorsFile.raw`."""
    nbytes = int(np.prod(shape)) * torch.empty((), dtype=src_dtype
                                               ).element_size()
    arr = _read_bytes(path, 0, nbytes, out).view(src_dtype).reshape(shape)
    return cast_array(arr, out_dtype) if out_dtype else arr


def write_safetensors(path: str, tensors: dict) -> int:
    """Write ``{name: tensor}`` (on any device) as one safetensors file
    (no ``safetensors`` package needed); tensors move to the host one at a
    time. Returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)         # data section 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            flat = t.detach().reshape(-1).cpu().contiguous()
            f.write(memoryview(flat.view(torch.uint8).numpy()))
    return 8 + len(head) + offset

"""Golden CPU codec: native C++ oracle with ctypes bindings.

Fills the role of the reference's `cpu_vlc_encode` golden encoder
(reference: cpuencode.cpp:13-46, cpuencode.h:4-7) — the bit-exactness oracle
the device pipeline is verified against (reference: main_test_cu.cu:122,171)
— plus the decoder the reference lacks.  The shared library is built
at first use with g++ (plain C ABI + ctypes) into _build/, a directory the
repository does not track, under a name keyed by the source's hash: a
fresh checkout builds its own, and an edited source never loads a stale
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from ..codebook import Codebook
from . import numpy_codec

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cpu_codec.cpp")
_BUILD = os.path.join(_HERE, "_build")
# Portable flags (no -march=native): the library may be built on one
# machine and loaded on another that shares the checkout.
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_BUILD, f"libhuffgolden-{key.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile to a temporary name, then rename: concurrent builders
    (test workers) never load a half-written library."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the golden codec shared library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.huff_encode_bytes.restype = ctypes.c_uint64
        lib.huff_encode_bytes.argtypes = [
            u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32), u8p]
        lib.huff_decode_bytes.restype = ctypes.c_uint64
        lib.huff_decode_bytes.argtypes = [
            u8p, ctypes.c_uint64, u8p, u8p, ctypes.c_int, u8p, ctypes.c_uint64]
        lib.byte_histogram.restype = None
        lib.byte_histogram.argtypes = [u8p, ctypes.c_uint64,
                                       ctypes.POINTER(ctypes.c_uint64)]
        _lib = lib
        return lib


def _as_u8(a) -> np.ndarray:
    if isinstance(a, (bytes, bytearray)):
        return np.frombuffer(a, dtype=np.uint8)
    return np.ascontiguousarray(a, dtype=np.uint8)


def encode(data, cb: Codebook) -> tuple[np.ndarray, int]:
    """Golden encode. Returns (packed MSB-first bytes, total_bits)."""
    arr = _as_u8(data)
    if arr.size == 0:
        return np.zeros(0, dtype=np.uint8), 0
    lib = load_library()
    max_len = max(int(cb.max_len), 1)
    out = np.zeros(arr.size * max_len // 8 + 16, dtype=np.uint8)
    codes = np.ascontiguousarray(cb.codes, dtype=np.uint32)
    lens = np.ascontiguousarray(cb.lengths, dtype=np.int32)
    total_bits = lib.huff_encode_bytes(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        arr.size,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[: (total_bits + 7) // 8].copy(), int(total_bits)


def decode(stream, n_out: int, cb: Codebook, bit_offset: int = 0) -> np.ndarray:
    """Golden decode of n_out symbols starting at bit_offset."""
    if n_out == 0:
        return np.zeros(0, dtype=np.uint8)
    lib = load_library()
    syms, lens = cb.decode_table()
    tb = max(int(cb.max_len), 1)
    s = _as_u8(stream)
    s = np.concatenate([s, np.zeros(8, dtype=np.uint8)])  # peek slack
    out = np.zeros(n_out, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    end = lib.huff_decode_bytes(
        s.ctypes.data_as(u8p), bit_offset,
        np.ascontiguousarray(syms).ctypes.data_as(u8p),
        np.ascontiguousarray(lens).ctypes.data_as(u8p),
        tb, out.ctypes.data_as(u8p), n_out)
    if end == np.iinfo(np.uint64).max:
        raise ValueError("corrupt stream (golden decoder)")
    return out


def histogram(data) -> np.ndarray:
    arr = _as_u8(data)
    lib = load_library()
    hist = np.zeros(256, dtype=np.uint64)
    lib.byte_histogram(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return hist.astype(np.int64)


__all__ = ["encode", "decode", "histogram", "load_library", "numpy_codec"]

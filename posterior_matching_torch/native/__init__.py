"""Multithreaded host batch gather (C++, loaded through ctypes).

Counterpart of ``posterior_matching_tpu/native/``: ``pm_data.cc`` (this
package's own copy) holds the three entry points ``pm_gather_rows``,
``pm_gather_u8_to_f32`` (the fused gather and rescale of an image field,
``float32(u8) * float32(scale)``) and ``pm_gather_f32``, each splitting a
batch's rows over ``THREADS`` threads. ``ArrayDataset`` assembles every
host batch through them.

The library is built with ``g++`` at first use into ``native/_build/``
(git-ignored), named by a hash of the source and flags as
``ops/_build.library_path`` names the kernels' libraries. Each process
builds into a file of its own (its pid in the name) and moves it into
place with ``os.replace``, so processes building at once all load a whole
library. A failed build or load raises with the compiler's output: no
caller falls back to numpy, whose gather (``src[indices]``) is the plain
version the tests hold these against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "pm_data.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
THREADS = min(8, os.cpu_count() or 1)

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libpm_data-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, built first where it is not there yet; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as err:
        raise RuntimeError(f"building {SRC.name} failed: {' '.join(cmd)}: {err}") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built and loaded once a process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I64 = ctypes.c_void_p, ctypes.c_int64
            for name, argtypes in (
                    ("pm_gather_rows", [P, P, P, I64, I64, ctypes.c_int]),
                    ("pm_gather_u8_to_f32", [P, P, P, I64, I64, ctypes.c_float, ctypes.c_int]),
                    ("pm_gather_f32", [P, P, P, I64, I64, ctypes.c_int])):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = None
            _lib = lib
        return _lib


def _checked(src: np.ndarray, indices, dtype=None):
    """``src`` and ``indices`` as the entry points take them: ``src`` a
    C-contiguous array of fixed-size items (of ``dtype`` where given) with
    a row axis, ``indices`` int64 rows of it; raises otherwise."""
    if not isinstance(src, np.ndarray) or src.ndim < 1 or not src.flags.c_contiguous:
        raise ValueError("the native gather takes a C-contiguous array with a row axis")
    if src.dtype.hasobject or (dtype is not None and src.dtype != dtype):
        raise TypeError(f"the native gather takes {dtype or 'fixed-size items'}, not {src.dtype}")
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if idx.ndim != 1:
        raise ValueError(f"indices must be 1-d, got shape {idx.shape}")
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"indices outside [0, {len(src)})")
    return idx, int(np.prod(src.shape[1:], dtype=np.int64))


def gather_rows(src: np.ndarray, indices) -> np.ndarray:
    """``src[indices]`` for a C-contiguous array of any fixed-size dtype."""
    idx, row_elems = _checked(src, indices)
    out = np.empty((len(idx), *src.shape[1:]), src.dtype)
    load().pm_gather_rows(src.ctypes.data, idx.ctypes.data, out.ctypes.data, len(idx),
                          row_elems * src.dtype.itemsize, THREADS)
    return out


def gather_u8_to_f32(src: np.ndarray, indices, scale: float) -> np.ndarray:
    """``src[indices].astype(np.float32) * np.float32(scale)`` for a uint8
    array, in one pass."""
    idx, row_elems = _checked(src, indices, np.uint8)
    out = np.empty((len(idx), *src.shape[1:]), np.float32)
    load().pm_gather_u8_to_f32(src.ctypes.data, idx.ctypes.data, out.ctypes.data, len(idx),
                               row_elems, ctypes.c_float(scale), THREADS)
    return out


def gather_f32(src: np.ndarray, indices) -> np.ndarray:
    """``src[indices]`` for a float32 array."""
    idx, row_elems = _checked(src, indices, np.float32)
    out = np.empty((len(idx), *src.shape[1:]), np.float32)
    load().pm_gather_f32(src.ctypes.data, idx.ctypes.data, out.ctypes.data, len(idx),
                         row_elems, THREADS)
    return out

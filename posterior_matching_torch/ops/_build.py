"""Builds and loads the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries go
into ``ops/_build/`` (git-ignored), named by a hash of the sources and flags,
so a changed source is rebuilt and an unchanged one is reused. Nothing is
built at import time: the first call of a kernel wrapper builds its library,
and :func:`build` compiles several at once, one ``nvcc`` process each.

The wrappers' shared launch helpers live here too: argument checks, the
CPU-or-CUDA dispatch test, and the error check after each launch (every C
entry point returns ``cudaGetLastError()``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

SOURCES = {
    "sampler_vrow": "sampler_vrow.cu",
    "sampler_row": "sampler_row.cu",
    "vq_search": "vq_search.cu",
    "gated_stream_fwd": "gated_stream_fwd.cu",
    "gated_stream_bwd": "gated_stream_bwd.cu",
    "gated_levels_fwd": "gated_levels_fwd.cu",
    "gated_levels_bwd": "gated_levels_bwd.cu",
    "block_chain_fwd": "block_chain_fwd.cu",
    "block_chain_bwd": "block_chain_bwd.cu",
    "decoder_chain_fwd": "decoder_chain_fwd.cu",
    "decoder_chain_bwd": "decoder_chain_bwd.cu",
}
HEADERS = ("sampler_common.cuh", "gated_common.cuh", "gated_levels.cuh",
           "block_chain_common.cuh", "decoder_chain_common.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name], *HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compiles the named kernels that are not built yet, all in parallel.
    Returns each newly built kernel's ``ptxas`` report (registers, shared
    memory, spills); raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


# ---------------------------------------------------------------------------
# Launch helpers
# ---------------------------------------------------------------------------

P = ctypes.c_void_p
I = ctypes.c_int
U32 = ctypes.c_uint32
F32 = ctypes.c_float


def load_fn(name: str, fn: str, argtypes: Sequence) -> ctypes.CDLL:
    """Loads kernel library ``name`` and declares its entry point ``fn``
    (returning a CUDA error code) and ``pm_error_string``."""
    lib = load(name)
    getattr(lib, fn).argtypes = list(argtypes)
    getattr(lib, fn).restype = I
    lib.pm_error_string.argtypes = [I]
    lib.pm_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> int:
    """Raises unless ``t`` is a contiguous ``dtype`` tensor of ``shape``;
    returns its device pointer."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


def on_cpu(tensors) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version), False when all are CUDA tensors; raises on a mix."""
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"}:
        raise ValueError(f"tensors on mixed devices: {sorted(devices)}")
    return False


def raise_on(lib, err: int, what: str):
    if err:
        msg = lib.pm_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: {msg} ({err})")

"""Where the gated chain kernels' time goes, on one CUDA device.

Builds the gated chain's libraries (``csrc/gated_stream_fwd.cu``,
``gated_stream_bwd.cu``, ``gated_levels_bwd.cu`` with ``gated_common.cuh``
and ``gated_levels.cuh``) as they are and in variants that each take one
part of the GEMM core's work away (by substitution in ``gated_common.cuh``
and ``gated_levels.cuh``),
times every build at the flagship's shapes (B*H*W = 32*16*16 rows, F = 128,
cond 512, keep 0.5, an up pass of 12 levels for the stream, a segment of 4)
with CUDA events, in turns, through the wrappers of ``ops/gated_chain.py``,
and prints one line each:

- ``kernel``: the sources as they are;
- ``one_pass``: one TF32 product per float32 product (big-big) instead of
  the 3xTF32 split's three;
- ``skeleton``: no MMAs (the operand gathers, the B ring, the barriers and
  the epilogues remain; the fragment loads and B's split go with the MMAs);
- ``no_a_loads``: A's gather reads no global memory (zeros go through its
  transform, split and store);
- ``no_b_copies``: B's ring issues no copies (the MMAs read stale stages);
- ``no_sync``: no block barrier a chunk (the warps race through the ring).

Only ``kernel`` computes the right values. ``--other NAME=DIR`` also times
the gated sources in DIR (another version of them that reads the same
``_GEOMETRY`` ints, num_filters last, e.g. a parent commit's ``ops/csrc``)
as NAME, in the same turns. Last, the rate at which the card
issues ``mma.sync`` alone (``MMA_RATE``: every warp of 264 blocks of 256
threads issuing 8 independent MMAs at a time), for m16n8k8 TF32, the core's
shape, and m16n8k16 bf16 beside it.

Usage: ``python3 -m posterior_matching_torch.ops.gated_breakdown [--other
parent=DIR] [--reps 5] [--out DIR]`` (sources, libraries and ``times.json``
go to ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict

import torch

from posterior_matching_torch.ops import _build, gated_chain as gc
from posterior_matching_torch.ops.profiling import time_ms

HEADER, LEVELS, PTX = "gated_common.cuh", "gated_levels.cuh", "ptx_mma.cuh"
FILES = (PTX, HEADER, LEVELS, "gated_stream_fwd.cu", "gated_stream_bwd.cu",
         "gated_levels_bwd.cu")
LIBS = ("gated_stream_fwd", "gated_stream_bwd", "gated_levels_bwd")
FILTERS = 128  # the flagship's num_filters, one of gc.KERNEL_WIDTHS
_MMAS = ("mma_tf32(part[mt][u], as[mt], bb[u]);", "mma_tf32(part[mt][u], ab[mt], bs[u]);",
         "mma_tf32(part[mt][u], ab[mt], bb[u]);")
# Each variant's substitutions: (file, old, new).
_PARTS = {
    "one_pass": [(HEADER, m, ";") for m in _MMAS[:2]],
    "skeleton": [(HEADER, m, ";") for m in _MMAS],
    "no_a_loads": [(HEADER, "      if (ok[h]) {\n        const int r = r0",
                    "      if (false) {\n        const int r = r0"),
                   (LEVELS, "      if (ok[h]) {\n        const size_t at = (size_t)(r + dy",
                    "      if (false) {\n        const size_t at = (size_t)(r + dy")],
    "no_b_copies": [(PTX, 'asm volatile("cp.async.cg.shared.global',
                     'if (false) asm volatile("cp.async.cg.shared.global')],
    "no_sync": [(HEADER, "    __syncthreads();   // everyone's", "    // everyone's"),
                (LEVELS, "    cp_async_wait_ring<kStages>();\n    __syncthreads();",
                 "    cp_async_wait_ring<kStages>();")],
}


# The mma.sync rate probe: each warp issues ITER rounds of 8 independent
# MMAs on register operands; pm_mma_rate times one launch of 264 blocks.
MMA_RATE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int ITER = 4096;
template <int BF16>
__global__ void probe(float* out, uint32_t seed) {
  float d[8][4] = {};
  const uint32_t a[4] = {seed, seed + 1, seed + 2, seed + 3}, b[2] = {seed * 3, seed * 5};
  for (int it = 0; it < ITER; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// The TFLOP/s of one launch (kind 0: TF32 m16n8k8, 1: bf16 m16n8k16) after
// a warm-up launch; a negative CUDA error code on failure.
extern "C" double pm_mma_rate(int kind) {
  constexpr int kBlocks = 264, kThreads = 256;
  float* out = nullptr;
  if (cudaMalloc(&out, kBlocks * kThreads * sizeof(float))) return -1.0;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (kind) probe<1><<<kBlocks, kThreads>>>(out, 7);
    else probe<0><<<kBlocks, kThreads>>>(out, 7);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  const int err = (int)cudaGetLastError();
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  if (err) return -err;
  const double flop = 2.0 * 16 * 8 * (kind ? 16 : 8) * 8 * ITER * (kBlocks * kThreads / 32);
  return flop / (ms * 1e-3) / 1e12;
}
"""


def mma_rates(out: Path) -> Dict[str, float]:
    """Builds and runs the probe: TFLOP/s of each MMA shape."""
    src, so = out / "mma_rate.cu", out / "lib" / "libmma_rate.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(MMA_RATE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.pm_mma_rate.argtypes, lib.pm_mma_rate.restype = [ctypes.c_int], ctypes.c_double
    rates = {"tf32_m16n8k8": lib.pm_mma_rate(0), "bf16_m16n8k16": lib.pm_mma_rate(1)}
    if min(rates.values()) < 0:
        raise RuntimeError(f"the mma.sync probe failed: {rates}")
    return rates


def variants(header: str, levels: str, ptx: str) -> Dict[str, Dict[str, str]]:
    """``gated_common.cuh``, ``gated_levels.cuh`` and ``ptx_mma.cuh`` as
    they are and with parts of the core taken away, by name."""
    out = {"kernel": {HEADER: header, LEVELS: levels, PTX: ptx}}
    for name, subs in _PARTS.items():
        texts = dict(out["kernel"])
        for f, old, new in subs:
            if texts[f].count(old) != 1:
                raise ValueError(f"{f} no longer has one {old!r} ({name})")
            texts[f] = texts[f].replace(old, new)
        out[name] = texts
    return out


def _build_all(dirs: Dict[str, Path], out: Path) -> Dict[str, Dict[str, ctypes.CDLL]]:
    """Compiles every library of every source directory, all at once."""
    procs = {}
    for name, src in dirs.items():
        for lib in LIBS:
            so = out / "lib" / f"lib{lib}-{name}.so"
            so.parent.mkdir(parents=True, exist_ok=True)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o", str(so),
                   str(src / _build.SOURCES[lib])]
            procs[name, lib] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), so)
    libs: Dict[str, Dict[str, ctypes.CDLL]] = {n: {} for n in dirs}
    for (name, lib), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{lib} ({name}) failed to build:\n{log}")
        libs[name][lib] = ctypes.CDLL(str(so))
    return libs


def _cases(dev):
    """The timed calls, each a function of nothing: the stream's forward
    and backward over an up pass, a segment's backward."""
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, w, f, cd, n = 32, 16, 16, FILTERS, 512, 12
    taps = gc.chain_taps()
    shapes = dict(gc.weight_shapes(f, cd, *taps, False))

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def level():
        return {k: rnd(*s, scale=s[0] ** -0.5 if len(s) == 2 else 0.05)
                for k, s in shapes.items()}

    xv0, xh0, cond = rnd(b, h, w, f), rnd(b, h, w, f), rnd(b, cd)
    stack = {k: v.contiguous() for k, v in gc.stack_levels([level() for _ in range(n)]).items()}
    cfg = gc.StreamConfig(xv0, cond, n, False, 0.5, 7, 0, taps)
    saves = gc.stream_fwd(cfg, xv0, xh0, None, cond, stack)
    saved = {"xv0": xv0, "xh0": xh0, "cond": cond, **saves}
    gv, gh = rnd(n, b * h * w, f), rnd(n, b * h * w, f)
    w_nb = {k: v for k, v in stack.items() if not k.startswith("b")}
    ws = [level() for _ in range(4)]
    scfg = gc.StreamConfig(xv0, cond, 4, False, 0.5, 7, 0, taps)
    ssaves = gc.seg_fwd(scfg, xv0, xh0, None, cond, ws)
    gs = [(rnd(b, h, w, f), rnd(b, h, w, f)) for _ in range(4)]
    return {
        "gated_stream_fwd": lambda: gc.stream_fwd(cfg, xv0, xh0, None, cond, stack),
        "gated_stream_bwd": lambda: gc.stream_bwd(cfg, gv, gh, saved, w_nb),
        "gated_segment_bwd": lambda: gc.seg_bwd(scfg, gs, xv0, xh0, cond, None, ssaves, ws),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", action="append", default=[], metavar="NAME=DIR")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out", default="chiprun_out/gated_breakdown")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gated_breakdown: no CUDA device is available", file=sys.stderr)
        return 2
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)

    dirs = {}
    for name, texts in variants(*((_build.CSRC / f).read_text()
                                  for f in (HEADER, LEVELS, PTX))).items():
        d = out / "src" / name
        d.mkdir(parents=True, exist_ok=True)
        for f in FILES:
            (d / f).write_text(texts.get(f) or (_build.CSRC / f).read_text())
        dirs[name] = d
    for spec in args.other:
        name, _, path = spec.partition("=")
        dirs[name] = Path(path).resolve()
    libs = _build_all(dirs, out)

    dev = torch.device("cuda")
    _build.build(("gated_levels_fwd",))
    for lib in LIBS:
        _build._loaded[lib] = libs["kernel"][lib]
    cases = _cases(dev)
    times = {case: {name: [] for name in libs} for case in cases}
    with torch.no_grad():
        for name in [*libs, *reversed(list(libs))]:
            for lib in LIBS:
                _build._loaded[lib] = libs[name][lib]
            for case, fn in cases.items():
                times[case][name].append(time_ms(fn, args.reps))
    for case, per in times.items():
        for name, ms in per.items():
            print(f"{case:18s} {name:10s} {' '.join(f'{t:.4f}' for t in ms)} ms/launch",
                  flush=True)
    rates = mma_rates(out)
    for shape, tflops in rates.items():
        print(f"mma.sync {shape}: {tflops:.1f} TFLOP/s", flush=True)
    (out / "times.json").write_text(json.dumps({"device": smi, "ms": times,
                                                "mma_tflops": rates}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the codebook search's time goes, on one CUDA device.

Builds ``csrc/vq_search.cu`` as it is and in variants that take one part of
its work away (by substitution in the source), and times every build, in
turns with the library's two-call yardstick, at the four shapes the port
runs the search at (latents x codes x width: the PM-VQVAE step's 8192 x
512 x 64, the CelebA stage-1 step's 16,384 x 512 x 64, MNIST's 1568 x 256 x
64 and digits16's 512 x 128 x 64; seeded normal latents and codes). One
line per (shape, build):

- ``kernel``: the source as it is;
- ``one_pass``: one TF32 product (big-big) instead of the 3xTF32 split's
  three;
- ``skeleton``: no MMAs (the staging, the ring, the norms and the argmax
  remain);
- ``no_copies``: the ring copies no codes (the MMAs read stale stages);
- ``tm128``, ``tm16``, ``full_wave``: every shape on 128-row (16-row)
  tiles, or row tiles chosen to fill a whole wave of 132 blocks instead of
  7/8 of one (all three compute the right values);
- ``library``: ``torch.addmm(-norms, z, cb.T, alpha=2)`` then ``argmax``,
  float32 with TF32 off, the norms made beforehand (two calls; the port
  never runs it).

Each line has the ms a call over back-to-back calls (CUDA events), the
device ms a call and the device kernels a call (``torch.profiler``, between
witness kernels), and the host us a call (the enqueue, from an idle
stream), in two turns, the second in reverse order. ``--other NAME=DIR``
also times the ``vq_search.cu`` in DIR (another version with the same C
entry point) as NAME. ``kernel``, the row-tile variants and an other build
are checked against the plain version.

Usage: ``python3 -m posterior_matching_torch.ops.vq_breakdown [--other
NAME=DIR] [--out DIR]`` (sources, libraries and ``times.json`` go to
``--out``, by default ``ops/_build/vq_breakdown``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch

from posterior_matching_torch.ops import _build, vq
from posterior_matching_torch.ops.profiling import host_ms, profile_calls, time_ms

SOURCE = "vq_search.cu"
SHAPES = ((8192, 512, 64), (16384, 512, 64), (1568, 256, 64), (512, 128, 64))
TURNS = 2
_MMAS = ("mma_tf32(part[mt][u], as, bb[u]);", "mma_tf32(part[mt][u], ab, bs[u]);",
         "mma_tf32(part[mt][u], ab, bb[u]);")
# Each variant's substitutions (old, new); each old string occurs once.
_PARTS = {
    "one_pass": [(m, ";") for m in _MMAS[:2]],
    "skeleton": [(m, ";") for m in _MMAS],
    "no_copies": [("    cp_async16(smem_u32(", "    if (false) cp_async16(smem_u32(")],
    "tm128": [("const int wave = PM_VQ_WAVE_BLOCKS;", "const int wave = 1;")],
    "full_wave": [("const int wave = PM_VQ_WAVE_BLOCKS;", "const int wave = 132;")],
    "tm16": [("const int wave = PM_VQ_WAVE_BLOCKS;", "const int wave = 1 << 30;")],
}
VARIANTS = ("kernel", *_PARTS)


def variants(text: str, names=VARIANTS) -> Dict[str, str]:
    """The source of each named variant; raises where a substitution does
    not find its place exactly once."""
    out = {}
    for name in names:
        src = text
        for old, new in _PARTS.get(name, ()):
            if src.count(old) != 1:
                raise ValueError(f"{name}: {old!r} occurs {src.count(old)} times")
            src = src.replace(old, new)
        out[name] = src
    return out


def measure(fn: Callable[[], object]) -> Dict[str, object]:
    """One line's numbers for ``fn``: ms a call back to back, device ms and
    kernels a call (None where the profiler measured no window), host us."""
    ms = time_ms(fn, 50, warmup=3)
    prof = profile_calls(fn, 20)
    return {"ms": ms, "device_ms": prof and prof[0], "kernels_per_call": prof and prof[1],
            "kernel_names": prof and prof[2], "host_us": host_ms(fn) * 1e3}


def library_fn(z: torch.Tensor, cb: torch.Tensor) -> Callable[[], torch.Tensor]:
    """The yardstick: two PyTorch calls (a float32 GEMM with the negative
    norms as its bias, then argmax), the norms made beforehand."""
    neg = -(cb * cb).sum(-1)
    return lambda: torch.addmm(neg, z, cb.T, alpha=2.0).argmax(dim=-1)


def _build_all(sources: Dict[str, str], out: Path) -> Dict[str, ctypes.CDLL]:
    """Compiles each source (one nvcc each, all at once); returns each
    build's library."""
    procs = {}
    for name, text in sources.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(text)
        lib = d / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            # the repo's csrc after d: the PTX helpers' header
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-I", str(_build.CSRC), "-o",
             str(lib), str(d / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        cdll = ctypes.CDLL(str(lib))
        P, I = _build.P, _build.I
        cdll.pm_vq_search.argtypes = [P] * 3 + [I] * 3 + [P]
        cdll.pm_vq_search.restype = I
        libs[name] = cdll
    return libs


def _call(lib: ctypes.CDLL, z: torch.Tensor, cb: torch.Tensor):
    """``fn`` running a build as the wrapper does."""
    n, d = z.shape
    k = cb.shape[0]

    def fn():
        out = torch.empty(n, dtype=torch.int32, device=z.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pm_vq_search(z.data_ptr(), cb.data_ptr(), out.data_ptr(), n, k, d, stream)
        if err:
            raise RuntimeError(f"vq_search launch failed ({err})")
        return out

    return fn


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", action="append", default=[],
                        help="NAME=DIR: time DIR's vq_search.cu too")
    parser.add_argument("--out", default=str(_build.BUILD_DIR / "vq_breakdown"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("vq_breakdown: no CUDA device is available", file=sys.stderr)
        return 2
    out = Path(args.out)
    sources = variants((_build.CSRC / SOURCE).read_text())
    for spec in args.other:
        name, d = spec.split("=", 1)
        sources[name] = (Path(d) / SOURCE).read_text()
    t0 = time.perf_counter()
    libs = _build_all(sources, out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s; {smi}; "
          f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {shape: (torch.randn(shape[0], shape[2], generator=gen, device=dev),
                     torch.randn(shape[1], shape[2], generator=gen, device=dev))
             for shape in SHAPES}
    for shape, (z, cb) in cases.items():
        want = vq.nearest_codebook_indices_plain(z, cb)
        for name, lib in libs.items():
            if name in ("one_pass", "skeleton", "no_copies"):
                continue
            agree = (_call(lib, z, cb)() == want).float().mean().item()
            print(f"{shape} {name}: agrees with the plain version on {agree:.6f}", flush=True)
            if agree < 0.999:
                raise AssertionError(f"{name} disagrees at {shape}")
    order: List[str] = [*libs, "library"]
    results: Dict[str, list] = {}
    for turn in range(TURNS):
        for name in (order if turn % 2 == 0 else order[::-1]):
            for shape, (z, cb) in cases.items():
                fn = library_fn(z, cb) if name == "library" else _call(libs[name], z, cb)
                r = measure(fn)
                key = f"{shape[0]}x{shape[1]}x{shape[2]} {name}"
                results.setdefault(key, []).append(r)
                dms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.5f}"
                print(f"turn {turn} {key}: {r['ms']:.5f} ms/call, device {dms} ms/call in "
                      f"{r['kernels_per_call']} kernels, host {r['host_us']:.2f} us/call",
                      flush=True)
    (out / "times.json").write_text(json.dumps({"nvidia_smi": smi, "results": results},
                                               indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the row sampler kernels' time goes, on one CUDA device.

Builds ``csrc/sampler_row.cu`` (``--kernel row``, the default) or
``csrc/sampler_vrow.cu`` (``--kernel vrow``) as it is and in variants that
each take one part of its work away (by substitution in the source and in
the ``sampler_common.cuh`` beside it), times every build at the imputation
path's shapes (n = 320, W = 16, F = 128, L = 24, K = 512) with CUDA events,
in turns, and prints one line each:

- ``kernel``: the source as it is;
- ``no_copy``: the producer completes each stage without copying (the
  products run on stale weights);
- ``no_fma``: the products' inner loop removed (the stream, the operand
  builds, the epilogues and the handshakes remain);
- ``skeleton``: neither: operand builds, epilogues, barriers and the ring's
  handshakes;
- ``no_ring``: the skeleton without the ring's handshakes or producer (the
  vrow kernel's warps refill the ring themselves);
- a ring of other slots: for the row kernel ``ring_5x32k``, five 32 KB
  slots instead of two of 64 KB (each warp taking 8 rows of every stage);
  for the vrow kernel ``ring_6x16k``, six 16 KB slots instead of three of
  32 KB (8 rows a warp).

Only ``kernel`` and the ring variant compute the right values; both are held
against the plain version. ``--other NAME=DIR`` also times the kernel source
in DIR (another version of it with the same entry point, which takes F
and the dtype int after the shape ints, and lpg after them in the row
kernel, e.g. a parent commit's; its ``sampler_common.cuh`` beside it) as
NAME, in the same turns. Every build is the float32 one.

Usage: ``python3 -m posterior_matching_torch.ops.row_breakdown [--kernel
row|vrow] [--other parent=DIR] [--out DIR]`` (sources, libraries and
``times.json`` go to ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, Tuple

import torch

from posterior_matching_torch.ops import _build, sampler_chain as sc
from posterior_matching_torch.ops.profiling import time_ms

HEADER = "sampler_common.cuh"
# The bulk copy in sampler_common.cuh; a stage's arming for its bytes is
# each kernel's "arm".
_BULK = """  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
"""

# Each kernel's source, the inner loop of its products, the substitutions
# that take its ring away (the row kernel's producer, waits and releases;
# the vrow kernel's waits and refills, which its warps issue themselves),
# and a ring of other slots (name, substitutions).
KERNELS = {
    "row": {
        "source": "sampler_row.cu",
        "fma": ("for (int r = 0; r < kGroupRows; ++r) {", "for (int r = 0; r < 0; ++r) {"),
        "arm": (("    mbar_expect_tx(bar, count * sizeof(cdt));\n", "    mbar_arrive(bar);\n"),
                ("        mbar_expect_tx(bar, rows * NC * sizeof(cdt));\n",
                 "        mbar_arrive(bar);\n")),
        "no_ring": (("    if (tid == kConsumers) produce(p, ring, per_pixel, W * per_pixel);\n",
                     ""),
                    ("    mbar_wait(ring.full_bar(next), (next / kStages) & 1);\n", ""),
                    ("    if (threadIdx.x % 32 == 0) mbar_arrive(ring.empty_bar(next));\n", "")),
        "ring": ("ring_5x32k", (("int kStage = 128 * F;", "int kStage = 64 * F;"),
                                ("constexpr int kStages = 2;", "constexpr int kStages = 5;"))),
    },
    "vrow": {
        "source": "sampler_vrow.cu",
        "fma": ("for (int k4 = 0; k4 < kWarpK; k4 += 4) {", "for (int k4 = 0; k4 < 0; k4 += 4) {"),
        "arm": (("      mbar_expect_tx(bar, s.count * sizeof(cdt));\n", "      mbar_arrive(bar);\n"),),
        "no_ring": (("    mbar_wait(smem_u32(full + next % kStages), (next / kStages) & 1);\n", ""),
                    ("      if (atomicAdd(done + next % kStages, 1) == kWarps - 1) {",
                     "      if (false) {"),
                    ("    for (int g = 0; g < kStages; ++g) stream.issue(g);\n", "")),
        "ring": ("ring_6x16k", (("int kStage = 64 * F;", "int kStage = 32 * F;"),
                                ("constexpr int kStages = 3;", "constexpr int kStages = 6;"),
                                ("constexpr int kWarpK = 16 * kCdtPerFloat;",
                                 "constexpr int kWarpK = 8 * kCdtPerFloat;"))),
    },
}
REPS = 10  # launches a timing
FILTERS = 128  # the flagship's num_filters, one of sc.KERNEL_WIDTHS


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"the source no longer has {old.strip()!r}")
    return src.replace(old, new)


def _subs(src: str, pairs) -> str:
    for old, new in pairs:
        src = _sub(src, old, new)
    return src


def variants(src: str, header: str, kernel: str = "row") -> Dict[str, Tuple[str, str]]:
    """The kernel's source and header and their variants, by name."""
    k = KERNELS[kernel]
    no_fma = _sub(src, *k["fma"])
    no_copy_h = _sub(header, _BULK, "")
    ring_name, ring_subs = k["ring"]
    return {
        "kernel": (src, header),
        "no_copy": (_subs(src, k["arm"]), no_copy_h),
        "no_fma": (no_fma, header),
        "skeleton": (_subs(no_fma, k["arm"]), no_copy_h),
        "no_ring": (_subs(no_fma, k["no_ring"]), header),
        ring_name: (_subs(src, ring_subs), header),
    }


def _build_all(kernel: str, sources: Dict[str, Path], out: Path) -> Dict[str, ctypes.CDLL]:
    stem = KERNELS[kernel]["source"].removesuffix(".cu")
    nptr, nint = (20, 7) if kernel == "row" else (19, 5)
    procs = {}
    for name, path in sources.items():
        lib = out / f"lib{stem}_{name}.so"
        # the repo's csrc after the source's own: the PTX helpers' header
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(path.parent), "-I",
               str(_build.CSRC), "-o", str(lib), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: {' | '.join(regs)}", flush=True)
        cdll = ctypes.CDLL(str(lib))
        entry = getattr(cdll, f"pm_{stem}")
        entry.argtypes = [_build.P] * nptr + [_build.I] * nint + [_build.P]
        entry.restype = _build.I
        cdll.pm_error_string.argtypes = [_build.I]
        cdll.pm_error_string.restype = ctypes.c_char_p
        libs[name] = cdll
    return libs


def _row_case(dev, gen):
    """The row kernel's inputs, outputs, a launch of library ``lib`` and its
    check against ``row_plain``."""
    f, n_lvl, wid, n, k = FILTERS, 24, 16, 320, 512

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).contiguous()

    s = 0.05
    ins = (rnd(n_lvl, 12 * f, f, scale=s), rnd(n_lvl, f, scale=s),
           rnd(n_lvl, 8 * f, 2 * f, scale=s), rnd(n_lvl, 2 * f, scale=s),
           rnd(n_lvl, n, 2 * f), rnd(n_lvl, wid, n, f), rnd(n_lvl, wid, n, 2 * f),
           rnd(n_lvl, wid, n, f), rnd(wid, n, f), rnd(wid, n, f),
           sc.gumbel_noise((wid, n, k), gen, dev), rnd(k, f, scale=s), rnd(f, k, scale=s),
           rnd(k, scale=s), rnd(2 * f, f, scale=s), rnd(f, scale=s))
    outh, outm = torch.empty_like(ins[5]), torch.empty_like(ins[6])
    outs = torch.empty(wid, n, dtype=torch.int32, device=dev)
    outl = torch.empty(wid, n, k, device=dev)

    def launch(lib):
        return lib.pm_sampler_row(*[t.data_ptr() for t in ins], outh.data_ptr(),
                                  outm.data_ptr(), outs.data_ptr(), outl.data_ptr(),
                                  n_lvl, wid, n, k, f, 0, 1,
                                  torch.cuda.current_stream().cuda_stream)

    want = sc.row_plain(*ins, with_logits=True)

    def check(name):
        agree = (outs == want[2]).float().mean().item()
        print(f"{name} vs row_plain: samples agree on {agree:.6f}", flush=True)
        return agree >= 0.999

    return launch, check


def _vrow_case(dev, gen):
    """As _row_case for the vrow kernel, with weights at 1 / sqrt(fan-in)."""
    f, n_lvl, wid, n = FILTERS, 24, 16, 320

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).contiguous()

    ins = (rnd(wid, n, f), rnd(wid, n, f), rnd(wid, n, f), rnd(n_lvl, wid, n, f),
           rnd(n_lvl, wid, n, 2 * f), rnd(n_lvl, n, 2 * f),
           rnd(6 * f, f, scale=(6 * f) ** -0.5), rnd(f, scale=0.05),
           rnd(3 * f, f, scale=(3 * f) ** -0.5), rnd(f, scale=0.05),
           rnd(n_lvl, 12 * f, f, scale=(12 * f) ** -0.5), rnd(n_lvl, f, scale=0.05),
           rnd(n_lvl, 12 * f, 2 * f, scale=(12 * f) ** -0.5), rnd(n_lvl, 2 * f, scale=0.05),
           rnd(n_lvl, 2 * f, f, scale=(2 * f) ** -0.5))
    outs = (torch.empty_like(ins[3]), torch.empty_like(ins[4]), torch.empty_like(ins[1]),
            torch.empty_like(ins[1]))

    def launch(lib):
        return lib.pm_sampler_vrow(*[t.data_ptr() for t in (*ins, *outs)], n_lvl, wid, n, f, 0,
                                   torch.cuda.current_stream().cuda_stream)

    want = sc.vrow_plain(*ins)

    def check(name):
        rel = max((o - w).abs().max().item() / max(1.0, w.abs().max().item())
                  for o, w in zip(outs, want))
        print(f"{name} vs vrow_plain: max error relative to scale {rel:.3e}", flush=True)
        return rel <= 1e-4

    return launch, check


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=tuple(KERNELS), default="row")
    parser.add_argument("--other", action="append", default=[], metavar="NAME=DIR")
    parser.add_argument("--out", default="chiprun_out/row_breakdown")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("row_breakdown: no CUDA device is available", file=sys.stderr)
        return 2
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)

    source = KERNELS[args.kernel]["source"]
    sources = {}
    for name, (text, header) in variants((_build.CSRC / source).read_text(),
                                         (_build.CSRC / HEADER).read_text(),
                                         args.kernel).items():
        src_dir = out / "src" / name
        src_dir.mkdir(parents=True, exist_ok=True)
        (src_dir / HEADER).write_text(header)
        sources[name] = src_dir / source
        sources[name].write_text(text)
    for spec in args.other:
        name, _, path = spec.partition("=")
        sources[name] = Path(path).resolve() / source
    libs = _build_all(args.kernel, sources, out)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    launch_with, check = (_row_case if args.kernel == "row" else _vrow_case)(dev, gen)

    def launch(lib):
        err = launch_with(lib)
        if err:
            raise RuntimeError(f"launch failed: {lib.pm_error_string(err).decode()} ({err})")

    ring_name = KERNELS[args.kernel]["ring"][0]
    for name in ("kernel", ring_name, *(o.partition("=")[0] for o in args.other)):
        launch(libs[name])
        torch.cuda.synchronize()
        if not check(name) and name in ("kernel", ring_name):
            raise AssertionError(f"{name} disagrees with the plain version")

    times = {name: [] for name in libs}
    for name in [*libs, *reversed(list(libs))]:
        times[name].append(time_ms(lambda: launch(libs[name]), REPS))
    for name, ms in times.items():
        print(f"{name:12s} {' '.join(f'{t:.4f}' for t in ms)} ms/launch", flush=True)
    (out / "times.json").write_text(json.dumps({"device": smi, "kernel": args.kernel,
                                                "ms": times}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

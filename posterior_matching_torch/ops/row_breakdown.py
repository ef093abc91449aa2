"""Where the row sampler kernel's time goes, on one CUDA device.

Builds ``csrc/sampler_row.cu`` as it is and in variants that each take one
part of its work away (by substitution in the source), times every build at
the imputation path's shapes (n = 320, W = 16, F = 128, L = 24, K = 512)
with CUDA events, in turns, and prints one line each:

- ``kernel``: the source as it is;
- ``no_copy``: the producer completes each stage without copying (the
  products run on stale weights);
- ``no_fma``: the products' inner loop removed (the stream, the gathers,
  the epilogues and the handshakes remain);
- ``skeleton``: neither: gathers, epilogues, barriers and the ring's
  handshakes;
- ``no_ring``: the skeleton without the ring's handshakes or producer;
- ``ring_5x32k``: the ring as five 32 KB slots instead of two of 64 KB
  (twice the stages, each warp taking 8 rows of every one).

Only ``kernel`` and ``ring_5x32k`` compute the right values; both are held
against ``row_plain``. ``--other NAME=DIR`` also times the ``sampler_row.cu``
in DIR (another version of the kernel, e.g. a parent commit's; its
``sampler_common.cuh`` beside it) as NAME, in the same turns.

Usage: ``python3 -m posterior_matching_torch.ops.row_breakdown [--other
parent=DIR] [--out chiprun_out/row_breakdown]``.
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

from posterior_matching_torch.ops import _build, sampler_chain as sc

_FMA_LOOP = "for (int r = 0; r < kWarpRows; ++r) {"
_COPY = "    mbar_expect_tx(bar, kStage * sizeof(float));\n"
_TAKE_WAIT = "    mbar_wait(ring.full_bar(next), (next / kStages) & 1);\n"
_RELEASE = "    if (threadIdx.x % 32 == 0) mbar_arrive(ring.empty_bar(next));\n"
_PRODUCE = "    if (tid == kConsumers) produce(p, ring, per_pixel, W * per_pixel);\n"
_STAGE = "constexpr int kStage = 16384;"
_STAGES = "constexpr int kStages = 2;"
REPS = 10  # launches a timing


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"sampler_row.cu no longer has {old.strip()!r}")
    return src.replace(old, new)


def variants(src: str) -> Dict[str, str]:
    """The kernel's source and its variants, by name."""
    no_fma = _sub(src, _FMA_LOOP, "for (int r = 0; r < 0; ++r) {")
    skeleton = _sub(no_fma, _COPY, "    mbar_arrive(bar);\n    continue;\n")
    no_ring = _sub(_sub(_sub(no_fma, _TAKE_WAIT, ""), _RELEASE, ""), _PRODUCE, "")
    return {
        "kernel": src,
        "no_copy": _sub(src, _COPY, "    mbar_arrive(bar);\n    continue;\n"),
        "no_fma": no_fma,
        "skeleton": skeleton,
        "no_ring": no_ring,
        "ring_5x32k": _sub(_sub(src, _STAGE, "constexpr int kStage = 8192;"),
                           _STAGES, "constexpr int kStages = 5;"),
    }


def _build_all(sources: Dict[str, Path], out: Path) -> Dict[str, ctypes.CDLL]:
    procs = {}
    for name, path in sources.items():
        lib = out / f"libsampler_row_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(path.parent), "-o", str(lib),
               str(path)]
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
        cdll.pm_sampler_row.argtypes = [_build.P] * 20 + [_build.I] * 4 + [_build.P]
        cdll.pm_sampler_row.restype = _build.I
        cdll.pm_error_string.argtypes = [_build.I]
        cdll.pm_error_string.restype = ctypes.c_char_p
        libs[name] = cdll
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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

    src_dir = out / "src"
    src_dir.mkdir(exist_ok=True)
    (src_dir / "sampler_common.cuh").write_bytes((_build.CSRC / "sampler_common.cuh").read_bytes())
    sources = {}
    for name, text in variants((_build.CSRC / "sampler_row.cu").read_text()).items():
        sources[name] = src_dir / f"sampler_row_{name}.cu"
        sources[name].write_text(text)
    for spec in args.other:
        name, _, path = spec.partition("=")
        sources[name] = Path(path).resolve() / "sampler_row.cu"
    libs = _build_all(sources, out)

    f, n_lvl, wid, n, k = sc.KERNEL_FILTERS, 24, 16, 320, 512
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

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
        err = lib.pm_sampler_row(*[t.data_ptr() for t in ins], outh.data_ptr(),
                                 outm.data_ptr(), outs.data_ptr(), outl.data_ptr(),
                                 n_lvl, wid, n, k, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {lib.pm_error_string(err).decode()} ({err})")

    want = sc.row_plain(*ins, with_logits=True)
    for name in ("kernel", "ring_5x32k", *(o.partition("=")[0] for o in args.other)):
        launch(libs[name])
        torch.cuda.synchronize()
        agree = (outs == want[2]).float().mean().item()
        print(f"{name} vs row_plain: samples agree on {agree:.6f}", flush=True)
        if name in ("kernel", "ring_5x32k") and agree < 0.999:
            raise AssertionError(f"{name} disagrees with row_plain")

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = {name: [] for name in libs}
    for name in [*libs, *reversed(list(libs))]:
        launch(libs[name])
        start.record()
        for _ in range(REPS):
            launch(libs[name])
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / REPS)
    for name, ms in times.items():
        print(f"{name:12s} {' '.join(f'{t:.4f}' for t in ms)} ms/launch", flush=True)
    (out / "times.json").write_text(json.dumps({"device": smi, "ms": times}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the VDVAE chain kernels' time goes, on one CUDA device.

Both chains run on one GEMM core (``csrc/vdvae_gemm.cuh``). For the chain
``--chain`` names, this builds its two libraries (the decoder's
``csrc/decoder_chain_fwd.cu`` and ``decoder_chain_bwd.cu``, or the
encoder's ``csrc/block_chain_fwd.cu`` and ``block_chain_bwd.cu``, with their
headers) as they are and in variants that each take one part of the work
away (by substitution in the sources), times every build in turns with CUDA
events through the wrappers of ``ops/decoder_chain.py`` (``ops/
block_chain.py``) at the five runs of a PM-VDVAE MNIST training batch (16
images, width 192, mid 48; the decoder's fused runs at res 1, 3, 7, 14, 28
with 2, 3, 3, 5, 7 levels and latent 16, the encoder's at res 28, 14, 7, 3,
1 with 6, 4, 2, 2, 2 levels; weights at 1 / sqrt(fan-in) from a seed), and
prints one line per (kind, run, build):

- ``kernel``: the sources as they are;
- ``one_pass``: one TF32 product per float32 product (big-big) instead of
  the 3xTF32 split's three;
- ``skeleton``: no MMAs (the operand gathers, the B ring, the barriers and
  the epilogues remain);
- ``no_a_loads``: the A gathers read no global memory (zeros go through
  gelu, the split and the stores);
- ``no_b_copies``: B's rings copy nothing (the MMAs read stale stages);
- ``no_sync``: no block barrier a chunk (the warps race through the rings);
- ``no_gelu``: the operands' gelu skipped (the products see the raw
  sources);
- ``tm64``, ``tm16``: every data product on row tiles of 64 (16) rows,
  whatever the run (both compute the right values);
- ``bwd_data``: the backward's data-gradient part alone (no weight or bias
  gradients);
- ``bwd_wgrad``: the backward's weight- and bias-gradient part alone (no
  level loop: it reads whatever the scratch holds).

Only ``kernel`` computes the right values. ``--other NAME=DIR`` also times
the chain's sources in DIR (another version of ``ops/csrc``, e.g. a parent
commit's) as NAME in the same turns; ``--only`` restricts the variants
(``--only kernel`` times the sources as they are and the others, whatever
their design). Each build that is timed whole (``kernel`` and the others)
is also profiled once per run: device ms by part (data products, weight
gradients, bias sums and reductions, z steps, copies), CUDA kernel launches
a level, each kernel's device ms in launch order (``times.json``), and the
TFLOP/s of float32 work (the run's operations, ``decoder_chain.chain_flops``
or ``block_chain.chain_flops``, over the timed ms).

Usage: ``python3 -m posterior_matching_torch.ops.decoder_breakdown [--chain
decoder|block] [--other parent=DIR] [--only kernel,one_pass] [--reps 5]
[--out DIR]`` (sources, libraries and ``times.json`` go to ``--out``, by
default ``ops/_build/{decoder,block}_breakdown``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import torch

from posterior_matching_torch.ops import _build, block_chain as bc, decoder_chain as dc
from posterior_matching_torch.ops.profiling import time_ms

CORE, FWD, BWD = "vdvae_gemm.cuh", "decoder_chain_fwd.cu", "decoder_chain_bwd.cu"
PTX = "ptx_mma.cuh"  # the PTX helpers the core includes (an older design has none)
# the decoder's sources; a version may lack some (an older design has no
# core header and includes block_chain_common.cuh)
FILES = (PTX, CORE, "block_chain_common.cuh", "decoder_chain_common.cuh", FWD, BWD)
# the block chain's: the core (an older design had none) and its own
BLOCK_FILES = (PTX, CORE, "block_chain_common.cuh", "block_chain_fwd.cu",
               "block_chain_bwd.cu")
_MMAS = ("mma_tf32(part[u], as, bb[u]);", "mma_tf32(part[u], ab, bs[u]);",
         "mma_tf32(part[u], ab, bb[u]);")
# Each variant's substitutions: (file, old, new[, n]); each old string
# occurs exactly n times (default once) in its file. The MMAs and the gelu
# of a weight gradient's source occur in wgrad and in wgrad_taps.
_PARTS = {
    "one_pass": [(CORE, m, ";", 2) for m in _MMAS[:2]],
    "skeleton": [(CORE, m, ";", 2) for m in _MMAS],
    "no_a_loads": [(CORE, "if (ok && v < lim) x = ldg4(", "if (false) x = ldg4("),
                   (CORE, "if (ok && lim > 0)", "if (false)"),
                   (CORE, "if (ok) a = src_at(", "if (false) a = src_at("),
                   (CORE, "va[v] = ok ? src_at(", "va[v] = false ? src_at(")],
    "no_b_copies": [(PTX, 'asm volatile("cp.async.cg.shared.global',
                     'if (false) asm volatile("cp.async.cg.shared.global')],
    "no_sync": [(CORE, "__syncthreads();  // chunk c's B stage and slab", "// chunk c's B stage"),
                (CORE, "__syncthreads();  // chunk c's B stage and A", "// chunk c's B stage"),
                (CORE, "__syncthreads();  // chunk c's cotangent stage", "// chunk c's stage")],
    "no_gelu": [(CORE, "if (t.gelu)", "if (false)"), (CORE, "if (J.gelu)", "if (false)", 2)],
    "tm64": [(CORE, "if (tiles64 * nj >= kWaveBlocks)", "if (true)")],
    "tm16": [(CORE, "if (tiles64 * nj >= kWaveBlocks)", "if (false)"),
             (CORE, "else if (tiles32 * nj >= kWaveBlocks)", "else if (false)")],
    "bwd_data": [(BWD, "  // ---- weight gradients", "  return (int)cudaGetLastError();\n  //")],
    "bwd_wgrad": [(BWD, "  for (int l = L - 1; l >= 0; --l) {",
                   "  for (int l = -1; l >= 0; --l) {")],
}
VARIANTS = ("kernel", *_PARTS)
# The PM-VDVAE MNIST decoder's fused runs at batch 16: (res, levels, k) ...
RUNS = ((1, 2, 1), (3, 3, 3), (7, 3, 3), (14, 5, 3), (28, 7, 3))
# ... and its encoder's runs (encoder_blocks "28x6,...,14x4,...,7x2,...,3x2,...,1x2").
BLOCK_RUNS = ((28, 6, 3), (14, 4, 3), (7, 2, 3), (3, 2, 3), (1, 2, 1))
BATCH, WIDTH, MID, LD = 16, 192, 48, 16


class Chain(NamedTuple):
    """A chain's sources (``files``: all it may include; ``fwd``, ``bwd``:
    its two entry points' files) and its libraries."""
    files: Tuple[str, ...]
    fwd: str
    bwd: str
    libs: Tuple[str, str]


CHAINS = {
    "decoder": Chain(FILES, FWD, BWD, ("decoder_chain_fwd", "decoder_chain_bwd")),
    "block": Chain(BLOCK_FILES, "block_chain_fwd.cu", "block_chain_bwd.cu",
                   ("block_chain_fwd", "block_chain_bwd")),
}
# device-time parts of a run, by kernel name (either design's)
PARTS = (("data products", ("chain_gemm", "dgemm")),
         ("weight gradients", ("wgrad",)),
         ("bias sums and reductions", ("bias_grad", "reduce_splits", "bias_sums",
                                       "reduce_parts")),
         ("z steps", ("z_into_state", "z_bwd")),
         ("copies", ("emcpy",)))


def variants(texts: Dict[str, str], names=VARIANTS,
             chain: str = "decoder") -> Dict[str, Dict[str, str]]:
    """The sources (by file name) of ``chain`` as they are and with parts
    taken away, for each of ``names``."""
    out = {}
    for name in names:
        new = dict(texts)
        for f, old, rep, *n in _PARTS.get(name, ()):
            f = CHAINS[chain].bwd if f == BWD else f
            if new[f].count(old) != (n[0] if n else 1):
                raise ValueError(f"{f} no longer has {n[0] if n else 1} of {old!r} ({name})")
            new[f] = new[f].replace(old, rep)
        out[name] = new
    return out


def _block_cases(dev):
    """The block chain's :func:`_cases`."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for res, n_lvl, k in BLOCK_RUNS:
        rows = BATCH * res * res
        x = torch.randn(BATCH, res, res, WIDTH, generator=gen, device=dev)
        cfg = bc.ChainConfig(x, n_lvl, MID, k)
        x0 = x.reshape(rows, WIDTH)
        w = {n: torch.randn((n_lvl, *s), generator=gen, device=dev) * s[0] ** -0.5
             for n, s in bc.weight_shapes(WIDTH, MID, k)}
        g = torch.randn(rows, WIDTH, generator=gen, device=dev)
        wk = {n: w[n] for n in ("w1", "w2", "w3", "w4")}
        holder = {}

        def fwd(cfg=cfg, x0=x0, w=w, holder=holder):
            holder["out"] = bc.chain_fwd(cfg, x0, w)

        def bwd(cfg=cfg, x0=x0, g=g, wk=wk, holder=holder):
            bc.chain_bwd(cfg, g, {"x0": x0, **holder["out"]}, wk)

        flops = bc.chain_flops(BATCH, res, res, WIDTH, MID, k, n_lvl)
        cases[f"fwd res {res}"] = (fwd, n_lvl, flops)
        cases[f"bwd res {res}"] = (bwd, n_lvl, 2 * flops)
    return cases


def _cases(dev):
    """Per run of the decoder: the forward and the backward call (functions
    of nothing), its levels and its operations."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    cases = {}
    for res, n_lvl, k in RUNS:
        rows = BATCH * res * res
        shape = (BATCH, res, res, WIDTH)
        x0, acts, macts = (rnd(*shape) for _ in range(3))
        cfg = dc.DecConfig(x0, acts, n_lvl, MID, LD, k)
        ins = {"x0": x0.reshape(rows, WIDTH), "acts": acts.reshape(rows, WIDTH),
               "macts": macts.reshape(rows, WIDTH), "eps": rnd(n_lvl, rows, LD)}
        ins.update({n: rnd(n_lvl, *s, scale=s[0] ** -0.5)
                    for n, s in dc.weight_shapes(WIDTH, WIDTH, MID, LD, k)})
        shapes = cfg.shapes()
        cots = {"g": rnd(*shapes["x0"]), "gpost": rnd(*shapes["post"]),
                "gprior": rnd(*shapes["prior"]), "gmask": rnd(*shapes["masked"])}
        w = {n: ins[n] for n in dc.NAMES}
        holder = {}

        def fwd(cfg=cfg, ins=ins, holder=holder):
            holder["out"] = dc.dec_fwd(cfg, ins)

        def bwd(cfg=cfg, ins=ins, holder=holder, cots=cots, w=w):
            saved = {n: {**ins, **holder["out"]}[n] for n in dc._SAVED}
            dc.dec_bwd(cfg, cots, saved, w)

        flops = dc.chain_flops(BATCH, res, res, WIDTH, MID, LD, k, n_lvl)
        cases[f"fwd res {res}"] = (fwd, n_lvl, flops)
        cases[f"bwd res {res}"] = (bwd, n_lvl, dc.bwd_flops(flops, rows, WIDTH, MID, n_lvl))
    return cases


def profile_parts(fn) -> Dict[str, float]:
    """``fn()`` under ``torch.profiler``: device ms by part, and the CUDA
    kernel launches (``launches``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {part: 0.0 for part, _ in PARTS}
    out["other"], out["launches"] = 0.0, 0
    for e in kernels:
        part = next((p for p, marks in PARTS if any(m in e.name for m in marks)), "other")
        out[part] += e.time_range.elapsed_us() / 1e3
        out["launches"] += "emcpy" not in e.name
    out["sequence"] = [(e.name[:60], e.time_range.elapsed_us() / 1e3)
                       for e in sorted(kernels, key=lambda e: e.time_range.start)]
    return out


def _sources(names: List[str], others: Dict[str, Path], out: Path,
             chain: str) -> Dict[str, Path]:
    """A directory of ``chain``'s sources per build: the variants written
    under ``out``, the others as given."""
    ch = CHAINS[chain]
    texts = {f: (_build.CSRC / f).read_text() for f in ch.files if (_build.CSRC / f).exists()}
    dirs = {}
    for name, new in variants(texts, names, chain).items():
        d = out / "src" / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in new.items():
            (d / f).write_text(text)
        dirs[name] = d
    for name, path in others.items():
        if not all((path / f).exists() for f in (ch.fwd, ch.bwd)):
            raise FileNotFoundError(f"{path} lacks {ch.fwd} or {ch.bwd}")
        dirs[name] = path
    return dirs


def _build_all(dirs: Dict[str, Path], out: Path, libs_of: Tuple[str, str]):
    """Compiles both libraries ``libs_of`` of every source directory, all
    at once."""
    procs = {}
    for name, src in dirs.items():
        for lib in libs_of:
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", choices=tuple(CHAINS), default="decoder")
    parser.add_argument("--other", action="append", default=[], metavar="NAME=DIR")
    parser.add_argument("--only", default=",".join(VARIANTS))
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decoder_breakdown: no CUDA device is available", file=sys.stderr)
        return 2
    names = [n for n in args.only.split(",") if n]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}")
    out = Path(args.out or _build.BUILD_DIR / f"{args.chain}_breakdown").resolve()
    out.mkdir(parents=True, exist_ok=True)
    ch = CHAINS[args.chain]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)

    others = {}
    for spec in args.other:
        name, _, path = spec.partition("=")
        others[name] = Path(path).resolve()
    dirs = _sources(names, others, out, args.chain)
    libs = _build_all(dirs, out, ch.libs)
    first = next(iter(libs))

    dev = torch.device("cuda")
    for lib in ch.libs:
        _build._loaded[lib] = libs[first][lib]
    cases = (_block_cases if args.chain == "block" else _cases)(dev)
    times = {case: {name: [] for name in libs} for case in cases}
    with torch.no_grad():
        # the first build warms the card (clocks, caches) before the turns
        for fn, _, _ in cases.values():
            for _ in range(args.reps):
                fn()
        torch.cuda.synchronize()
        # every build's forward first: the backwards read its saves
        for name in [*libs, *reversed(list(libs))]:
            for lib in ch.libs:
                _build._loaded[lib] = libs[name][lib]
            for case, (fn, _, _) in cases.items():
                times[case][name].append(time_ms(fn, args.reps))
        whole = [n for n in libs if n == "kernel" or n in others]
        parts = {case: {} for case in cases}
        for name in whole:
            for lib in ch.libs:
                _build._loaded[lib] = libs[name][lib]
            for case, (fn, _, _) in cases.items():
                parts[case][name] = profile_parts(fn)
    for case, per in times.items():
        _, n_lvl, flops = cases[case]
        for name, ms in per.items():
            mean = sum(ms) / len(ms)
            line = (f"{case:11s} {name:11s} {' '.join(f'{t:.4f}' for t in ms)} ms/launch, "
                    f"{flops / (mean * 1e-3) / 1e12:.2f} TFLOP/s of float32 work")
            p = parts[case].get(name)
            if p:
                line += (f"; {p['launches'] / n_lvl:.1f} launches a level; device ms: " +
                         ", ".join(f"{part} {p[part]:.4f}" for part, _ in PARTS)
                         + f", other {p['other']:.4f}; the first level's launches (ms): "
                         + " ".join(f"{ms:.4f}" for _, ms in
                                    p["sequence"][:round(p["launches"] / n_lvl)]))
            print(line, flush=True)
    for name in libs:
        for kind in ("fwd", "bwd"):
            mean = [sum(v[name]) / len(v[name]) for c, v in times.items() if c.startswith(kind)]
            print(f"{name:11s} {kind} mean over the five runs: {sum(mean) / len(mean):.4f} "
                  f"ms/launch", flush=True)
    (out / "times.json").write_text(json.dumps(
        {"device": smi, "chain": args.chain, "ms": times, "parts": parts, "reps": args.reps},
        indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

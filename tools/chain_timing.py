"""Times the VDVAE chains' kernels (the block chain's and the decoder
chain's forward and backward) at the five encoder and five decoder runs of
a ``pm_vdvae_mnist`` training batch of 16, on one GPU, for one tree of the
repository or several, turn by turn, each turn a process of its own.

A turn imports the package from its ``--root`` tree, builds that tree's
float32 chain libraries (and, where the tree has them, the bf16 ones with
``--bf16``), and times each wrapper at each run with CUDA events (REPS
back-to-back calls after one untimed), with inputs drawn from seed 0. It
logs each kernel's ms per launch (the mean over the runs, and each run)
and writes them as JSON to ``--out``; with several ``--root`` it runs them
in the order given, so that two trees in turns (``parent change change
parent``) are compared within one call, on one card:

    python tools/chain_timing.py --root _archive/parent --root . --root . \\
        --root _archive/parent --out chiprun_out/chain_ab.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPS = 20
BATCH, WIDTH, MID, LD = 16, 192, 48, 16
BLOCK_RUNS = ((28, 6, 3), (14, 4, 3), (7, 2, 3), (3, 2, 3), (1, 2, 1))
DEC_RUNS = ((1, 2, 1), (3, 3, 3), (7, 3, 3), (14, 5, 3), (28, 7, 3))


def turn(bf16: bool) -> dict:
    """One tree's times, in this process (the package already on the
    path): {kernel: {"ms": mean over the runs, "runs": [ms of each]}}."""
    import torch

    from posterior_matching_torch.ops import _build, block_chain as bc, decoder_chain as dc
    from posterior_matching_torch.ops.profiling import time_ms

    dtypes = [torch.float32] + ([torch.bfloat16] if bf16 else [])
    _build.build([n for n in _build.SOURCES if "chain" in n and "gated" not in n
                  and (bf16 or not n.endswith("_bf16"))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s, scale=1.0: scale * torch.randn(s, generator=gen, device=dev)
    out = {}

    def add(name, ms):
        out.setdefault(name, {"runs": []})["runs"].append(ms)

    for cd in dtypes:
        tag = "" if cd == torch.float32 else "_bf16"
        extra = {} if cd == torch.float32 else {"compute_dtype": cd}
        fwd = bc.chain_fwd_bf16 if tag else bc.chain_fwd
        bwd = bc.chain_bwd_bf16 if tag else bc.chain_bwd
        for res, n_lvl, k in BLOCK_RUNS:
            x = rnd(BATCH, res, res, WIDTH)
            cfg = bc.ChainConfig(x, n_lvl, MID, k, **extra)
            x0 = x.reshape(cfg.rows, WIDTH)
            w = {n: rnd(n_lvl, *s, scale=s[0] ** -0.5).to(
                     cfg.dtype_of(n) if hasattr(cfg, "dtype_of") else torch.float32)
                 for n, s in bc.weight_shapes(WIDTH, MID, k)}
            g = rnd(cfg.rows, WIDTH)
            with torch.no_grad():
                saved = {"x0": x0, **fwd(cfg, x0, w)}
                wk = {n: w[n] for n in ("w1", "w2", "w3", "w4")}
                add("block_chain_fwd" + tag, time_ms(lambda: fwd(cfg, x0, w), REPS))
                add("block_chain_bwd" + tag, time_ms(lambda: bwd(cfg, g, saved, wk), REPS))
        fwd = dc.dec_fwd_bf16 if tag else dc.dec_fwd
        bwd = dc.dec_bwd_bf16 if tag else dc.dec_bwd
        for res, n_lvl, k in DEC_RUNS:
            x0, acts, macts = (rnd(BATCH, res, res, WIDTH) for _ in range(3))
            cfg = dc.DecConfig(x0, acts, n_lvl, MID, LD, k, **extra)
            R, shapes = cfg.rows, cfg.shapes()
            ins = {"x0": x0.reshape(R, WIDTH), "acts": acts.reshape(R, WIDTH),
                   "macts": macts.reshape(R, WIDTH), "eps": rnd(n_lvl, R, LD)}
            ins.update({n: rnd(n_lvl, *s, scale=s[0] ** -0.5).to(
                            cfg.dtype_of(n) if hasattr(cfg, "dtype_of") else torch.float32)
                        for n, s in dc.weight_shapes(WIDTH, WIDTH, MID, LD, k)})
            cots = {"g": rnd(*shapes["x0"]), "gpost": rnd(*shapes["post"]),
                    "gprior": rnd(*shapes["prior"]), "gmask": rnd(*shapes["masked"])}
            wk = {n: ins[n] for n in dc.NAMES}
            names = getattr(cfg, "saved", dc._SAVED)
            with torch.no_grad():
                outs = fwd(cfg, ins)
                saved = {n: {**ins, **outs}[n] for n in names}
                add("decoder_chain_fwd" + tag, time_ms(lambda: fwd(cfg, ins), REPS))
                add("decoder_chain_bwd" + tag, time_ms(lambda: bwd(cfg, cots, saved, wk), REPS))
    for v in out.values():
        v["ms"] = sum(v["runs"]) / len(v["runs"])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", default=None,
                        help="a tree of the repository (this one by default); repeatable")
    parser.add_argument("--bf16", action="store_true", help="the bf16 builds too")
    parser.add_argument("--out", default=None)
    parser.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.turn is not None:
        sys.path.insert(0, str(Path(args.turn).resolve()))
        print(json.dumps(turn(args.bf16)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    turns = []
    for root in args.root or ["."]:
        tree = str(Path(root).resolve())
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", tree,
                               *(["--bf16"] if args.bf16 else [])],
                              capture_output=True, text=True, cwd=tree)
        if done.returncode:
            print(done.stdout[-2000:], done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        times = json.loads(done.stdout.strip().splitlines()[-1])
        turns.append({"root": root, "times": times})
        print(f"{root}: " + ", ".join(f"{k} {v['ms']:.4f}" for k, v in sorted(times.items())),
              flush=True)
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"nvidia_smi": smi, "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

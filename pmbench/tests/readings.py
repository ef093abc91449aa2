"""The numbers a cell's output check compares, over many seeds in one process:
the program as it is, the control (the reference at the next lower precision in
the program's place) or the program with a fault planted. What the limits in
``limits/<cell>.json`` are set from. On the card, from the root of a checkout::

    python3 -m pmbench.tests.readings --workload pm_vqvae_celeb_a.train \\
        --mode program --seeds 101 102 103 --seconds 2

One JSON line a seed on standard output, and with ``--out`` the same lines in a
file."""
from __future__ import annotations

import argparse
import json
import sys
import time


def readings(workload, mode, seeds, seconds, device="cuda", cell=None):
    from pmbench import harness
    from pmbench.tests import faults

    cell = cell or harness.find_cell(harness.benchmark(), workload)
    drv = harness.driver(cell)
    fault = mode[len("fault:"):] if mode.startswith("fault:") else ""
    for seed in seeds:
        with faults.planted(fault):
            out = drv.run(cell, seed=seed, seconds=seconds, trace=False, device=device,
                          t_start=time.time(), control=(mode == "control"))
        res = harness.result(cell, out, False, device, None)
        yield {"workload": cell.name, "mode": mode, "seed": seed, "correct": res["correct"],
               "attempted": out.attempted,
               "checks": {k: v[0] for k, v in out.checks.items()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    fp = open(args.out, "a") if args.out else None
    for line in readings(args.workload, args.mode, args.seeds, args.seconds):
        text = json.dumps(line)
        print(text, flush=True)
        if fp:
            fp.write(text + "\n")
            fp.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

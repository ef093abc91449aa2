"""Runs one cell of the benchmark once, on the machine it is started on:

    python3 -m pmbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the result's
JSON object; the numbers the output check compared, each beside its limit, are
the last lines of standard error. Exits non-zero, printing no result, where the
cell is unknown, the cards are missing, or a forbidden module was loaded."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def process_start() -> float:
    """This process's start on the host's clock (``time.time()``)."""
    try:
        with open("/proc/self/stat") as fp:
            ticks = int(fp.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fp:
            btime = next(int(line.split()[1]) for line in fp if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


T_START = process_start()


def parse(argv):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(root / ".pmbench_cache" / sub)


def card_state() -> str:
    """The card's name, power limit, SM clock, power draw and temperature as
    ``nvidia-smi`` reads them ("" where it cannot): beside every share, and to
    tell a slow run's cause."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
                              "temperature.gpu", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip().splitlines()
        return out[0] if out else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def main(argv=None) -> int:
    from pmbench import harness

    args = parse(argv)
    cache_dirs(harness.ROOT)
    try:
        cell = harness.find_cell(harness.benchmark(), args.workload)
        drv = harness.driver(cell)
    except KeyError as err:
        print(f"pmbench: {err.args[0]}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"pmbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    outcome = drv.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_start=T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"pmbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    res = harness.result(cell, outcome, bool(args.trace), torch.cuda.get_device_name(0),
                         card_state())
    if outcome.setup_phases:
        print(outcome.setup_phases, file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

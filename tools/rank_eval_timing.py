"""Times ``eval_pm_vqvae`` over two gloo ranks sharing one GPU at a large
eval split, and how long a rank waits inside a collective.

A PM-VQVAE at ``pm_vqvae_celeb_a``'s full width (random weights from seed
0) evaluates the synthetic CelebA test split's first ``--num_instances``
images (1024 at most) at 10 samples, one trial, global batch 32. Each rank
is a process with the launcher's environment set by hand (LOCAL_RANK 0 for
both: gloo takes two ranks on one card, NCCL refuses them), and times every
``broadcast``, ``all_reduce`` and ``barrier`` it enters. It logs rank 0's
``Wall time:`` line, each rank's wall seconds, number of collectives,
longest single wait and summed waits, and the card's name and power limit,
and writes them as JSON to ``--out``. A rank that waited in one collective
for work that grows with the split (rank 0's embeddings and PRD, say) shows
as a longest wait of that size. Run from the repository's root on a GPU:

    python tools/rank_eval_timing.py --num_instances 1024 --out chiprun_out/rank_eval.json
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
RANK = """
import json, os, sys, time
import torch.distributed as dist
waits = []
for name in ("broadcast", "all_reduce", "barrier"):
    def timed(*a, _f=getattr(dist, name), **k):
        t = time.perf_counter(); r = _f(*a, **k); waits.append(time.perf_counter() - t); return r
    setattr(dist, name, timed)
from posterior_matching_torch import eval_pm_vqvae
t = time.perf_counter()
rc = eval_pm_vqvae.main(sys.argv[2:])
with open(f"{sys.argv[1]}/wait.{os.environ['RANK']}.json", "w") as fp:
    json.dump({"wall_s": time.perf_counter() - t, "collectives": len(waits),
               "max_wait_s": max(waits), "sum_wait_s": sum(waits)}, fp)
sys.exit(rc)
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num_instances", type=int, default=1024)
    parser.add_argument("--num_samples", type=int, default=10)
    parser.add_argument("--out", default="chiprun_out/rank_eval.json")
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from posterior_matching_torch import convert
    from posterior_matching_torch.config import CONFIGS
    from posterior_matching_torch.data import load_arrays
    from posterior_matching_torch.ops import _build
    from posterior_matching_torch.train.state import TrainState, save_train_state

    if not torch.cuda.is_available():
        print("rank_eval_timing: no CUDA device is available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "torch_parallel_worker", REPO / "tests" / "torch_parallel_worker.py")
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    _build.build()   # once here, so that neither rank compiles
    pm, vq = CONFIGS["pm_vqvae_celeb_a"](), CONFIGS["vqvae_celeb_a"]()["model"]
    pc = dict(pm["pixel_cnn"], num_indices=vq["num_embeddings"])
    out = {"card": card, "num_instances": args.num_instances, "num_samples": args.num_samples}
    with tempfile.TemporaryDirectory() as work:
        os.makedirs(f"{work}/data/celeb_a")
        test = load_arrays("celeb_a", "test")   # the synthetic stand-in without files
        np.savez(f"{work}/data/celeb_a/test.npz",
                 **{k: v[:args.num_instances] for k, v in test.items()})
        run = f"{work}/run"
        os.makedirs(run)
        params, state = convert.random_pm_vqvae_tree(pm["conditional_dim"], vq, pc, seed=0)
        save_train_state(f"{run}/train_state.pkl", TrainState(params=params, state=state, step=1))
        with open(f"{run}/config.json", "w") as fp:
            json.dump({"conditional_dim": pm["conditional_dim"], "pixel_cnn": pc}, fp)
        with open(f"{run}/vqvae_config.json", "w") as fp:
            json.dump(vq, fp)
        t0 = time.perf_counter()
        outs = worker.spawn_command(
            [sys.executable, "-c", RANK, work, "--run_dir", run, "--dataset", "celeb_a",
             "--mask_generator", "CelebAMaskGenerator", "--num_instances",
             str(args.num_instances), "--batch_size", "32", "--num_samples",
             str(args.num_samples), "--num_trials", "1", "--dist_backend", "gloo"],
            cwd=work, env={"PM_TPU_DATA_DIR": f"{work}/data", "LOCAL_RANK": "0"}, timeout=900)
        out["ranks_s"] = time.perf_counter() - t0
        psnrs = np.load(f"{run}/imputation_results/psnrs.npy")
        if psnrs.shape != (1, args.num_instances) or not np.isfinite(psnrs).all():
            raise AssertionError(f"psnrs of shape {psnrs.shape}, finite {np.isfinite(psnrs).all()}")
        if outs[1]:
            raise AssertionError(f"rank 1 printed {outs[1][:200]!r}")
        out["wall_time_line"] = [ln for ln in outs[0].splitlines() if ln.startswith("Wall time:")]
        out["ranks"] = []
        for r in range(2):
            with open(f"{work}/wait.{r}.json") as fp:
                out["ranks"].append(json.load(fp))
    print(json.dumps(out, indent=1))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(out, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

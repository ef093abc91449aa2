"""Collects greedy active-feature-acquisition trajectories on the GPU.

Counterpart of ``eval_greedy_acquisition.py``. Run it as::

    python -m posterior_matching_torch.eval_greedy_acquisition \\
        --run_dir runs/lookahead-mnist16-<ts> --dataset mnist16 \\
        [--num_instances 1000] [--num_samples 50] [--episode_length 31] \\
        [--chunk_size 8] [--device cpu]

- The first ``num_instances`` test instances (``load_eval_dataset`` in
  batches of 32, the remainder kept) go through the lookahead run of
  ``--run_dir`` (``lookahead_config.json``, ``pm_vae_config.json``,
  ``train_state.pkl``, written by either package), ``chunk_size``
  instances at a time, each step batched over them
  (:mod:`posterior_matching_torch.acquisition`); the draws come from a
  generator seeded with 91.
- It writes ``<run_dir>/trajectories/sampling_trajectories.pkl`` and
  ``lookahead_trajectories.pkl``: lists of per-instance dicts of
  ``[episode_length, ...]`` numpy arrays under the JAX CLI's keys
  (``sampling_action``, ``lookahead_action``, ``sampling_probs``,
  ``lookahead_probs``, ``reconstruction``, ``rmse``, ``mask``) and the
  instance as ``truth``, and prints its wall time.
- It runs on the GPU unless ``--device cpu``, and raises without one, in
  one process, as the JAX CLI runs on one device: a launcher's
  ``WORLD_SIZE`` above 1 is refused by name.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from posterior_matching_torch import convert
from posterior_matching_torch.acquisition import (
    make_acquisition_eval_fn,
    make_collect_trajectory_fn,
)
from posterior_matching_torch.data import load_eval_dataset
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> int:
    mesh.refuse_ranks("eval_greedy_acquisition", "eval_greedy_acquisition.py builds no mesh")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--run_dir", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--num_instances", type=int, default=1000)
    parser.add_argument("--num_samples", type=int, default=50)
    parser.add_argument("--episode_length", type=int, default=31)
    parser.add_argument("--chunk_size", type=int, default=8)
    parser.add_argument("--device", default=None, help="the GPU unless 'cpu'")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    dataset = load_eval_dataset(args.dataset, 32, args.num_instances, drop_remainder=False)
    data_key = "image" if "image" in next(iter(dataset)) else "features"
    data = np.concatenate([b[data_key] for b in dataset], axis=0)
    model = convert.load_lookahead(args.run_dir, device=device).eval()
    collect = make_collect_trajectory_fn(make_acquisition_eval_fn(model, args.num_samples),
                                         args.episode_length)
    gen = torch.Generator(device=device).manual_seed(91)

    sampling_trajectories, lookahead_trajectories = [], []
    for start in range(0, len(data), args.chunk_size):
        xb = data[start:start + args.chunk_size]
        runs = collect(torch.as_tensor(xb, device=device), gen)
        for out, run in zip((sampling_trajectories, lookahead_trajectories), runs):
            host = {k: v.cpu().numpy() for k, v in run.items()}
            for i in range(len(xb)):
                out.append({**{k: v[i] for k, v in host.items()}, "truth": xb[i]})

    results_dir = os.path.join(args.run_dir, "trajectories")
    os.makedirs(results_dir, exist_ok=True)
    for name, trajectories in (("sampling", sampling_trajectories),
                               ("lookahead", lookahead_trajectories)):
        with open(os.path.join(results_dir, f"{name}_trajectories.pkl"), "wb") as fp:
            pickle.dump(trajectories, fp)
    print(f"Wall time: {time.perf_counter() - t0:.2f} s for {len(data)} instances x "
          f"{args.episode_length} steps x 2 rollouts", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Evaluates a PM-VAE on a UCI table on the GPU: NRMSE and arbitrary-
conditioning log-likelihood.

Counterpart of ``eval_pm_vae_uci.py``. Run it as::

    python -m posterior_matching_torch.eval_pm_vae_uci --run_dir runs/pm-vae-gas-<ts> \\
        --dataset gas [--num_instances N] [--batch_size 32] [--num_samples 512] \\
        [--num_trials 5] [--seed 91] [--device cpu]

- The run directory is a PM-VAE run of either package
  (``convert.load_pm_vae``); the test split of ``--dataset``, its first
  ``--num_instances`` rows, in batches (a last partial batch dropped, as
  in JAX).
- Each trial draws Bernoulli(0.5) masks; the mean of ``num_samples``
  imputations (``impute``) feeds the NRMSE over the unobserved features
  (:func:`nrmse_score`), and ``is_log_prob`` at ``num_samples`` importance
  samples gives ``log p(x_u | x_o)`` (AC-LL), averaged over the rows. Masks
  and samples come from one ``torch.Generator`` seeded with ``--seed``.
- It writes ``<run_dir>/uci_results/{nrmse,ac_lls}.npy`` (one value a
  trial) and prints the two result lines of the JAX CLI and the wall time.
- It runs on the GPU unless ``--device cpu``, and raises without one, in
  one process, as the JAX CLI runs on one device: a launcher's
  ``WORLD_SIZE`` above 1 is refused by name.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from posterior_matching_torch import convert
from posterior_matching_torch.data import load_eval_dataset
from posterior_matching_torch.masking import add_mask, get_mask_generator
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import resolve_device


def nrmse_score(imputations: np.ndarray, true_data: np.ndarray,
                observed_mask: np.ndarray) -> np.ndarray:
    """Per-trial NRMSE over the unobserved entries (``eval_pm_vae_uci.py:
    45-66``), averaged over the features whose standard deviation is not
    zero (identical to the reference's where every feature varies)."""
    error = (imputations - true_data) ** 2
    mse = np.sum(error, axis=-2) / np.count_nonzero(1.0 - observed_mask, axis=-2)
    std = np.std(true_data, axis=-2)
    nrmse = np.sqrt(mse) / std
    valid = np.all(std.reshape(-1, std.shape[-1]) > 0, axis=0)
    if not np.all(valid):
        print(f"NRMSE: excluding {int((~valid).sum())}/{valid.size} "
              "zero-variance features from the normalized average.")
    return np.mean(nrmse[..., valid], axis=-1)


def main(argv: Optional[Sequence[str]] = None) -> int:
    mesh.refuse_ranks("eval_pm_vae_uci", "eval_pm_vae_uci.py builds no mesh")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--run_dir", required=True,
                        help="The run directory of the model to evaluate.")
    parser.add_argument("--dataset", required=True, help="The dataset to evaluate on.")
    parser.add_argument("--num_instances", type=int, default=None,
                        help="The number of instances to evaluate.")
    parser.add_argument("--batch_size", type=int, default=32, help="The batch size.")
    parser.add_argument("--num_samples", type=int, default=512,
                        help="The number of samples to use for expectations.")
    parser.add_argument("--num_trials", type=int, default=5,
                        help="The number of trials to compute means and std. over.")
    parser.add_argument("--device", default=None, help="the GPU unless 'cpu'")
    parser.add_argument("--seed", type=int, default=91)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    dataset = load_eval_dataset(args.dataset, args.batch_size, args.num_instances)
    data_np = np.vstack([b["features"] for b in dataset])
    model = convert.load_pm_vae(args.run_dir, device=device).eval()
    mask_fn = get_mask_generator("BernoulliMaskGenerator", device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.perf_counter()
    imputations, masks, lls = [], [], []
    with torch.no_grad():
        for _ in range(args.num_trials):
            imp_t, mask_t, ll_t = [], [], []
            for batch in dataset:
                batch = add_mask({"features": torch.as_tensor(batch["features"], device=device)},
                                 gen, mask_fn)
                x, b = batch["features"], batch["mask"]
                imp_t.append(model.impute(x, b, gen, args.num_samples).mean(0).cpu().numpy())
                ll_t.append(model.is_log_prob(x, b, gen, args.num_samples)[1].cpu().numpy())
                mask_t.append(b.cpu().numpy())
            imputations.append(np.vstack(imp_t))
            masks.append(np.vstack(mask_t))
            lls.append(np.hstack(ll_t))
    wall = time.perf_counter() - t0

    x = np.broadcast_to(data_np[None], (args.num_trials, *data_np.shape))
    nrmse = nrmse_score(np.array(imputations), x, np.array(masks))
    lls = np.mean(np.array(lls), axis=1)

    results_dir = os.path.join(args.run_dir, "uci_results")
    os.makedirs(results_dir, exist_ok=True)
    np.save(os.path.join(results_dir, "nrmse.npy"), nrmse)
    np.save(os.path.join(results_dir, "ac_lls.npy"), lls)

    print("\n****RESULTS****")
    print(f"NRMSE: {np.mean(nrmse).item()} ± {np.std(nrmse).item()}")
    print(f"AC LL: {np.mean(lls).item()} ± {np.std(lls).item()}")
    print(f"wall: {wall:.3f} s for {args.num_trials} trials of {len(data_np)} rows at "
          f"{args.num_samples} samples", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

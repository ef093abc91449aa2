"""Evaluates a PM-VQVAE on the GPU: imputation PSNR and PRD precision/recall.

Counterpart of ``eval_pm_vqvae.py``. Run it as::

    python -m posterior_matching_torch.eval_pm_vqvae --run_dir runs/pm-vqvae-celeb_a-<ts> \\
        --dataset celeb_a --mask_generator CelebAMaskGenerator [--num_instances 160] \\
        [--batch_size 32] [--num_samples 10] [--num_trials 5] [--seed 91] [--device cpu]

- The run directory is a stage-2 run of either package
  (``convert.load_pm_vqvae``); imputations come from ``pm_vqvae_impute``
  (the sampler kernels), masks and samples from one ``torch.Generator``
  seeded with ``--seed``.
- The protocol is :mod:`posterior_matching_torch.eval.imputation`'s:
  ``num_trials`` passes, PSNR of the mean of ``num_samples`` imputations,
  PRD of each sample against the real images (20 clusters, 1001 angles, 10
  runs) with the random-conv embedder, the F_8 / F_1/8 pair.
- It writes ``<run_dir>/imputation_results/`` as the JAX CLI does:
  ``psnrs.npy`` ``[trials, N]``, ``prd_data.npy`` ``[trials, samples, 2,
  1001]``, ``f_scores.npy``, ``embedder.txt`` and ``eval_summary.json``
  with its keys; it prints the results and the wall time of the requests,
  the embeddings and PRD.
- It runs on the GPU unless ``--device cpu``, and raises without one.
  Under a launcher's W ranks (``python -m torch.distributed.run
  --nproc_per_node W -m posterior_matching_torch.eval_pm_vqvae ...``;
  ``--dist_backend`` ``nccl`` on the GPU and ``gloo`` on the CPU unless
  given) each ``--batch_size`` batch is global, as on the JAX CLI's mesh:
  the masks and the Gumbel noise of the whole request come from the shared
  generator, each rank samples its rows' share of the noise, every rank
  gets the rows back and scores them, and rank 0 writes the files, which
  are the one-process run's (:mod:`posterior_matching_torch.eval.imputation`).
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from posterior_matching_torch import convert
from posterior_matching_torch.data import load_eval_dataset
from posterior_matching_torch.eval import embedder_provenance
from posterior_matching_torch.eval.imputation import (
    eval_parser,
    run_imputation_eval,
    save_imputation_results,
)
from posterior_matching_torch.masking import get_mask_generator
from posterior_matching_torch.models.pm_vqvae import PMVQVAE, pm_vqvae_impute
from posterior_matching_torch.ops.sampler_chain import gumbel_noise
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import resolve_device


def evaluate_batch(model: PMVQVAE, x: torch.Tensor, b: torch.Tensor, num_samples: int,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num_samples`` imputations of ``x [B, H, W, C]`` in [0, 1] where
    ``b`` is 0, and the PSNR of their mean: ``([B], [B, S, H, W, C])``
    (``eval_pm_vqvae.py:84-95``). Noise as ``pm_vqvae_impute`` takes it."""
    imputations = pm_vqvae_impute(model, x, b, num_samples, generator=generator, noise=noise)
    mse = ((imputations.mean(1) - x) ** 2).mean((1, 2, 3))
    return -10.0 * torch.log10(mse), imputations


def rank_noise(model: PMVQVAE, batch: int, num_samples: int,
               generator: torch.Generator) -> torch.Tensor:
    """This rank's rows of the Gumbel noise that the sampler would draw from
    ``generator`` for a global request of ``batch`` rows a rank (one image
    row at a time, sample-major): ``[h, w, num_samples * batch, K]``, the
    whole request's noise in one process."""
    pixel_cnn = model.pixel_cnn
    (hgt, wid), k = pixel_cnn.image_shape, pixel_cnn.num_indices
    rows = batch * mesh.world_size()
    lo, hi = mesh.shard_rows(rows)
    noise = torch.empty((hgt, wid, num_samples, hi - lo, k), device=generator.device)
    for r in range(hgt):
        drawn = gumbel_noise((wid, num_samples * rows, k), generator, generator.device)
        noise[r] = drawn.view(wid, num_samples, rows, k)[:, :, lo:hi]
    return noise.view(hgt, wid, num_samples * batch, k)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = eval_parser(__doc__.splitlines()[0], batch_size=32, num_samples=10).parse_args(argv)
    with mesh.process_group(args.device, args.dist_backend):
        return _evaluate(args)


def _evaluate(args) -> int:
    device = resolve_device(args.device)
    dataset = load_eval_dataset(args.dataset, args.batch_size, args.num_instances)
    model = convert.load_pm_vqvae(args.run_dir, device=device)
    mask_fn = get_mask_generator(args.mask_generator, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def evaluate(x, b, g):
        return evaluate_batch(model, x, b, args.num_samples,
                              noise=rank_noise(model, x.shape[0], args.num_samples, g))

    results = run_imputation_eval(dataset, evaluate, mask_fn, args.num_samples,
                                  args.num_trials, gen)
    if results is None:
        return 0
    results_dir = save_imputation_results(args.run_dir, results)

    psnr, f_scores = results["per_trial_psnr"], results["f_scores"]
    f_means, f_stds = np.mean(f_scores, axis=0), np.std(f_scores, axis=0)
    summary = {
        "dataset": args.dataset,
        "num_instances": args.num_instances,
        "num_samples": args.num_samples,
        "num_trials": int(results["psnrs"].shape[0]),
        "psnr_mean": float(np.mean(psnr)),
        "psnr_std": float(np.std(psnr)),
        "per_trial_psnr": [float(v) for v in psnr],
        "precision": float(f_means[1]),
        "precision_std": float(f_stds[1]),
        "recall": float(f_means[0]),
        "recall_std": float(f_stds[0]),
        "embedder": embedder_provenance(),
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    with open(os.path.join(results_dir, "eval_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

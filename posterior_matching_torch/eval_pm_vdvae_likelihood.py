"""Evaluates PM-VDVAE likelihoods on the GPU: BPD and the arbitrary-
conditioning log-likelihood by importance sampling.

Counterpart of ``eval_pm_vdvae_likelihood.py``. Run it as::

    python -m posterior_matching_torch.eval_pm_vdvae_likelihood \\
        --run_dir runs/pm-vdvae-mnist-<ts> --dataset mnist \\
        --mask_generator MNISTMaskGenerator [--num_instances N] [--batch_size 625] \\
        [--num_samples 10000] [--batch_chunk 125] [--num_trials 5] [--seed 91] \\
        [--device cpu]

- The run directory is a PM-VDVAE run of either package, its EMA
  parameters when the checkpoint has them (``convert.load_pm_vdvae``); the
  log-likelihoods come from ``vdvae_is_log_probs`` with ``num_samples``
  importance samples, ``batch_chunk`` instances at a time (the block-chain
  kernels in both encoders), masks and samples from one
  ``torch.Generator`` seeded with ``--seed``. Images stay in [0, 255].
- It writes ``<run_dir>/likelihood_results/{x_lls,xo_lls,bpd}.npy``
  (``[trials, N]``; ``xo_lls`` is log p(x_o), ``bpd`` is ``-x_lls`` over
  the image's dimensions times log 2) and prints the BPD and the AC LL
  (``x_lls - xo_lls``), each mean over the values that are finite and
  within 1e10 (``eval_pm_vdvae_likelihood.py:158-166``).
- It runs on the GPU unless ``--device cpu``, and raises without one; a
  ragged last chunk runs as it is. ``--batch_size`` and ``--batch_chunk``
  are per device (``eval_pm_vdvae_likelihood.py:74-77,114``): under a
  launcher's W ranks (``--dist_backend`` as in
  :mod:`posterior_matching_torch.eval_pm_vqvae`) a batch holds W times
  ``--batch_size`` instances, whose masks come from the shared generator;
  each rank scores its rows, ``--batch_chunk`` at a time, with normals of
  its own (``eval.imputation.rank_generator``: equal to the one-process
  run's only in distribution), and rank 0 gathers them and writes the
  files.
"""
from __future__ import annotations

import json
import math
import os
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from posterior_matching_torch import convert
from posterior_matching_torch.data import load_eval_dataset
from posterior_matching_torch.eval.imputation import eval_parser, rank_generator
from posterior_matching_torch.masking import add_mask, get_mask_generator
from posterior_matching_torch.models.vdvae import (
    Noise,
    PosteriorMatchingVDVAE,
    vdvae_is_log_probs,
)
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import resolve_device


def _finite(v: np.ndarray) -> np.ma.MaskedArray:
    return np.ma.masked_array(v, mask=(~np.isfinite(v)) | (np.abs(v) > 1e10))


def evaluate_batch(model: PosteriorMatchingVDVAE, x: torch.Tensor, b: torch.Tensor,
                   num_samples: int, batch_chunk: Optional[int] = None,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Noise] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """log p(x) and log p(x_o) of ``x [B, H, W, C]`` in [0, 255] where ``b``
    is 1, by ``num_samples`` importance samples, ``([B], [B])``."""
    px, pxu = vdvae_is_log_probs(model, x, b, num_samples, batch_chunk=batch_chunk,
                                 generator=generator, noise=noise)
    return px, px - pxu


def summarize(x_lls: np.ndarray, xo_lls: np.ndarray,
              image_shape: Sequence[int]) -> Tuple[np.ndarray, np.ma.MaskedArray,
                                                   np.ma.MaskedArray]:
    """The BPD ``[T, N]`` of ``x_lls [T, N]``, and the per-trial means of the
    BPD and of the AC LL ``x_lls - xo_lls`` over their values that are
    finite and within 1e10, ``([T, N], [T], [T])``."""
    bpd = -x_lls / (math.prod(image_shape) * np.log(2))
    return bpd, np.mean(_finite(bpd), axis=1), np.mean(_finite(x_lls - xo_lls), axis=1)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = eval_parser(__doc__.splitlines()[0], batch_size=625, num_samples=10000)
    parser.add_argument("--batch_chunk", type=int, default=125,
                        help="instances a compute chunk holds; >= batch_size for one")
    args = parser.parse_args(argv)
    with mesh.process_group(args.device, args.dist_backend):
        return _evaluate(args)


def _evaluate(args) -> int:
    device = resolve_device(args.device)
    dataset = load_eval_dataset(args.dataset, args.batch_size * mesh.world_size(),
                                args.num_instances, normalize_images=False)
    with open(os.path.join(args.run_dir, "model_config.json")) as fp:
        image_shape = json.load(fp)["image_shape"]
    model = convert.load_pm_vdvae(args.run_dir, device=device)
    mask_fn = get_mask_generator(args.mask_generator, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    x_lls, xo_lls = [], []
    for trial in range(args.num_trials):
        px_trial, xo_trial = [], []
        for batch in dataset:
            x = torch.from_numpy(batch["image"]).to(device)
            b = add_mask({"image": x}, gen, mask_fn)["mask"]
            g = gen if mesh.world_size() == 1 else rank_generator(gen)
            px, pxo = evaluate_batch(model, mesh.shard_batch(x), mesh.shard_batch(b),
                                     args.num_samples, batch_chunk=max(args.batch_chunk, 1),
                                     generator=g)
            px_trial.append(mesh.gather_rows(px).cpu().numpy())
            xo_trial.append(mesh.gather_rows(pxo).cpu().numpy())
        x_lls.append(np.concatenate(px_trial))
        xo_lls.append(np.concatenate(xo_trial))
        if mesh.rank() == 0:
            print(f"Trial {trial + 1}: {len(x_lls[-1])} instances", flush=True)
    if mesh.rank() != 0:
        return 0
    x_lls, xo_lls = np.array(x_lls), np.array(xo_lls)
    bpd, per_trial_bpd, per_trial_ac = summarize(x_lls, xo_lls, image_shape)

    results_dir = os.path.join(args.run_dir, "likelihood_results")
    os.makedirs(results_dir, exist_ok=True)
    for name, value in (("x_lls", x_lls), ("xo_lls", xo_lls), ("bpd", bpd)):
        np.save(os.path.join(results_dir, f"{name}.npy"), value)

    print("\n****RESULTS****")
    print(f"BPD: {np.mean(per_trial_bpd).item()} ± {np.std(per_trial_bpd).item()}")
    print(f"AC LL: {np.mean(per_trial_ac).item()} ± {np.std(per_trial_ac).item()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

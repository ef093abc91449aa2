"""Evaluates PM-VDVAE imputation on the GPU: PSNR and PRD precision/recall.

Counterpart of ``eval_pm_vdvae_imputation.py``. Run it as::

    python -m posterior_matching_torch.eval_pm_vdvae_imputation \\
        --run_dir runs/pm-vdvae-mnist-<ts> --dataset mnist \\
        --mask_generator MNISTMaskGenerator [--num_instances N] [--batch_size 32] \\
        [--num_samples 10] [--num_trials 5] [--seed 91] [--device cpu]

- The run directory is a PM-VDVAE run of either package, its EMA
  parameters when the checkpoint has them (``convert.load_pm_vdvae``);
  imputations come from ``vdvae_impute`` (the block-chain kernels in both
  encoders), masks and samples from one ``torch.Generator`` seeded with
  ``--seed``.
- Images stay in [0, 255] (``normalize_images=False``); the PSNR is of the
  mean imputation over 255 against the image over 255, and PRD embeds the
  imputations over 255 (``eval_pm_vdvae_imputation.py:88-97``), with the
  protocol of :mod:`posterior_matching_torch.eval.imputation`.
- It writes ``<run_dir>/imputation_results/{psnrs,prd_data,f_scores}.npy``
  and ``embedder.txt`` as the JAX CLI does, and prints the results and the
  wall time of the requests, the embeddings and PRD.
- It runs on the GPU unless ``--device cpu``, and raises without one.
  Under a launcher's W ranks (``--dist_backend`` as in
  :mod:`posterior_matching_torch.eval_pm_vqvae`) each ``--batch_size``
  batch is global: its masks come from the shared generator, each rank
  imputes its rows with normals of its own (``eval.imputation.
  rank_generator``: equal to the one-process run's only in distribution),
  every rank gets the rows back and scores them, and rank 0 writes the
  files.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence, Tuple

import torch

from posterior_matching_torch import convert
from posterior_matching_torch.data import load_eval_dataset
from posterior_matching_torch.eval.imputation import (
    eval_parser,
    rank_generator,
    run_imputation_eval,
    save_imputation_results,
)
from posterior_matching_torch.masking import get_mask_generator
from posterior_matching_torch.models.vdvae import Noise, PosteriorMatchingVDVAE, vdvae_impute
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import resolve_device


def evaluate_batch(model: PosteriorMatchingVDVAE, x: torch.Tensor, b: torch.Tensor,
                   num_samples: int, generator: Optional[torch.Generator] = None,
                   noise: Optional[Noise] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num_samples`` imputations of ``x [B, H, W, C]`` in [0, 255] where
    ``b`` is 0: the PSNR of their mean on the [0, 1] scale and the
    imputations over 255, ``([B], [B, S, H, W, C])``."""
    imputations = vdvae_impute(model, x, b, num_samples, generator=generator, noise=noise)
    mse = ((imputations.mean(1) / 255.0 - x / 255.0) ** 2).mean((1, 2, 3))
    return -10.0 * torch.log10(mse), imputations / 255.0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = eval_parser(__doc__.splitlines()[0], batch_size=32, num_samples=10).parse_args(argv)
    with mesh.process_group(args.device, args.dist_backend):
        return _evaluate(args)


def _evaluate(args) -> int:
    device = resolve_device(args.device)
    dataset = load_eval_dataset(args.dataset, args.batch_size, args.num_instances,
                                normalize_images=False)
    model = convert.load_pm_vdvae(args.run_dir, device=device)
    mask_fn = get_mask_generator(args.mask_generator, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def evaluate(x, b, g):
        g = g if mesh.world_size() == 1 else rank_generator(g)
        return evaluate_batch(model, x, b, args.num_samples, generator=g)

    results = run_imputation_eval(dataset, evaluate, mask_fn, args.num_samples,
                                  args.num_trials, gen, image_scale=255.0)
    if results is not None:
        save_imputation_results(args.run_dir, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The image eval CLIs' shared command line and imputation protocol.

``eval_pm_vqvae`` and ``eval_pm_vdvae_imputation`` run the same protocol
(the root ``eval_pm_vqvae.py:62-190`` and ``eval_pm_vdvae_imputation.py``):
``num_trials`` passes over the eval split, masks drawn on the device, each
batch imputed ``num_samples`` times and scored by the PSNR of the mean
imputation; per trial, every sample's embeddings against the real images'
by PRD (20 clusters, 1001 angles, 10 runs) and the F_8 / F_1/8 pair of the
trial's mean curve. ``eval_pm_vdvae_likelihood`` shares the flags.

Under a launcher's W ranks (:mod:`posterior_matching_torch.parallel.mesh`)
each batch is global, as on the JAX CLIs' mesh: every rank draws the
batch's masks from the shared generator, imputes its own rows, and gets
every rank's rows back. Every rank then embeds all of them and runs PRD on
the same generator, so that no rank waits in a collective for work that
grows with the dataset; rank 0 alone writes the results. At the end of a
trial the generator takes rank 0's state on every rank (a guard: the ranks
have drawn the same), so the next trial's masks stay shared.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from posterior_matching_torch.data.datasets import ArrayDataset
from posterior_matching_torch.eval import (
    compute_prd_from_embedding,
    embedder_provenance,
    get_inception_embeddings,
    prd_to_max_f_beta_pair,
)
from posterior_matching_torch.cli import add_dist_backend
from posterior_matching_torch.masking import MaskFn, add_mask
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.train.trainer import derive_seed

# (x, b, generator) -> (psnr [B], imputations [B, S, H, W, C] in [0, 1])
Evaluate = Callable[[torch.Tensor, torch.Tensor, torch.Generator],
                    Tuple[torch.Tensor, torch.Tensor]]


def eval_parser(description: str, batch_size: int, num_samples: int) -> argparse.ArgumentParser:
    """The JAX eval CLIs' flags and defaults, with ``--device`` (the GPU
    unless ``cpu``) and ``--seed`` (of the masks, samples and clusterings;
    the JAX CLIs' ``PRNGKey(91)``)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--run_dir", required=True,
                        help="The run directory of the model to evaluate.")
    parser.add_argument("--dataset", required=True, help="The dataset to evaluate on.")
    parser.add_argument("--mask_generator", required=True,
                        help="The name of the mask generator to use.")
    parser.add_argument("--num_instances", type=int, default=None,
                        help="The number of instances to evaluate.")
    parser.add_argument("--batch_size", type=int, default=batch_size, help="The batch size.")
    parser.add_argument("--num_samples", type=int, default=num_samples,
                        help="The number of samples per instance.")
    parser.add_argument("--num_trials", type=int, default=5,
                        help="The number of trials to compute means and std. over.")
    parser.add_argument("--device", default=None, help="the GPU unless 'cpu'")
    parser.add_argument("--seed", type=int, default=91)
    add_dist_backend(parser)
    return parser


def rank_generator(gen: torch.Generator) -> torch.Generator:
    """A generator of this rank's own, seeded by one draw of ``gen`` (the
    same draw on every rank) folded with the rank: the ranks' samples for
    their rows are then independent, and equal to the one-process run's
    only in distribution."""
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))
    return torch.Generator(device=gen.device).manual_seed(derive_seed(seed, mesh.rank(), 5))


def run_imputation_eval(dataset: ArrayDataset, evaluate: Evaluate, mask_fn: MaskFn,
                        num_samples: int, num_trials: int, gen: torch.Generator,
                        image_scale: float = 1.0) -> Dict[str, np.ndarray]:
    """The protocol over ``dataset``, whose images over ``image_scale`` lie
    in [0, 1]. Returns ``psnrs [T, N]``, ``prd_data [T, S, 2, 1001]``,
    ``f_scores [T, 2]`` (F_8, F_1/8), ``per_trial_psnr [T]`` and the wall
    seconds of the requests, the embeddings and PRD; None on ranks other
    than 0, where ``evaluate`` gets the rank's rows of each batch."""
    device, main = gen.device, mesh.rank() == 0
    seconds = {"requests": 0.0, "embeddings": 0.0, "prd": 0.0}
    t0 = time.perf_counter()
    real = np.concatenate([b["image"] for b in dataset], axis=0)
    real_embeddings = get_inception_embeddings(real / image_scale, batch_size=16, device=device)
    seconds["embeddings"] += time.perf_counter() - t0
    psnrs, prd_data = [], []
    for trial in range(num_trials):
        t0 = time.perf_counter()
        trial_psnrs, imputations = [], []
        for batch in dataset:
            x = torch.from_numpy(batch["image"]).to(device)
            b = add_mask({"image": x}, gen, mask_fn)["mask"]
            psnr, imp = evaluate(mesh.shard_batch(x), mesh.shard_batch(b), gen)
            trial_psnrs.append(mesh.gather_rows(psnr).cpu().numpy())
            imputations.append(mesh.gather_rows(imp).cpu().numpy())
        psnrs.append(np.concatenate(trial_psnrs, axis=0))
        imputations = np.concatenate(imputations, axis=0)   # [N, S, H, W, C]
        t1 = time.perf_counter()
        fake_embeddings = np.stack(
            [get_inception_embeddings(imputations[:, i], batch_size=16, verbose=False,
                                      device=device)
             for i in range(num_samples)], axis=1)
        t2 = time.perf_counter()
        prd_data.append(np.array([
            compute_prd_from_embedding(eval_data=fake_embeddings[:, i],
                                       ref_data=real_embeddings, num_clusters=20,
                                       num_angles=1001, num_runs=10, generator=gen)
            for i in range(num_samples)]))
        t3 = time.perf_counter()
        seconds["requests"] += t1 - t0
        seconds["embeddings"] += t2 - t1
        seconds["prd"] += t3 - t2
        if main:
            print(f"Trial {trial + 1}: {len(psnrs[-1])} instances x {num_samples} samples, "
                  f"PSNR {np.mean(np.ma.masked_invalid(psnrs[-1]))}", flush=True)
        mesh.sync_generator(gen)
    if not main:
        return None
    psnrs, prd_data = np.array(psnrs), np.array(prd_data)
    per_trial_prd = np.mean(prd_data, axis=1)
    return {
        "psnrs": psnrs, "prd_data": prd_data,
        "f_scores": np.array([prd_to_max_f_beta_pair(p[0], p[1], beta=8)
                              for p in per_trial_prd]),
        "per_trial_psnr": np.mean(np.ma.masked_invalid(psnrs), axis=1).data,
        "seconds": seconds,
    }


def save_imputation_results(run_dir: str, results: Dict[str, np.ndarray]) -> str:
    """``<run_dir>/imputation_results/{psnrs,prd_data,f_scores}.npy`` and
    ``embedder.txt``, as the JAX CLIs write them; prints the results and
    the wall-time split. Returns the directory."""
    results_dir = os.path.join(run_dir, "imputation_results")
    os.makedirs(results_dir, exist_ok=True)
    for name in ("psnrs", "prd_data", "f_scores"):
        np.save(os.path.join(results_dir, f"{name}.npy"), results[name])
    embedder = embedder_provenance()
    with open(os.path.join(results_dir, "embedder.txt"), "w") as f:
        f.write(embedder + "\n")
    psnr = results["per_trial_psnr"]
    f_means, f_stds = np.mean(results["f_scores"], axis=0), np.std(results["f_scores"], axis=0)
    s = results["seconds"]
    print("\n****RESULTS****")
    print(f"PSNR: {np.mean(psnr).item()} ± {np.std(psnr).item()}")
    print(f"Precision: {f_means[1]} ± {f_stds[1]}  [embedder: {embedder}]")
    print(f"Recall: {f_means[0]} ± {f_stds[0]}  [embedder: {embedder}]")
    print(f"Wall time: requests {s['requests']:.3f} s, embeddings {s['embeddings']:.3f} s, "
          f"PRD {s['prd']:.3f} s", flush=True)
    return results_dir

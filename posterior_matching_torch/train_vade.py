"""Trains a VaDE model on the GPU, in three phases.

Counterpart of ``train_vade.py``. Run it as::

    python -m posterior_matching_torch.train_vade --config vade_mnist \\
        [--config.pretrain_steps N] [--config.steps M] \\
        [--config.validation_freq K] [--config.seed S] [--device cpu]

- ``--config`` is ``vade_mnist``, ``vade_digits`` or ``vade_digits16``;
  ``--config.<path> <value>``, ``--device`` and ``--resume_dir`` as
  :mod:`posterior_matching_torch.cli` reads them.
- Phase 1 pretrains the deterministic autoencoder (``pretrain_loss``) for
  ``pretrain_steps`` with plain Adam at ``pretrain_lr`` and writes
  ``pretrain_state.pkl``. Phase 2 encodes the training split's means,
  fits a diagonal Gaussian mixture of ``num_components`` to them on the
  device (:class:`~posterior_matching_torch.eval.gmm.GaussianMixture`:
  300 iterations, 10 initialisations, seeded from the run's seed), prints
  ``GMM Accuracy:`` on the validation split and grafts the fit into the
  prior: ``logits = log(weights_)``, ``mu = means_`` and, as the reference
  does, ``log_scale = log(covariances_)``, the log of the *variance*.
  Phases 1 and 2 read their own streams of the training split, so phase
  3's does not depend on them (``train_vade.py:121-129``).
- Phase 3 trains ``-mean(elbo)`` for ``steps`` with Adam (the
  configuration's ``adam`` options) under the exponential decay, logging
  ``val_clustering_accuracy`` (the argmax of ``predict_cluster`` at
  ``cluster_pred_num_samples``) at each validation.
- Weights start from the JAX package's initialisation, drawn from the
  seed. The run directory ``runs/vade-<dataset>-<timestamp>/`` holds
  ``pretrain_state.pkl``, ``model_config.json``, ``train_meta.json`` and
  ``train_state.pkl`` (written at every validation), in the JAX package's
  layout.
- ``tb/`` holds the TensorBoard events of each phase-3 validation's
  scalar logs.
- ``--resume_dir`` continues phase 3 of a run of either package into a
  fresh run directory, skipping phases 1 and 2 (``train_vade.py:
  114-128``), whose results the checkpoint holds.
- It runs on the GPU unless ``--device cpu``, and raises without one, in
  one process, as the JAX CLI runs on one device: a launcher's
  ``WORLD_SIZE`` above 1 is refused by name.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from posterior_matching_torch import convert
from posterior_matching_torch.cli import parse_config
from posterior_matching_torch.config import VADE_CONFIGS
from posterior_matching_torch.data import load_datasets
from posterior_matching_torch.eval.clustering import (
    ClusteringAccuracyCallback,
    clustering_accuracy,
)
from posterior_matching_torch.eval.gmm import GaussianMixture
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import resolve_device
from posterior_matching_torch.train.callbacks import (
    CheckpointCallback,
    LearningRateLoggerCallback,
    TensorBoardCallback,
)
from posterior_matching_torch.train.resume import resume_state_from_dir, save_train_meta
from posterior_matching_torch.train.trainer import vade_pretrain_trainer, vade_trainer
from posterior_matching_torch.utils import batch_process, make_run_dir


def gmm_graft(gmm: GaussianMixture) -> dict:
    """The prior's parameters from a fitted mixture (``train_vade.py:
    163-171``), ``log_scale`` the log of the variances as the reference
    grafts them."""
    return {"logits": np.log(gmm.weights_).astype(np.float32),
            "mu": gmm.means_.astype(np.float32),
            "log_scale": np.log(gmm.covariances_).astype(np.float32)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    mesh.refuse_ranks("train_vade", "train_vade.py:188 trains on one device")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args, config = parse_config(parser, argv, VADE_CONFIGS)
    device = resolve_device(args.device)
    resume = resume_state_from_dir(args.resume_dir)
    seed = config["seed"]

    data = dict(config["data"])
    train_dataset, val_dataset = load_datasets(data, seed=seed)
    data_key = "image" if "image" in next(iter(val_dataset)) else "features"
    model = convert.vade_from_jax(convert.init_vade_tree(config["model"], seed=seed),
                                  config["model"], device=device)

    run_dir = make_run_dir(prefix=f"vade-{data['dataset']}")
    print("Using run directory:", run_dir, flush=True)
    save_train_meta(run_dir, config)
    graft = None if resume is not None else pretrain_and_fit(
        model, config, data_key, val_dataset, run_dir, device)

    # -- phase 3: ELBO training -------------------------------------------------
    with open(os.path.join(run_dir, "model_config.json"), "w") as fp:
        json.dump(config["model"], fp)
    trainer = vade_trainer(model, config, seed=seed, data_key=data_key, device=device)
    trainer.init(graft)
    samples = config["cluster_pred_num_samples"]
    pred_fn = lambda m, gen, batch: m.predict_cluster(batch[data_key], gen, samples).argmax(-1)
    callbacks = [ClusteringAccuracyCallback(pred_fn),
                 CheckpointCallback(os.path.join(run_dir, "train_state.pkl")),
                 LearningRateLoggerCallback(trainer.optimizer.schedule),
                 TensorBoardCallback(os.path.join(run_dir, "tb"))]
    print("Starting main training...", flush=True)
    trainer.fit(train_dataset, config["steps"], callbacks, val_batches=val_dataset,
                validation_freq=config["validation_freq"], resume_from=resume)
    return 0


def pretrain_and_fit(model, config, data_key: str, val_dataset, run_dir: str, device):
    """Phases 1 and 2: pretrains ``model`` (``pretrain_state.pkl``), fits the
    mixture to its latents and returns the prior's grafted parameters.
    They read their own streams of the training split, so phase 3's does
    not depend on them (``train_vade.py:121-129``)."""
    seed, data = config["seed"], dict(config["data"])
    pretrain_dataset, _ = load_datasets(data, seed=seed)
    latents_dataset, _ = load_datasets(data, seed=seed)

    # -- phase 1: pretraining -------------------------------------------------
    pretrain = vade_pretrain_trainer(model, config, seed=seed, data_key=data_key,
                                     device=device)
    pretrain.init()
    print("Pretraining...", flush=True)
    pretrain.fit(pretrain_dataset, config["pretrain_steps"], validation_freq=10**9)
    pretrain.save_checkpoint(os.path.join(run_dir, "pretrain_state.pkl"))

    # -- phase 2: the mixture fit on the latents --------------------------------
    print("Fitting GMM...", flush=True)
    model.eval()
    encode = lambda batch: model.encode_mean(batch[data_key])
    latents = batch_process(encode, latents_dataset, device=device)
    val_latents = batch_process(encode, val_dataset, device=device)
    gmm = GaussianMixture(config["model"]["num_components"], max_iter=300, n_init=10,
                          generator=torch.Generator(device=device).manual_seed(seed))
    gmm.fit(latents)
    targets = np.concatenate([b["label"] for b in val_dataset], axis=0)
    print("GMM Accuracy:", round(clustering_accuracy(targets, gmm.predict(val_latents)), 4),
          flush=True)
    return convert.to_torch(gmm_graft(gmm))


if __name__ == "__main__":
    sys.exit(main())

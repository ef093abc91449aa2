"""Trains a Posterior Matching VDVAE on the GPU.

Counterpart of ``train_pm_vdvae.py:111-227``. Run it as::

    python -m posterior_matching_torch.train_pm_vdvae --config pm_vdvae_mnist \\
        [--config.steps 1000] [--config.validation_freq 500] [--config.seed 0] \\
        [--config.model.fused_chain=True] [--device cpu]

- ``--config`` is ``pm_vdvae_mnist`` or ``pm_vdvae_digits16``;
  ``--config.<path> <value>``, ``--device`` and ``--resume_dir`` as
  :mod:`posterior_matching_torch.cli` reads them.
- The loss is ``-ELBO + mean(pm_kl)``, logged with ``reconstruction_ll``,
  ``kl``, ``pm_kl`` and ``bpd`` (:135-150); the optimizer, EMA and skipping
  of non-finite updates are ``pm_vdvae_trainer``'s; masks are drawn on the
  device; validation runs on the configuration's validation split with the
  EMA parameters every ``validation_freq`` steps and at the last.
- Weights start from the JAX package's initialisation, drawn from the
  seed. The run directory ``runs/pm-vdvae-<dataset>-<timestamp>/`` holds
  ``model_config.json`` (the keys of the config file's ``model`` block:
  ``fused_chain`` is this run's execution option and is not written),
  ``train_meta.json`` and ``train_state.pkl``, written at every validation
  in the JAX package's layout, which the JAX CLIs evaluate.
- It runs on the GPU unless ``--device cpu``, and raises without one.
  One device: the configuration's per-device batch is the batch.

Not ported yet: ``--resume_dir`` (refused), the TensorBoard logs and the
reconstruction images they show.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from posterior_matching_torch import convert
from posterior_matching_torch.cli import parse_config
from posterior_matching_torch.config import PM_VDVAE_MNIST
from posterior_matching_torch.data import load_datasets
from posterior_matching_torch.masking import get_mask_generator
from posterior_matching_torch.runtime import resolve_device
from posterior_matching_torch.train.callbacks import CheckpointCallback, LearningRateLoggerCallback
from posterior_matching_torch.train.resume import save_train_meta
from posterior_matching_torch.train.trainer import pm_vdvae_trainer
from posterior_matching_torch.utils import make_run_dir


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args, config = parse_config(parser, argv, ("pm_vdvae_mnist", "pm_vdvae_digits16"))
    device = resolve_device(args.device)

    data = dict(config["data"])
    train_dataset, val_dataset = load_datasets(data, normalize_images=False)
    tree = convert.init_pm_vdvae_tree(config["model"], seed=config["seed"])
    model = convert.pm_vdvae_from_jax(tree, config["model"], device=device)
    trainer = pm_vdvae_trainer(model, config, seed=config["seed"],
                               mask_fn=get_mask_generator(
                                   data["mask_generator"], device,
                                   **(data.get("mask_generator_kwargs") or {})),
                               device=device)
    trainer.init()

    run_dir = make_run_dir(prefix=f"pm-vdvae-{data['dataset']}")
    print("Using run directory:", run_dir, flush=True)
    save_train_meta(run_dir, config)
    with open(os.path.join(run_dir, "model_config.json"), "w") as fp:
        json.dump({k: config["model"][k] for k in PM_VDVAE_MNIST}, fp)

    callbacks = [CheckpointCallback(os.path.join(run_dir, "train_state.pkl")),
                 LearningRateLoggerCallback(trainer.optimizer.schedule)]
    trainer.fit(train_dataset, config["steps"], callbacks, val_batches=val_dataset,
                validation_freq=config["validation_freq"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Trains a Posterior Matching VAE on the GPU.

Counterpart of ``train_pm_vae.py``. Run it as::

    python -m posterior_matching_torch.train_pm_vae --config pm_vae_gas \\
        [--config.steps 1000] [--config.validation_freq 500] [--config.seed 0] \\
        [--device cpu]

- ``--config`` is one of the eleven ``pm_vae_*`` configurations;
  ``--config.<path> <value>``, ``--device`` and ``--resume_dir`` as
  :mod:`posterior_matching_torch.cli` reads them.
- The loss is ``-mean(reconstruction_ll - beta kl) + matching_coef
  * -mean(matching_ll)`` with the configuration's beta schedule at the step
  (``train_pm_vae.py:49-77``), logged with each term and ``beta``; the
  optimizer is ``pm_vae_trainer``'s (Adam, the decayed weights, the
  exponential decay); masks and the training noise are drawn on the
  device, the noise in training only; validation runs on the
  configuration's validation split every ``validation_freq`` steps and at
  the last.
- Weights start from the JAX package's initialisation, drawn from the
  seed. The run directory ``runs/pm-vae-<dataset>-<timestamp>/`` holds
  ``model_config.json`` (the configuration's ``model`` block),
  ``train_meta.json``, ``train_state.pkl``, written at every validation
  and, with ``save_final_state``, at the end, in the JAX package's layout,
  which the JAX CLIs evaluate and resume, and ``tb/``, the TensorBoard
  events of each validation's scalar logs.
- ``--resume_dir`` continues a run of either package into a fresh run
  directory.
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

from posterior_matching_torch import convert
from posterior_matching_torch.cli import device_resident, parse_config
from posterior_matching_torch.config import PM_VAE_CONFIGS
from posterior_matching_torch.data import load_datasets
from posterior_matching_torch.masking import get_mask_generator
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import resolve_device
from posterior_matching_torch.train.callbacks import (
    CheckpointCallback,
    LearningRateLoggerCallback,
    TensorBoardCallback,
)
from posterior_matching_torch.train.resume import resume_state_from_dir, save_train_meta
from posterior_matching_torch.train.trainer import pm_vae_trainer
from posterior_matching_torch.utils import make_run_dir


def main(argv: Optional[Sequence[str]] = None) -> int:
    mesh.refuse_ranks("train_pm_vae", "train_pm_vae.py:131 trains on one device")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args, config = parse_config(parser, argv, PM_VAE_CONFIGS)
    device = resolve_device(args.device)
    resume = resume_state_from_dir(args.resume_dir)

    data = dict(config["data"])
    train_dataset, val_dataset = load_datasets(data, seed=config["seed"])
    data_key = "image" if "image" in next(iter(val_dataset)) else "features"
    tree = convert.init_pm_vae_tree(config["model"], seed=config["seed"])
    model = convert.pm_vae_from_jax(tree, config["model"], device=device)
    mask_fn = None
    if "mask_generator" in data:
        mask_fn = get_mask_generator(data["mask_generator"], device,
                                     **(data.get("mask_generator_kwargs") or {}))
    trainer = pm_vae_trainer(model, config, seed=config["seed"], mask_fn=mask_fn,
                             data_key=data_key, device=device,
                             steps_per_call=config.get("steps_per_call", 1))
    trainer.init()

    run_dir = make_run_dir(prefix=f"pm-vae-{data['dataset']}")
    print("Using run directory:", run_dir, flush=True)
    save_train_meta(run_dir, config)
    with open(os.path.join(run_dir, "model_config.json"), "w") as fp:
        json.dump(config["model"], fp)

    ckpt = os.path.join(run_dir, "train_state.pkl")
    callbacks = [CheckpointCallback(ckpt), LearningRateLoggerCallback(trainer.optimizer.schedule),
                 TensorBoardCallback(os.path.join(run_dir, "tb"))]
    train_dataset = device_resident(config, train_dataset, device)
    trainer.fit(train_dataset, config["steps"], callbacks, val_batches=val_dataset,
                validation_freq=config["validation_freq"], resume_from=resume)
    if config.get("save_final_state", False):
        trainer.save_checkpoint(ckpt)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Trains lookahead posteriors on a frozen PM-VAE, on the GPU.

Counterpart of ``train_lookahead_posterior.py``. Run it as::

    python -m posterior_matching_torch.train_lookahead_posterior \\
        --config lookahead_mnist16 --config.pm_vae_dir runs/pm-vae-mnist16-<ts> \\
        [--config.steps N] [--config.validation_freq M] [--config.seed S] \\
        [--device cpu]

- ``--config`` is ``lookahead_mnist16`` or ``lookahead_digits``;
  ``--config.<path> <value>``, ``--device`` and ``--resume_dir`` as
  :mod:`posterior_matching_torch.cli` reads them.
- ``model.num_features`` is the data's feature count (``H W`` for images,
  whose masks have one channel); the PM-VAE under ``pm_vae`` starts from
  ``pm_vae_dir``'s ``model_config.json`` and ``train_state.pkl`` (a run of
  either package's ``train_pm_vae``), the lookahead modules from the JAX
  package's initialisation drawn from the seed; only the modules whose
  path holds ``lookahead`` train.
- The loss is ``-mean`` of the lookahead training log-likelihood, with the
  configuration's masks drawn on the device; Adam under the exponential
  decay.
- The run directory ``runs/lookahead-<dataset>-<timestamp>/`` holds
  ``lookahead_config.json``, ``pm_vae_config.json``, ``train_meta.json``
  ``train_state.pkl`` (written at every validation), in the JAX package's
  layout, which ``eval_greedy_acquisition`` of either package reads, and
  ``tb/``, the TensorBoard events of each validation's scalar logs.
- ``--resume_dir`` continues a run of either package into a fresh run
  directory.
- It runs on the GPU unless ``--device cpu``, and raises without one, in
  one process, as the JAX CLI runs on one device: a launcher's
  ``WORLD_SIZE`` above 1 is refused by name.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Optional, Sequence

from posterior_matching_torch import convert
from posterior_matching_torch.cli import parse_config
from posterior_matching_torch.config import LOOKAHEAD_CONFIGS
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
from posterior_matching_torch.train.state import load_train_state
from posterior_matching_torch.train.trainer import lookahead_trainer
from posterior_matching_torch.utils import make_run_dir


def main(argv: Optional[Sequence[str]] = None) -> int:
    mesh.refuse_ranks("train_lookahead_posterior", "train_lookahead_posterior.py:113 trains on one device")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args, config = parse_config(parser, argv, LOOKAHEAD_CONFIGS)
    device = resolve_device(args.device)
    resume = resume_state_from_dir(args.resume_dir)

    data = config["data"]
    train_dataset, val_dataset = load_datasets(data, seed=config["seed"])
    first = next(iter(val_dataset))
    data_key = "image" if "image" in first else "features"
    with open(os.path.join(config["pm_vae_dir"], "model_config.json")) as fp:
        pm_vae_config = json.load(fp)
    pm_vae_state = load_train_state(os.path.join(config["pm_vae_dir"], "train_state.pkl"))

    feature_dims = first[data_key].shape[1:]
    if data_key == "image":
        feature_dims = (*feature_dims[:-1], 1)   # masks are [H, W, 1]
    config["model"]["num_features"] = math.prod(feature_dims)

    tree = convert.init_lookahead_tree(config["model"], pm_vae_config, seed=config["seed"])
    model = convert.lookahead_from_jax(tree, config["model"], pm_vae_config, device=device)
    mask_fn = get_mask_generator(data["mask_generator"], device,
                                 **(data.get("mask_generator_kwargs") or {}))
    trainer = lookahead_trainer(model, config, seed=config["seed"], mask_fn=mask_fn,
                                data_key=data_key, device=device)
    pm_vae = convert.pm_vae_state_dict(pm_vae_state.params)
    trainer.init(convert.to_torch({f"pm_vae.{k}": v for k, v in pm_vae.items()}))

    run_dir = make_run_dir(prefix=f"lookahead-{data['dataset']}")
    print("Using run directory:", run_dir, flush=True)
    save_train_meta(run_dir, config)
    with open(os.path.join(run_dir, "lookahead_config.json"), "w") as fp:
        json.dump(config["model"], fp)
    with open(os.path.join(run_dir, "pm_vae_config.json"), "w") as fp:
        json.dump(pm_vae_config, fp)

    callbacks = [CheckpointCallback(os.path.join(run_dir, "train_state.pkl")),
                 LearningRateLoggerCallback(trainer.optimizer.schedule),
                 TensorBoardCallback(os.path.join(run_dir, "tb"))]
    trainer.fit(train_dataset, config["steps"], callbacks, val_batches=val_dataset,
                validation_freq=config["validation_freq"], resume_from=resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())

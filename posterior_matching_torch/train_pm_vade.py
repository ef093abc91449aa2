"""Trains the partial encoder of a PM-VaDE on a frozen VaDE, on the GPU.

Counterpart of ``train_pm_vade.py``. Run it as::

    python -m posterior_matching_torch.train_pm_vade --config pm_vade_mnist \\
        --config.vade_dir runs/vade-mnist-<timestamp> [--config.steps N] \\
        [--config.validation_freq M] [--config.seed S] [--device cpu]

- ``--config`` is ``pm_vade_mnist`` or ``pm_vade_digits``;
  ``--config.<path> <value>``, ``--device`` and ``--resume_dir`` as
  :mod:`posterior_matching_torch.cli` reads them.
- Every parameter starts from ``vade_dir``'s ``train_state.pkl`` (a run of
  either package's ``train_vade``), the partial encoder and its posterior
  from the JAX package's initialisation drawn from the seed; only the
  modules whose path holds ``partial_`` train, so the VaDE, its mixture
  prior included, stays as it was.
- The loss is ``-mean(posterior_matching_ll)``, with masks from the
  ``UniformMaskGenerator`` (no bounds), which the CLI forces as the
  reference's does (``train_pm_vade.py:52``), drawn on the device; Adam
  under the exponential decay.
- The run directory ``runs/pm-vade-<dataset>-<timestamp>/`` holds
  ``model_config.json``, ``train_meta.json``, ``train_state.pkl`` (written
  at every validation), in the JAX package's layout, and ``tb/``, the
  TensorBoard events of each validation's scalar logs.
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
from posterior_matching_torch.cli import parse_config
from posterior_matching_torch.config import PM_VADE_CONFIGS
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
from posterior_matching_torch.train.trainer import pm_vade_trainer
from posterior_matching_torch.utils import make_run_dir


def main(argv: Optional[Sequence[str]] = None) -> int:
    mesh.refuse_ranks("train_pm_vade", "train_pm_vade.py:104 trains on one device")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args, config = parse_config(parser, argv, PM_VADE_CONFIGS)
    device = resolve_device(args.device)
    resume = resume_state_from_dir(args.resume_dir)

    config["data"]["mask_generator"] = "UniformMaskGenerator"
    data = config["data"]
    train_dataset, val_dataset = load_datasets(data, seed=config["seed"])
    data_key = "image" if "image" in next(iter(val_dataset)) else "features"
    tree = convert.init_vade_tree(config["model"], seed=config["seed"], partial=True)
    model = convert.vade_from_jax(tree, config["model"], device=device)
    vade_state = load_train_state(os.path.join(config["vade_dir"], "train_state.pkl"))
    mask_fn = get_mask_generator("UniformMaskGenerator", device,
                                 **(data.get("mask_generator_kwargs") or {}))
    trainer = pm_vade_trainer(model, config, seed=config["seed"], mask_fn=mask_fn,
                              data_key=data_key, device=device)
    trainer.init(convert.to_torch(convert.vade_state_dict(vade_state.params)))

    run_dir = make_run_dir(prefix=f"pm-vade-{data['dataset']}")
    print("Using run directory:", run_dir, flush=True)
    save_train_meta(run_dir, config)
    callbacks = [CheckpointCallback(os.path.join(run_dir, "train_state.pkl")),
                 LearningRateLoggerCallback(trainer.optimizer.schedule),
                 TensorBoardCallback(os.path.join(run_dir, "tb"))]
    with open(os.path.join(run_dir, "model_config.json"), "w") as fp:
        json.dump(config["model"], fp)

    print("Starting main training...", flush=True)
    trainer.fit(train_dataset, config["steps"], callbacks, val_batches=val_dataset,
                validation_freq=config["validation_freq"], resume_from=resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())

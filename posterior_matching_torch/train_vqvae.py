"""Trains a VQ-VAE, stage 1 of the PM-VQVAE pipeline, on the GPU.

Counterpart of ``train_vqvae.py:69-134``. Run it as::

    python -m posterior_matching_torch.train_vqvae --config vqvae_celeb_a \\
        [--config.steps 1000] [--config.validation_freq 500] [--config.seed 0] \\
        [--device cpu]

- ``--config`` is ``vqvae_celeb_a``, ``vqvae_mnist`` or ``vqvae_digits16``;
  ``--config.<path> <value>``, ``--device`` and ``--resume_dir`` as
  :mod:`posterior_matching_torch.cli` reads them.
- The loss is the decoder's reconstruction loss plus the commitment loss,
  logged with ``perplexity``, ``reconstruction_loss`` and ``vq_loss``
  (:84-98); Adam at the constant ``learning_rate``; the codebook's EMA
  advances on training steps only (``vqvae_trainer``); validation runs on
  the configuration's validation split every ``validation_freq`` steps and
  at the last. Images are scaled to [0, 1].
- Weights start from the JAX package's initialisation, drawn from the
  seed. The run directory ``runs/vqvae-<dataset>-<timestamp>/`` holds
  ``model_config.json`` (the config's ``model`` block), ``train_meta.json``,
  ``train_state.pkl`` (``params`` and ``state = {"vq_ema": ...}`` in the
  JAX package's layout), written at every validation, and ``tb/``, the
  TensorBoard events of each validation's logs with ``reconstructions``:
  ``[x | reconstruction]`` strips of 3 validation images
  (:class:`ReconstructionCallback`). Either package's ``train_pm_vqvae``
  reads it as its ``vqvae_dir``.
- ``--resume_dir`` continues a run of either package, its EMA codebook
  included, into a fresh run directory.
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

import torch

from posterior_matching_torch import convert
from posterior_matching_torch.cli import parse_config
from posterior_matching_torch.data import load_datasets
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import resolve_device
from posterior_matching_torch.train.callbacks import (
    Callback,
    CheckpointCallback,
    TensorBoardCallback,
)
from posterior_matching_torch.train.resume import resume_state_from_dir, save_train_meta
from posterior_matching_torch.train.trainer import Trainer, vqvae_trainer
from posterior_matching_torch.utils import make_run_dir


class ReconstructionCallback(Callback):
    """Logs ``reconstructions``, ``[x | reconstruction]`` strips of the
    first ``num_examples`` images of ``dataset``'s first batch, at each
    validation (``train_vqvae.py:43-67``)."""

    def __init__(self, trainer: Trainer, dataset, num_examples: int = 3):
        self._trainer = trainer
        self._images = torch.as_tensor(next(iter(dataset))["image"][:num_examples],
                                       device=trainer.device)

    def on_validation_end(self, train_state, step, logs):
        with self._trainer.eval_parameters() as model:
            recon = model(self._images, is_training=False)["reconstruction"].clamp(0.0, 1.0)
        logs["reconstructions"] = torch.cat([self._images, recon], 2).cpu().numpy()


def main(argv: Optional[Sequence[str]] = None) -> int:
    mesh.refuse_ranks("train_vqvae", "train_vqvae.py:109 trains on one device")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args, config = parse_config(parser, argv, ("vqvae_mnist", "vqvae_celeb_a", "vqvae_digits16"))
    device = resolve_device(args.device)
    resume = resume_state_from_dir(args.resume_dir)

    train_dataset, val_dataset = load_datasets(config["data"], seed=config["seed"])
    params, state = convert.init_vqvae_tree(config["model"], seed=config["seed"])
    model = convert.vqvae_from_jax(params, state, config["model"], device=device)
    trainer = vqvae_trainer(model, config, seed=config["seed"], device=device)
    trainer.init()

    run_dir = make_run_dir(prefix=f"vqvae-{config['data']['dataset']}")
    print("Using run directory:", run_dir, flush=True)
    save_train_meta(run_dir, config)
    with open(os.path.join(run_dir, "model_config.json"), "w") as fp:
        json.dump(config["model"], fp)

    callbacks = [CheckpointCallback(os.path.join(run_dir, "train_state.pkl")),
                 ReconstructionCallback(trainer, val_dataset),
                 TensorBoardCallback(os.path.join(run_dir, "tb"))]
    trainer.fit(train_dataset, config["steps"], callbacks, val_batches=val_dataset,
                validation_freq=config["validation_freq"], resume_from=resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())

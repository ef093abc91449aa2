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
  ``model_config.json`` (the config's ``model`` block), ``train_meta.json``
  and ``train_state.pkl`` (``params`` and ``state = {"vq_ema": ...}`` in the
  JAX package's layout), written at every validation; either package's
  ``train_pm_vqvae`` reads it as its ``vqvae_dir``.
- It runs on the GPU unless ``--device cpu``, and raises without one.

Not ported yet: ``--resume_dir`` (refused), the TensorBoard logs and the
reconstruction images they show (``ROADMAP.md`` A6).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from posterior_matching_torch import convert
from posterior_matching_torch.cli import parse_config
from posterior_matching_torch.data import load_datasets
from posterior_matching_torch.runtime import resolve_device
from posterior_matching_torch.train.callbacks import CheckpointCallback
from posterior_matching_torch.train.resume import save_train_meta
from posterior_matching_torch.train.trainer import vqvae_trainer
from posterior_matching_torch.utils import make_run_dir


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args, config = parse_config(parser, argv, ("vqvae_mnist", "vqvae_celeb_a", "vqvae_digits16"))
    device = resolve_device(args.device)

    train_dataset, val_dataset = load_datasets(config["data"])
    params, state = convert.init_vqvae_tree(config["model"], seed=config["seed"])
    model = convert.vqvae_from_jax(params, state, config["model"], device=device)
    trainer = vqvae_trainer(model, config, seed=config["seed"], device=device)
    trainer.init()

    run_dir = make_run_dir(prefix=f"vqvae-{config['data']['dataset']}")
    print("Using run directory:", run_dir, flush=True)
    save_train_meta(run_dir, config)
    with open(os.path.join(run_dir, "model_config.json"), "w") as fp:
        json.dump(config["model"], fp)

    trainer.fit(train_dataset, config["steps"],
                [CheckpointCallback(os.path.join(run_dir, "train_state.pkl"))],
                val_batches=val_dataset, validation_freq=config["validation_freq"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Trains a Posterior Matching VDVAE on the GPU.

Counterpart of ``train_pm_vdvae.py:111-227``. Run it as::

    python -m posterior_matching_torch.train_pm_vdvae --config pm_vdvae_mnist \\
        [--config.steps 1000] [--config.validation_freq 500] [--config.seed 0] \\
        [--config.model.fused_chain=True] [--device cpu]

or over N GPUs of one host, one process each::

    python -m torch.distributed.run --nproc_per_node N \
        -m posterior_matching_torch.train_pm_vdvae --config pm_vdvae_mnist [...]

- ``--config`` is ``pm_vdvae_mnist`` or ``pm_vdvae_digits16``;
  ``--config.<path> <value>``, ``--device``, ``--resume_dir`` and
  ``--dist_backend`` as :mod:`posterior_matching_torch.cli` reads them.
- The loss is ``-ELBO + mean(pm_kl)``, logged with ``reconstruction_ll``,
  ``kl``, ``pm_kl`` and ``bpd`` (:135-150); the optimizer, EMA and skipping
  of non-finite updates are ``pm_vdvae_trainer``'s; masks are drawn on the
  device; validation runs on the configuration's validation split with the
  EMA parameters every ``validation_freq`` steps and at the last.
- Weights start from the JAX package's initialisation, drawn from the
  seed. The run directory ``runs/pm-vdvae-<dataset>-<timestamp>/`` holds
  ``model_config.json`` (the keys of the config file's ``model`` block:
  ``fused_chain`` is this run's execution option and is not written),
  ``train_meta.json``, ``train_state.pkl``, written at every validation
  in the JAX package's layout, which the JAX CLIs evaluate and resume, and
  ``tb/``, the TensorBoard events of each validation's logs with
  ``learning_rate`` and the images of :class:`ReconstructionCallback`.
- ``--resume_dir`` continues a run of either package, its EMA parameters
  included, into a fresh run directory.
- It runs on the GPU unless ``--device cpu``, and raises without one.
  The configuration's batch sizes are per device: under a launcher's W
  ranks (``--dist_backend`` ``nccl`` on the GPU and ``gloo`` on the CPU
  unless given) the global batches are W times theirs
  (``train_pm_vdvae.py:118-122``), each rank steps on its rows
  (:class:`~posterior_matching_torch.train.trainer.Trainer`), and rank 0
  alone makes the run directory and writes its files and events.
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
from posterior_matching_torch.cli import add_dist_backend, parse_config
from posterior_matching_torch.config import PM_VDVAE_MNIST
from posterior_matching_torch.data import load_datasets
from posterior_matching_torch.masking import add_mask, get_mask_generator
from posterior_matching_torch.models.vdvae import vdvae_impute
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import resolve_device
from posterior_matching_torch.train.callbacks import (
    Callback,
    CheckpointCallback,
    LearningRateLoggerCallback,
    TensorBoardCallback,
)
from posterior_matching_torch.train.resume import resume_state_from_dir, save_train_meta
from posterior_matching_torch.train.trainer import Trainer, derive_seed, pm_vdvae_trainer
from posterior_matching_torch.utils import make_run_dir


def _as_image(t: torch.Tensor) -> np.ndarray:
    """Values in [0, 255] cast to uint8 (truncated), over 255."""
    return t.cpu().numpy().astype(np.uint8) / 255.0


class ReconstructionCallback(Callback):
    """Logs, from the EMA parameters (the model's own without an EMA), for
    the first ``num_examples`` images of ``dataset``'s first batch:
    ``reconstructions`` (``[x | reconstruction]``), ``imputations``
    (``[x | x_o | 8 imputations]``, the unobserved pixels of ``x_o`` at
    127.5) and 8 unconditional ``samples``, each cast to uint8 and over 255,
    at each validation (``train_pm_vdvae.py:59-100``). The mask and the
    draws come from a seed derived from (run seed, step)."""

    def __init__(self, trainer: Trainer, dataset, mask_fn, num_examples: int = 8):
        self._trainer, self._mask_fn = trainer, mask_fn
        self._images = torch.as_tensor(next(iter(dataset))["image"][:num_examples],
                                       device=trainer.device)

    def on_validation_end(self, train_state, step, logs):
        trainer, x = self._trainer, self._images
        gen = torch.Generator(device=trainer.device).manual_seed(
            derive_seed(trainer.seed, step, 4))
        b = add_mask({"image": x}, gen, self._mask_fn)["mask"]
        with trainer.eval_parameters() as model:
            recon = model(x, b, gen)["reconstruction"]
            imputations = vdvae_impute(model, x, b, 8, generator=gen)
            samples = model.sample(8, gen)
        x_o = torch.where(b == 1, x, 127.5)
        n, s, h, w, c = imputations.shape
        strip = imputations.transpose(1, 2).reshape(n, h, s * w, c)
        logs["reconstructions"] = _as_image(torch.cat([x, recon], 2))
        logs["imputations"] = _as_image(torch.cat([x, x_o, strip], 2))
        logs["samples"] = _as_image(samples)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_dist_backend(parser)
    args, config = parse_config(parser, argv, ("pm_vdvae_mnist", "pm_vdvae_digits16"))
    with mesh.process_group(args.device, args.dist_backend):
        return _train(args, config)


def _train(args, config) -> int:
    device = resolve_device(args.device)
    resume = resume_state_from_dir(args.resume_dir)

    data = dict(config["data"])
    data["train_batch_size"] *= mesh.world_size()
    data["val_batch_size"] *= mesh.world_size()
    train_dataset, val_dataset = load_datasets(data, normalize_images=False, seed=config["seed"])
    tree = convert.init_pm_vdvae_tree(config["model"], seed=config["seed"])
    model = convert.pm_vdvae_from_jax(tree, config["model"], device=device)
    mask_fn = get_mask_generator(data["mask_generator"], device,
                                 **(data.get("mask_generator_kwargs") or {}))
    trainer = pm_vdvae_trainer(model, config, seed=config["seed"], mask_fn=mask_fn,
                               device=device)
    trainer.init()

    callbacks = []
    if mesh.rank() == 0:
        run_dir = make_run_dir(prefix=f"pm-vdvae-{data['dataset']}")
        print("Using run directory:", run_dir, flush=True)
        save_train_meta(run_dir, config)
        with open(os.path.join(run_dir, "model_config.json"), "w") as fp:
            json.dump({k: config["model"][k] for k in PM_VDVAE_MNIST}, fp)
        callbacks = [CheckpointCallback(os.path.join(run_dir, "train_state.pkl")),
                     ReconstructionCallback(trainer, val_dataset, mask_fn),
                     LearningRateLoggerCallback(trainer.optimizer.schedule),
                     TensorBoardCallback(os.path.join(run_dir, "tb"))]
    trainer.fit(train_dataset, config["steps"], callbacks, val_batches=val_dataset,
                validation_freq=config["validation_freq"], resume_from=resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())

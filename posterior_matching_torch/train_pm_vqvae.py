"""Trains a PM-VQVAE, stage 2: partial encoder and conditional PixelCNN on a
frozen VQ-VAE, on the GPU.

Counterpart of ``train_pm_vqvae.py:88-224``. Run it as::

    python -m posterior_matching_torch.train_pm_vqvae --config pm_vqvae_celeb_a \\
        --config.vqvae_dir runs/vqvae-celeb_a-<timestamp> [--config.steps 1000] \\
        [--config.validation_freq 500] [--config.seed 0] [--chain_segment 4] \\
        [--device cpu]

- ``--config`` is ``pm_vqvae_celeb_a``, ``pm_vqvae_mnist`` or
  ``pm_vqvae_digits16`` (64 filters and 128 codes: the kernels' other
  build);
  ``--config.<path> <value>``, ``--device`` and ``--resume_dir`` as
  :mod:`posterior_matching_torch.cli` reads them.
- ``vqvae_dir`` is a stage-1 run directory of either package: its
  ``model_config.json`` builds the VQ-VAE and sets ``pixel_cnn.num_indices``
  to its ``num_embeddings`` (:99-105); its ``train_state.pkl`` warm-starts
  the ``vqvae`` subtree and its ``vq_ema`` codebook (:212-223), which stay
  frozen: no gradient, no update, the codebook never moved.
- ``--chain_segment`` chooses the PixelCNN chain's kernels: ``stream`` (the
  default, one launch a pass), ``1`` (one pair launch a level) or an
  integer ``L`` (segments of ``L`` levels), as ``PM_TPU_CHAIN_SEGMENT`` does
  in the JAX package. It is this run's execution option: no file holds it.
- The loss is ``-mean log p(codes | cond)`` (:144-157) under Adam with the
  exponential decay (``pm_vqvae_trainer``), masks drawn on the device;
  validation every ``validation_freq`` steps and at the last. Other
  weights start from the JAX package's initialiser families, drawn from
  the seed. Images are scaled to [0, 1].
- The run directory ``runs/pm-vqvae-<dataset>-<timestamp>/`` holds
  ``config.json`` (the configuration's own keys), ``vqvae_config.json``,
  ``train_meta.json``, ``train_state.pkl`` in the JAX package's layout,
  which ``eval_pm_vqvae.py`` and ``convert.load_pm_vqvae`` read, and
  ``tb/``, the TensorBoard events of each validation's logs with
  ``imputations``: ``[x | x_o | 5 imputations]`` strips of 3 validation
  images through the raster sampler (:class:`ImputationCallback`).
- ``--resume_dir`` continues a run of either package (a ``packed_chain``
  one too) into a fresh run directory; ``vqvae_dir`` still names the
  VQ-VAE's configuration.
- It runs on the GPU unless ``--device cpu``, and raises without one, in
  one process, as the JAX CLI runs on one device: a launcher's
  ``WORLD_SIZE`` above 1 is refused by name.

Not ported yet: ``compute_dtype`` (refused unless None).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence, Union

import torch

from posterior_matching_torch import convert
from posterior_matching_torch.cli import parse_config
from posterior_matching_torch.data import load_datasets
from posterior_matching_torch.masking import add_mask, get_mask_generator
from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import resolve_device
from posterior_matching_torch.train.callbacks import (
    Callback,
    CheckpointCallback,
    TensorBoardCallback,
)
from posterior_matching_torch.train.resume import resume_state_from_dir, save_train_meta
from posterior_matching_torch.train.state import load_train_state
from posterior_matching_torch.train.trainer import Trainer, derive_seed, pm_vqvae_trainer
from posterior_matching_torch.utils import make_run_dir


class ImputationCallback(Callback):
    """Logs ``imputations``, ``[x | x_o | imputations...]`` strips (the
    unobserved pixels of ``x_o`` at 0.5) of the first ``num_examples``
    images of ``dataset``'s first batch, ``num_samples`` each through
    :func:`~posterior_matching_torch.models.pm_vqvae.pm_vqvae_impute`, at
    each validation (``train_pm_vqvae.py:52-85``). The mask and the samples
    are drawn from a seed derived from (run seed, step)."""

    def __init__(self, trainer: Trainer, dataset, mask_fn, num_examples: int = 3,
                 num_samples: int = 5):
        self._trainer, self._mask_fn, self._num_samples = trainer, mask_fn, num_samples
        self._images = torch.as_tensor(next(iter(dataset))["image"][:num_examples],
                                       device=trainer.device)

    def on_validation_end(self, train_state, step, logs):
        trainer, x = self._trainer, self._images
        gen = torch.Generator(device=trainer.device).manual_seed(
            derive_seed(trainer.seed, step, 4))
        b = add_mask({"image": x}, gen, self._mask_fn)["mask"]
        with trainer.eval_parameters() as model:
            imputations = pm_vqvae_impute(model, x, b, self._num_samples, generator=gen)
        x_o = torch.where(b == 1, x, 0.5)
        n, s, h, w, c = imputations.shape
        strip = imputations.transpose(1, 2).reshape(n, h, s * w, c)
        logs["imputations"] = torch.cat([x, x_o, strip], 2).cpu().numpy()


def chain_segment(raw: str) -> Union[str, int]:
    """``stream``, or a segment length >= 1."""
    if raw == "stream":
        return raw
    if not raw.isdigit() or int(raw) < 1:
        raise argparse.ArgumentTypeError(f"'stream' or an integer >= 1, not {raw!r}")
    return int(raw)


def main(argv: Optional[Sequence[str]] = None) -> int:
    mesh.refuse_ranks("train_pm_vqvae", "train_pm_vqvae.py:187 trains on one device")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain_segment", type=chain_segment, default="stream",
                        help="the PixelCNN chain's kernels: stream, 1 (pairs) or L (segments)")
    args, config = parse_config(parser, argv,
                                ("pm_vqvae_mnist", "pm_vqvae_celeb_a", "pm_vqvae_digits16"))
    if config["compute_dtype"] is not None:
        parser.error("compute_dtype is not ported: the port computes in float32")
    device = resolve_device(args.device)
    resume = resume_state_from_dir(args.resume_dir)

    data = config["data"]
    train_dataset, val_dataset = load_datasets(data, seed=config["seed"])
    with open(os.path.join(config["vqvae_dir"], "model_config.json")) as fp:
        vqvae_config = json.load(fp)
    vqvae_state = load_train_state(os.path.join(config["vqvae_dir"], "train_state.pkl"))
    config["pixel_cnn"]["num_indices"] = vqvae_config["num_embeddings"]

    params, _ = convert.random_pm_vqvae_tree(
        config["conditional_dim"], vqvae_config, config["pixel_cnn"], seed=config["seed"])
    params["vqvae"] = vqvae_state.params
    state = {"vq_ema": {"vqvae": vqvae_state.state["vq_ema"]}}
    model = convert.pm_vqvae_from_jax(params, state, config["conditional_dim"], vqvae_config,
                                      config["pixel_cnn"], device=device,
                                      chain_segment=args.chain_segment)
    mask_fn = get_mask_generator(data["mask_generator"], device,
                                 **(data.get("mask_generator_kwargs") or {}))
    trainer = pm_vqvae_trainer(model, config, seed=config["seed"], mask_fn=mask_fn,
                               device=device)
    trainer.init()

    run_dir = make_run_dir(prefix=f"pm-vqvae-{data['dataset']}")
    print("Using run directory:", run_dir, flush=True)
    save_train_meta(run_dir, config)
    with open(os.path.join(run_dir, "config.json"), "w") as fp:
        json.dump(config, fp)
    with open(os.path.join(run_dir, "vqvae_config.json"), "w") as fp:
        json.dump(vqvae_config, fp)

    callbacks = [CheckpointCallback(os.path.join(run_dir, "train_state.pkl")),
                 ImputationCallback(trainer, val_dataset, mask_fn),
                 TensorBoardCallback(os.path.join(run_dir, "tb"))]
    trainer.fit(train_dataset, config["steps"], callbacks, val_batches=val_dataset,
                validation_freq=config["validation_freq"], resume_from=resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())

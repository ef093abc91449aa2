"""Trains a Posterior Matching VDVAE on the GPU.

Counterpart of ``train_pm_vdvae.py:111-227``. Run it as::

    python -m posterior_matching_torch.train_pm_vdvae --config pm_vdvae_mnist \\
        [--config.steps 1000] [--config.validation_freq 500] [--config.seed 0] \\
        [--config.model.fused_chain=True] [--device cpu]

- ``--config`` names a configuration of
  :data:`posterior_matching_torch.config.CONFIGS`; each ``--config.<path>
  <value>`` (or ``--config.<path>=<value>``) sets one of its entries, the
  value read as a Python literal (``True``, ``16``, ``1.5e-4``, ``None``)
  or else kept as a string. An entry the configuration lacks is refused.
- The loss is ``-ELBO + mean(pm_kl)``, logged with ``reconstruction_ll``,
  ``kl``, ``pm_kl`` and ``bpd`` (:135-150); the optimizer, EMA and skipping
  of non-finite updates are ``pm_vdvae_trainer``'s; masks are drawn on the
  device; validation runs on the configuration's validation split with the
  EMA parameters every ``validation_freq`` steps and at the last.
- Weights start from the JAX package's initialisation, drawn from the
  seed. The run directory ``runs/pm-vdvae-<dataset>-<timestamp>/`` holds
  ``model_config.json``, ``train_meta.json`` and ``train_state.pkl``,
  written at every validation in the JAX package's layout, which the JAX
  CLIs evaluate.
- It runs on the GPU unless ``--device cpu``, and raises without one.
  One device: the configuration's per-device batch is the batch.

Not ported yet: ``--resume_dir`` (refused), the TensorBoard logs and the
reconstruction images they show.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from posterior_matching_torch import convert
from posterior_matching_torch.config import CONFIGS
from posterior_matching_torch.data import load_datasets
from posterior_matching_torch.masking import get_mask_generator
from posterior_matching_torch.runtime import resolve_device
from posterior_matching_torch.train.callbacks import CheckpointCallback, LearningRateLoggerCallback
from posterior_matching_torch.train.resume import resolve_seed, save_train_meta
from posterior_matching_torch.train.trainer import pm_vdvae_trainer
from posterior_matching_torch.utils import make_run_dir


def _value(raw: str) -> Any:
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def parse_overrides(args: Sequence[str]) -> List[Tuple[List[str], Any]]:
    """``--config.a.b=v`` / ``--config.a.b v`` flags -> ``(["a", "b"], v)``."""
    out, i = [], 0
    while i < len(args):
        flag = args[i]
        if not flag.startswith("--config."):
            raise ValueError(f"unknown argument {flag!r}")
        key, eq, raw = flag[len("--config."):].partition("=")
        if not eq:
            if i + 1 == len(args):
                raise ValueError(f"{flag} needs a value")
            i += 1
            raw = args[i]
        out.append((key.split("."), _value(raw)))
        i += 1
    return out


def apply_overrides(config: Dict[str, Any], overrides) -> None:
    for path, value in overrides:
        node = config
        for key in path[:-1]:
            node = node.get(key) if isinstance(node, dict) else None
        if not isinstance(node, dict) or path[-1] not in node:
            raise KeyError(f"--config.{'.'.join(path)}: the configuration has no such entry")
        node[path[-1]] = value


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, choices=sorted(CONFIGS))
    parser.add_argument("--device", default=None, help="the GPU unless 'cpu'")
    parser.add_argument("--resume_dir", default=None)
    args, rest = parser.parse_known_args(argv)
    if args.resume_dir:
        parser.error("--resume_dir is not ported yet: the port's optimizer state is not "
                     "optax's layout (ROADMAP.md A2)")
    config = CONFIGS[args.config]()
    try:
        apply_overrides(config, parse_overrides(rest))
    except (ValueError, KeyError) as err:
        parser.error(str(err))
    config["seed"] = resolve_seed(config)
    device = resolve_device(args.device)

    data = dict(config["data"])
    train_dataset, val_dataset = load_datasets(data, normalize_images=False)
    tree = convert.init_pm_vdvae_tree(config["model"], seed=config["seed"])
    model = convert.pm_vdvae_from_jax(tree, config["model"], device=device)
    trainer = pm_vdvae_trainer(model, config, seed=config["seed"],
                               mask_fn=get_mask_generator(data["mask_generator"], device),
                               device=device)
    trainer.init()

    run_dir = make_run_dir(prefix=f"pm-vdvae-{data['dataset']}")
    print("Using run directory:", run_dir, flush=True)
    save_train_meta(run_dir, config)
    with open(os.path.join(run_dir, "model_config.json"), "w") as fp:
        json.dump(config["model"], fp)

    callbacks = [CheckpointCallback(os.path.join(run_dir, "train_state.pkl")),
                 LearningRateLoggerCallback(trainer.optimizer.schedule)]
    trainer.fit(train_dataset, config["steps"], callbacks, val_batches=val_dataset,
                validation_freq=config["validation_freq"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

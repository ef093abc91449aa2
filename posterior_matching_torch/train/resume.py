"""The training seed and the run directory's ``train_meta.json``.

Counterpart, in part, of ``posterior_matching_tpu/train/resume.py``: the
seed rule of ``resolve_seed`` (:33-61) without ``--resume_dir``, and
``save_train_meta`` (:64-70), so that a run directory written by the port
records its seed as the JAX package's does. Continuing a run from its
checkpoint waits for the optimizer state to be written in optax's layout
(``ROADMAP.md`` A6); the training CLI refuses ``--resume_dir`` until then.
"""
from __future__ import annotations

import json
import os
import random
from typing import Any, Mapping


def resolve_seed(config: Mapping[str, Any]) -> int:
    """An explicit ``config["seed"]``, else a fresh draw."""
    if config.get("seed") is not None:
        return int(config["seed"])
    return random.randint(0, int(2e9))


def save_train_meta(run_dir: str, config: Mapping[str, Any]) -> None:
    """Writes ``train_meta.json``: the resolved seed and the step target."""
    meta = {"seed": int(config["seed"]), "steps": int(config.get("steps", 0))}
    with open(os.path.join(run_dir, "train_meta.json"), "w") as fp:
        json.dump(meta, fp)

"""``--resume_dir``: the training seed, the run directory's
``train_meta.json`` and the checkpoint a run continues from.

Counterpart of ``posterior_matching_tpu/train/resume.py``: the seed rule of
``resolve_seed`` (:33-61), ``save_train_meta`` (:64-70) and the checkpoint
read of ``resume_state_from_flag`` (:73-84), with the run directory passed
in rather than read from a flag. With the run's seed restored, every draw of
a resumed run (masks, noise, dropout, the shuffle) is the interrupted run's,
so resuming and training on equals training straight through.
"""
from __future__ import annotations

import json
import os
import random
from typing import Any, Mapping, Optional

from posterior_matching_torch.train.state import TrainState, load_train_state


def resolve_seed(config: Mapping[str, Any], resume_dir: Optional[str] = None) -> int:
    """An explicit ``config["seed"]``, else the seed in ``resume_dir``'s
    ``train_meta.json``, else a fresh draw (with a warning when
    ``resume_dir`` has no seed to give: the resumed draws then differ from
    the interrupted run's)."""
    if config.get("seed") is not None:
        return int(config["seed"])
    if resume_dir:
        meta_path = os.path.join(resume_dir, "train_meta.json")
        try:
            with open(meta_path) as fp:
                seed = int(json.load(fp)["seed"])
            print(f"Restored training seed {seed} from {meta_path}", flush=True)
            return seed
        except (OSError, ValueError, KeyError, TypeError):
            print(f"WARNING: {meta_path} has no recoverable seed; drawing a fresh one. The "
                  "resumed mask, noise and shuffle streams will NOT match the original "
                  "run's.", flush=True)
    return random.randint(0, int(2e9))


def save_train_meta(run_dir: str, config: Mapping[str, Any]) -> None:
    """Writes ``train_meta.json``: the resolved seed and the step target."""
    meta = {"seed": int(config["seed"]), "steps": int(config.get("steps", 0))}
    with open(os.path.join(run_dir, "train_meta.json"), "w") as fp:
        json.dump(meta, fp)


def resume_state_from_dir(run_dir: Optional[str]) -> Optional[TrainState]:
    """The ``train_state.pkl`` of ``run_dir`` (None without a run
    directory); raises ``FileNotFoundError`` when it has none."""
    if not run_dir:
        return None
    path = os.path.join(run_dir, "train_state.pkl")
    if not os.path.exists(path):
        raise FileNotFoundError(f"--resume_dir={run_dir} has no train_state.pkl")
    state = load_train_state(path)
    print(f"Resuming from {path} at step {int(state.step)}", flush=True)
    return state

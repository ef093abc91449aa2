"""Model FLOPs of a training step (``work/<family>.py``) times the window's steps
a second, over the float32 peak."""
import importlib

from pmbench.readers import mfu_pct
from pmbench.work import peaks


def read(cell, outcome):
    if not outcome.facts.get("window_s"):
        return None
    work = importlib.import_module(f"pmbench.work.{cell.family}")
    steps_per_s = outcome.facts["steps"] / outcome.facts["window_s"]
    return mfu_pct(work.train_step_flops(cell.config), steps_per_s, peaks.FLOAT32_FLOPS)

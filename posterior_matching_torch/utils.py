"""Small helpers (counterpart of ``posterior_matching_tpu/utils.py``)."""
from __future__ import annotations

import math
import os
from datetime import datetime
from typing import Optional

import torch


def logmeanexp(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``log(mean(exp(x)))`` along ``dim`` (``utils.py:105-108``)."""
    return torch.logsumexp(x, dim) - math.log(x.shape[dim])


def make_run_dir(path: str = "runs", prefix: Optional[str] = None) -> str:
    """Creates ``runs/<prefix>-<timestamp>/`` (``utils.py:50-57``)."""
    run_id = datetime.now().strftime("%Y%m%d-%H%M%S")
    if prefix is not None:
        run_id = prefix + "-" + run_id
    run_dir = os.path.join(path, run_id)
    os.makedirs(run_dir)
    return run_dir

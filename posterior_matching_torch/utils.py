"""Small numerical helpers (counterpart of ``posterior_matching_tpu/utils.py``)."""
from __future__ import annotations

import math

import torch


def logmeanexp(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``log(mean(exp(x)))`` along ``dim`` (``utils.py:105-108``)."""
    return torch.logsumexp(x, dim) - math.log(x.shape[dim])

"""Dense layer and the truncated-normal fan-in init.

Counterpart of ``posterior_matching_tpu/models/networks.py:17-29``. Kernels
keep flax's ``[in, out]`` layout so checkpoints map over unchanged.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def _trunc_normal_fan_in(shape: Sequence[int]) -> torch.Tensor:
    """Truncated normal in [-2, 2] scaled by 1/sqrt(fan_in), where fan_in is
    the product of every axis but the last (the haiku default)."""
    fan_in = math.prod(shape[:-1])
    out = torch.empty(tuple(shape))
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0)
    return out / math.sqrt(fan_in)


class Dense(nn.Module):
    """``x @ kernel + bias`` with a flax-layout ``[in, out]`` kernel."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(
            _trunc_normal_fan_in((in_features, out_features))
        )
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias

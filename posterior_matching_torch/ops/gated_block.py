"""Elementwise helpers shared with the sampler kernels.

Counterpart of ``posterior_matching_tpu/ops/gated_block.py:58-70``. The
``exp(min(z, 0)) - 1`` form (not ``expm1``) is the one the CUDA kernels
compute, so the plain path and the kernels agree to rounding.
"""
from __future__ import annotations

import torch


def _elu(z: torch.Tensor) -> torch.Tensor:
    z = z.float()
    return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)


def _concat_elu(z: torch.Tensor) -> torch.Tensor:
    return torch.cat([_elu(z), _elu(-z)], dim=-1)

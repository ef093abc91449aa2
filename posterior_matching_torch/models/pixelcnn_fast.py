"""Tap and dense helpers of the incrementally-cached sampler.

Counterpart of ``posterior_matching_tpu/models/pixelcnn_fast.py:37-52``: a
masked conv's valid region as per-tap ``[in, out]`` matrices, the form the
sampler's fused weight stacks are built from.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from posterior_matching_torch.models.pixelcnn import KernelBias


def _conv_taps(
    layer: KernelBias, valid_rows: Tuple[int, int], valid_cols: Tuple[int, int]
) -> Tuple[List[Tuple[int, int, torch.Tensor]], torch.Tensor]:
    """Masked-conv params -> ``([(dy, dx, w[in, out]), ...], bias)``, taps
    offset from the kernel centre."""
    kernel = layer.kernel
    kh, kw = kernel.shape[:2]
    cy, cx = kh // 2, kw // 2
    taps = [
        (ky - cy, kx - cx, kernel[ky, kx])
        for ky in range(valid_rows[0], valid_rows[1])
        for kx in range(valid_cols[0], valid_cols[1])
    ]
    return taps, layer.bias


def _dense(layer: KernelBias, x: torch.Tensor) -> torch.Tensor:
    return x @ layer.kernel + layer.bias

"""Tap geometry and elementwise helpers shared by the PixelCNN kernels.

Counterpart of ``posterior_matching_tpu/ops/gated_block.py:22-83``:
:class:`TapPlan` / :func:`plan_taps` (the statically sliced masked conv as
shifted taps), ``_elu``, ``_concat_elu`` and ``_concat_elu_bwd``. The
``exp(min(z, 0)) - 1`` form (not ``expm1``) is the one the CUDA kernels
compute, so the plain path and the kernels agree to rounding.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch


class TapPlan(NamedTuple):
    """Static geometry of a sliced masked conv."""

    skh: int  # sliced kernel height (r1 - r0)
    skw: int  # sliced kernel width (c1 - c0)
    pad_top: int
    pad_left: int

    def shifts(self) -> List[Tuple[int, int]]:
        """Each tap's source offset ``(dy, dx)``, tap-major as the flattened
        ``[T * cin, cout]`` kernels are: tap ``(i, j)`` of output position
        ``(y, x)`` reads ``(y + i - pad_top, x + j - pad_left)``, zero off
        the grid."""
        return [
            (i - self.pad_top, j - self.pad_left)
            for i in range(self.skh) for j in range(self.skw)
        ]


def plan_taps(
    kernel_size: Tuple[int, int],
    valid_rows: Tuple[int, int],
    valid_cols: Tuple[int, int],
) -> TapPlan:
    """SAME padding of the full stride-1 odd kernel is ``(k//2, k//2)``;
    keeping taps ``[v0, v1)`` shifts it to ``(k//2 - v0, (v1-1) - k//2)``.
    Only non-negative pads are supported, which every gated block has."""
    kh, kw = kernel_size
    (r0, r1), (c0, c1) = valid_rows, valid_cols
    pad_top = kh // 2 - r0
    pad_bottom = (r1 - 1) - kh // 2
    pad_left = kw // 2 - c0
    pad_right = (c1 - 1) - kw // 2
    if min(pad_top, pad_bottom, pad_left, pad_right) < 0:
        raise ValueError(
            f"fused gated block requires non-negative implied padding, got "
            f"{(pad_top, pad_bottom, pad_left, pad_right)} for kernel "
            f"{kernel_size} valid {valid_rows}x{valid_cols}"
        )
    return TapPlan(r1 - r0, c1 - c0, pad_top, pad_left)


def _elu(z: torch.Tensor) -> torch.Tensor:
    # at least float32: half types go up, float64 stays
    z = z.to(torch.promote_types(z.dtype, torch.float32))
    return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)


def _concat_elu(z: torch.Tensor) -> torch.Tensor:
    return torch.cat([_elu(z), _elu(-z)], dim=-1)


def _concat_elu_bwd(z: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """d/dz of ``concat_elu`` given the ``[..., 2C]`` cotangent; z is
    ``[..., C]``."""
    c = z.shape[-1]
    z = z.float()
    d_pos = torch.where(z > 0, 1.0, torch.exp(z))
    d_neg = torch.where(-z > 0, 1.0, torch.exp(-z))
    return g2[..., :c] * d_pos - g2[..., c:] * d_neg

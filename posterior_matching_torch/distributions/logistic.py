"""Discretized mixture of logistics (DMoL), the PM-VDVAE's pixel model.

Counterpart of ``posterior_matching_tpu/distributions/logistic.py:34-132``:
``log_prob`` (the quantized CDF difference with edge bins at ``low`` and
``high`` and a ``1e-12`` clamp, :73-109) and ``mean`` (the mixture-weighted
mean with the RGB channel coupling, clipped to [-1, 1] and rounded half to
even, :111-132). Parameters live in [-1, 1] space; pixels in ``[low, high]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F


@dataclass
class QuantizedLogisticMixture:
    component_logits: torch.Tensor   # [..., H, W, M]
    locs: torch.Tensor               # [..., H, W, M, C]
    scales: torch.Tensor             # [..., H, W, M, C]
    coeffs: Optional[torch.Tensor]   # [..., H, W, M, C (C - 1) / 2] or None
    low: float = 0.0
    high: float = 255.0
    num_channels: int = 1

    def _coupled_locs(self, value: torch.Tensor) -> torch.Tensor:
        if self.coeffs is None:
            return self.locs
        tv = (2.0 * (value - self.low) / (self.high - self.low) - 1.0)[..., None, :]
        locs = [self.locs[..., i] for i in range(self.num_channels)]
        n = 0
        for i in range(self.num_channels):
            for j in range(i):
                locs[i] = locs[i] + tv[..., j] * self.coeffs[..., n]
                n += 1
        return torch.stack(locs, -1)

    def log_prob(self, value: torch.Tensor, independent: bool = True) -> torch.Tensor:
        """Log-likelihood of integer-valued pixels ``[..., H, W, C]``: summed
        over (H, W) with ``independent``, else per pixel ``[..., H, W]``."""
        half = 0.5 * (self.high - self.low)
        locs = self.low + half * (self._coupled_locs(value) + 1.0)
        scales = self.scales * half
        v = value[..., None, :]
        plus_in = (v + 0.5 - locs) / scales
        minus_in = (v - 0.5 - locs) / scales
        log_cdf_plus = F.logsigmoid(plus_in)
        log_sf_minus = F.logsigmoid(-minus_in)
        cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(minus_in)
        mid = torch.log(torch.clamp(cdf_delta, min=1e-12))
        log_probs = torch.where(
            v <= self.low, log_cdf_plus, torch.where(v >= self.high, log_sf_minus, mid)
        ).sum(-1)
        mix = F.log_softmax(self.component_logits, -1)
        per_pixel = torch.logsumexp(log_probs + mix, -1)
        return per_pixel.sum((-2, -1)) if independent else per_pixel

    def mean_unrounded(self) -> torch.Tensor:
        """:meth:`mean` before its rounding."""
        weights = torch.softmax(self.component_logits, -1)[..., None]
        mean_locs = (self.locs * weights).sum(-2)
        if self.coeffs is not None:
            mean_coeffs = (self.coeffs * weights).sum(-2)
        channels, n = [], 0
        for i in range(self.num_channels):
            loc = mean_locs[..., i]
            for prev in channels:
                loc = loc + prev * mean_coeffs[..., n]
                n += 1
            channels.append(torch.clamp(loc, -1.0, 1.0))
        out = torch.stack(channels, -1)
        return self.low + 0.5 * (self.high - self.low) * (out + 1.0)

    def mean(self) -> torch.Tensor:
        """Mixture-weighted mean in ``[low, high]``, rounded half to even as
        ``jnp.round`` (and ``torch.round``) rounds."""
        return torch.round(self.mean_unrounded())

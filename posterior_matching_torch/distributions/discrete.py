"""The Bernoulli distribution on logits.

Counterpart of ``posterior_matching_tpu/distributions/discrete.py:9-38``
(``tfd.Bernoulli`` with the logits parameterisation), elementwise, with
what PM-VAE's likelihood uses: ``log_prob`` and ``mean``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass
class Bernoulli:
    logits: torch.Tensor

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """``x log sigmoid(l) + (1 - x) log sigmoid(-l)``."""
        x = x.to(self.logits.dtype)
        return x * F.logsigmoid(self.logits) + (1.0 - x) * F.logsigmoid(-self.logits)

    def mean(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

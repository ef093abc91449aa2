"""Adam with a learning-rate schedule, as the JAX training scripts compose it.

Counterpart of ``optax.chain(scale_by_adam(), scale_by_schedule(schedule),
scale(-1.0))`` (``train_pm_vqvae.py:170-175``), with optax's defaults (``b1 = 0.9``,
``b2 = 0.999``, ``eps = 1e-8``, ``eps_root = 0``; no ported config changes
them) and order of operations: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2
nu``, bias correction by the incremented count, ``u = mu_hat /
(sqrt(nu_hat + eps_root) + eps)``, and ``p <- p - schedule(count) u`` with
the count before the increment. Only the parameters it is given have state
and get updates: frozen parameters are simply not passed, which is what the
JAX trainer's ``multi_transform(... set_to_zero)`` does to them.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from posterior_matching_torch.train.schedules import Schedule


B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], schedule: Schedule):
        self.params = dict(params)
        self.schedule = schedule
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update from ``grads`` (keyed like ``params``), in place."""
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - B1 ** self.count
        c2 = 1.0 - B2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            mu = self.mu[k].mul_(B1).add_((1.0 - B1) * g)
            nu = self.nu[k].mul_(B2).add_((1.0 - B2) * (g * g))
            p.sub_(lr * ((mu / c1) / (torch.sqrt(nu / c2) + EPS)))

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}


def trainable_names(names: Sequence[str], frozen_prefixes: Sequence[str]):
    """The names outside every frozen subtree (``"vqvae"`` freezes
    ``vqvae.*``)."""
    return [n for n in names
            if not any(n == p or n.startswith(p + ".") for p in frozen_prefixes)]

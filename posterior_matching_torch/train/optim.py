"""Adam with a learning-rate schedule, as the JAX training scripts compose it.

:class:`Adam` is the PM-VQVAE chain; :class:`ClippedAdam` the PM-VDVAE one
and, without its clip, PM-VAE's (below).

Counterpart of ``optax.chain(scale_by_adam(), scale_by_schedule(schedule),
scale(-1.0))`` (``train_pm_vqvae.py:170-175``), with optax's defaults (``b1 =
0.9``, ``b2 = 0.999``, ``eps = 1e-8``, ``eps_root = 0``; ``eps`` is an option,
which the VaDE configurations set) and order of operations: ``mu = (1 - b1) g
+ b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, bias correction by the
incremented count, ``u = mu_hat / (sqrt(nu_hat + eps_root) + eps)``, and ``p
<- p - schedule(count) u`` with the count before the increment. Only the parameters it is given have state
and get updates: frozen parameters are simply not passed, which is what the
JAX trainer's ``multi_transform(... set_to_zero)`` does to them.

Each optimizer names the optax chain it stands for (``chain``, its
transforms in order), which fixes the layout of its state in a checkpoint
(``convert.optax_opt_state``); :meth:`Adam.load_state` takes a state back.
:class:`GroupedClippedAdam` is ``ClippedAdam`` under the JAX package's
``group_by_shape`` (``flat_optimizer``): the same updates, its state in
that layout.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from posterior_matching_torch.train.schedules import Schedule


B1, B2, EPS = 0.9, 0.999, 1e-8

# ``optax.adam(lr)`` (``train_vqvae.py:108``, ``train_vade.py:133``) and the
# CLIs' ``chain(scale_by_adam(), scale_by_schedule(schedule), scale(-1.0))``.
OPTAX_ADAM = ("scale_by_adam", "scale_by_learning_rate")
OPTAX_SCHEDULED_ADAM = ("scale_by_adam", "scale_by_schedule", "scale")


class Adam:
    # whether the state is group_by_shape's (GroupedClippedAdam)
    grouped = False

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Schedule, eps: float = EPS,
                 chain: Sequence[str] = OPTAX_SCHEDULED_ADAM):
        self.params = dict(params)
        self.schedule = schedule
        self.eps = float(eps)
        self.chain = tuple(chain)
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def _advance(self):
        """The step's learning rate (at the count before the increment) and
        bias corrections (at the count after it)."""
        lr = self.schedule(self.count)
        self.count += 1
        return lr, 1.0 - B1 ** self.count, 1.0 - B2 ** self.count

    def _direction(self, k: str, g: torch.Tensor, c1: float, c2: float) -> torch.Tensor:
        """Updates ``k``'s moments with ``g`` in place and returns Adam's
        direction ``mu_hat / (sqrt(nu_hat) + eps)``."""
        mu = self.mu[k].mul_(B1).add_((1.0 - B1) * g)
        nu = self.nu[k].mul_(B2).add_((1.0 - B2) * (g * g))
        return (mu / c1) / (torch.sqrt(nu / c2) + self.eps)

    def _update(self, p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """The update of ``p`` before the schedule scales it: Adam's
        direction ``u`` as it is (``ClippedAdam`` adds the decayed weights)."""
        return u

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update from ``grads`` (keyed like ``params``), in place."""
        lr, c1, c2 = self._advance()
        for k, p in self.params.items():
            p.sub_(lr * self._update(p, self._direction(k, grads[k], c1, c2)))

    @torch.no_grad()
    def load_state(self, count: int, mu: Dict[str, torch.Tensor],
                   nu: Dict[str, torch.Tensor]) -> None:
        """Continues from a state of the same parameters: the count, and
        the moments copied into this optimizer's own tensors."""
        for name, moments in (("mu", mu), ("nu", nu)):
            if set(moments) != set(self.params):
                diff = sorted(set(moments) ^ set(self.params))
                raise KeyError(f"{name} has other parameters than the optimizer: {diff[:5]}")
        self.count = int(count)
        for k in self.params:
            self.mu[k].copy_(mu[k])
            self.nu[k].copy_(nu[k])


class ClippedAdam(Adam):
    """``optax.chain(clip_by_global_norm(max_norm), scale_by_adam(),
    add_decayed_weights(weight_decay, mask=ndim != 1),
    scale_by_schedule(schedule), scale(-1.0))`` (``train_pm_vdvae.py:
    161-186``), in optax's order: the gradients are scaled by ``max_norm /
    norm`` (as ``(g / norm) * max_norm``) only when their global norm is at
    least ``max_norm``; Adam as :class:`Adam`; then ``weight_decay * p`` is
    added to the update of every parameter that is not 1-D (a scalar is
    decayed), and the update is scaled by the schedule. With ``max_norm``
    None there is no clip: PM-VAE's chain (``train_pm_vae.py:80-94``)."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Schedule,
                 max_norm: Optional[float], weight_decay: float = 0.0, eps: float = EPS):
        clip = () if max_norm is None else ("clip_by_global_norm",)
        super().__init__(params, schedule, eps, chain=(
            *clip, "scale_by_adam", "add_decayed_weights", "scale_by_schedule", "scale"))
        self.max_norm = None if max_norm is None else float(max_norm)
        self.weight_decay = float(weight_decay)

    def _update(self, p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return u + self.weight_decay * p if self.weight_decay and p.ndim != 1 else u

    def _clip(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``grads`` clipped by their global norm (as they are without a
        clip)."""
        if self.max_norm is None:
            return grads
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = ~(norm < self.max_norm)   # optax: keep g where norm < max_norm
        return {k: torch.where(clip, (g / norm) * self.max_norm, g) for k, g in grads.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        super().step(self._clip(grads))


def shape_groups(shapes: Dict[str, Tuple[int, ...]]) -> List[Tuple[tuple, List[str]]]:
    """``group_by_shape``'s plan (``posterior_matching_tpu/train/optim.py:
    45-53``) of float32 leaves named by their dotted tree paths: the leaves
    in the tree's flattening order (each level's keys sorted), grouped by
    (shape, dtype), the groups in the order of ``sorted(groups, key=str)``;
    each group as its key and its leaves' names."""
    groups: Dict[tuple, List[str]] = {}
    for name in sorted(shapes, key=lambda n: n.split(".")):
        groups.setdefault((tuple(shapes[name]), np.dtype("float32")), []).append(name)
    return [(k, groups[k]) for k in sorted(groups, key=str)]


class GroupedClippedAdam(ClippedAdam):
    """:class:`ClippedAdam` under ``group_by_shape`` (``train_pm_vdvae.py:
    167-186`` with ``flat_optimizer``): the moments of same-shaped
    parameters are stacked along a new leading axis, one stack a group
    (:func:`shape_groups`, the parameters named by their tree paths), and a
    step updates each group's stack in one elementwise pass; the decay
    applies to the parameters that are not 1-D, as ``stacked_shape_mask``
    judges a stack by its first slice. ``mu`` and ``nu`` name each
    parameter's slice of its group's stack. The global norm is summed
    parameter by parameter, as :class:`ClippedAdam` sums it, so the updates
    equal its bit for bit (the JAX package sums it over the stacks: the
    same norm to float32 rounding)."""

    grouped = True

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Schedule,
                 max_norm: Optional[float], weight_decay: float = 0.0, eps: float = EPS):
        super().__init__(params, schedule, max_norm, weight_decay, eps)
        self.groups = shape_groups({k: tuple(p.shape) for k, p in self.params.items()})
        self.stacks = []
        for _, names in self.groups:
            mu = torch.zeros_like(torch.stack([self.params[k] for k in names]))
            nu = torch.zeros_like(mu)
            self.stacks.append((mu, nu))
            for j, k in enumerate(names):
                self.mu[k], self.nu[k] = mu[j], nu[j]

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        grads = self._clip(grads)
        lr, c1, c2 = self._advance()
        for (key, names), (mu, nu) in zip(self.groups, self.stacks):
            g = torch.stack([grads[k] for k in names])
            mu.mul_(B1).add_((1.0 - B1) * g)
            nu.mul_(B2).add_((1.0 - B2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay and len(key[0]) != 1:
                u = u + self.weight_decay * torch.stack([self.params[k] for k in names])
            for j, k in enumerate(names):
                self.params[k].sub_(lr * u[j])


def trainable_names(names: Sequence[str],
                    trainable: Optional[Callable[[str, str], bool]] = None):
    """The names that ``trainable`` accepts (all of them without it).
    ``trainable`` sees a name as the JAX trainer's predicate sees its tree
    path (``trainer.py:193-205``): the module path, the name's dotted prefix
    with ``/`` for the dots (``""`` for a parameter at the top of the
    tree), and the leaf's name."""
    out = []
    for n in names:
        module, _, leaf = n.rpartition(".")
        if trainable is None or trainable(module.replace(".", "/"), leaf):
            out.append(n)
    return out

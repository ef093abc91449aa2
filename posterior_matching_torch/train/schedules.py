"""Learning-rate schedules.

Counterpart of the optax schedules the JAX training scripts use. Only the
flagship's is ported: ``optax.exponential_decay`` (``train_pm_vqvae.py:170``
with ``configs/pm_vqvae_celeb_a.py:42-46``), without the options no ported
config sets (``transition_begin``, ``staircase``, ``end_value``).
"""
from __future__ import annotations

from typing import Callable

Schedule = Callable[[int], float]


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Schedule:
    """``init_value * decay_rate ** (count / transition_steps)``, so the
    value at update count 0 is ``init_value``; constant when optax's would
    be (``transition_steps <= 0`` or ``decay_rate == 0``)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    return lambda count: init_value * decay_rate ** (count / transition_steps)

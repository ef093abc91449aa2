"""Learning-rate schedules.

Counterpart of the optax schedules the JAX training scripts use:
``optax.exponential_decay`` (``train_pm_vqvae.py:170`` with
``configs/pm_vqvae_celeb_a.py:42-46``), without the options no ported
config sets (``transition_begin``, ``staircase``, ``end_value``); and
PM-VDVAE's constant rate or ``optax.linear_schedule(0, lr, warm_up)``
(``train_pm_vdvae.py:161-165``).
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


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax's ``linear_schedule``: ``(init - end) (1 - c / steps) + end``
    with the count ``c`` clipped to ``[0, steps]``."""
    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1.0 - c / transition_steps) + end_value
    return schedule

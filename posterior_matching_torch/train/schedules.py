"""Learning-rate and beta schedules.

Counterpart of the optax schedules the JAX training scripts use:
``optax.exponential_decay`` (``train_pm_vqvae.py:170`` with
``configs/pm_vqvae_celeb_a.py:42-46``; ``train_pm_vae.py:82``), without the
options no ported config sets (``transition_begin``, ``end_value``, and
``staircase``, which the VaDE configurations name only as False); ``optax.linear_schedule`` with its ``transition_begin``
(PM-VDVAE's warm-up, ``train_pm_vdvae.py:161-165``, and ``pm_vae_bsds``'s
monotonic beta); and PM-VAE's beta schedules,
``cyclical_annealing_schedule`` and ``get_beta_schedule``
(``posterior_matching_tpu/train/schedules.py:9-43``), computed in float32
as the JAX package computes them.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np

Schedule = Callable[[int], float]


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, staircase: bool = False) -> Schedule:
    """``init_value * decay_rate ** (count / transition_steps)``, so the
    value at update count 0 is ``init_value``; constant when optax's would
    be (``transition_steps <= 0`` or ``decay_rate == 0``). ``staircase``
    True is refused."""
    if staircase:
        raise NotImplementedError("staircase exponential decay is not ported")
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    return lambda count: init_value * decay_rate ** (count / transition_steps)


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    """optax's ``linear_schedule``: ``(init - end) (1 - c / steps) + end``
    with ``c = count - transition_begin`` clipped to ``[0, steps]``;
    constant ``init_value`` when ``transition_steps <= 0``."""
    if transition_steps <= 0:
        return lambda count: init_value
    begin = max(transition_begin, 0)

    def schedule(count: int) -> float:
        c = min(max(count - begin, 0), transition_steps)
        return (init_value - end_value) * (1.0 - c / transition_steps) + end_value
    return schedule


def cyclical_annealing_schedule(low_value: float, high_value: float, period: int,
                                delay: int = 0) -> Schedule:
    """From ``delay`` on, ramps ``low -> high`` over the first half of each
    ``period`` and holds ``high`` for the second; 0 before ``delay``."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = min(max((count - delay) % period, 0), period // 2)
        frac = f32(1) - f32(c) / f32(period // 2)
        x = f32(low_value - high_value) * frac + f32(high_value)
        return float(x * f32(count >= delay))
    return schedule


def get_beta_schedule(config: Optional[Mapping[str, Any]]) -> Schedule:
    """PM-VAE's KL weight: 1 without a ``schedule``, else ``monotonic``
    (:func:`linear_schedule`) or ``cyclic``
    (:func:`cyclical_annealing_schedule`)."""
    cfg = dict(config or {})
    if "schedule" not in cfg:
        return lambda count: 1.0
    if cfg["schedule"] == "monotonic":
        return linear_schedule(cfg["low_value"], cfg["high_value"], cfg["transition_steps"],
                               cfg["transition_begin"])
    if cfg["schedule"] == "cyclic":
        return cyclical_annealing_schedule(cfg["low_value"], cfg["high_value"], cfg["period"],
                                           cfg["delay"])
    raise ValueError(f"unknown beta schedule: {cfg['schedule']}")

"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``). A
reader returns None where its run has nothing to read: no traced window, or no
kernel of its group in it."""
from __future__ import annotations

from typing import Optional, Sequence


def per_unit_launches(outcome) -> Optional[float]:
    tw = outcome.trace
    return None if tw is None or not tw.units else len(tw.kernels) / tw.units


def idle_pct(outcome, units: str) -> Optional[float]:
    """The share of a step or request, as the untraced window times it, in
    which no device operation runs: 1 - the device-busy seconds of a profiled
    unit over the window's seconds a unit (``facts[units]`` units in
    ``facts["window_s"]``). Not the traced window's own length: tracing the
    device records every launch, and slowed PM-VDVAE's launch-bound steps
    ~1.5x."""
    tw, facts = outcome.trace, outcome.facts
    if tw is None or not tw.units or not facts.get(units) or not facts.get("window_s"):
        return None
    return 100.0 * (1.0 - (tw.busy_s() / tw.units) / (facts["window_s"] / facts[units]))


def roofline_pct(outcome, marks: Sequence[str], bound_s_per_unit: float) -> Optional[float]:
    """The kernels' least time over their device time in the traced window."""
    tw = outcome.trace
    if tw is None:
        return None
    spent = tw.device_s(marks)
    return None if spent <= 0 else 100.0 * bound_s_per_unit * tw.units / spent


def mfu_pct(flops_per_unit: float, units_per_s: float, peak: float) -> float:
    return 100.0 * flops_per_unit * units_per_s / peak

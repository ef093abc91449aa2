"""Share of a training step, as the window times it, in which no device
operation runs (the device-busy seconds from the profiled steps)."""
from pmbench.readers import idle_pct


def read(cell, outcome):
    return idle_pct(outcome, "steps")

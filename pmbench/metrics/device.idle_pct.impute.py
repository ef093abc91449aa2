"""Share of a request, as the window times it, in which no device operation
runs (the device-busy seconds from the profiled requests)."""
from pmbench.readers import idle_pct


def read(cell, outcome):
    return idle_pct(outcome, "requests")

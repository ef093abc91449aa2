"""The gated chain kernels' share of their roofline in the profiled steps: the
least time of a step's stream launches (``work/gated_chain.py``) over the device
time of the kernels of the chain's namespace, ``gsk::``."""
from pmbench.readers import roofline_pct
from pmbench.work.gated_chain import train_step_bound_s


def read(cell, outcome):
    return roofline_pct(outcome, ("gsk::",), train_step_bound_s(cell.config))

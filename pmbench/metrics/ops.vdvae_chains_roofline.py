"""The PM-VDVAE chain kernels' share of their roofline in the profiled steps: the
least time of a step's block chain and decoder chain launches
(``work/vdvae_chains.py``) over the device time of the kernels of the chains'
namespaces (``bck::``, ``dck::``) and the decoder chain's own kernels."""
from pmbench.readers import roofline_pct
from pmbench.work.vdvae_chains import train_step_bound_s

MARKS = ("bck::", "dck::", "::z_into_state<", "::z_bwd<")


def read(cell, outcome):
    return roofline_pct(outcome, MARKS, train_step_bound_s(cell.config))

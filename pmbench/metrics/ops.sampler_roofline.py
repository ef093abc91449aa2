"""The raster sampler kernels' share of their roofline in the profiled requests:
the least time of a request's ``sampler_vrow`` and ``sampler_row`` launches
(``work/sampler.py``) over their device time."""
from pmbench.readers import roofline_pct
from pmbench.work.sampler import request_bound_s


def read(cell, outcome):
    return roofline_pct(outcome, ("row_kernel",), request_bound_s(cell.config, cell.traffic))

"""Device operations (kernels, copies, fills) a training step launches, over the
profiled steps."""
from pmbench.readers import per_unit_launches


def read(cell, outcome):
    return per_unit_launches(outcome)

"""Device operations an imputation request launches, over the profiled requests."""
from pmbench.readers import per_unit_launches


def read(cell, outcome):
    return per_unit_launches(outcome)

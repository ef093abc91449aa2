"""Mean host ms of a profiled request: the program's ``impute.request`` span
around ``pm_vqvae_impute`` (the partial encoder, both samplers, the decode and
the stitch)."""
from pmbench.spans import mean_ms, window_spans


def read(cell, outcome):
    return mean_ms(window_spans(outcome, "impute.request"), "impute.request")

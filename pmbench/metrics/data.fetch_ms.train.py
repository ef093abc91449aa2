"""Mean host ms of a batch fetch in the profiled steps: the program's
``data.fetch`` span in ``ArrayDataset`` (the native gather and rescale, the
transform)."""
from pmbench.spans import mean_ms, window_spans


def read(cell, outcome):
    return mean_ms(window_spans(outcome, "train.step"), "data.fetch")

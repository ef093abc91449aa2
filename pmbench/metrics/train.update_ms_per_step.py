"""Mean host ms of a profiled step's update: the program's ``train.update`` span
(the finiteness test, the optimizer, the buffers' restore, the EMA)."""
from pmbench.spans import mean_ms, window_spans


def read(cell, outcome):
    return mean_ms(window_spans(outcome, "train.step"), "train.update")

"""Mean host ms of a profiled step's prologue: the program's ``train.prologue``
span (the batch copied to the device, the mask generator)."""
from pmbench.spans import mean_ms, window_spans


def read(cell, outcome):
    return mean_ms(window_spans(outcome, "train.step"), "train.prologue")

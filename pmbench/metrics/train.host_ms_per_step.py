"""Mean host ms of a profiled step: the program's ``train.step`` span around
``Trainer.train_step`` (its self time is the loss's forward and the backward)."""
from pmbench.spans import mean_ms, window_spans


def read(cell, outcome):
    return mean_ms(window_spans(outcome, "train.step"), "train.step")

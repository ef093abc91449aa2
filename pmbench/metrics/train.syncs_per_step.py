"""Host-device syncs a profiled step makes: the program's ``sync`` spans inside
``train.step``, counted over the profiled steps and divided by their number."""
from pmbench.spans import inside, window_spans


def read(cell, outcome):
    timed = window_spans(outcome, "train.step")
    if timed is None or not outcome.trace.units:
        return None
    return len(inside(timed, "sync", "train.step")) / outcome.trace.units

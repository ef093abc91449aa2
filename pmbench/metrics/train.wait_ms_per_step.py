"""Host ms a profiled step waits for the device: the program's ``sync`` spans
inside ``train.step`` (the batch's copy, the finiteness test's reads), summed
over the profiled steps and divided by their number."""
from pmbench.spans import inside, window_spans


def read(cell, outcome):
    timed = window_spans(outcome, "train.step")
    if timed is None or not outcome.trace.units:
        return None
    return sum(t.ms for t in inside(timed, "sync", "train.step")) / outcome.trace.units

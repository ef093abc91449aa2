"""Of the profiled steps' device-idle seconds (the traced window less the union
of its kernels' intervals), the share that lies under the program's
``train.update`` spans, their ``sync`` spans included."""
from pmbench.spans import idle_share_pct, window_spans


def read(cell, outcome):
    return idle_share_pct(outcome.trace, window_spans(outcome, "train.step"), "train.update")

"""Mean host ms of a batch fetch from ``ArrayDataset`` (the native gather and
rescale) over the window: the benchmark's own span around each ``next()``."""


def read(cell, outcome):
    ms = outcome.facts.get("batch_ms")
    return sum(ms) / len(ms) if ms else None

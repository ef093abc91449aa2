"""Host spans at the port's layer boundaries, on the clock of the device trace.

``with span("train.step", step):`` records the span's name, its start and end on
``time.time_ns()`` (the Unix-epoch clock that ``torch.profiler``'s events carry,
so a span lines up with the kernels it launched), the index of the span that
encloses it and its unit: the step or request it belongs to, given to a
top-level span and inherited by every span inside it.

Spans record only while ``torch.profiler`` is on, and only on the main thread.
At every other time ``span()`` reads one flag and returns a shared no-op
context: no allocation, no clock read. Nothing is emitted into the profiler (a
``record_function`` range would show among the device's events and change what
a trace counts); the shared clock ties the spans to the trace.

Spans are kept in memory, up to ``MAX_SPANS``, counting those dropped past it;
:func:`spans` returns them, :func:`clear` empties the list.

The spans: ``data.fetch`` (a host batch: gather, rescale, transform),
``train.step`` (unit: the step; its self time is the loss's forward and the
backward), ``train.prologue`` (the batch to the device, the mask generator),
``train.update`` (the finiteness test, the optimizer, the buffers' restore,
the EMA), ``impute.request`` (unit: a request number) and ``sync`` (a call
that makes the host wait for the device)."""
from __future__ import annotations

import threading
import time
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

MAX_SPANS = 200_000


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]   # None while the span is open
    parent: Optional[int]   # index in spans() of the enclosing span
    unit: Optional[int]


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_MAIN = threading.main_thread().ident
_records: List[list] = []   # [name, start_ns, end_ns, parent, unit]
_open: List[int] = []       # indices of the open spans, innermost last
_dropped = 0


class _Recording:
    __slots__ = ("name", "unit", "record")

    def __init__(self, name: str, unit: Optional[int]):
        self.name, self.unit = name, unit

    def __enter__(self):
        parent = _open[-1] if _open else None
        unit = self.unit if self.unit is not None or not _open else _records[_open[0]][4]
        self.record = [self.name, time.time_ns(), None, parent, unit]
        _open.append(len(_records))
        _records.append(self.record)
        return self

    def __exit__(self, *exc):
        self.record[2] = time.time_ns()
        _open.pop()
        return False


def span(name: str, unit: Optional[int] = None):
    """A context that records one span while the profiler is on."""
    global _dropped
    if not _profiler._is_profiler_enabled:
        return _OFF
    if threading.get_ident() != _MAIN:
        return _OFF
    if len(_records) >= MAX_SPANS:
        _dropped += 1
        return _OFF
    return _Recording(name, unit)


def spans() -> List[Span]:
    """The recorded spans, in the order they opened."""
    return [Span(*r) for r in _records]


def dropped() -> int:
    """Spans not recorded since the last :func:`clear` because the list was full."""
    return _dropped


def clear() -> None:
    """Empties the list; refused while a span is open."""
    global _dropped
    if _open:
        raise RuntimeError("tracing.clear() inside an open span")
    _records.clear()
    _dropped = 0

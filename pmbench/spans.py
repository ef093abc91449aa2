"""Shared arithmetic of the readers of the program's own spans
(``posterior_matching_torch.tracing``, recorded while the profiler is on). A
reader takes the spans of this process whose top-level span starts inside the
traced window the metrics read (``profiling.profile_window``'s device-alone window:
the spans and the device's events share one clock), and returns None where the
run has no traced window, the program has no spans (a program without the
tracing module), or the window does not hold one top-level span a unit (a
``train.step`` a profiled step, an ``impute.request`` a profiled request)."""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

NO_SPAN = "no span"


class Timed(NamedTuple):
    """A span of the window: its name, the names from the outermost span that
    holds it down to its own, its start and end (us)."""
    name: str
    path: Tuple[str, ...]
    start_us: float
    end_us: float

    @property
    def ms(self) -> float:
        return (self.end_us - self.start_us) / 1e3


def program_spans() -> Optional[list]:
    try:
        from posterior_matching_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def in_window(tw, spans: Optional[Sequence], unit: str) -> Optional[List[Timed]]:
    """The closed spans (``tracing.Span``) whose top-level span starts inside
    ``tw`` (a step's spans count whole, should the device's clock end the
    window early), or None where there is no window or no spans, or where the
    spans named ``unit`` are not ``tw.units``."""
    if tw is None or spans is None:
        return None
    out = []
    for s in spans:
        path, top = [s.name], s
        while top.parent is not None:
            top = spans[top.parent]
            path.append(top.name)
        if s.end_ns is None or not tw.start_us <= top.start_ns / 1e3 < tw.end_us:
            continue
        out.append(Timed(s.name, tuple(reversed(path)), s.start_ns / 1e3, s.end_ns / 1e3))
    return out if sum(t.name == unit for t in out) == tw.units else None


def window_spans(outcome, unit: str) -> Optional[List[Timed]]:
    """:func:`in_window` over the spans this process recorded."""
    return in_window(outcome.trace, program_spans(), unit)


def mean_ms(timed: Optional[List[Timed]], name: str) -> Optional[float]:
    ms = [t.ms for t in timed or () if t.name == name]
    return sum(ms) / len(ms) if ms else None


def inside(timed: List[Timed], name: str, outer: str) -> List[Timed]:
    """The spans named ``name`` that a span named ``outer`` holds."""
    return [t for t in timed if t.name == name and outer in t.path[:-1]]


def idle_gaps(tw) -> List[Tuple[float, float]]:
    """The window's device-idle intervals (us): the complement, inside it, of
    the union of its kernels' intervals (the busy time of ``busy_s``)."""
    gaps, cursor = [], tw.start_us
    for s, e in sorted((s, e) for _, s, e in tw.kernels):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if tw.end_us > cursor:
        gaps.append((cursor, tw.end_us))
    return gaps


def _segments(timed: List[Timed], start: float, end: float) -> List[Tuple[float, float, str]]:
    """``[start, end]`` cut where a span opens or closes, each piece labelled
    with the path (``a/b/c``) of the innermost span over it, or ``NO_SPAN``.
    The spans of one thread nest, so a stack holds the open ones."""
    events = []
    for i, t in enumerate(timed):
        if t.end_us > t.start_us:   # an empty span covers no time
            depth = len(t.path)
            events.append((t.start_us, 1, depth, i))
            events.append((t.end_us, 0, -depth, i))
    events.sort()   # at one instant: closes first, inner ones first; then opens, outer first
    segs, stack, prev = [], [], start
    for t, opens, _, i in events:
        t = min(max(t, start), end)
        if t > prev:
            segs.append((prev, t, "/".join(timed[stack[-1]].path) if stack else NO_SPAN))
            prev = t
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    if end > prev:
        segs.append((prev, end, "/".join(timed[stack[-1]].path) if stack else NO_SPAN))
    return segs


def idle_by_span(tw, timed: List[Timed]) -> Dict[str, float]:
    """The window's device-idle seconds under each span, keyed by its path
    (``train.step/train.update/sync``), the innermost span winning;
    ``NO_SPAN`` for idle time under none. The values sum to the window's idle
    seconds."""
    out: Dict[str, float] = {}
    segs, j = _segments(timed, tw.start_us, tw.end_us), 0
    for a, b in idle_gaps(tw):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + (hi - lo) / 1e6
            k += 1
    return out


def idle_share_pct(tw, timed: Optional[List[Timed]], name: str) -> Optional[float]:
    """Of the window's device-idle seconds, the share under spans named
    ``name`` (their inner spans included)."""
    if timed is None:
        return None
    idle = idle_by_span(tw, timed)
    total = sum(idle.values())
    under = sum(v for k, v in idle.items() if name in k.split("/"))
    return 100.0 * under / total if total > 0 else None

"""A profiled window of device work, copied from the program's profiler helper
(``ops/profiling.py::profile_calls``) and kept whole: eight ``add`` kernels before
the calls and eight ``mul`` kernels after them mark the window, since the profiler
loses a window's first kernel and at times its tail; a window whose trace does not
start and end with them is profiled again, up to three times.

The window that the metrics read records the device's activity alone: recording
the host's ops too slows a launch-bound host (PM-VDVAE's ~33.6k launches a step
ran ~1.8x slower), so its idle share would measure the profiler. A second window
over the same work records both, and only names the breakdown's idle gaps."""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

Span = Tuple[str, float, float]   # name, start us, end us


@dataclass
class TraceWindow:
    """The device events between the markers, the host's ops over the same
    time (where they were recorded), how many units of work (steps, requests)
    ran in it, and the window whose host ops name the idle gaps."""
    units: int
    kernels: List[Span]
    host_ops: List[Span]
    start_us: float
    end_us: float
    named: Optional["TraceWindow"] = None

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of the
        kernels' intervals."""
        spans = sorted((s, e) for _, s, e in self.kernels)
        busy, cur = 0.0, None
        for s, e in spans:
            if cur is None or s > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        if cur is not None:
            busy += cur[1] - cur[0]
        return busy / 1e6

    def device_s(self, marks) -> float:
        """Summed device seconds of the kernels whose names hold one of
        ``marks``."""
        return sum(e - s for n, s, e in self.kernels if any(m in n for m in marks)) / 1e6


def profile_window(fn: Callable[[], object], units: int) -> Optional[TraceWindow]:
    """``fn()`` (which runs ``units`` steps or requests) under ``torch.profiler``
    recording the device alone, or None where no window was measured; then
    ``fn()`` once more recording the host's ops too, as its ``named`` window."""
    tw = _profile(fn, units, host=False)
    if tw is not None:
        tw.named = _profile(fn, units, host=True)
    return tw


def _profile(fn: Callable[[], object], units: int, host: bool) -> Optional[TraceWindow]:
    """One marked window. The profiler's raw events are read as they are (a few
    us an event), not through its ``events()`` tree, which takes minutes over a
    window of some 100,000 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", torch.cuda.current_device())
    lead, trail = torch.zeros(1, device=dev), torch.ones(1, device=dev)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(8):
                lead.add_(1.0)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            for _ in range(8):
                trail.mul_(1.0)
            torch.cuda.synchronize()
        raw = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
                e.device_type() == DeviceType.CUDA)
               for e in prof.profiler.kineto_results.events()]
        dev_ev = sorted((r for r in raw if r[3]), key=lambda r: r[1])
        if not dev_ev or "add" not in dev_ev[0][0].lower() \
                or "mul" not in dev_ev[-1][0].lower():
            continue
        lo, hi = 0, len(dev_ev)
        while lo < hi and "add" in dev_ev[lo][0].lower():
            lo += 1
        while hi > lo and "mul" in dev_ev[hi - 1][0].lower():
            hi -= 1
        if lo == 0 or hi == len(dev_ev):
            continue
        start, end = dev_ev[lo - 1][2], dev_ev[hi][1]
        kernels = [r[:3] for r in dev_ev[lo:hi]]
        host = [r[:3] for r in raw if not r[3] and r[2] > start and r[1] < end]
        return TraceWindow(units, kernels, host, start, end)
    return None


def breakdown(tw: TraceWindow, top: int = 10, gaps_named: int = 500) -> dict:
    """The device operations that took most time, and the idle gaps summed by
    what the host was doing in them: the ``gaps_named`` longest gaps of the
    ``named`` window (where there is one; its host ran slower under the
    profiler), each named by the innermost host op (other than a CUDA runtime
    call) under its middle."""
    by_name = {}
    for n, s, e in tw.kernels:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda t: -t[1])[:top]
    tw = tw.named or tw
    gaps, cursor = [], tw.start_us
    for s, e in sorted((s, e) for _, s, e in tw.kernels):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if tw.end_us > cursor:
        gaps.append((cursor, tw.end_us))
    host = sorted((h for h in tw.host_ops if not h[0].startswith("cuda")), key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:gaps_named]:
        mid, name = (a + b) / 2, "no host op"
        for i in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(
                starts, mid) - 5000), -1):
            if host[i][2] >= mid:
                name = host[i][0]
                break
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    gaps_top = sorted(idle.items(), key=lambda t: -t[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps_top]}

"""Timers of a call on the CUDA device, shared by ``chip_smoke.py``, the
breakdown tools and the GPU tests: the ms a call back to back (CUDA events),
the host's ms to enqueue one, and the device time and kernels of a call
(``torch.profiler``)."""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch


def time_ms(fn: Callable[[], object], reps: int, warmup: int = 1) -> float:
    """ms a call over ``reps`` back-to-back calls of ``fn`` (CUDA events),
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn: Callable[[], object]) -> float:
    """The host's ms to enqueue one ``fn()``: 10 calls back to back from an
    idle stream, the host clock stopped before the device is waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / 10
    torch.cuda.synchronize()
    return ms


def profile_calls(fn: Callable[[], object],
                  reps: int) -> Optional[Tuple[float, float, Dict[str, int]]]:
    """``reps`` calls of ``fn`` under ``torch.profiler``: (device ms a call,
    device kernels a call, {kernel name: launches}), or None where no window
    measured them. The profiler loses a window's first kernel, and at times
    every kernel from some point on; so eight ``add`` kernels run before
    the calls and eight ``mul`` kernels after them, and a window counts only
    where its trace starts with the one and ends with the other (else it is
    profiled again, up to three windows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", torch.cuda.current_device())
    lead, trail = torch.zeros(1, device=dev), torch.ones(1, device=dev)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                lead.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            for _ in range(8):
                trail.mul_(1.0)
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        if not ev or "add" not in ev[0].name.lower() or "mul" not in ev[-1].name.lower():
            continue
        lo, hi = 0, len(ev)
        while lo < hi and "add" in ev[lo].name.lower():
            lo += 1
        while hi > lo and "mul" in ev[hi - 1].name.lower():
            hi -= 1
        body = ev[lo:hi]
        names: Dict[str, int] = {}
        for e in body:
            names[e.name] = names.get(e.name, 0) + 1
        dev_ms = sum(e.time_range.elapsed_us() for e in body) / 1e3 / reps
        return dev_ms, len(body) / reps, names
    return None

"""What the benchmark finds by name: the cell in ``BENCHMARK.json``, its
configuration's file, its traffic mix (``traffic/<mix>.json``), the driver of
its model family and traffic kind (``drivers/<family>_<kind>.py``), the limits
of its output check (``limits/<cell>.json``) and the reader of each per-layer
metric (``metrics/<metric>.py``). Adding a cell, a mix or a metric adds files
and entries; nothing here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "haiku", "posterior_matching_tpu")

M32 = 0xFFFFFFFF


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


@dataclass
class Outcome:
    """What a driver hands back: the work attempted and failed in the window,
    every end-to-end metric it took, the numbers its output check compared
    (``{name: (value, limit)}``), the peak device memory, the traced window
    (``--trace 1``) and facts the metric readers use."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    trace: object = None
    facts: dict = field(default_factory=dict)
    setup_phases: str = ""


def load_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` with its files read; ``KeyError`` naming what is
    missing."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {workload!r} names unknown config {w['config']!r}")
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(_named(PKG / "traffic", w["traffic"], ".json", "traffic mix"))
    limits = load_json(_named(PKG / "limits", workload, ".json", "limits file"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def _named(folder: Path, name: str, suffix: str, what: str) -> Path:
    path = folder / f"{name}{suffix}"
    if not path.is_file():
        known = sorted(p.name[:-len(suffix)] for p in folder.glob(f"*{suffix}"))
        raise KeyError(f"unknown {what} {name!r}; known: {known}")
    return path


def driver(cell: Cell):
    """The module that runs ``cell``'s family under its kind of traffic."""
    name = f"{cell.family}_{cell.kind}"
    _named(PKG / "drivers", name, ".py", "driver")
    return importlib.import_module(f"pmbench.drivers.{name}")


def reader(metric: str) -> Callable:
    """``read(cell, outcome) -> float or None`` of a per-layer metric, loaded
    from ``metrics/<metric>.py``."""
    path = _named(PKG / "metrics", metric, ".py", "metric reader")
    spec = importlib.util.spec_from_file_location(f"pmbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name, whole, is one of FORBIDDEN."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def sync(device) -> None:
    """Waits for the device's queued work (nothing on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's seed (weights, data, a request)."""
    from pmbench.reference.dropout import mix32_int

    h = mix32_int((seed & M32) ^ mix32_int(seed >> 32))
    for p in path:
        h = mix32_int(h ^ mix32_int(p))
    lo = mix32_int(h ^ 0x9E3779B9)
    return ((h << 31) ^ lo) & 0x7FFFFFFFFFFFFFFF


class Stamps:
    """Seconds of each set-up phase from ``start`` (the process's start on
    ``time.time()``), printed on standard error: where set-up goes."""

    def __init__(self, start: float):
        self.t, self.parts = start, []

    def __call__(self, what: str) -> None:
        now = time.time()
        self.parts.append((what, now - self.t))
        self.t = now

    def line(self) -> str:
        return "setup phases: " + ", ".join(f"{w} {s:.2f} s" for w, s in self.parts)


class HostReading:
    """What the host did over a window, to tell a slow run's cause: the main
    thread's CPU seconds and context switches (involuntary ones: it was
    preempted), the process's CPU seconds (the gather's and the driver's
    threads with it), the machine's steal time (another guest held the core),
    and the garbage collector's collections and seconds."""

    def __init__(self):
        import gc
        import resource

        self._gc, self._gc_s, self._gc_n, self._gc_t = gc, 0.0, 0, 0.0
        gc.callbacks.append(self._on_gc)
        self._ru = resource.getrusage(resource.RUSAGE_THREAD)
        self._cpu, self._proc, self._steal = time.thread_time(), time.process_time(), _steal_s()
        self._t = time.perf_counter()

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self._gc_s += time.perf_counter() - self._gc_t
            self._gc_n += 1

    def line(self) -> str:
        import resource

        wall = time.perf_counter() - self._t
        ru = resource.getrusage(resource.RUSAGE_THREAD)
        self._gc.callbacks.remove(self._on_gc)
        return (f"host over the window: {wall:.2f} s; main thread on CPU "
                f"{time.thread_time() - self._cpu:.2f} s, {ru.ru_nivcsw - self._ru.ru_nivcsw} "
                f"involuntary and {ru.ru_nvcsw - self._ru.ru_nvcsw} voluntary switches; process "
                f"CPU {time.process_time() - self._proc:.2f} s; machine steal "
                f"{_steal_s() - self._steal:.2f} CPU s; gc {self._gc_n} collections "
                f"{self._gc_s:.3f} s; {len(os.sched_getaffinity(0))} cores allowed, "
                f"load {os.getloadavg()[0]:.2f}")


def _steal_s() -> float:
    """The machine's steal time so far, over all cores, in seconds."""
    try:
        with open("/proc/stat") as fp:
            return int(fp.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


def check_ok(value: float, limit: float) -> bool:
    return isinstance(value, (int, float)) and math.isfinite(value) and value <= limit


def result(cell: Cell, outcome: Outcome, trace: bool, device_kind: str,
           card: Optional[str]) -> dict:
    """The result line's object: the cell's end-to-end metrics, or with
    ``trace`` its per-layer metrics that found something to read; ``card``,
    what ``nvidia-smi`` reads after the run (name, power limit, SM clock,
    power draw, temperature); the checks last."""
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = reader(m["name"])(cell, outcome)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = outcome.failed == 0 and all(check_ok(v, lim) for v, lim in outcome.checks.values())
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if card:
        device["nvidia_smi"] = card
    out = {"correct": bool(correct), "attempted": int(outcome.attempted),
           "failed": int(outcome.failed), "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        from pmbench.profiling import breakdown

        device["busy_s"] = outcome.trace.busy_s()
        device["window_s"] = outcome.trace.window_s
        out["breakdown"] = breakdown(outcome.trace)
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return out

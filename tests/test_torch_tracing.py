"""The port's host spans (``posterior_matching_torch.tracing``) and the benchmark's
readers of them (``pmbench/spans.py``, ``pmbench/metrics/``), on the CPU.

Off (no profiler), ``span()`` records nothing and hands back one shared no-op
context. Under ``torch.profiler`` spans nest, carry their top-level span's unit
and share the profiler's clock: a span holds the profiler's own events of the
ops inside it. A trainer's step records its prologue, its update and one
``sync`` span for each wait on the device. The readers are worked by hand on a
built trace window."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pmbench import harness, spans as pspans
from pmbench.harness import Outcome
from pmbench.profiling import TraceWindow
from posterior_matching_torch import tracing
from posterior_matching_torch.data.datasets import ArrayDataset
from posterior_matching_torch.models.pm_vqvae import PMVQVAE, pm_vqvae_impute
from posterior_matching_torch.train.optim import Adam
from posterior_matching_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CLOCK_SLACK_NS = 20_000   # the profiler's timestamps against time.time_ns()


@pytest.fixture(autouse=True)
def empty_list():
    tracing.clear()
    yield
    tracing.clear()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    ctx = tracing.span("train.step", 3)
    assert ctx is tracing.span("sync")
    with ctx, tracing.span("sync"):
        pass
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_nested_spans_record_parents_units_and_the_profilers_clock():
    a = torch.randn(384, 384)
    with traced() as prof:
        with tracing.span("outer", 7):
            with tracing.span("inner"):
                a @ a
            with tracing.span("sync"):
                pass
        with tracing.span("loose"):
            pass
    got = tracing.spans()
    assert [s.name for s in got] == ["outer", "inner", "sync", "loose"]
    assert [s.parent for s in got] == [None, 0, 0, None]
    assert [s.unit for s in got] == [7, 7, 7, None]
    assert all(s.start_ns <= s.end_ns for s in got)
    inner = got[1]
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert inner.start_ns - CLOCK_SLACK_NS <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= inner.end_ns + CLOCK_SLACK_NS


def test_a_full_list_drops_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 2)
    with traced():
        for _ in range(5):
            with tracing.span("data.fetch"):
                pass
    assert len(tracing.spans()) == 2 and tracing.dropped() == 3
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_clear_is_refused_inside_an_open_span():
    with traced():
        with tracing.span("train.step", 0):
            with pytest.raises(RuntimeError):
                tracing.clear()


def _trainer():
    model = torch.nn.Linear(3, 1)
    loss = lambda m, batch, seed, training: (m(batch["x"]) ** 2).mean()  # noqa: E731
    trainer = Trainer(model, loss, optimizer=lambda params: Adam(params, lambda count: 0.1),
                      skip_nonfinite_updates=True, ema_rate=0.5, device="cpu")
    trainer.init()
    return trainer


def test_a_step_records_its_prologue_update_and_one_sync_a_wait():
    trainer = _trainer()
    batch = {"x": np.ones((2, 3), np.float32)}
    trainer.train_step(batch)
    assert tracing.spans() == []
    leaves = len(trainer.optimizer.params)
    with traced():
        trainer.train_step(batch)
    got = tracing.spans()
    steps = [i for i, s in enumerate(got) if s.name == "train.step"]
    assert len(steps) == 1 and got[steps[0]].unit == 1 and got[steps[0]].parent is None
    (pro,) = [i for i, s in enumerate(got) if s.name == "train.prologue"]
    (upd,) = [i for i, s in enumerate(got) if s.name == "train.update"]
    assert got[pro].parent == steps[0] and got[upd].parent == steps[0]
    syncs = [s for s in got if s.name == "sync"]
    # the batch's copy, the loss's finiteness, one a gradient
    assert len(syncs) == 2 + leaves
    assert [s.parent for s in syncs] == [pro] + [upd] * (1 + leaves)
    assert all(s.unit == 1 for s in got)
    assert {s.name for s in got} == {"train.step", "train.prologue", "train.update", "sync"}


def test_a_batch_already_on_the_device_is_no_sync():
    trainer = _trainer()
    with traced():
        trainer.train_step({"x": torch.ones(2, 3)})
    assert sum(s.name == "sync" for s in tracing.spans()) == 1 + len(trainer.optimizer.params)


def test_a_fetch_and_a_request_are_spans():
    ds = ArrayDataset({"image": np.zeros((8, 4, 4, 3), np.uint8)}, 4)
    vq = {"output_channels": 3, "embedding_dim": 8, "num_embeddings": 16, "hidden_units": 8,
          "residual_blocks": 1, "residual_hidden_units": 4, "decay": 0.99, "use_ema": True,
          "commitment_cost": 0.25}
    pc = {"image_shape": (4, 4), "num_resnet": 2, "num_hierarchies": 1, "num_filters": 8,
          "dropout": 0.0, "num_indices": 16}
    model = PMVQVAE(6, vq, pc).eval()
    x, b = torch.rand(1, 16, 16, 3), torch.ones(1, 16, 16, 1)
    with traced():
        next(iter(ds))
        for _ in range(2):
            pm_vqvae_impute(model, x, b, 2, generator=torch.Generator().manual_seed(0))
    got = tracing.spans()
    assert [s.name for s in got] == ["data.fetch", "impute.request", "impute.request"]
    assert got[2].unit == got[1].unit + 1 and all(s.parent is None for s in got)


# ---- the readers, on a window built by hand (times in us)
#
#   kernels          [10, 20]       [30, 60]
#   data.fetch  [1, 4]
#   train.step     [5, ............................................ 95]
#   train.prologue [5, 25], its sync [15, 25]
#   train.update                           [60, 90], its sync [70, 80]
#
# Idle: [0, 10], [20, 30], [60, 100] = 60 us. Under the innermost span: no span
# 1 + 1 + 5, data.fetch 3, the prologue 5, its sync 5, the step's own 5 + 5,
# the update 10 + 10, its sync 10; the update's share (30 of 60) is 50%.

def _window(units=1):
    return TraceWindow(units, [("k", 10.0, 20.0), ("k", 30.0, 60.0)], [], 0.0, 100.0)


def _spans(offset_us=0.0, base=0):
    us = lambda t: int((t + offset_us) * 1e3)  # noqa: E731
    rows = [("data.fetch", 1, 4, None, None), ("train.step", 5, 95, None, 0),
            ("train.prologue", 5, 25, 1, 0), ("sync", 15, 25, 2, 0),
            ("train.update", 60, 90, 1, 0), ("sync", 70, 80, 4, 0)]
    return [tracing.Span(n, us(a), us(b), None if p is None else p + base, u)
            for n, a, b, p, u in rows]


def test_idle_by_span_worked_by_hand():
    timed = pspans.in_window(_window(), _spans(), "train.step")
    idle = {k: round(v * 1e6, 6) for k, v in pspans.idle_by_span(_window(), timed).items()}
    assert idle == {pspans.NO_SPAN: 7.0, "data.fetch": 3.0, "train.step/train.prologue": 5.0,
                    "train.step/train.prologue/sync": 5.0, "train.step": 10.0,
                    "train.step/train.update": 20.0, "train.step/train.update/sync": 10.0}
    assert pspans.idle_share_pct(_window(), timed, "train.update") == pytest.approx(50.0)


TRAIN_READS = {"train.host_ms_per_step": 0.090, "train.prologue_ms_per_step": 0.020,
               "train.update_ms_per_step": 0.030, "train.wait_ms_per_step": 0.020,
               "train.syncs_per_step": 2.0, "device.idle_in_update_pct.train": 50.0,
               "data.fetch_ms.train": 0.003}


def _outcome(tw):
    return Outcome(attempted=1, failed=0, end_to_end={}, checks={}, memory_peak_bytes=0,
                   trace=tw)


@pytest.mark.parametrize("metric", sorted(TRAIN_READS))
def test_train_readers_by_hand(monkeypatch, metric):
    cell = harness.find_cell(harness.benchmark(), "pm_vqvae_celeb_a.train")
    assert metric in {m["name"] for m in cell.per_layer}
    read = harness.reader(metric)
    # spans of the named window, after the metrics' window, are left out
    monkeypatch.setattr(pspans, "program_spans", lambda: _spans() + _spans(1000.0, 6))
    assert read(cell, _outcome(_window())) == pytest.approx(TRAIN_READS[metric])
    assert read(cell, _outcome(None)) is None
    assert read(cell, _outcome(_window(units=2))) is None
    monkeypatch.setattr(pspans, "program_spans", lambda: None)
    assert read(cell, _outcome(_window())) is None


def test_a_step_counts_whole_where_the_window_ends_inside_it(monkeypatch):
    cell = harness.find_cell(harness.benchmark(), "pm_vdvae_mnist.train")
    monkeypatch.setattr(pspans, "program_spans", lambda: _spans())
    short = TraceWindow(1, [("k", 10.0, 20.0), ("k", 30.0, 60.0)], [], 0.0, 65.0)
    assert harness.reader("train.syncs_per_step")(cell, _outcome(short)) == 2.0
    assert harness.reader("train.update_ms_per_step")(cell, _outcome(short)) == pytest.approx(0.030)


def test_impute_reader_by_hand(monkeypatch):
    cell = harness.find_cell(harness.benchmark(), "pm_vqvae_celeb_a.impute")
    read = harness.reader("impute.host_ms_per_request")
    rows = [tracing.Span("impute.request", 10_000, 40_000, None, 0),
            tracing.Span("impute.request", 50_000, 60_000, None, 1)]
    monkeypatch.setattr(pspans, "program_spans", lambda: rows)
    assert read(cell, _outcome(_window(units=2))) == pytest.approx(0.020)
    assert read(cell, _outcome(_window(units=3))) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    import sys

    import posterior_matching_torch

    monkeypatch.delattr(posterior_matching_torch, "tracing")
    monkeypatch.setitem(sys.modules, "posterior_matching_torch.tracing", None)
    assert pspans.program_spans() is None


def test_segments_at_shared_instants():
    # siblings meeting at 20, a child closing with its parent at 30, an empty span
    timed = [pspans.Timed("a", ("a",), 10.0, 30.0), pspans.Timed("b", ("a", "b"), 10.0, 20.0),
             pspans.Timed("c", ("a", "c"), 20.0, 30.0), pspans.Timed("d", ("d",), 40.0, 40.0)]
    assert pspans._segments(timed, 0.0, 50.0) == [
        (0.0, 10.0, pspans.NO_SPAN), (10.0, 20.0, "a/b"), (20.0, 30.0, "a/c"),
        (30.0, 50.0, pspans.NO_SPAN)]

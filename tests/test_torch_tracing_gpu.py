"""The port's host spans on the card.

The shared clock: a span around a ~1 ms product and a synchronise holds that
kernel's device interval in a ``pmbench.profiling.profile_window`` trace, to
within 50 us at either end.

One ``sync`` span a synchronising call: under
``torch.cuda.set_sync_debug_mode("warn")``, a steady ``train_step`` of each
training cell's trainer (the benchmark's own set-up, on a small split) and a
steady ``pm_vqvae_impute`` request warn of a synchronising call only inside a
``sync`` span, every ``sync`` span holds a call warned of, and the spans and
warnings come to the counts the steps are known to make: a sync added to the
hot path without its span fails here, and ``train.syncs_per_step`` stays a
count of the calls that wait. These need an
NVIDIA GPU; elsewhere they skip. From the root of a checkout, on the card::

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_tracing_gpu.py
"""
import copy
import time
import traceback
import warnings

import pytest
import torch

from posterior_matching_torch import tracing

pytestmark = pytest.mark.cuda

SEED = 2 ** 31 + 2027
SLACK_US = 50.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tracing.clear()
    yield torch.device("cuda")
    tracing.clear()


def test_a_span_holds_its_kernel_on_the_trace_clock(dev):
    from pmbench.profiling import profile_window

    a = torch.randn(3072, 3072, device=dev)
    (a @ a).sum().item()

    def probe():
        with tracing.span("probe"):
            a @ a
            torch.cuda.synchronize()

    tw = profile_window(probe, 1)
    assert tw is not None and tw.kernels
    (span,) = [s for s in tracing.spans()
               if s.name == "probe" and tw.start_us <= s.start_ns / 1e3 <= tw.end_us]
    _, k0, k1 = max(tw.kernels, key=lambda k: k[2] - k[1])
    s0, s1 = span.start_ns / 1e3, span.end_ns / 1e3
    assert k1 - k0 > 200.0, tw.kernels
    assert s0 - SLACK_US <= k0 and k1 <= s1 + SLACK_US, (s0, k0, k1, s1)
    # the synchronise returns soon after the kernel ends
    assert s1 - k1 < 1000.0, (k1, s1)


def _syncs_and_warnings(fn, unit):
    """Runs ``fn`` once under the profiler with the sync debug mode on. Returns
    the spans recorded inside the ``unit`` span, and for each synchronising
    call warned of inside it the time and the innermost line of the port that
    made it."""
    tracing.clear()
    warned = []

    def note(message, category, *args, **kwargs):
        if "synchroniz" in str(message).lower():
            port = [f for f in traceback.extract_stack()
                    if "posterior_matching_torch" in f.filename]
            where = f"{port[-1].filename.rsplit('/', 1)[-1]}:{port[-1].lineno}" if port else "?"
            warned.append((time.time_ns(), where))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    got = tracing.spans()
    (top,) = [s for s in got if s.name == unit]
    spans = [s for s in got if top.start_ns <= s.start_ns <= top.end_ns]
    return spans, [w for w in warned if top.start_ns <= w[0] <= top.end_ns]


def _check(spans, warned):
    """Every warning inside a ``sync`` span, and every ``sync`` span over a
    call warned of; returns the spans and the number of warnings, and says
    where the warnings came from."""
    syncs = [s for s in spans if s.name == "sync"]
    lines = {}
    for _, where in warned:
        lines[where] = lines.get(where, 0) + 1
    outside = [w for w in warned if not any(s.start_ns <= w[0] <= s.end_ns for s in syncs)]
    idle = [s for s in syncs if not any(s.start_ns <= t <= s.end_ns for t, _ in warned)]
    detail = f"{len(syncs)} sync spans, {len(warned)} warnings from {lines}"
    assert not outside, (f"warnings outside a sync span from {sorted({w for _, w in outside})}; "
                         f"{detail}")
    assert not idle, f"{len(idle)} sync spans over no warned call; {detail}"
    print(detail)
    return syncs, len(warned)


# sync spans and warnings a steady step makes: the batch's copy and the mask
# mixture's weights copied from the host in the prologue, then PM-VQVAE's
# codebook counts (``torch.bincount`` reads its input's least and largest
# value: two waits in one call), PM-VDVAE's finiteness test (the loss and 1,013
# gradients)
@pytest.mark.parametrize("workload,syncs,warns", [("pm_vqvae_celeb_a.train", 3, 4),
                                                  ("pm_vdvae_mnist.train", 1016, 1016)])
def test_one_sync_span_a_sync_in_a_training_step(dev, workload, syncs, warns):
    from pmbench import harness

    cell = harness.find_cell(harness.benchmark(), workload)
    cell.config = dict(copy.deepcopy(cell.config), train_examples=1024)
    s = harness.driver(cell).setup(cell, SEED, dev, lambda what: None)
    for _ in range(2):
        s.trainer.train_step(next(s.batches))
    torch.cuda.synchronize()
    batch = next(s.batches)
    spans, warned = _syncs_and_warnings(lambda: s.trainer.train_step(batch), "train.step")
    got, n = _check(spans, warned)
    assert (len(got), n) == (syncs, warns)


def test_one_sync_span_a_sync_in_a_request(dev):
    from pmbench import harness
    from pmbench.drivers import _pm_vqvae as pmv
    from pmbench.drivers.pm_vqvae_impute import Requests
    from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute

    cell = harness.find_cell(harness.benchmark(), "pm_vqvae_celeb_a.impute")
    cfg = dict(copy.deepcopy(cell.config), eval_examples=256)
    model = pmv.program_model(cfg, pmv.draw_weights(cfg, SEED, dev), dev)
    reqs = Requests(cfg, cell.traffic, SEED, dev)
    for i in range(2):
        x, b, noise = reqs.inputs(i)
        pm_vqvae_impute(model, x, b, reqs.samples, noise=noise)
    torch.cuda.synchronize()
    x, b, noise = reqs.inputs(2)
    spans, warned = _syncs_and_warnings(
        lambda: pm_vqvae_impute(model, x, b, reqs.samples, noise=noise), "impute.request")
    got, n = _check(spans, warned)
    assert (len(got), n) == (0, 0)

"""The output checks at a tiny size on the CPU: the program passes, and each
fault a cell can have, planted underneath the timed path, turns ``correct``
false. The drivers, the reference and the comparison are the card's; only the
widths are cut (``tiny.py``)."""
from __future__ import annotations

import pytest

from pmbench import harness
from pmbench.tests import faults
from pmbench.tests.readings import readings
from pmbench.tests.tiny import tiny_cell

WORKLOADS = [w["name"] for w in harness.benchmark()["workloads"]]
CASES = [(w, f) for w in WORKLOADS
         for f in faults.FAULTS_OF[harness.find_cell(harness.benchmark(), w).kind]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_program_passes(workload):
    (line,) = readings(workload, "program", [2 ** 31 + 5], 0.3, device="cpu",
                       cell=tiny_cell(workload))
    assert line["correct"], line


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_planted_fault_fails(workload, fault):
    (line,) = readings(workload, f"fault:{fault}", [2 ** 31 + 6], 0.3, device="cpu",
                       cell=tiny_cell(workload))
    assert not line["correct"], line


def test_loss_gap_reads_relative_gaps():
    from pmbench.drivers._train import gaps

    g = {"a": 1.0, "b": 2.0, "c": 1e-9}
    got = ([1.0, 2.0], {"a": 1.1, "b": 2.0, "c": 0.0}, {"a": 1.0, "b": 1.0, "c": 5.0}, None)
    want = ([1.0, 2.2], g, {"a": 1.0, "b": 0.5, "c": 1.0}, None)
    out = gaps(got, want)
    assert "ema_gap" not in out
    assert out["loss_gap"] == pytest.approx(0.2 / 2.2)
    # against max(own norm, median 1.0): a 0.1 / 1.0; c's tiny gradient against the median
    assert out["grad_gap"] == pytest.approx(0.1)
    # c's gradient is under a thousandth of the median: left out of the change
    assert out["change_gap"] == pytest.approx(0.5 / 0.75)
    # an EMA the reference keeps and the program does not fails
    out = gaps(got[:3] + (None,), want[:3] + ({"a": 1.0, "b": 1.0, "c": 1.0},))
    assert out["ema_gap"] == float("inf")

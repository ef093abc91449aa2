"""On the card, at the cells' own sizes: the program passes its output check on
fresh seeds, the control (the reference in TF32 in the program's place) fails
it, and each fault a cell can have fails it. Run from the root of a checkout::

    python3 -m pytest --noconftest -q -m cuda pmbench/tests/test_pmbench_gpu.py
"""
from __future__ import annotations

import pytest

from pmbench import harness
from pmbench.tests import faults
from pmbench.tests.readings import readings

WORKLOADS = [w["name"] for w in harness.benchmark()["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _seconds(workload):
    return 4.0 if workload.endswith(".impute") else 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_three_seeds(card, workload):
    lines = list(readings(workload, "control", SEEDS, _seconds(workload)))
    assert not any(line["correct"] for line in lines), lines


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes(card, workload):
    (line,) = readings(workload, "program", SEEDS[:1], _seconds(workload))
    assert line["correct"], line


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in WORKLOADS
    for f in faults.FAULTS_OF[harness.find_cell(harness.benchmark(), w).kind]])
def test_planted_fault_fails(card, workload, fault):
    (line,) = readings(workload, f"fault:{fault}", SEEDS[:1], _seconds(workload))
    assert not line["correct"], line

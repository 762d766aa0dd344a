"""A whole run of each cell on the CPU at a reduced size, the harness's
look for a card skipped: sound, it comes out correct; with the timed
path broken underneath by each fault a one-chip training cell can have
(``faults.py``), and with the control (the reference computed in
float8) in the program's place, it comes out not correct at the cell's
own limits."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import check, harness
from portbench.faults import FAULTS
from portbench.reference.model import FP8
from portbench.tests.helpers import CELLS, small_cell

SEED = 2**31 + 101
#: the reference's readings of each cell, computed once for its runs
_REFERENCE: dict = {}
_reference_readings = harness.reference_readings


def _cached_reference(cell, seed, device):
    key = (cell.name, seed)
    if key not in _REFERENCE:
        _REFERENCE[key] = _reference_readings(cell, seed, device)
    return _REFERENCE[key]


@pytest.mark.parametrize("fault", [None, *FAULTS])
@pytest.mark.parametrize("name", CELLS)
def test_run_sees_the_fault(name, fault, monkeypatch):
    monkeypatch.setattr(harness, "reference_readings", _cached_reference)
    cell = small_cell(name)
    out, lines = harness.run(cell, SEED, 0.05, False, "cpu",
                             time.perf_counter(),
                             fault=FAULTS[fault]() if fault else None)
    assert out["correct"] is (fault is None), lines
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = small_cell(name)
    cpu = torch.device("cpu")
    ref = _cached_reference(cell, SEED, cpu)
    ctl = harness.reference_readings(cell, SEED, cpu, FP8)
    correct, checks = check.verdict(check.gaps(ctl, ref), cell.limits)
    assert not correct, checks

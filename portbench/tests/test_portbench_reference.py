"""The benchmark's plain reference against the port, on the CPU at the
registry's reduced sizes: the same initial weights from a seed, the
same routing, and the same rounds (losses and every leaf's change) on
the masked and the partitioned client planes, dense and moe."""
from __future__ import annotations

import pytest
import torch

from portbench import check, harness
from portbench import traffic as tr
from portbench.program import Program
from portbench.reference import model as ref_model
from portbench.tests.helpers import CELLS, MOE, small_cell
from repro_torch.models import moe as port_moe
from repro_torch.utils.tree import leaves as port_leaves

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", [CELLS[0], MOE])
def test_initial_weights_equal_the_ports(name):
    cell = small_cell(name, "bfloat16")
    prog = Program(cell.cfg, cell.traffic, 12345, CPU)
    mine = ref_model.init_params(cell.cfg, tr.weights_generator(12345, CPU))
    got = dict(ref_model.leaves(mine))
    theirs = dict(ref_model.leaves(prog.params()))
    assert set(got) == set(theirs)
    assert len(port_leaves(prog.params())) == len(theirs)
    for path, a in got.items():
        b = theirs[path]
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("name", [*CELLS, MOE])
def test_rounds_equal_the_ports_in_f32(name):
    """Three rounds in f32: each round's loss and each leaf's change
    agree to f32 rounding (the kernels' plain versions sum in another
    order than the reference)."""
    cell = small_cell(name)
    prog = Program(cell.cfg, cell.traffic, 2**31 + 11, CPU)
    got, _ = harness.check_rounds(prog)
    ref = harness.reference_readings(cell, 2**31 + 11, CPU)
    for a, b in zip(got["loss"], ref["loss"], strict=True):
        assert a == pytest.approx(b, rel=1e-5)
    for key in ("step1", "change"):
        assert set(got[key]) == set(ref[key])
        for leaf, v in ref[key].items():
            assert got[key][leaf] == pytest.approx(v, rel=1e-4, abs=1e-7), \
                (key, leaf)
    gaps = check.gaps(got, ref)
    assert all(v < 1e-4 for v, _ in gaps.values()), gaps


def test_limited_cohort_moves_only_the_classifier():
    cell = small_cell(CELLS[0])
    cell.traffic = {**cell.traffic, "p_limited": 1.0}
    ref = harness.reference_readings(cell, 7, CPU, rounds=1)
    moved = ref["step1"]["lm_head.w"]
    assert moved > 0
    for leaf, v in ref["step1"].items():
        if leaf.split(".")[0] in ("embed", "body"):
            # only the server mix's f32 rounding of a*p + b*p moves them
            assert v < 1e-4 * moved, leaf


@pytest.mark.parametrize("ties", [False, True])
def test_routing_equals_the_ports(ties):
    """Top-2 of 8 experts with a capacity that drops: the expert, place
    and gate of every assignment as the port's dispatch and combine give
    them, with exact ties among the probabilities (the lower expert
    first) and without."""
    cfg = {"num_experts": 8, "top_k": 2, "capacity_factor": 1.25}
    gen = torch.Generator().manual_seed(3)
    T = 64
    logits = torch.randn(T, 8, generator=gen)
    if ties:
        logits = torch.round(logits * 2) / 2
    probs = torch.softmax(logits, -1)
    idx, place, gate, kept = ref_model.route(probs, cfg)

    class Cfg:
        num_experts, top_k, capacity_factor = 8, 2, 1.25
    xt = torch.randn(T, 4, generator=gen)
    disp, comb = port_moe._dispatch_combine(xt, probs, Cfg)
    C = ref_model.capacity(T, cfg)
    assert disp.shape[-1] == C == port_moe._capacity(T, Cfg)
    want = torch.zeros(T, 8, C)
    for t in range(T):
        for k in range(2):
            if kept[t, k]:
                want[t, idx[t, k], place[t, k]] = gate[t, k]
    assert torch.equal(comb, want)
    assert torch.equal(disp, (want > 0).to(disp.dtype))

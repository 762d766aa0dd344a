"""The benchmark's counts pinned to hand-worked numbers, and to the
port's own parameter tree at a reduced size."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import counts, spec
from portbench.program import Program
from portbench.reference.model import leaves
from portbench.tests.helpers import CELLS, MOE, small_cell

#: minitron-8b's blocks: attention 4096 x 6144 (q) + 2 x 4096 x 1024 (k,
#: v) + 6144 x 4096 (o) = 58,720,256; the MLP 2 x 4096 x 16384 =
#: 134,217,728; two norms 8,192: 192,946,176 a block. Embedding and head
#: 2 x 256000 x 4096 = 2,097,152,000, the final norm 4,096.
#: (layers, parameters): the cells' depth and the published 32 (8.27 B)
COUNTS = [(9, 9 * 192_946_176 + 2_097_156_096),
          (32, 32 * 192_946_176 + 2_097_156_096)]
#: phi3.5-moe (hf:microsoft/Phi-3.5-MoE-instruct) at 3 of 32 layers: a
#: block holds attention 2 x 4096 x 4096 + 2 x 4096 x 1024, 16 experts of
#: 3 x 4096 x 6400, an f32 router of 4096 x 16 and two norms
PHI = dict(d_model=4096, d_ff=6400, vocab_size=32064, num_heads=32,
           num_kv_heads=8, head_dim=128, num_experts=16, top_k=2,
           mlp_gated=True, dtype="bfloat16", num_layers=3)


def _cfg(name="minitron-8b.l9"):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("layers,want", COUNTS)
def test_parameter_counts(layers, want):
    assert counts.param_count({**_cfg(), "num_layers": layers}) == want
    assert want in (3_833_671_680, 8_271_433_728)


def test_moe_counts_and_router_group():
    assert counts.param_count(PHI) == 4_163_596_288
    assert counts.params_by_dtype(PHI)["float32"] == 3 * 4096 * 16


@pytest.mark.parametrize("name", [CELLS[0], MOE])
def test_counts_match_the_ports_tree(name):
    cell = small_cell(name, "bfloat16")
    prog = Program(cell.cfg, cell.traffic, 1, torch.device("cpu"))
    by = {}
    for _, x in leaves(prog.params()):
        k = str(x.dtype).split(".")[1]
        by[k] = by.get(k, 0) + x.numel()
    assert by == counts.params_by_dtype(cell.cfg)


def test_minitron_flops_a_token():
    """9 layers at S 4096: 6 x 2,785,017,856 matmul parameters (the
    blocks' 9 x 192,937,984 and the head's 1,048,576,000) plus causal
    attention's 3 x 4 x 48 x 128 x 2048.5 x 9 = 1,359,286,272."""
    cfg = _cfg()
    assert counts.full_row_flops(cfg, 4096) == 4096 * 18_069_393_408
    assert counts.full_row_flops(cfg, 4096) / 4096 / 1e9 == \
        pytest.approx(18.07, abs=0.005)


def test_limited_row_flops():
    """Forward 2 x 2,785,017,856 + 4 x 6144 x 2048.5 x 9 a token; the
    head's backward 4 x 1,048,576,000, the 2 tail blocks' 4 x
    192,937,984 + 8 x 6144 x 2048.5 each, less 2 x 33,554,432 (the first
    tail block's q, k, v input gradient)."""
    cfg = _cfg()
    fwd = 2 * 2_785_017_856 + 4 * 6144 * 2048.5 * 9
    bwd = (4 * 1_048_576_000 + 2 * (4 * 192_937_984 + 8 * 6144 * 2048.5)
           - 2 * 33_554_432)
    assert counts.limited_row_flops(cfg, 4096) == 4096 * (fwd + bwd)
    assert fwd + bwd == 11_895_205_888


def test_round_flops():
    cell = spec.load("minitron8b.pod.masked")
    S = cell.traffic["seq"]
    one = counts.round_flops(cell.cfg, cell.traffic, 1)
    assert one == 2 * (counts.full_row_flops(cell.cfg, S)
                       + counts.limited_row_flops(cell.cfg, S))


def test_flash_bound():
    """PERF.md's row 7: B 2, S 2048, 32 heads of 128, causal bf16: the
    forward 68.8 GFLOP (0.0695 ms), dq 103.2, dkdv 137.5 GFLOP."""
    f = counts.flash_work("fwd", 2, 2048, 32, 8, 128, 2)
    assert f[1] / 1e9 == pytest.approx(68.75, abs=0.01)
    assert counts.bound_s(*f, counts.BF16_FLOPS) * 1e3 == \
        pytest.approx(0.0695, abs=1e-4)
    assert counts.flash_work("bwd_dq", 2, 2048, 32, 8, 128, 2)[1] / 1e9 \
        == pytest.approx(103.2, abs=0.1)
    assert counts.flash_work("bwd_dkdv", 2, 2048, 32, 8, 128, 2)[1] / 1e9 \
        == pytest.approx(137.5, abs=0.1)


def test_server_mix_bound():
    """PERF.md's row 1: N 2,583,711,744 bf16, K 2: 6.1701 ms."""
    nbytes = counts.server_mix_bytes(2, 2_583_711_744, "bfloat16")
    assert nbytes / counts.HBM_BYTES * 1e3 == pytest.approx(6.1701, abs=1e-4)

"""Cells of the benchmark cut to a CPU test's size."""
from __future__ import annotations

from portbench import spec

#: the registry's reduced sizes (``configs/base.py: reduced``), with 6
#: query heads of 64 so that q and o are 1.5 d wide, as minitron-8b's 48
#: heads of 128 are at d 4096
SMALL = dict(num_layers=2, d_model=256, d_ff=512, vocab_size=512,
             num_heads=6, num_kv_heads=2, head_dim=64, fes_tail_layers=1)
CELLS = ("minitron8b.pod.masked", "minitron8b.pod.fes50")
#: a moe configuration for the reference's moe layer, which no cell runs
#: yet: the minitron cell's file with phi3.5-moe's routing
#: (hf:microsoft/Phi-3.5-MoE-instruct: 16 experts of 6400, top 2, SwiGLU
#: experts); ``small_cell`` cuts it to 4 experts
MOE = "moe"
MOE_KEYS = dict(family="moe", num_experts=16, top_k=2, capacity_factor=1.25,
                moe_group_size=4096, mlp_gated=True)


def small_cell(name: str, dtype: str = "float32", seq: int = 64):
    """The cell ``name`` (or, for ``MOE``, the moe configuration under
    the masked traffic) at the registry's reduced widths (4 experts for
    the moe configuration), rows of ``seq`` tokens, in ``dtype``."""
    cell = spec.load(CELLS[0] if name == MOE else name)
    extra = {}
    if name == MOE:
        cell.name = MOE
        extra = {**MOE_KEYS, "num_experts": 4}
    cell.cfg = {**cell.cfg, **SMALL, **extra, "dtype": dtype}
    cell.traffic = {**cell.traffic, "seq": seq}
    return cell

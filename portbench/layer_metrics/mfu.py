"""mfu (whole round, ``core/round.py: make_round_step``): the FLOPs the
window's rounds require (``counts.round_flops``: no recomputation, a
limited cohort's forward and its classifier's backward only) over the
window's seconds, as a share of the card's bf16 peak."""
from portbench import counts


def read(run):
    if not run.round_s:
        return None
    flops = run.round_flops * len(run.round_s)
    return 100.0 * flops / run.window_s / counts.BF16_FLOPS

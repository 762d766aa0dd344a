"""flash_roofline (attention kernels, ``kernels/flash_attention.py``,
``csrc/flash_attention_sm90.cu``): the sum of the bounds over the sum of
the kernel times of every flash_fwd, flash_bwd_dq and flash_bwd_dkdv
launch in the trace. A launch's batch comes from its grid (B x H blocks
in x, B x Hkv for dkdv); its bound is the larger of its bytes over HBM
bandwidth and its operations over the bf16 (the sm90 kernels) or f32
peak (``counts.flash_work``)."""
from portbench import counts

_KERNEL = r"\bflash_(fwd|bwd_dq|bwd_dkdv)(_sm90)?_kernel"


def read(run):
    if run.trace is None:
        return None
    cfg, S = run.cfg, run.traffic["seq"]
    H, Hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    bound = spent = 0.0
    for e in run.trace.kernels(_KERNEL):
        name = e["name"]
        kind = ("bwd_dkdv" if "bwd_dkdv" in name else
                "bwd_dq" if "bwd_dq" in name else "fwd")
        sm90 = "_sm90" in name
        heads = Hkv if kind == "bwd_dkdv" else H
        B = e["args"]["grid"][0] // heads
        nbytes, flops = counts.flash_work(kind, B, S, H, Hkv, hd,
                                          2 if sm90 else 4)
        bound += counts.bound_s(nbytes, flops, counts.BF16_FLOPS if sm90
                                else counts.F32_FLOPS)
        spent += e["dur"] / 1e6
    return 100.0 * bound / spent if spent else None
